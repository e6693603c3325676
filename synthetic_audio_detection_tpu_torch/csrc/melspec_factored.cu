// Factored-DFT log-mel front end for Hopper (sm_90a).
//
// Replaces the TPU kernel synthetic_audio_detection_tpu/ops/pallas_melspec.py
// :_factored_kernel (entries fused_log_mel_factored / serving_log_mel) with
// standardize as a flag and the float32 mel product (lowp_tail off). One call
// of sad_melspec_factored runs three launches on the caller's stream:
//
//   1. block_dft_kernel  Y[b·nb + h, :] = bf16(block h of window b) ·
//      [cos | sin][hop, 2·ncp], float32 accumulation. A shared-memory tiled
//      GEMM on the tensor cores (mma.sync m16n8k16 bf16). This is the bulk of
//      the arithmetic (2·M·N·K with M = windows·blocks, N = 2·ncp, K = hop)
//      and is compute-bound; the product stays in bf16 operands / f32
//      accumulators exactly as the TPU kernel's DFT matmul does.
//   2. frames_mel_kernel  one block per (window, 32-frame tile), looping over
//      64-bin frequency tiles: X_t[f] = Σ_i c_i[f]·Y[t+i, f] with the phases
//      c_i[f] = (−j)^(i·(f mod 4)) computed, not loaded (exact at
//      n_fft/hop = 4); the periodic Hann as the 3-tap conv
//      0.5·X[f] − 0.25·(X[f−1] + X[f+1]) with X[−1] = conj(X[1]) and a
//      one-bin halo on each side of the tile (bin n_sig is the guard bin:
//      a real DFT value, never padding); power |W|²; and the mel product
//      accumulated in float32 registers over the tiles. This stage is bound
//      by moving Y (each Y row feeds four frames): the X tile is assembled
//      once in shared memory so each Y value is read once per tile, and the
//      mel filterbank rows are read through the read-only cache.
//   3. db_standardize_kernel  one 1024-thread block per window holds the
//      whole [n_mels, n_frames] plane in registers: 10·log10(max(mel,1e-10)),
//      the max − top_db clamp, then mean and unbiased variance in two passes,
//      z = (db − mean) / (sqrt(var) + eps). Reductions are fixed-order trees
//      with no atomics, so repeated runs give identical bits.
//
// The kernel allocates nothing: the caller passes the Y scratch and the mel
// and output tensors. Returns the first CUDA error (cudaGetLastError after
// each launch) or cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---- stage 1: block DFT GEMM ------------------------------------------------

constexpr int BM = 128;   // rows (hop blocks) per block
constexpr int BN = 128;   // DFT columns per block
constexpr int BK = 32;    // samples per k step
constexpr int SPAD = 8;   // bf16 row padding in shared memory (no bank conflicts)
constexpr int GEMM_THREADS = 256;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a: [M, K] float32 row-major (the centre-padded waveforms viewed as hop
// blocks); bt: [N, K] bf16 (the DFT matrix transposed, k contiguous);
// y: [M, N] float32. Requires N % BN == 0 and K % BK == 0.
__global__ void __launch_bounds__(GEMM_THREADS)
block_dft_kernel(const float* __restrict__ a, const __nv_bfloat16* __restrict__ bt,
                 float* __restrict__ y, int M, int N, int K) {
    __shared__ __align__(16) __nv_bfloat16 As[BM][BK + SPAD];
    __shared__ __align__(16) __nv_bfloat16 Bs[BN][BK + SPAD];

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp >> 2;  // 2 warp rows of 64
    const int wn = warp & 3;   // 4 warp columns of 32
    const int g = lane >> 2, tq = lane & 3;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    for (int k0 = 0; k0 < K; k0 += BK) {
        // A tile: 128 x 32 floats as 1024 float4, rounded to bf16 on the way in
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int idx = tid + i * GEMM_THREADS;
            const int r = idx >> 3, c = (idx & 7) * 4;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (m0 + r < M)
                v = *reinterpret_cast<const float4*>(a + (size_t)(m0 + r) * K + k0 + c);
            uint2 p;
            p.x = pack_bf16x2(v.x, v.y);
            p.y = pack_bf16x2(v.z, v.w);
            *reinterpret_cast<uint2*>(&As[r][c]) = p;
        }
        // B tile: 128 x 32 bf16 as 512 uint4
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int idx = tid + i * GEMM_THREADS;
            const int r = idx >> 2, c = (idx & 3) * 8;
            *reinterpret_cast<uint4*>(&Bs[r][c]) =
                *reinterpret_cast<const uint4*>(bt + (size_t)(n0 + r) * K + k0 + c);
        }
        __syncthreads();

#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            uint32_t af[4][4], bfr[4][2];
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) {
                const int r = wm * 64 + mi * 16 + g;
                af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + tq * 2]);
                af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + tq * 2]);
                af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + tq * 2 + 8]);
                af[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + tq * 2 + 8]);
            }
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
                const int c = wn * 32 + ni * 8 + g;
                bfr[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[c][kk + tq * 2]);
                bfr[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[c][kk + tq * 2 + 8]);
            }
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
        const int r = m0 + wm * 64 + mi * 16 + g;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const int c = n0 + wn * 32 + ni * 8 + tq * 2;
            if (r < M)
                *reinterpret_cast<float2*>(y + (size_t)r * N + c) =
                    make_float2(acc[mi][ni][0], acc[mi][ni][1]);
            if (r + 8 < M)
                *reinterpret_cast<float2*>(y + (size_t)(r + 8) * N + c) =
                    make_float2(acc[mi][ni][2], acc[mi][ni][3]);
        }
    }
}

// ---- stage 2: frames, Hann in frequency, power, mel -------------------------

constexpr int TF = 32;  // frames per block
constexpr int FT = 64;  // frequency bins per tile
constexpr int MEL_THREADS = 256;
constexpr int MAX_MELS = 128;

// y: [windows, nb, 2·ncp] (re in [0, ncp), im in [ncp, 2·ncp)); fb: [n_sig,
// n_mels]; mel: [windows, n_mels, n_frames].
__global__ void __launch_bounds__(MEL_THREADS)
frames_mel_kernel(const float* __restrict__ y, const float* __restrict__ fb,
                  float* __restrict__ mel, int nb, int ncp, int n_frames, int n_sig,
                  int n_mels) {
    __shared__ float xr[TF][FT + 2];
    __shared__ float xi[TF][FT + 2];
    __shared__ float pw[TF][FT];

    const int b = blockIdx.y;
    const int t0 = blockIdx.x * TF;
    const int tid = threadIdx.x;
    const int tx = tid & 31, ty = tid >> 5;  // mels tx + 32j, frames 4·ty + i
    const float* yb = y + (size_t)b * nb * 2 * ncp;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int f0 = 0; f0 < n_sig; f0 += FT) {
        // X for bins f0−1 … f0+FT (column c holds bin f0 − 1 + c)
        for (int idx = tid; idx < TF * (FT + 2); idx += MEL_THREADS) {
            const int tl = idx / (FT + 2), c = idx % (FT + 2);
            const int t = t0 + tl;
            int f = f0 - 1 + c;
            const bool mirror = f < 0;
            if (mirror) f = 1;  // X[−1] = conj(X[1])
            float re = 0.f, im = 0.f;
            if (t < n_frames && f <= n_sig) {
                const int q = f & 3;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float* row = yb + (size_t)(t + i) * 2 * ncp;
                    const float yr = row[f], yi = row[ncp + f];
                    switch ((i * q) & 3) {
                        case 0: re += yr; im += yi; break;  // c = 1
                        case 1: re += yi; im -= yr; break;  // c = −j
                        case 2: re -= yr; im -= yi; break;  // c = −1
                        default: re -= yi; im += yr; break; // c = +j
                    }
                }
            }
            xr[tl][c] = re;
            xi[tl][c] = mirror ? -im : im;
        }
        __syncthreads();

        for (int idx = tid; idx < TF * FT; idx += MEL_THREADS) {
            const int tl = idx / FT, c = idx % FT;
            float p = 0.f;
            if (f0 + c < n_sig) {
                const float wr = 0.5f * xr[tl][c + 1] - 0.25f * (xr[tl][c] + xr[tl][c + 2]);
                const float wi = 0.5f * xi[tl][c + 1] - 0.25f * (xi[tl][c] + xi[tl][c + 2]);
                p = wr * wr + wi * wi;
            }
            pw[tl][c] = p;
        }
        __syncthreads();

        const int n_c = min(FT, n_sig - f0);
        for (int c = 0; c < n_c; ++c) {
            const float* fr = fb + (size_t)(f0 + c) * n_mels;
            float fv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int m = tx + 32 * j;
                fv[j] = m < n_mels ? __ldg(fr + m) : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float p = pw[ty * 4 + i][c];
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p, fv[j], acc[i][j]);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int m = tx + 32 * j;
            if (t < n_frames && m < n_mels)
                mel[((size_t)b * n_mels + m) * n_frames + t] = acc[i][j];
        }
    }
}

// ---- stage 3: dB, clamp, standardize ----------------------------------------

constexpr int NORM_THREADS = 1024;
constexpr int PER_THREAD = 32;  // 1024 · 32 = 32768 cells per window at most

// Fixed-order block reduction over 1024 threads (sum or max); every thread
// gets lane 0's result.
__device__ __forceinline__ float block_reduce(float v, float* red, bool take_max) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const float w = __shfl_xor_sync(0xffffffffu, v, o);
        v = take_max ? fmaxf(v, w) : v + w;
    }
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = red[lane];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const float w = __shfl_xor_sync(0xffffffffu, v, o);
            v = take_max ? fmaxf(v, w) : v + w;
        }
        if (lane == 0) red[32] = v;
    }
    __syncthreads();
    const float r = red[32];
    __syncthreads();
    return r;
}

// mel, out: [windows, n] with n = n_mels · n_frames (the same layout).
__global__ void __launch_bounds__(NORM_THREADS)
db_standardize_kernel(const float* __restrict__ mel, float* __restrict__ out, int n,
                      float top_db, float eps, int standardize) {
    __shared__ float red[33];
    const size_t base = (size_t)blockIdx.x * n;
    float v[PER_THREAD];
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
        const int idx = threadIdx.x + k * NORM_THREADS;
        float d = -INFINITY;
        if (idx < n) d = 10.f * log10f(fmaxf(mel[base + idx], 1e-10f));
        v[k] = d;
        mx = fmaxf(mx, d);
    }
    const float floor_db = block_reduce(mx, red, true) - top_db;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
        if (threadIdx.x + k * NORM_THREADS < n) {
            v[k] = fmaxf(v[k], floor_db);
            s += v[k];
        }
    }
    if (!standardize) {
#pragma unroll
        for (int k = 0; k < PER_THREAD; ++k) {
            const int idx = threadIdx.x + k * NORM_THREADS;
            if (idx < n) out[base + idx] = v[k];
        }
        return;
    }
    const float mean = block_reduce(s, red, false) / (float)n;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
        if (threadIdx.x + k * NORM_THREADS < n) {
            const float d = v[k] - mean;
            q += d * d;
        }
    }
    const float var = block_reduce(q, red, false) / (float)(n > 1 ? n - 1 : 1);
    const float denom = sqrtf(var) + eps;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
        const int idx = threadIdx.x + k * NORM_THREADS;
        if (idx < n) out[base + idx] = (v[k] - mean) / denom;
    }
}

}  // namespace

extern "C" int sad_melspec_factored(const void* xpad, const void* cs_t, const void* fb,
                                    void* y, void* mel, void* out, int n_windows,
                                    int n_blocks, int hop, int ncp, int n_frames, int n_sig,
                                    int n_mels, float top_db, float eps, int standardize,
                                    void* stream) {
    const int M = n_windows * n_blocks, N = 2 * ncp, K = hop;
    if (n_windows <= 0 || N % BN != 0 || K % BK != 0 || n_mels > MAX_MELS ||
        n_sig >= ncp || n_frames + 3 > n_blocks || n_mels * n_frames > NORM_THREADS * PER_THREAD ||
        (M + BM - 1) / BM > 65535 || n_windows > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);

    dim3 g1(N / BN, (M + BM - 1) / BM);
    block_dft_kernel<<<g1, GEMM_THREADS, 0, s>>>(
        static_cast<const float*>(xpad), static_cast<const __nv_bfloat16*>(cs_t),
        static_cast<float*>(y), M, N, K);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;

    dim3 g2((n_frames + TF - 1) / TF, n_windows);
    frames_mel_kernel<<<g2, MEL_THREADS, 0, s>>>(
        static_cast<const float*>(y), static_cast<const float*>(fb), static_cast<float*>(mel),
        n_blocks, ncp, n_frames, n_sig, n_mels);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;

    db_standardize_kernel<<<n_windows, NORM_THREADS, 0, s>>>(
        static_cast<const float*>(mel), static_cast<float*>(out), n_mels * n_frames, top_db,
        eps, standardize);
    return (int)cudaGetLastError();
}

extern "C" const char* sad_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
