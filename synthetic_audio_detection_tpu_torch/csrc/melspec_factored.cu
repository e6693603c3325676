// Factored-DFT log-mel front end for Hopper (sm_90a).
//
// Replaces the TPU kernel synthetic_audio_detection_tpu/ops/pallas_melspec.py
// :_factored_kernel (entries fused_log_mel_factored / serving_log_mel) with
// standardize and lowp_tail as flags. One call of sad_melspec_factored runs
// three launches on the caller's stream:
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
//      mel filterbank rows are read through the read-only cache. With
//      lowp_tail the power and the filterbank are rounded to bf16 before the
//      mel product (float32 accumulation), as the TPU kernel's bf16 mel matmul.
//   3. db_standardize_kernel  one 1024-thread block per window holds the
//      whole [n_mels, n_frames] plane in registers and runs the tail shared
//      with the strip kernel (melspec_tail.cuh): 10·log10(max(mel,1e-10)),
//      the max − top_db clamp, then mean and unbiased variance in two passes,
//      z = (db − mean) / (sqrt(var) + eps); float32 out, or bf16 with
//      lowp_tail. Reductions are fixed-order trees with no atomics, so
//      repeated runs give identical bits.
//
// The kernel allocates nothing: the caller passes the Y scratch and the mel
// and output tensors. Returns the first CUDA error (cudaGetLastError after
// each launch) or cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "melspec_tail.cuh"
#include "mma_bf16.cuh"

namespace {

// ---- stage 1: block DFT GEMM ------------------------------------------------

constexpr int BM = 128;   // rows (hop blocks) per block
constexpr int BN = 128;   // DFT columns per block
constexpr int BK = 32;    // samples per k step
constexpr int SPAD = 8;   // bf16 row padding in shared memory (no bank conflicts)
constexpr int GEMM_THREADS = 256;

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
            p.x = sad::pack_bf16x2(v.x, v.y);
            p.y = sad::pack_bf16x2(v.z, v.w);
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
        for (int kk = 0; kk < BK; kk += 16)
            sad::warp_mma_64x32(As, Bs, wm * 64, wn * 32, kk, lane, acc);
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

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// y: [windows, nb, 2·ncp] (re in [0, ncp), im in [ncp, 2·ncp)); fb: [n_sig,
// n_mels]; mel: [windows, n_mels, n_frames]. lowp rounds both operands of
// the mel product to bf16.
__global__ void __launch_bounds__(MEL_THREADS)
frames_mel_kernel(const float* __restrict__ y, const float* __restrict__ fb,
                  float* __restrict__ mel, int nb, int ncp, int n_frames, int n_sig,
                  int n_mels, int lowp) {
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
            pw[tl][c] = lowp ? round_bf16(p) : p;
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
                if (lowp) fv[j] = round_bf16(fv[j]);
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

// mel: [windows, n] float32, out: [windows, n] OutT, n = n_mels · n_frames
// (the same layout).
template <typename OutT>
__global__ void __launch_bounds__(sad::TAIL_THREADS)
db_standardize_kernel(const float* __restrict__ mel, OutT* __restrict__ out, int n,
                      float top_db, float eps, int standardize) {
    __shared__ float red[33];
    const size_t base = (size_t)blockIdx.x * n;
    float v[sad::TAIL_PER_THREAD];
#pragma unroll
    for (int k = 0; k < sad::TAIL_PER_THREAD; ++k) {
        const int idx = threadIdx.x + k * sad::TAIL_THREADS;
        v[k] = idx < n ? mel[base + idx] : 0.f;
    }
    sad::db_standardize_store(v, out + base, n, top_db, eps, standardize, red);
}

}  // namespace

extern "C" int sad_melspec_factored(const void* xpad, const void* cs_t, const void* fb,
                                    void* y, void* mel, void* out, int n_windows,
                                    int n_blocks, int hop, int ncp, int n_frames, int n_sig,
                                    int n_mels, float top_db, float eps, int standardize,
                                    int lowp_tail, void* stream) {
    const int M = n_windows * n_blocks, N = 2 * ncp, K = hop;
    if (n_windows <= 0 || N % BN != 0 || K % BK != 0 || n_mels > MAX_MELS ||
        n_sig >= ncp || n_frames + 3 > n_blocks ||
        n_mels * n_frames > sad::TAIL_THREADS * sad::TAIL_PER_THREAD ||
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
        n_blocks, ncp, n_frames, n_sig, n_mels, lowp_tail);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;

    const float* mel_f = static_cast<const float*>(mel);
    if (lowp_tail)
        db_standardize_kernel<<<n_windows, sad::TAIL_THREADS, 0, s>>>(
            mel_f, static_cast<__nv_bfloat16*>(out), n_mels * n_frames, top_db, eps, standardize);
    else
        db_standardize_kernel<<<n_windows, sad::TAIL_THREADS, 0, s>>>(
            mel_f, static_cast<float*>(out), n_mels * n_frames, top_db, eps, standardize);
    return (int)cudaGetLastError();
}

extern "C" const char* sad_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
