// Strip-DFT log-mel front end for Hopper (sm_90a).
//
// Replaces the TPU kernel synthetic_audio_detection_tpu/ops/pallas_melspec.py
// :_kernel (entry fused_log_mel): the standardized log-mel of centre-padded
// windows with one DFT per frame, the periodic Hann applied in time. Frame t
// of a window is xw[t, k] = bf16(x[t·hop + k] · hann[k]) (product in float32,
// rounded once), re|im = xw · [cos | sin][n_fft, n_bins] with bf16 operands
// and float32 accumulation, power = re² + im², mel = power · fb in float32,
// then dB, the top_db clamp and the standardization over the window's real
// [n_mels, n_frames] cells. One call of sad_melspec_strip runs two launches
// on the caller's stream:
//
//   1. strip_dft_power_kernel  an implicit GEMM on the tensor cores
//      (mma.sync m16n8k16): M = a window's frames in tiles of 128 (the grid's
//      z axis runs over windows), N = 2·n_bins DFT columns, K = n_fft. A
//      K-slice of a frame row is a run of contiguous samples, so the A tile
//      loads straight from the padded float32 waveform, is multiplied by the
//      Hann window and rounded to bf16 as it is stored to shared memory: no
//      frame matrix is ever written, which is what the Pallas kernel's four
//      hop-wide strips keep out of memory. The cos|sin matrix is interleaved
//      (row 2f the cos of bin f, row 2f + 1 its sin), so the two accumulators
//      a thread holds for adjacent columns are the real and imaginary parts
//      of one bin, and the epilogue writes the power (a separate multiply and
//      add, as the plain version rounds) to a [window, bin, frame] scratch.
//   2. strip_mel_tail_kernel  one 1024-thread block per window. Each thread
//      forms the mel values of its 32 cells as a sparse product: the
//      filterbank is triangular, so each mel sums the power over one
//      contiguous span of bins (at most 2 nonzero weights per bin), read from
//      the scratch coalesced along frames. Then the tail shared with the
//      factored kernel (melspec_tail.cuh): dB, clamp, standardize, with
//      fixed-order reductions, so repeated runs give identical bits.
//
// What bounds it, at [128, 128000] (251 frames, n_bins 768, 1,515 nonzero
// filterbank weights): the DFT is 2·128·251·2048·1536 = 202.1 GFLOP in bf16,
// 0.204 ms at 989 TFLOP/s; the mel product 2·128·251·1515 = 0.097 GFLOP in
// float32, 0.0015 ms at 67 TFLOP/s; 65.5 MB of waveforms in, 16.4 MB of
// z-scores out and 6.3 MB of cos|sin, 0.026 ms at 3.35 TB/s. So the tensor
// cores bound it, at about 0.204 ms: 3.5× the factored kernel's bound,
// because the strip form transforms each hop block four times. This first
// version spends more than that on a register-staged mma.sync mainloop (no
// cp.async ring, no wgmma/TMA), 2.0% of rows padding the last frame tile, and
// the power scratch (98.7 MB written and read back at that shape); the mel
// product inside the GEMM epilogue and wgmma/TMA are later work.
//
// The kernel allocates nothing: the caller passes the scratch and the
// output. Returns the first CUDA error (cudaGetLastError after each launch),
// cudaErrorInvalidValue for shapes it does not take, or cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "melspec_tail.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int BM = 128;  // frames per block
constexpr int BN = 128;  // DFT columns (64 bins, cos and sin) per block
constexpr int BK = 32;   // samples per k step
constexpr int SPAD = 8;  // bf16 row padding in shared memory (no bank conflicts)
constexpr int GEMM_THREADS = 256;  // 8 warps: 2 along M (64 frames) × 4 along N (32 columns)

// x: [windows, padded_len] float32, the centre-padded waveforms; hann:
// [n_fft] float32; cs: [2·n_bins, n_fft] bf16, k contiguous, rows
// interleaved cos/sin; powt: [windows, n_bins, n_frames] float32.
__global__ void __launch_bounds__(GEMM_THREADS)
strip_dft_power_kernel(const float* __restrict__ x, const float* __restrict__ hann,
                       const __nv_bfloat16* __restrict__ cs, float* __restrict__ powt,
                       int padded_len, int n_fft, int hop, int n_frames, int n_bins) {
    __shared__ __align__(16) __nv_bfloat16 As[BM][BK + SPAD];
    __shared__ __align__(16) __nv_bfloat16 Bs[BN][BK + SPAD];

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp >> 2, wn = warp & 3;
    const int t0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const float* xb = x + (size_t)blockIdx.z * padded_len;

    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    for (int k0 = 0; k0 < n_fft; k0 += BK) {
        // A tile: 128 frames × 32 samples as 1024 float4, times the window,
        // rounded to bf16 on the way in; frames past the last are zero
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int idx = tid + i * GEMM_THREADS;
            const int r = idx >> 3, c = (idx & 7) * 4;
            const int t = t0 + r;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (t < n_frames) {
                const float4 s =
                    *reinterpret_cast<const float4*>(xb + (size_t)t * hop + k0 + c);
                const float4 h = *reinterpret_cast<const float4*>(hann + k0 + c);
                v = make_float4(s.x * h.x, s.y * h.y, s.z * h.z, s.w * h.w);
            }
            uint2 p;
            p.x = sad::pack_bf16x2(v.x, v.y);
            p.y = sad::pack_bf16x2(v.z, v.w);
            *reinterpret_cast<uint2*>(&As[r][c]) = p;
        }
        // B tile: 128 columns × 32 samples of cos|sin as 512 uint4
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int idx = tid + i * GEMM_THREADS;
            const int r = idx >> 2, c = (idx & 3) * 8;
            *reinterpret_cast<uint4*>(&Bs[r][c]) =
                *reinterpret_cast<const uint4*>(cs + (size_t)(n0 + r) * n_fft + k0 + c);
        }
        __syncthreads();

#pragma unroll
        for (int kk = 0; kk < BK; kk += 16)
            sad::warp_mma_64x32(As, Bs, wm * 64, wn * 32, kk, lane, acc);
        __syncthreads();
    }

    // columns 2q, 2q + 1 of each m16n8 tile are the re and im of one bin
    const int g = lane >> 2, tq = lane & 3;
    float* pb = powt + (size_t)blockIdx.z * n_bins * n_frames;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
        const int t = t0 + wm * 64 + mi * 16 + g;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const float* a = acc[mi][ni];
            float* col = pb + (size_t)((n0 + wn * 32 + ni * 8 + tq * 2) >> 1) * n_frames;
            if (t < n_frames) col[t] = __fadd_rn(__fmul_rn(a[0], a[0]), __fmul_rn(a[1], a[1]));
            if (t + 8 < n_frames)
                col[t + 8] = __fadd_rn(__fmul_rn(a[2], a[2]), __fmul_rn(a[3], a[3]));
        }
    }
}

// powt: [windows, n_bins, n_frames]; mel m sums bins mel_lo[m] + j with
// weights mel_w[mel_off[m] + j], j < mel_off[m + 1] − mel_off[m]; out:
// [windows, n_mels, n_frames].
__global__ void __launch_bounds__(sad::TAIL_THREADS)
strip_mel_tail_kernel(const float* __restrict__ powt, const int* __restrict__ mel_lo,
                      const int* __restrict__ mel_off, const float* __restrict__ mel_w,
                      float* __restrict__ out, int n_bins, int n_frames, int n_mels,
                      float top_db, float eps) {
    __shared__ float red[33];
    const int n = n_mels * n_frames;
    const float* pb = powt + (size_t)blockIdx.x * n_bins * n_frames;
    float v[sad::TAIL_PER_THREAD];
#pragma unroll
    for (int k = 0; k < sad::TAIL_PER_THREAD; ++k) {
        const int idx = threadIdx.x + k * sad::TAIL_THREADS;
        float s = 0.f;
        if (idx < n) {
            const int m = idx / n_frames, t = idx - m * n_frames;
            const float* p = pb + (size_t)__ldg(mel_lo + m) * n_frames + t;
            const int end = __ldg(mel_off + m + 1);
            for (int j = __ldg(mel_off + m); j < end; ++j, p += n_frames)
                s = fmaf(*p, __ldg(mel_w + j), s);
        }
        v[k] = s;
    }
    sad::db_standardize_store(v, out + (size_t)blockIdx.x * n, n, top_db, eps, 1, red);
}

}  // namespace

extern "C" int sad_melspec_strip(const void* xpad, const void* hann, const void* cs,
                                 const void* mel_lo, const void* mel_off, const void* mel_w,
                                 void* powt, void* out, int n_windows, int padded_len, int n_fft,
                                 int hop, int n_frames, int n_bins, int n_mels, float top_db,
                                 float eps, void* stream) {
    if (n_windows <= 0 || n_windows > 65535 || n_frames <= 0 || (2 * n_bins) % BN != 0 ||
        n_fft % BK != 0 || hop % 4 != 0 || padded_len % 4 != 0 ||
        (size_t)(n_frames - 1) * hop + n_fft > (size_t)padded_len ||
        n_mels * n_frames > sad::TAIL_THREADS * sad::TAIL_PER_THREAD)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);

    dim3 g1(2 * n_bins / BN, (n_frames + BM - 1) / BM, n_windows);
    strip_dft_power_kernel<<<g1, GEMM_THREADS, 0, s>>>(
        static_cast<const float*>(xpad), static_cast<const float*>(hann),
        static_cast<const __nv_bfloat16*>(cs), static_cast<float*>(powt), padded_len, n_fft,
        hop, n_frames, n_bins);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;

    strip_mel_tail_kernel<<<n_windows, sad::TAIL_THREADS, 0, s>>>(
        static_cast<const float*>(powt), static_cast<const int*>(mel_lo),
        static_cast<const int*>(mel_off), static_cast<const float*>(mel_w),
        static_cast<float*>(out), n_bins, n_frames, n_mels, top_db, eps);
    return (int)cudaGetLastError();
}

extern "C" const char* sad_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
