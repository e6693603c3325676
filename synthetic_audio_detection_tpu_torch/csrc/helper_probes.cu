// Shifted-row multi-tap product for Hopper (sm_90a): the three helper
// probes.
//
// Replaces the TPU kernels of benchmarks/pallas_helper_bisect.py:main (:39),
// which probed the TPU compile helper on bf16 arrays:
//   P1  k1 (:44, pallas_call :51)  a dot behind a program-id-dependent row
//       slice: out[b, 256·t + r] = x[b, 256·t + 3 + r] @ W, grid (2, 7);
//   P2  k2 (:58, :67)  a lane concatenation before a K = 2C dot:
//       out[b, r] = [x[b, r] | x[b, r + 1]] @ [W; W];
//   P3  k3 (:74, :83)  nine static tap slices: out[b, r] = Σ_i x[b, i + r] @ W9[i].
// All three are one function,
//   out[b, 256·t + r, :] = bf16( Σ_{i < taps} x[b, row0 + 256·t + i + r, :] @ W_i ),
// with W_i = w + i·w_tap_stride (stride 0: every tap reads the same W), bf16
// operands and a float32 sum rounded once, so one kernel takes all three.
//
// One block per (256-row tile t, batch b), 8 warps: 4 along the rows (64
// each) × 2 along the 64 output columns (32 each). The block copies the
// 256 + taps − 1 input rows its taps read to shared memory once; tap i reads
// them from row i on. Each tap's W_i goes to shared memory transposed
// (column-major, so a warp's B fragments are k-contiguous), then four
// mma.sync m16n8k16 steps per warp tile (mma_bf16.cuh) add x-rows · W_i into
// float32 accumulators, which the epilogue rounds to bf16 once.
//
// What bounds it: nothing on the card. P1 moves 0.93 MB (1,792 rows in and
// out per image, 64 channels, bf16) and does 29.4 MFLOP, P3 37.7 MFLOP on
// 0.21 MB: a bound of 0.3 µs or less, far under the few microseconds a
// launch costs. So launch latency bounds it, and this simple kernel (no
// cp.async ring, no wgmma, one wave of 14 or 2 blocks) is not tuned.
//
// Returns cudaErrorInvalidValue for shapes it does not take, else the
// launch's cudaGetLastError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int TILE = 256;    // output rows per block
constexpr int CH = 64;       // input channels (the contraction of one tap)
constexpr int COLS = 64;     // output columns
constexpr int MAX_TAPS = 9;
constexpr int LD = CH + 8;   // bf16 row pitch in shared memory (no bank conflicts)
constexpr int THREADS = 256;

// x: [batch, rows_in, CH] bf16; w: taps × [CH, COLS] bf16 at w + i·w_tap_stride;
// out: [batch, rows_out, COLS] bf16, rows_out = 256·gridDim.x.
__global__ void __launch_bounds__(THREADS)
shifted_taps_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ out, int rows_in, int taps, int row0,
                    int w_tap_stride) {
    __shared__ __align__(16) __nv_bfloat16 As[TILE + MAX_TAPS - 1][LD];
    __shared__ __align__(16) __nv_bfloat16 Bs[COLS][LD];

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp >> 1, wn = warp & 1;
    const int t = blockIdx.x, b = blockIdx.y;
    const int rows_out = TILE * gridDim.x;

    // the tile's input rows, 8 channels (16 bytes) a thread and step
    const __nv_bfloat16* xb = x + ((size_t)b * rows_in + row0 + (size_t)TILE * t) * CH;
    const int a_rows = TILE + taps - 1;
    for (int idx = tid; idx < a_rows * (CH / 8); idx += THREADS) {
        const int r = idx / (CH / 8), c = (idx % (CH / 8)) * 8;
        *reinterpret_cast<uint4*>(&As[r][c]) =
            *reinterpret_cast<const uint4*>(xb + (size_t)r * CH + c);
    }

    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    for (int i = 0; i < taps; ++i) {
        const __nv_bfloat16* wi = w + (size_t)i * w_tap_stride;
        for (int idx = tid; idx < CH * COLS; idx += THREADS) {
            const int c = idx / COLS, n = idx % COLS;  // coalesced read of W_i[c][n]
            Bs[n][c] = wi[idx];
        }
        __syncthreads();  // the A rows (first tap) and B_i are in place
#pragma unroll
        for (int kk = 0; kk < CH; kk += 16)
            sad::warp_mma_64x32(As, Bs, wm * 64 + i, wn * 32, kk, lane, acc);
        __syncthreads();  // B_i read by every warp before the next tap overwrites it
    }

    // lane (g, q) holds rows g and g + 8, columns 2q and 2q + 1 of each m16n8 tile
    const int g = lane >> 2, tq = lane & 3;
    __nv_bfloat16* ob = out + ((size_t)b * rows_out + (size_t)TILE * t) * COLS;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const int c = wn * 32 + ni * 8 + tq * 2;
            const float* a = acc[mi][ni];
            *reinterpret_cast<uint32_t*>(ob + (size_t)r * COLS + c) = sad::pack_bf16x2(a[0], a[1]);
            *reinterpret_cast<uint32_t*>(ob + (size_t)(r + 8) * COLS + c) =
                sad::pack_bf16x2(a[2], a[3]);
        }
    }
}

}  // namespace

// out[b, 256·t + r, :] = Σ_{i < taps} x[b, row0 + 256·t + i + r, :] @ w[i·w_tap_stride ...]
// for t < tiles, r < 256; x [batch, rows_in, channels], out [batch, 256·tiles, cols].
extern "C" int sad_shifted_taps(const void* x, const void* w, void* out, int batch, int rows_in,
                                int channels, int cols, int tiles, int taps, int row0,
                                int w_tap_stride, void* stream) {
    if (batch <= 0 || batch > 65535 || tiles <= 0 || channels != CH || cols != COLS ||
        taps < 1 || taps > MAX_TAPS || row0 < 0 || w_tap_stride < 0 ||
        (long long)row0 + (long long)TILE * tiles + taps - 1 > rows_in ||
        (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    shifted_taps_kernel<<<dim3(tiles, batch), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), rows_in, taps, row0, w_tap_stride);
    return (int)cudaGetLastError();
}

extern "C" const char* sad_probes_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
