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
//   out[b, r, :] = bf16( Σ_{i < taps} x[b, row0 + r + i, :] @ W_i ),
// with W_i = w + i·w_tap_stride (stride 0: every tap reads the same W), bf16
// operands and a float32 sum rounded once, so one kernel takes all three.
//
// What bounds it: not the card's rates. P1 moves 0.93 MB (1,792 rows in and
// out per image, 64 channels, bf16) and does 29.4 MFLOP, P3 37.7 MFLOP on
// 0.21 MB: 0.3 µs or less at 3.35 TB/s or 989 TFLOP/s. What a call costs is
// latency in series: the launch, one round trip from the SM to L2 for the
// operands, the products, the stores. The design pays each once a block:
//
// - Enough blocks: 64-row output tiles, one warpgroup's wgmma M (the host's
//   plan, ops/cuda_probes.tiles; the entry refuses another tile size). P1
//   runs on 56 blocks, P2 and P3 on 8.
// - Every load in flight before the first wait: one thread starts all of
//   the block's TMA loads on one mbarrier with their bytes expected, and
//   the block waits once; no barrier between taps. A is one box per tap (64
//   rows × 64 channels at row row0 + r0 + i, K-major, 128-byte swizzle): the
//   swizzle is a function of the shared address within 1024 bytes, so a
//   descriptor cannot start tap i at row i of one box. B is each distinct
//   W_i as TMA writes it, [K, N] with N contiguous, read by wgmma as an
//   MN-major operand through its transpose bit: no transposed copy. P3's
//   block holds 9 A boxes and W9, 144 KB.
// - wgmma m64n64k16, four k-steps a tap, every tap in one commit group,
//   waited once.
// - Epilogue: one rounding to bf16, the tile staged in shared memory and
//   stored as whole rows, 16 bytes a thread; 64-bit offsets.
//
// P3's nine taps split over a cluster of 3 CTAs (3 taps and a third of W9
// each, 24 blocks, float32 partials added in rank 0's shared memory) took
// 5% longer on an H100 than one CTA taking all nine (PERF.md), so a block
// takes all of its tile's taps.
//
// The kernel allocates nothing. sad_shifted_taps returns
// cudaErrorInvalidValue for shapes or tiles it does not take, −CUresult if
// encoding a tensor map failed, else the launch's cudaGetLastError()
// (sad_probes_error_string names either).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_sm90.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int TILE = 64;          // output rows per block: one warpgroup's wgmma M
constexpr int CH = 64;            // input channels: one tap's K, one 128-byte swizzle row
constexpr int COLS = 64;          // output columns: the wgmma N
constexpr int MAX_TAPS = 9;
constexpr int THREADS = 128;      // one warpgroup
constexpr int BOX_BYTES = TILE * CH * 2;  // a tap's A box, and one W_i: 8 KB
constexpr int OUT_LD = COLS + 8;  // bf16 pitch of the staged output tile (no bank conflicts)

// Shared memory of a block of TAPS taps: TAPS A boxes, TAPS W boxes (one
// when the taps share W), the staged output tile, the mbarrier; 1024 bytes
// of slack to align the boxes for the swizzle.
template <int TAPS>
struct Smem {
    static constexpr int A = 0;
    static constexpr int W = TAPS * BOX_BYTES;
    static constexpr int OUT = 2 * TAPS * BOX_BYTES;
    static constexpr int BAR = OUT + TILE * OUT_LD * 2;
    static constexpr int BYTES = 1024 + BAR + 8;
};

// x: [batch·rows_in, CH] bf16 through tmap_x (boxes of TILE rows); W_i
// through tmap_w (boxes of CH rows at row i·CH, or row 0 when the taps share
// W); out: [batch, TILE·gridDim.x, COLS] bf16. Grid (tiles, batch).
template <int TAPS>
__global__ void __launch_bounds__(THREADS, 1)
shifted_taps_kernel(const __grid_constant__ CUtensorMap tmap_x,
                    const __grid_constant__ CUtensorMap tmap_w, __nv_bfloat16* __restrict__ out,
                    int rows_in, int row0, int w_per_tap) {
    using S = Smem<TAPS>;
    extern __shared__ uint8_t smem_raw[];
    // 128-byte swizzle repeats every 1024 bytes of shared address
    const uint32_t raw = sad::smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    uint8_t* sm = smem_raw + (base - raw);
    const uint32_t bar = base + S::BAR;
    const int tid = threadIdx.x;
    const int r0 = blockIdx.x * TILE, b = blockIdx.y;

    if (tid == 0) {
        sad::mbar_init(bar, 1);  // the loading thread's arrive + the TMA bytes
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
        const int nw = w_per_tap ? TAPS : 1;
        sad::mbar_expect_tx(bar, (TAPS + nw) * BOX_BYTES);
        const int xrow = b * rows_in + row0 + r0;
#pragma unroll
        for (int i = 0; i < TAPS; ++i)
            sad::tma_load_2d(base + S::A + i * BOX_BYTES, &tmap_x, bar, 0, xrow + i);
        for (int i = 0; i < nw; ++i)
            sad::tma_load_2d(base + S::W + i * BOX_BYTES, &tmap_w, bar, 0, i * CH);
    }
    sad::mbar_wait(bar, 0);

    float acc[COLS / 2];
#pragma unroll
    for (int i = 0; i < COLS / 2; ++i) acc[i] = 0.f;
    sad::wgmma_fence();
#pragma unroll
    for (int i = 0; i < TAPS; ++i) {
        const uint32_t a = base + S::A + i * BOX_BYTES;
        const uint32_t w = base + S::W + (w_per_tap ? i : 0) * BOX_BYTES;
#pragma unroll
        for (int kk = 0; kk < CH / 16; ++kk)
            sad::wgmma_m64n64k16<1>(acc, sad::wgmma_desc_sw128(a + 32 * kk),
                                    sad::wgmma_desc_sw128_mn(w + 2048 * kk));
    }
    sad::wgmma_commit();
    sad::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < COLS / 2; ++i) sad::fence_operand(acc[i]);

    // thread t (warp w, lane l) holds acc[4·j + 2·h + e] at row 16·w + l / 4
    // + 8·h, column 8·j + 2·(l % 4) + e
    const int warp = tid >> 5, lane = tid & 31;
    __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(sm + S::OUT);
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = 16 * warp + (lane >> 2) + 8 * h, c = 8 * j + 2 * (lane & 3);
            *reinterpret_cast<uint32_t*>(stage + r * OUT_LD + c) =
                sad::pack_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
    __syncthreads();
    __nv_bfloat16* ob = out + ((size_t)b * gridDim.x * TILE + r0) * COLS;
#pragma unroll
    for (int k = 0; k < TILE * COLS / 8 / THREADS; ++k) {
        const int idx = k * THREADS + tid, r = idx >> 3, c = (idx & 7) * 8;
        *reinterpret_cast<uint4*>(ob + (size_t)r * COLS + c) =
            *reinterpret_cast<const uint4*>(stage + r * OUT_LD + c);
    }
}

template <int TAPS>
int launch(const CUtensorMap& tmap_x, const CUtensorMap& tmap_w, void* out, int rows_in,
           int row0, int w_per_tap, int tiles, int batch, cudaStream_t s) {
    cudaError_t e = cudaFuncSetAttribute(shifted_taps_kernel<TAPS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Smem<TAPS>::BYTES);
    if (e != cudaSuccess) return (int)e;
    shifted_taps_kernel<TAPS><<<dim3(tiles, batch), THREADS, Smem<TAPS>::BYTES, s>>>(
        tmap_x, tmap_w, static_cast<__nv_bfloat16*>(out), rows_in, row0, w_per_tap);
    return (int)cudaGetLastError();
}

typedef int (*Launch)(const CUtensorMap&, const CUtensorMap&, void*, int, int, int, int, int,
                      cudaStream_t);
// one kernel for each count of taps: the tap loop unrolls into one commit group
constexpr Launch LAUNCH[MAX_TAPS] = {launch<1>, launch<2>, launch<3>, launch<4>, launch<5>,
                                     launch<6>, launch<7>, launch<8>, launch<9>};

}  // namespace

// out[b, r, :] = Σ_{i < taps} x[b, row0 + r + i, :] @ W_i for r < tile_rows·tiles,
// W_i the [channels, cols] block at w + i·w_tap_stride (stride 0 or
// channels·cols); x [batch, rows_in, channels], out [batch, tile_rows·tiles,
// cols], all 16-byte aligned. tile_rows is the host's tile size
// (ops/cuda_probes.TILE_ROWS), for which it planned the tiles; it must be
// TILE.
extern "C" int sad_shifted_taps(const void* x, const void* w, void* out, int batch, int rows_in,
                                int channels, int cols, int tile_rows, int tiles, int taps,
                                int row0, int w_tap_stride, void* stream) {
    if (tile_rows != TILE || batch <= 0 || batch > 65535 || tiles <= 0 ||
        tiles > 0x7fffffff / TILE || channels != CH || cols != COLS || taps < 1 ||
        taps > MAX_TAPS || row0 < 0 || (w_tap_stride != 0 && w_tap_stride != CH * COLS) ||
        rows_in <= 0 || (long long)row0 + (long long)TILE * tiles + taps - 1 > rows_in ||
        (long long)batch * rows_in > 0x7fffffffLL ||
        (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
         reinterpret_cast<uintptr_t>(out)) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    // x as [batch·rows_in][CH], a box of TILE rows; w as [W_i rows][COLS], a
    // box of one W_i
    alignas(64) CUtensorMap tmap_x, tmap_w;
    const cuuint64_t x_dims[2] = {CH, (cuuint64_t)batch * rows_in};
    const cuuint64_t w_dims[2] = {COLS, (cuuint64_t)(w_tap_stride ? taps * CH : CH)};
    const cuuint64_t x_strides[1] = {CH * 2};
    const cuuint64_t w_strides[1] = {COLS * 2};
    const cuuint32_t x_box[2] = {CH, TILE};
    const cuuint32_t w_box[2] = {COLS, CH};
    const cuuint32_t elem[2] = {1, 1};
    int rc = sad::encode_bf16_sw128(&tmap_x, 2, x, x_dims, x_strides, x_box, elem);
    if (rc != 0) return rc;
    rc = sad::encode_bf16_sw128(&tmap_w, 2, w, w_dims, w_strides, w_box, elem);
    if (rc != 0) return rc;
    return LAUNCH[taps - 1](tmap_x, tmap_w, out, rows_in, row0, w_tap_stride != 0, tiles, batch,
                            static_cast<cudaStream_t>(stream));
}

extern "C" const char* sad_probes_error_string(int code) { return sad::error_string(code); }
