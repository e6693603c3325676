// 3x3 SAME convolution + per-channel affine + optional ReLU for Hopper (sm_90a),
// on wgmma fed by a TMA ring. It takes the whole contract of the wrappers in
// ops/cuda_conv.py: C and F multiples of 8, any H and W that divide by the
// stride; ragged channel chunks, channel tiles and pixel rectangles are
// zero-filled by the TMA or masked in the epilogue.
//
// Replaces four TPU kernels of the reference package, which are four layouts
// of one function:
//   synthetic_audio_detection_tpu/ops/pallas_conv.py:_kernel             (K3)
//   synthetic_audio_detection_tpu/ops/pallas_conv.py:_tiled_kernel       (K4)
//   synthetic_audio_detection_tpu/ops/pallas_conv_flat.py:_flat_kernel  (K5)
//   synthetic_audio_detection_tpu/ops/pallas_conv_flat.py:_flat_static_kernel (K6)
//
// out[b, i, j, f] = act(scale[f] · Σ_{dy,dx,c} x[b, s·i+dy−1, s·j+dx−1, c] ·
//                   w[f, dy, dx, c] + bias[f]), taps outside the image are 0.
//
// What bounds it on an H100: the deeper ResNet-18 shapes are bound by the
// tensor cores (up to 6e2 FLOP per byte of input and output); layer 1
// ([B, 128, 128, 64] → 64) sits at the card's balance point, and its 3x3
// halo re-reads and weight tiles make it lean on L2 as well. The design:
//
// - Implicit GEMM, M = output pixels, N = F, K = 9·C, walked as (tap,
//   64-channel chunk): one K-step is one tap × 64 channels, 128 bytes, one
//   128-byte swizzle row. Tap and channel offset are loop counters.
// - A (pixels) by a 4-D TMA box [64 ch, tw, th, 1] of the NHWC input at the
//   signed start (c0, s·j0+dx−1, s·i0+dy−1, b): the hardware fills taps
//   outside the image, and channels at or past C, with zeros
//   (CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE), so no padded copy exists. Stride 2
//   is the tensor map's element stride of 2 on W and H. The BM-pixel M tile
//   is a th × tw rectangle of one image (tw a power of two, th·tw = BM);
//   pixels past the image's edge are computed and not stored.
// - B (weights [F, 9, C], K-major) by a 3-D TMA box [64, 1, BN] at (c0, tap,
//   n0): channels at or past C and filters at or past F are zero-filled, so
//   a ragged channel chunk adds nothing, and filters past F are not stored.
//   A and B land, 128-byte swizzled, in a ring of STAGES stages; each stage
//   completes on an mbarrier ("full") and is handed back on another
//   ("empty").
// - Warp specialisation: warpgroup 0 is the producer (one thread starts the
//   TMA loads; the group gives registers back with setmaxnreg), warpgroups 1
//   and 2 are consumers (setmaxnreg up to 232), each issuing wgmma
//   m64nBNk16 on its own 64·MSUB rows of the tile, with one K-step's group
//   kept in flight: a stage goes back to the producer once wgmma.wait_group
//   shows that the products reading it have retired.
// - Persistent: one block per SM walks output tiles, so the producer loads
//   the next tile while the consumers run the epilogue.
// - Epilogue straight from the accumulators: a float32 multiply by scale
//   and a separate add of bias (no FMA, the plain version's rounding), the
//   ReLU, one rounding to bf16 or float32, 4- or 8-byte stores; 64-bit
//   offsets.
//
// Tiles (chosen by cuda_conv.tile_plan, checked here): BN 256 where F % 256
// == 0, else 128 where F % 128 == 0, else 64, the last N tile masked where
// BN does not divide F; BM 128 at BN 256, else 256. A consumer holds 64·MSUB
// × BN float32 accumulators (at most 128 a thread).
//
// The kernel allocates nothing. sad_conv3x3_wgmma returns cudaGetLastError()
// after the launch, cudaErrorInvalidValue for shapes or tiles it does not
// take, or −CUresult if encoding a tensor map failed (sad_conv_error_string
// names either).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_sm90.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int STAGES = 4;
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int ROW_BYTES = 128;  // one K-step of one pixel or one output channel

struct Params {
    const float* scale;
    const float* bias;
    void* out;
    int C, F, Ho, Wo, stride, relu;
    int th, tw_log2;                      // the M tile: th × 2^tw_log2 pixels
    int tiles_h, tiles_w, tiles_n, tiles;  // tile grid: B × tiles_h × tiles_w × tiles_n
};

struct Tile {
    int b, ti, tj, n0;
};

__device__ __forceinline__ Tile decode(const Params& p, int t, int bn) {
    // n fastest, so the blocks in flight share their A rows through L2
    Tile r;
    r.n0 = (t % p.tiles_n) * bn;
    t /= p.tiles_n;
    r.tj = t % p.tiles_w;
    t /= p.tiles_w;
    r.ti = t % p.tiles_h;
    r.b = t / p.tiles_h;
    return r;
}

template <int MSUB, int BN>
struct Shape {
    static constexpr int BM = 128 * MSUB;          // two consumers × 64·MSUB rows
    static constexpr int A_BYTES = BM * ROW_BYTES;
    static constexpr int B_BYTES = BN * ROW_BYTES;
    static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
    // the ring, 1024 bytes of slack to align it for the swizzle, the barriers
    static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
};

template <int MSUB, int BN, bool OUT_F32>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                     const __grid_constant__ CUtensorMap tmap_w, const Params p) {
    using S = Shape<MSUB, BN>;
    extern __shared__ uint8_t smem_raw[];
    // 128-byte swizzle repeats every 1024 bytes of shared address
    const uint32_t raw = sad::smem_u32(smem_raw);
    const uint32_t ring = (raw + 1023u) & ~1023u;
    const uint32_t full = ring + STAGES * S::STAGE_BYTES;  // STAGES barriers, then STAGES "empty"
    const uint32_t empty = full + STAGES * 8;
    auto a_tile = [&](int s) { return ring + s * S::STAGE_BYTES; };
    auto b_tile = [&](int s) { return ring + s * S::STAGE_BYTES + S::A_BYTES; };

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            sad::mbar_init(full + 8 * s, 1);   // the producer's arrive + the TMA bytes
            sad::mbar_init(empty + 8 * s, 2);  // one arrive per consumer warpgroup
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int ksteps = 9 * ((p.C + 63) >> 6);  // a ragged last chunk is zero-filled
    const int wg = threadIdx.x >> 7;

    if (wg == 0) {
        // ---- producer: one thread keeps the ring full ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == 0) {
            const int tw = 1 << p.tw_log2, s = p.stride;
            int stage = 0, phase = 0;
            for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
                const Tile tile = decode(p, t, BN);
                const int x0 = s * tile.tj * tw - 1, y0 = s * tile.ti * p.th - 1;
                for (int dy = 0; dy < 3; ++dy) {
                    for (int dx = 0; dx < 3; ++dx) {
                        for (int c0 = 0; c0 < p.C; c0 += 64) {
                            sad::mbar_wait(empty + 8 * stage, phase ^ 1);
                            sad::mbar_expect_tx(full + 8 * stage, S::STAGE_BYTES);
                            sad::tma_load_4d(a_tile(stage), &tmap_x, full + 8 * stage, c0,
                                             x0 + dx, y0 + dy, tile.b);
                            sad::tma_load_3d(b_tile(stage), &tmap_w, full + 8 * stage, c0,
                                             3 * dy + dx, tile.n0);
                            if (++stage == STAGES) {
                                stage = 0;
                                phase ^= 1;
                            }
                        }
                    }
                }
            }
        }
    } else {
        // ---- consumers: wgmma on the ring, then the epilogue ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int cw = wg - 1;  // rows [64·MSUB·cw, 64·MSUB·(cw + 1)) of the tile
        const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
        const bool signaller = (threadIdx.x & 127) == 0;
        int stage = 0, phase = 0;
        float acc[MSUB][BN / 2];
        for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
#pragma unroll
            for (int ms = 0; ms < MSUB; ++ms)
#pragma unroll
                for (int i = 0; i < BN / 2; ++i) acc[ms][i] = 0.f;
            int prev = -1;
            for (int k = 0; k < ksteps; ++k) {
                sad::mbar_wait(full + 8 * stage, phase);
                const uint32_t a = a_tile(stage) + cw * MSUB * 64 * ROW_BYTES;
                const uint32_t b = b_tile(stage);
                sad::wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                    for (int ms = 0; ms < MSUB; ++ms) {
                        const uint32_t a_k = a + ms * 64 * ROW_BYTES + 32 * kk;
                        sad::wgmma_m64k16<BN>(acc[ms], sad::wgmma_desc_sw128(a_k),
                                              sad::wgmma_desc_sw128(b + 32 * kk));
                    }
                sad::wgmma_commit();
                // the previous step's products have retired: hand its stage back
                sad::wgmma_wait<1>();
                if (prev >= 0 && signaller) sad::mbar_arrive(empty + 8 * prev);
                prev = stage;
                if (++stage == STAGES) {
                    stage = 0;
                    phase ^= 1;
                }
            }
            sad::wgmma_wait<0>();
            if (signaller) sad::mbar_arrive(empty + 8 * prev);
#pragma unroll
            for (int ms = 0; ms < MSUB; ++ms)
#pragma unroll
                for (int i = 0; i < BN / 2; ++i) sad::fence_operand(acc[ms][i]);

            // epilogue: row m of the tile is pixel (ti·th + m / tw, tj·tw + m % tw)
            const Tile tile = decode(p, t, BN);
            const int tw = 1 << p.tw_log2;
            const int f0 = tile.n0 + 2 * (lane & 3);
#pragma unroll
            for (int ms = 0; ms < MSUB; ++ms) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int m = (cw * MSUB + ms) * 64 + warp * 16 + (lane >> 2) + 8 * h;
                    const int i = tile.ti * p.th + (m >> p.tw_log2);
                    const int j = tile.tj * tw + (m & (tw - 1));
                    if (i >= p.Ho || j >= p.Wo) continue;
                    const size_t o = (((size_t)tile.b * p.Ho + i) * p.Wo + j) * p.F + f0;
#pragma unroll
                    for (int jn = 0; jn < BN / 8; ++jn) {
                        // a ragged last N tile stores only channels below F
                        // (F is even); the loads stay in bounds and
                        // unconditional, so the compiler can issue them early
                        const int f = f0 + 8 * jn;
                        const int fl = f < p.F ? f : 0;
                        const float2 sc = __ldg(reinterpret_cast<const float2*>(p.scale + fl));
                        const float2 bi = __ldg(reinterpret_cast<const float2*>(p.bias + fl));
                        float v0 = __fadd_rn(__fmul_rn(acc[ms][4 * jn + 2 * h], sc.x), bi.x);
                        float v1 = __fadd_rn(__fmul_rn(acc[ms][4 * jn + 2 * h + 1], sc.y), bi.y);
                        if (p.relu) {
                            v0 = fmaxf(v0, 0.f);
                            v1 = fmaxf(v1, 0.f);
                        }
                        if (f >= p.F)
                            continue;
                        if (OUT_F32)
                            *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o + 8 * jn) =
                                make_float2(v0, v1);
                        else
                            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) +
                                                               o + 8 * jn) =
                                __floats2bfloat162_rn(v0, v1);
                    }
                }
            }
        }
    }
}

template <int MSUB, int BN, bool OUT_F32>
int launch(const CUtensorMap& tx, const CUtensorMap& tw, const Params& p, int sms,
           cudaStream_t stream) {
    auto kernel = conv3x3_wgmma_kernel<MSUB, BN, OUT_F32>;
    const int smem = Shape<MSUB, BN>::SMEM;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const int grid = p.tiles < sms ? p.tiles : sms;
    kernel<<<grid, THREADS, smem, stream>>>(tx, tw, p);
    return (int)cudaGetLastError();
}

template <int MSUB, int BN>
int launch_dtype(const CUtensorMap& tx, const CUtensorMap& tw, const Params& p, int sms,
                 bool out_f32, cudaStream_t stream) {
    return out_f32 ? launch<MSUB, BN, true>(tx, tw, p, sms, stream)
                   : launch<MSUB, BN, false>(tx, tw, p, sms, stream);
}

}  // namespace

// x: [B, H, W, C] bf16; w: [F, 3, 3, C] bf16; scale, bias: [F] float32,
// 8-byte aligned; out: [B, H/stride, W/stride, F], float32 if out_f32 else
// bf16. All contiguous; x and w 16-byte aligned; C % 8 == 0 and F % 8 == 0.
// The tiles: bn output channels (64, 128 or 256) by th × tw output pixels,
// th·tw = 128 at bn 256 and 256 otherwise, tw a power of two, th·stride and
// tw·stride at most 256 (one TMA box).
extern "C" int sad_conv3x3_wgmma(const void* x, const void* w, const void* scale,
                                 const void* bias, void* out, int B, int H, int W, int C, int F,
                                 int stride, int relu, int out_f32, int bn, int th, int tw,
                                 void* stream) {
    if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0 || C % 8 != 0 || F % 8 != 0 ||
        (stride != 1 && stride != 2) || H % stride != 0 || W % stride != 0 ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const int Ho = H / stride, Wo = W / stride;
    const int BN = bn, BM = bn == 256 ? 128 : 256;
    if ((bn != 64 && bn != 128 && bn != 256) || th <= 0 || tw <= 0 || (tw & (tw - 1)) != 0 ||
        th * tw != BM || th * stride > 256 || tw * stride > 256)
        return (int)cudaErrorInvalidValue;
    int tw_log2 = 0;
    while ((1 << tw_log2) < tw) ++tw_log2;

    Params p;
    p.scale = static_cast<const float*>(scale);
    p.bias = static_cast<const float*>(bias);
    p.out = out;
    p.C = C;
    p.F = F;
    p.Ho = Ho;
    p.Wo = Wo;
    p.stride = stride;
    p.relu = relu;
    p.th = th;
    p.tw_log2 = tw_log2;
    p.tiles_h = (Ho + th - 1) / th;
    p.tiles_w = (Wo + tw - 1) / tw;
    p.tiles_n = (F + BN - 1) / BN;
    const long long tiles = (long long)B * p.tiles_h * p.tiles_w * p.tiles_n;
    if (tiles > 0x7fffffffLL || 9LL * C > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    p.tiles = (int)tiles;

    // x as [B][H][W][C]; the box is one tap's 64 channels of th × tw output
    // pixels, every stride-th input row and column
    alignas(64) CUtensorMap tmap_x, tmap_w;
    const cuuint64_t x_dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t x_strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                     (cuuint64_t)H * W * C * 2};
    const cuuint32_t x_box[4] = {64, (cuuint32_t)(tw * stride), (cuuint32_t)(th * stride), 1};
    const cuuint32_t x_elem[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride, 1};
    int rc = sad::encode_bf16_sw128(&tmap_x, 4, x, x_dims, x_strides, x_box, x_elem);
    if (rc != 0) return rc;
    // w as [F][9][C], K-major; the box is one tap's 64 channels of BN filters
    const cuuint64_t w_dims[3] = {(cuuint64_t)C, 9, (cuuint64_t)F};
    const cuuint64_t w_strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)9 * C * 2};
    const cuuint32_t w_box[3] = {64, 1, (cuuint32_t)BN};
    const cuuint32_t w_elem[3] = {1, 1, 1};
    rc = sad::encode_bf16_sw128(&tmap_w, 3, w, w_dims, w_strides, w_box, w_elem);
    if (rc != 0) return rc;

    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (BN == 256) return launch_dtype<1, 256>(tmap_x, tmap_w, p, sms, out_f32, s);
    if (BN == 128) return launch_dtype<2, 128>(tmap_x, tmap_w, p, sms, out_f32, s);
    return launch_dtype<2, 64>(tmap_x, tmap_w, p, sms, out_f32, s);
}

// The text of a code that sad_conv3x3_wgmma returned: a cudaError_t, or
// −CUresult from encoding a tensor map.
extern "C" const char* sad_conv_error_string(int code) { return sad::error_string(code); }
