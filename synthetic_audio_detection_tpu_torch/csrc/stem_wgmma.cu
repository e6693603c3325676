// The ResNet stem of the fast backbone for Hopper (sm_90a): the 7x7 stride-2
// conv (pad 3, 64 filters, 1 or 3 input channels), the eval-BN affine, one
// rounding to bf16, the 3x3 stride-2 max-pool (pad 1) and the ReLU, in one
// kernel. Neither the conv's output nor a bf16 copy of it goes to device
// memory.
//
// Replaces no TPU kernel: the reference package computes the stem with
// lax.conv and reduce_window (synthetic_audio_detection_tpu/models/
// fast_resnet.py:151 and :153). It was added because the port ran the stem
// as five device passes (a float32 cuDNN conv, a scale pass, a bias and
// rounding pass, the max-pool, the ReLU) that moved a 2.15-GB float32
// intermediate per 128-window batch at 512² and took more than half of the
// shared-backbone serving batch's device time.
//
// pooled[b, p, q, f] = relu(max_{a, c < 3} bf16(acc[b, 2p+a−1, 2q+c−1, f] ·
// scale[f] + bias[f])), acc[b, i, j, f] = Σ_{ch, dy, dx} x[b, ch, 2i+dy−3,
// 2j+dx−3] · w[f, ch, dy, dx] over bf16 values (exact products, a float32
// sum); input taps outside the image are 0, pool taps outside the conv's
// output never win. The multiply and the add round separately (no FMA), as
// the plain composition does.
//
// What bounds it on an H100: at [128, 3, 512, 512] the products of the three
// channels are 158 GFLOP (0.16 ms at the bf16 tensor-core peak); the bytes
// are one 67-MB bf16 plane in (the serving input repeats one plane on the
// three channels) and 268 MB out, 0.10 ms. The design:
//
// - A block owns TH × TW = 8 × 16 pooled outputs of one image and computes
//   the (2·TH+1) × (2·TW+1) = 17 × 33 conv pixels they read, the pool's
//   one-pixel halo included (561 pixels where the tile's own share is 512:
//   about 10% recompute), from an input patch of 39 × 72 bf16 per plane that it
//   loads once into shared memory (zeros outside the image).
// - Implicit GEMM on wgmma m64n64k16, M = conv pixels (9 blocks of 64), N =
//   the 64 filters, K = (channel, dy, dx) with dx padded to 8: 56 per
//   channel, padded to a multiple of 16 (64 for one channel, 176 for
//   three). A comes from registers: a thread's fragment for one (channel,
//   dy) is two bf16 taps (dx = 2·(l % 4) + {0, 1}) of one patch row, one
//   4-byte shared load, so no im2col matrix is written. With a stride-0
//   channel axis the block loads one plane and its 14 A registers serve all
//   three channels' weights. B, the packed weights [64, K] (at most 24 KB),
//   sits in shared memory, K-major with the 128-byte swizzle, for the whole
//   persistent block.
// - Epilogue from the accumulators: x·scale, + bias, one rounding to bf16,
//   into a bf16 conv tile in shared memory [pixel][64 filters] (16-byte
//   chunks swizzled by the pixel, so the stores and the pool's loads are
//   conflict-free); conv pixels outside the conv's output hold −inf.
// - Pool: a thread takes 8 filters of one pooled column over 4 pooled rows,
//   keeps the 9 conv rows' horizontal maxima in registers, and stores each
//   output as 16 bytes of the NHWC row.
// - Persistent blocks, two to an SM where shared memory allows (one plane:
//   about 100 KB each), so one block's pool overlaps the other's products;
//   the next tile's patch is fetched into registers during the pool.
//
// Each output pixel's summation order depends only on its own position in
// its tile, and the tiles only on H and W, so a row's output does not depend
// on the batch it is in.
//
// The kernel allocates nothing. sad_stem_wgmma returns cudaErrorInvalidValue
// for shapes or tiles it does not take, else the launch's cudaGetLastError()
// (sad_stem_error_string names it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_sm90.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int THREADS = 256;                   // two warpgroups
constexpr int TH = 8, TW = 16;                 // pooled outputs of a tile (ops/cuda_stem.TILE)
constexpr int CH = 2 * TH + 1, CW = 2 * TW + 1;  // its conv pixels: 17 × 33
constexpr int NPIX = CH * CW;                  // 561
constexpr int MBLK = (NPIX + 63) / 64;         // 9 wgmma M blocks
constexpr int PR = 4 * TH + 7, PC = 4 * TW + 8;  // patch rows and columns: 39 × 72
constexpr int PATCH = PR * PC;                 // elements of one plane's patch
constexpr int FILTERS = 64;
constexpr int ROW = 128;  // bytes: one conv pixel's 64 filters; one weight row's 64 k
constexpr uint32_t NEG_INF2 = 0xFF80FF80u;     // two bf16 −inf

template <int C, bool SHARED>
struct Cfg {
    static constexpr int CL = SHARED ? 1 : C;      // planes loaded
    static constexpr int GROUPS = 7 * C;           // (channel, dy) rows of 8 k
    static constexpr int KS = (GROUPS + 1) / 2;    // k16 steps: 4 or 11
    static constexpr int KP = 16 * KS;             // packed K: 64 or 176
    static constexpr int PANELS = (KP + 63) / 64;  // 128-byte swizzle panels of B
    static constexpr int W_BYTES = PANELS * FILTERS * ROW;
    static constexpr int CONV = W_BYTES;           // after B, which is 1024-aligned
    static constexpr int PATCH_AT = CONV + NPIX * ROW;
    static constexpr int AFFINE = PATCH_AT + CL * PATCH * 2;
    static constexpr int SMEM = 1024 + AFFINE + 2 * FILTERS * 4;
    static constexpr int NPRE = (CL * PATCH + THREADS - 1) / THREADS;  // patch loads a thread
};

struct Params {
    const uint16_t* x;  // bf16 [B, C, H, W] planes, W contiguous
    long long bs, cs;   // batch and channel strides, elements (cs 0: one plane)
    const uint16_t* w;  // bf16 [64, KP], k = ch·56 + dy·8 + dx, dx 7 and k ≥ 56·C zero
    const float* scale;
    const float* bias;
    uint16_t* out;      // bf16 [B, Hp, Wp, 64]
    int H, W, Ho, Wo, Hp, Wp;
    int tiles_h, tiles_w, tiles;
};

struct Tile {
    int b, p0, q0;  // image, first pooled row and column
};

__device__ __forceinline__ Tile decode(const Params& p, int t) {
    Tile r;
    r.q0 = (t % p.tiles_w) * TW;
    t /= p.tiles_w;
    r.p0 = (t % p.tiles_h) * TH;
    r.b = t / p.tiles_h;
    return r;
}

// The tile's patch into registers: element i = tid + k·THREADS of the CL
// planes' [PR, PC] patches, whose origin is input (4·p0 − 5, 4·q0 − 5).
template <int CL, int NPRE>
__device__ __forceinline__ void fetch_patch(const Params& p, int t, uint16_t (&v)[NPRE]) {
    const Tile tile = decode(p, t);
    const int y0 = 4 * tile.p0 - 5, x0 = 4 * tile.q0 - 5;
    const uint16_t* img = p.x + (size_t)tile.b * p.bs;
#pragma unroll
    for (int k = 0; k < NPRE; ++k) {
        const int i = threadIdx.x + k * THREADS;
        uint16_t e = 0;
        if (i < CL * PATCH) {
            const int plane = i / PATCH, rem = i % PATCH;
            const int y = y0 + rem / PC, x = x0 + rem % PC;
            if (y >= 0 && y < p.H && x >= 0 && x < p.W)
                e = __ldg(img + plane * p.cs + (size_t)y * p.W + x);
        }
        v[k] = e;
    }
}

template <int CL, int NPRE>
__device__ __forceinline__ void store_patch(uint16_t* patch, const uint16_t (&v)[NPRE]) {
#pragma unroll
    for (int k = 0; k < NPRE; ++k) {
        const int i = threadIdx.x + k * THREADS;
        if (i < CL * PATCH) patch[i] = v[k];
    }
}

__device__ __forceinline__ uint32_t bf16x2_max(uint32_t a, uint32_t b) {
    __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&a);
    __nv_bfloat162 y = *reinterpret_cast<__nv_bfloat162*>(&b);
    __nv_bfloat162 m = __hmax2_nan(x, y);
    return *reinterpret_cast<uint32_t*>(&m);
}

__device__ __forceinline__ uint4 max4(uint4 a, uint4 b) {
    return make_uint4(bf16x2_max(a.x, b.x), bf16x2_max(a.y, b.y), bf16x2_max(a.z, b.z),
                      bf16x2_max(a.w, b.w));
}

template <int C, bool SHARED>
__global__ void __launch_bounds__(THREADS, Cfg<C, SHARED>::CL == 1 ? 2 : 1)
stem_wgmma_kernel(const Params p) {
    using K = Cfg<C, SHARED>;
    constexpr int CL = K::CL, KS = K::KS, KP = K::KP, NPRE = K::NPRE;
    extern __shared__ uint8_t smem_raw[];
    // the weights' swizzle repeats every 1024 bytes of shared address
    uint8_t* base = smem_raw + ((1024 - (sad::smem_u32(smem_raw) & 1023)) & 1023);
    uint8_t* conv = base + K::CONV;
    uint16_t* patch = reinterpret_cast<uint16_t*>(base + K::PATCH_AT);
    float* scale = reinterpret_cast<float*>(base + K::AFFINE);
    float* bias = scale + FILTERS;
    const int tid = threadIdx.x;

    // B: row n, 16-byte chunk kc of the packed weight → panel kc / 8, chunk
    // (kc % 8) ^ (n % 8) of row n
    for (int i = tid; i < FILTERS * (KP / 8); i += THREADS) {
        const int n = i / (KP / 8), kc = i % (KP / 8);
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p.w) + i);
        *reinterpret_cast<uint4*>(base + (kc >> 3) * FILTERS * ROW + n * ROW +
                                  (((kc & 7) ^ (n & 7)) << 4)) = v;
    }
    if (tid < FILTERS) {
        scale[tid] = p.scale[tid];
        bias[tid] = p.bias[tid];
    }
    uint16_t pre[NPRE];
    int t = blockIdx.x;
    if (t < p.tiles) {
        fetch_patch<CL>(p, t, pre);
        store_patch<CL>(patch, pre);
    }
    __syncthreads();

    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    const uint32_t b_addr = sad::smem_u32(base);
    const uint32_t* patch_w = reinterpret_cast<const uint32_t*>(patch);
    for (; t < p.tiles; t += gridDim.x) {
        const Tile tile = decode(p, t);
        const int r0 = 2 * tile.p0 - 1, c0 = 2 * tile.q0 - 1;  // the tile's first conv pixel

        // ---- conv: warpgroup wg takes M blocks wg, wg + 2, ... ----
        for (int blk = wg; blk < MBLK; blk += 2) {
            // this thread's A rows: pixels m and m + 8 of the block, whose
            // taps (dy, 2q) start at patch word r·PC/2 + c + q (4-byte pairs)
            int at[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                int m = blk * 64 + warp * 16 + g + 8 * h;
                m = m < NPIX ? m : 0;  // the last block's padding rows: any pixel
                at[h] = (m / CW) * PC + m % CW + q;
            }
            uint32_t a[7 * CL][2];
#pragma unroll
            for (int gr = 0; gr < 7 * CL; ++gr)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const uint32_t v =
                        patch_w[at[h] + (gr / 7) * (PATCH / 2) + (gr % 7) * (PC / 2)];
                    a[gr][h] = q == 3 ? (v & 0xFFFFu) : v;  // dx 7 is padding
                }
            float acc[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                acc[i] = 0.f;
                sad::fence_operand(acc[i]);
            }
#pragma unroll
            for (int gr = 0; gr < 7 * CL; ++gr) {
                sad::fence_reg(a[gr][0]);
                sad::fence_reg(a[gr][1]);
            }
            sad::wgmma_fence();
            uint32_t zero = 0;
#pragma unroll
            for (int s = 0; s < KS; ++s) {
                // k16 step s: (channel, dy) groups 2s and 2s + 1; with one
                // plane a group's taps do not depend on the channel
                uint32_t frag[4];
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int gr = 2 * s + half;
                    const int src = gr >= 7 * C ? 0 : SHARED ? gr % 7 : gr;
                    frag[2 * half] = gr < 7 * C ? a[src][0] : zero;
                    frag[2 * half + 1] = gr < 7 * C ? a[src][1] : zero;
                }
                const uint32_t b = b_addr + (s >> 2) * FILTERS * ROW + 32 * (s & 3);
                sad::wgmma_m64n64k16_rs(acc, frag, sad::wgmma_desc_sw128(b));
            }
            sad::wgmma_commit();
            sad::wgmma_wait<0>();
#pragma unroll
            for (int gr = 0; gr < 7 * CL; ++gr) {
                sad::fence_reg(a[gr][0]);
                sad::fence_reg(a[gr][1]);
            }
#pragma unroll
            for (int i = 0; i < 32; ++i) sad::fence_operand(acc[i]);

            // epilogue: acc[4j + 2h + e] is pixel m_h, filter 8j + 2q + e
            float2 sc[8], bi[8];
#pragma unroll
            for (int jn = 0; jn < 8; ++jn) {
                sc[jn] = *reinterpret_cast<const float2*>(scale + 8 * jn + 2 * q);
                bi[jn] = *reinterpret_cast<const float2*>(bias + 8 * jn + 2 * q);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = blk * 64 + warp * 16 + g + 8 * h;
                if (m >= NPIX) continue;
                const int i = r0 + m / CW, j = c0 + m % CW;
                const bool inside = i >= 0 && i < p.Ho && j >= 0 && j < p.Wo;
                uint8_t* row = conv + m * ROW + 4 * q;
#pragma unroll
                for (int jn = 0; jn < 8; ++jn) {
                    const float v0 = __fadd_rn(__fmul_rn(acc[4 * jn + 2 * h], sc[jn].x), bi[jn].x);
                    const float v1 =
                        __fadd_rn(__fmul_rn(acc[4 * jn + 2 * h + 1], sc[jn].y), bi[jn].y);
                    *reinterpret_cast<uint32_t*>(row + ((jn ^ (m & 7)) << 4)) =
                        inside ? sad::pack_bf16x2(v0, v1) : NEG_INF2;
                }
            }
        }
        __syncthreads();  // the conv tile is whole; the patch is free

        const int tn = t + gridDim.x;
        if (tn < p.tiles) fetch_patch<CL>(p, tn, pre);

        // ---- pool + ReLU: 8 filters (chunk jc) of pooled column qq, pooled
        // rows 4·hf ... 4·hf + 3, from conv rows 8·hf ... 8·hf + 8 ----
        {
            const int hf = tid >> 7, qq = (tid >> 3) & 15, jc = tid & 7;
            auto load = [&](int m) {
                return *reinterpret_cast<const uint4*>(conv + m * ROW + ((jc ^ (m & 7)) << 4));
            };
            uint4 rmax[9];
#pragma unroll
            for (int k = 0; k < 9; ++k) {
                const int m = (8 * hf + k) * CW + 2 * qq;
                rmax[k] = max4(max4(load(m), load(m + 1)), load(m + 2));
            }
            const int pq = tile.q0 + qq;
#pragma unroll
            for (int pp = 0; pp < 4; ++pp) {
                const int pr = tile.p0 + 4 * hf + pp;
                if (pr >= p.Hp || pq >= p.Wp) continue;
                uint4 v = max4(max4(rmax[2 * pp], rmax[2 * pp + 1]), rmax[2 * pp + 2]);
                v = max4(v, make_uint4(0u, 0u, 0u, 0u));  // the ReLU
                *reinterpret_cast<uint4*>(p.out + (((size_t)tile.b * p.Hp + pr) * p.Wp + pq) *
                                                      FILTERS + 8 * jc) = v;
            }
        }
        if (tn < p.tiles) store_patch<CL>(patch, pre);
        __syncthreads();  // the next patch is in; the conv tile is free
    }
}

template <int C, bool SHARED>
int launch(const Params& p, cudaStream_t stream) {
    auto kernel = stem_wgmma_kernel<C, SHARED>;
    const int smem = Cfg<C, SHARED>::SMEM;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long slots = (long long)sms * per_sm;
    const int grid = p.tiles < slots ? p.tiles : (int)slots;
    kernel<<<grid, THREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace

// x: bf16 planes [B, C, H, W] with W contiguous and rows W apart, batch
// stride bs and channel stride cs in elements (cs 0: one plane repeated on
// the channels); C 1 or 3. w: bf16 [64, 16·ceil(7·C / 2)] packed (k = ch·56
// + dy·8 + dx; dx 7 and the tail zero), 16-byte aligned. scale, bias: [64]
// float32. out: bf16 [B, Hp, Wp, 64], 16-byte aligned, Ho = ceil(H / 2), Hp =
// ceil(Ho / 2) (likewise W). th × tw: the pooled tile, which must be the
// kernel's 8 × 16 (ops/cuda_stem.tile_plan).
extern "C" int sad_stem_wgmma(const void* x, long long bs, long long cs, const void* w,
                              const void* scale, const void* bias, void* out, int B, int C,
                              int H, int W, int th, int tw, void* stream) {
    if (B <= 0 || H <= 0 || W <= 0 || (C != 1 && C != 3) || th != TH || tw != TW ||
        reinterpret_cast<uintptr_t>(x) % 2 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    Params p;
    p.x = static_cast<const uint16_t*>(x);
    p.bs = bs;
    p.cs = cs;
    p.w = static_cast<const uint16_t*>(w);
    p.scale = static_cast<const float*>(scale);
    p.bias = static_cast<const float*>(bias);
    p.out = static_cast<uint16_t*>(out);
    p.H = H;
    p.W = W;
    p.Ho = (H + 1) / 2;
    p.Wo = (W + 1) / 2;
    p.Hp = (p.Ho + 1) / 2;
    p.Wp = (p.Wo + 1) / 2;
    p.tiles_h = (p.Hp + TH - 1) / TH;
    p.tiles_w = (p.Wp + TW - 1) / TW;
    const long long tiles = (long long)B * p.tiles_h * p.tiles_w;
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    p.tiles = (int)tiles;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (C == 1) return launch<1, true>(p, s);
    return cs == 0 ? launch<3, true>(p, s) : launch<3, false>(p, s);
}

// The text of a code that sad_stem_wgmma returned.
extern "C" const char* sad_stem_error_string(int code) { return sad::error_string(code); }
