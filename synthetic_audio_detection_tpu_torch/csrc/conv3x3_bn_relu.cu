// 3x3 SAME convolution + per-channel affine + optional ReLU for Hopper (sm_90a).
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
// An implicit GEMM: M = B·Ho·Wo output pixels, N = F output channels,
// K = 9·C, with k = (3·dy + dx)·C + c. A block computes a 128-pixel × 64-channel
// tile of the output. Each step of 32 along K loads, for each of the block's
// pixels, four 16-byte segments of 8 channels of one tap (C % 8 == 0, so a
// segment never crosses a tap) straight from the NHWC input, zero-filled where
// the tap falls outside the image (no padded copy of the input exists), and
// the matching rows of the packed weight [F, 3, 3, C]. The product runs on the
// tensor cores with mma.sync m16n8k16, bf16 operands and float32 accumulators.
// The epilogue applies acc·scale[f] + bias[f] as a float32 multiply and a
// separate add (no fused multiply-add, so the rounding equals the plain
// version's), then the ReLU, and rounds once to bf16 or float32.
//
// What bounds it: at ResNet-18's layer-1 shape ([128, 128, 128, 64] → 64)
// the work is 155 GFLOP against 0.54 GB of input and output, about 290
// FLOP/byte, right at the H100's bf16 balance point; the deeper layers have
// more FLOP per byte and are bound by the tensor cores. The design does
// what a first kernel can: every input and output byte crosses device memory
// once from the kernel's side (re-reads of the 3x3 halo hit L2), the affine
// and ReLU are fused so no float32 intermediate is written, and the next
// K-step's global loads are issued into registers before the current step's
// products, into a second shared-memory buffer, so one barrier per step
// suffices. wgmma, TMA and a deeper cp.async ring are later work.
//
// tile_h groups output rows: the grid's z axis runs over B · (Ho / tile_h)
// row tiles and its y axis over 128-pixel chunks of one tile; a ragged last
// chunk is masked. Offsets into the input and output are 64-bit.
//
// The kernel allocates nothing. sad_conv3x3_bn_relu returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for shapes it
// does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // reduction elements per step
constexpr int SPAD = 8;  // bf16 row padding in shared memory (no bank conflicts)
constexpr int THREADS = 256;  // 8 warps: 4 along M (32 pixels) × 2 along N (32 channels)

template <bool OUT_F32>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               void* __restrict__ out, int H, int W, int C, int F, int Ho, int Wo, int stride,
               int tile_h, int relu) {
    __shared__ __align__(16) __nv_bfloat16 As[2][BM][BK + SPAD];
    __shared__ __align__(16) __nv_bfloat16 Bs[2][BN][BK + SPAD];

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp >> 1, wn = warp & 1;
    const int g = lane >> 2, tq = lane & 3;

    const int K = 9 * C;
    const int n0 = blockIdx.x * BN;
    const int tiles_per_image = Ho / tile_h;
    const int b = blockIdx.z / tiles_per_image;
    const int ho0 = (blockIdx.z % tiles_per_image) * tile_h;
    const int tile_pixels = tile_h * Wo;
    const int p0 = blockIdx.y * BM;  // first pixel of this block inside its tile

    // A loads: rows ra and ra + 64, one 8-channel segment sa of the step
    const int ra = tid >> 2, sa = tid & 3;
    const __nv_bfloat16* ximg = x + (size_t)b * H * W * C;
    int hbase[2], wbase[2];
    bool rvalid[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int p = p0 + ra + 64 * i;
        rvalid[i] = p < tile_pixels;
        const int ho = ho0 + p / Wo, wo = p % Wo;
        hbase[i] = ho * stride - 1;
        wbase[i] = wo * stride - 1;
    }
    // B loads: weight row rb (output channel n0 + rb), segment sb
    const int rb = tid >> 2, sb = tid & 3;
    const bool bvalid = n0 + rb < F;
    const __nv_bfloat16* wrow = w + (size_t)(bvalid ? n0 + rb : 0) * K;

    uint4 areg[2], breg;
    auto load = [&](int k0) {
        const int k = k0 + sa * 8;
        const int tap = k / C;
        const int c = k - tap * C;
        const int dy = tap / 3, dx = tap - 3 * (tap / 3);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int hi = hbase[i] + dy, wi = wbase[i] + dx;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (rvalid[i] && k < K && hi >= 0 && hi < H && wi >= 0 && wi < W)
                v = *reinterpret_cast<const uint4*>(ximg + ((size_t)hi * W + wi) * C + c);
            areg[i] = v;
        }
        const int kb = k0 + sb * 8;
        breg = make_uint4(0u, 0u, 0u, 0u);
        if (bvalid && kb < K) breg = *reinterpret_cast<const uint4*>(wrow + kb);
    };
    auto store = [&](int buf) {
        *reinterpret_cast<uint4*>(&As[buf][ra][sa * 8]) = areg[0];
        *reinterpret_cast<uint4*>(&As[buf][ra + 64][sa * 8]) = areg[1];
        *reinterpret_cast<uint4*>(&Bs[buf][rb][sb * 8]) = breg;
    };

    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    const int nk = (K + BK - 1) / BK;
    load(0);
    store(0);
    __syncthreads();
    for (int kt = 0; kt < nk; ++kt) {
        const int cur = kt & 1;
        if (kt + 1 < nk) load((kt + 1) * BK);  // in flight during the products below
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            uint32_t af[2][4], bfr[4][2];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
                const int r = wm * 32 + mi * 16 + g;
                af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[cur][r][kk + tq * 2]);
                af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[cur][r + 8][kk + tq * 2]);
                af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[cur][r][kk + tq * 2 + 8]);
                af[mi][3] = *reinterpret_cast<const uint32_t*>(&As[cur][r + 8][kk + tq * 2 + 8]);
            }
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
                const int n = wn * 32 + ni * 8 + g;
                bfr[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[cur][n][kk + tq * 2]);
                bfr[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[cur][n][kk + tq * 2 + 8]);
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) sad::mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
        }
        // the other buffer was last read before the previous barrier
        if (kt + 1 < nk) store(cur ^ 1);
        __syncthreads();
    }

    // epilogue: pixel p of this tile is output row (b·Ho + ho0)·Wo + p
    const size_t row0 = ((size_t)b * Ho + ho0) * Wo;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int p = p0 + wm * 32 + mi * 16 + g + half * 8;
            if (p >= tile_pixels) continue;
            const size_t o = (row0 + p) * F;
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
                const int f = n0 + wn * 32 + ni * 8 + tq * 2;
                if (f >= F) continue;  // F % 8 == 0, so f + 1 < F here
                float v0 = __fadd_rn(__fmul_rn(acc[mi][ni][2 * half], scale[f]), bias[f]);
                float v1 = __fadd_rn(__fmul_rn(acc[mi][ni][2 * half + 1], scale[f + 1]),
                                     bias[f + 1]);
                if (relu) {
                    v0 = fmaxf(v0, 0.f);
                    v1 = fmaxf(v1, 0.f);
                }
                if (OUT_F32)
                    *reinterpret_cast<float2*>(static_cast<float*>(out) + o + f) =
                        make_float2(v0, v1);
                else
                    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o + f) =
                        __floats2bfloat162_rn(v0, v1);
            }
        }
    }
}

}  // namespace

// x: [B, H, W, C] bf16; w: [F, 3, 3, C] bf16; scale, bias: [F] float32;
// out: [B, H/stride, W/stride, F], float32 if out_f32 else bf16. All
// contiguous, x and w 16-byte aligned.
extern "C" int sad_conv3x3_bn_relu(const void* x, const void* w, const void* scale,
                                   const void* bias, void* out, int B, int H, int W, int C,
                                   int F, int stride, int tile_h, int relu, int out_f32,
                                   void* stream) {
    if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0 || C % 8 != 0 || F % 8 != 0 ||
        (stride != 1 && stride != 2) || H % stride != 0 || W % stride != 0)
        return (int)cudaErrorInvalidValue;
    const int Ho = H / stride, Wo = W / stride;
    if (tile_h <= 0 || Ho % tile_h != 0) return (int)cudaErrorInvalidValue;
    const long long tile_pixels = (long long)tile_h * Wo;
    const long long tiles = (long long)B * (Ho / tile_h);
    const long long chunks = (tile_pixels + BM - 1) / BM;
    if (tiles > 65535 || chunks > 65535 || 9LL * C > 0x7fffffffLL ||
        (long long)H * W > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid((F + BN - 1) / BN, (unsigned)chunks, (unsigned)tiles);
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
    const float* sc = static_cast<const float*>(scale);
    const float* bi = static_cast<const float*>(bias);
    if (out_f32)
        conv3x3_kernel<true><<<grid, THREADS, 0, s>>>(xb, wb, sc, bi, out, H, W, C, F, Ho, Wo,
                                                      stride, tile_h, relu);
    else
        conv3x3_kernel<false><<<grid, THREADS, 0, s>>>(xb, wb, sc, bi, out, H, W, C, F, Ho, Wo,
                                                       stride, tile_h, relu);
    return (int)cudaGetLastError();
}

extern "C" const char* sad_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
