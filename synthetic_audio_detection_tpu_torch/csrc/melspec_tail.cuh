// The tail shared by the log-mel kernels: dB, the top_db clamp and the
// per-window standardization of one window's [n_mels, n_frames] plane, held
// by one 1024-thread block in registers (32 cells a thread, so a plane of at
// most 32,768 cells: 128 mels × 251 frames at 4-s windows). Reductions are
// fixed-order shuffle trees with no atomics, so repeated runs give identical
// bits.
#pragma once

#include <cuda_bf16.h>
#include <math.h>

namespace sad {

constexpr int TAIL_THREADS = 1024;
constexpr int TAIL_PER_THREAD = 32;

// Fixed-order reduction over the block's 1024 threads (sum or max); every
// thread gets lane 0's result. red: 33 floats of shared memory.
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

__device__ __forceinline__ void store_value(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_value(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

// v[k] holds the mel power of cell threadIdx.x + k·TAIL_THREADS of the
// window's plane of n cells. Writes out[0, n): 10·log10(max(mel, 1e-10))
// clamped from below at the plane's max − top_db, then, with standardize,
// z = (db − mean) / (sqrt(var) + eps) with the unbiased variance, in two
// passes; rounded once to OutT. red: 33 floats of shared memory.
template <typename OutT>
__device__ __forceinline__ void db_standardize_store(float (&v)[TAIL_PER_THREAD],
                                                     OutT* __restrict__ out, int n, float top_db,
                                                     float eps, int standardize, float* red) {
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < TAIL_PER_THREAD; ++k) {
        const int idx = threadIdx.x + k * TAIL_THREADS;
        float d = -INFINITY;
        if (idx < n) d = 10.f * log10f(fmaxf(v[k], 1e-10f));
        v[k] = d;
        mx = fmaxf(mx, d);
    }
    const float floor_db = block_reduce(mx, red, true) - top_db;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < TAIL_PER_THREAD; ++k) {
        if (threadIdx.x + k * TAIL_THREADS < n) {
            v[k] = fmaxf(v[k], floor_db);
            s += v[k];
        }
    }
    if (!standardize) {
#pragma unroll
        for (int k = 0; k < TAIL_PER_THREAD; ++k) {
            const int idx = threadIdx.x + k * TAIL_THREADS;
            if (idx < n) store_value(out + idx, v[k]);
        }
        return;
    }
    const float mean = block_reduce(s, red, false) / (float)n;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < TAIL_PER_THREAD; ++k) {
        if (threadIdx.x + k * TAIL_THREADS < n) {
            const float d = v[k] - mean;
            q += d * d;
        }
    }
    const float var = block_reduce(q, red, false) / (float)(n > 1 ? n - 1 : 1);
    const float denom = sqrtf(var) + eps;
#pragma unroll
    for (int k = 0; k < TAIL_PER_THREAD; ++k) {
        const int idx = threadIdx.x + k * TAIL_THREADS;
        if (idx < n) store_value(out + idx, (v[k] - mean) / denom);
    }
}

}  // namespace sad
