// bf16 tensor-core helpers shared by the hand-written kernels (mma.sync
// m16n8k16, float32 accumulators).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sad {

// Two floats → two bf16 in one register (round to nearest even); the low
// half holds lo.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
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

// One 16-deep step, at column kk, of a warp's 64 × 32 output tile: A rows
// [r0, r0 + 64) of As and output columns [c0, c0 + 32) of Bs, both stored
// k-contiguous in shared memory. acc[mi][ni] is the m16n8 accumulator of
// rows r0 + 16·mi … and columns c0 + 8·ni …: lane (g = lane / 4, q = lane % 4)
// holds rows g and g + 8, columns 2q and 2q + 1.
template <int LD>
__device__ __forceinline__ void warp_mma_64x32(__nv_bfloat16 (*As)[LD], __nv_bfloat16 (*Bs)[LD],
                                               int r0, int c0, int kk, int lane,
                                               float (&acc)[4][4][4]) {
    const int g = lane >> 2, tq = lane & 3;
    uint32_t af[4][4], bfr[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
        const int r = r0 + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + tq * 2]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + tq * 2]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + tq * 2 + 8]);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + tq * 2 + 8]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
        const int c = c0 + ni * 8 + g;
        bfr[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[c][kk + tq * 2]);
        bfr[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[c][kk + tq * 2 + 8]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
}

}  // namespace sad
