// Hopper TMA loads and mbarriers for the hand-written kernels, and the host
// side that encodes their tensor maps. sm_90a.
//
// A kernel keeps a ring of shared-memory stages; one producer thread starts
// the TMA loads of a stage, which complete on that stage's "full" barrier
// (the producer's arrive plus the bytes); the consumers hand the stage back
// on its "empty" barrier. Tensor maps are bf16 with the 128-byte swizzle
// that wgmma_bf16.cuh's descriptors read, and zero fill outside the tensor.
// cuTensorMapEncodeTiled comes through the CUDA runtime's entry-point
// lookup, so a library needs no -lcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sad {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed. A
// wait of more than about ten seconds is a fault: it traps, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    const long long t0 = clock64();
    while (!done) {
        if (clock64() - t0 > 20000000000LL) __trap();
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// The same load of a box into the shared memory of every CTA of the cluster
// in `mask` (bit r: rank r), at dst's offset, each completing on its own
// barrier at bar's offset.
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int c0, int c1,
                                                      uint16_t mask) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0), "r"(c1)
        : "memory");
}

// ---- thread block clusters ----

__device__ __forceinline__ uint32_t cluster_ctarank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}

// Arrive on the barrier at bar's offset in the shared memory of CTA `rank`
// of the cluster (this CTA's own included).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
    asm volatile(
        "{\n.reg .b32 remote;\n"
        "mapa.shared::cluster.u32 remote, %0, %1;\n"
        "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
        "r"(rank)
        : "memory");
}

// Every thread of the cluster: wait until all its threads that have not
// exited have arrived (shared memory writes before it are visible after).
__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" :::
                     "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
typedef CUresult (*GetErrorName)(CUresult, const char**);

inline void* driver_fn(const char* name) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion(name, &fn, 12000, cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
        return nullptr;
#else
    if (cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
        return nullptr;
#endif
    return fn;
}

// A bf16 tensor map with 128-byte swizzle and zero fill outside the tensor.
// Returns 0, or −CUresult if encoding failed.
inline int encode_bf16_sw128(CUtensorMap* map, int rank, const void* base,
                             const cuuint64_t* dims, const cuuint64_t* strides,
                             const cuuint32_t* box, const cuuint32_t* elem_strides) {
    static EncodeTiled fn = reinterpret_cast<EncodeTiled>(driver_fn("cuTensorMapEncodeTiled"));
    if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                          dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// The text of a code from a launcher that uses the above: a cudaError_t,
// or −CUresult from encoding a tensor map.
inline const char* error_string(int code) {
    if (code >= 0) return cudaGetErrorString(static_cast<cudaError_t>(code));
    static GetErrorName fn = reinterpret_cast<GetErrorName>(driver_fn("cuGetErrorName"));
    const char* name = nullptr;
    if (fn == nullptr || fn(static_cast<CUresult>(-code), &name) != CUDA_SUCCESS || !name)
        return "cuTensorMapEncodeTiled failed";
    return name;
}

}  // namespace sad
