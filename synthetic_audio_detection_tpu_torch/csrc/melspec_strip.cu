// Strip-DFT log-mel front end for Hopper (sm_90a).
//
// Replaces the TPU kernel synthetic_audio_detection_tpu/ops/pallas_melspec.py
// :_kernel (entry fused_log_mel): the standardized log-mel of centre-padded
// windows with one DFT per frame, the periodic Hann applied in time. Frame t
// of a window is xw[t, n] = bf16(xpad[t·hop + n] · hann[n]) (product in
// float32, rounded once), re|im = xw · [cos | sin][n_fft, n_bins] with bf16
// operands and float32 accumulation, power = re·re + im·im (a separate
// multiply and add), mel = power · fb in float32, then dB, the top_db clamp
// and the standardization over the window's [n_mels, n_frames] cells.
//
// What bounds it, at [128, 128000] (251 frames, 768 bins, 1,514 filterbank
// nonzeros a frame): the DFT, 2·128·251·2048·1536 = 202.1 GFLOP of bf16,
// 0.204 ms at 989 TFLOP/s; the mel product 0.097 GFLOP of float32 (0.0015
// ms); 65.5 MB of waveforms in and 16.4 MB of z-scores out (0.025 ms at
// 3.35 TB/s). So the tensor cores bound it: the strip form transforms each
// hop block n_fft/hop = 4 times, which is why it is 3.8× K1's bound. With
// K = n_fft, a 128 × 256 tile's operands come from L2 at about 85 FLOP a
// byte, so L2 is the other limit; the design keeps everything but the
// strips and a mel-sized plane out of device memory. One call runs three
// launches on the caller's stream:
//
//   1. strip_bf16_kernel  the k = n_fft/hop Hann-weighted strips, S_i[h, s]
//      = bf16(xpad[h·hop + s] · hann[i·hop + s]) for every hop block h of
//      all windows back to back, [k, windows·nb, hop] bf16, straight from
//      the unpadded float32 waveforms by the reflect-pad and zero-tail index
//      math of the factored kernel's pre-pass: each thread reads 8 samples
//      once and writes them into the k strips. Frame t of window b is then
//      row b·nb + t + i of strip i, for i < k.
//   2. strip_dft_kernel  one block per (band of 128 bins, tile of 128 frame
//      rows). Tiles run over all windows' block rows back to back (a
//      window's last k − 1 rows start no frame: 1.2% at the defaults); the
//      band index is the grid's fastest, so a tile's bands share its strips
//      in L2. A band is bins f0 … f0 + 127 as 256 interleaved columns
//      (column 2j the cos of bin f0 + j, 2j + 1 its sin), planned by the host
//      (ops/cuda_melspec_strip.band_plan) so each mel's whole span lies in
//      the one band that owns it. Mainloop: [128, 256] = A·Bᵀ with K =
//      n_fft, as k strips × hop/64 steps: A the 128 rows r0 + i … of strip i
//      (a 3-D TMA box; rows past the last are zero-filled), B the band's 256
//      rows at samples i·hop + 64·step. wgmma m64n256k16 from two consumer
//      warpgroups of 64 rows, a 4-stage ring filled by one producer thread
//      (128-byte swizzle). Two tiles of one band form a cluster and each
//      CTA loads half of the B box, multicast to both: B's L2 traffic
//      halves, which made the launch about 10% faster on an H100 than
//      1-tile clusters (4-tile clusters were slower again; PERF.md).
//      Epilogue, in shared memory over the drained ring:
//      the re and im of a bin are adjacent accumulator columns of one
//      thread, so each thread forms its 64 powers in registers and stores
//      them to a [bin, frame] plane; then each thread keeps, for one frame,
//      one running sum over the band's bins for its even mels (warpgroup 0)
//      or its odd ones (warpgroup 1) and stores a mel's sum at its last bin:
//      every mel cell is written once, in bin order, with no atomics, so
//      repeated runs give identical bits. No power scratch exists.
//   3. strip_tail_kernel  one 1024-thread block per window: the tail shared
//      with the factored kernel (melspec_tail.cuh).
//
// The kernel allocates nothing: the caller passes the strips, the mel plane
// and the output. sad_melspec_strip returns cudaErrorInvalidValue for shapes
// it does not take, −CUresult if encoding a tensor map failed, else the
// first cudaGetLastError() after a launch (sad_cuda_error_string names
// either).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "melspec_tail.cuh"
#include "tma_sm90.cuh"
#include "wgmma_bf16.cuh"

namespace {

// ---- launch 1: Hann-weighted bf16 strips -------------------------------------

// x: [windows, T] float32; hann: [k·hop] float32, 16-byte aligned; strips:
// [k, windows·row_len] bf16, row_len = nb·hop. Sample p of a window's padded
// row is x[p − pad] reflected at both edges (numpy's 'reflect': the edge
// sample is not repeated) for p < T + 2·pad, else 0. n8: the number of
// 8-sample groups of one strip.
__global__ void __launch_bounds__(256)
strip_bf16_kernel(const float* __restrict__ x, const float* __restrict__ hann,
                  __nv_bfloat16* __restrict__ strips, int T, int pad, int hop, int k,
                  int row_len, long long n8) {
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= n8) return;
    const long long e = g * 8;
    const int b = (int)(e / row_len);
    const int p0 = (int)(e - (long long)b * row_len);
    const int s0 = p0 % hop;
    const float* xb = x + (size_t)b * T;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        int s = p0 + j - pad;
        float f = 0.f;
        if (s < T + pad) {
            s = s < 0 ? -s : (s >= T ? 2 * (T - 1) - s : s);
            f = xb[s];
        }
        v[j] = f;
    }
    for (int i = 0; i < k; ++i) {
        const float4* hq = reinterpret_cast<const float4*>(hann + i * hop + s0);
        const float4 h0 = __ldg(hq), h1 = __ldg(hq + 1);
        const float h[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
        __align__(16) __nv_bfloat16 o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16_rn(__fmul_rn(v[j], h[j]));
        *reinterpret_cast<uint4*>(strips + (size_t)i * n8 * 8 + e) =
            *reinterpret_cast<const uint4*>(o);
    }
}

// ---- launch 2: strip DFT on wgmma, power, sparse mel --------------------------

constexpr int ROWS = 128;         // frame rows a tile: two consumer warpgroups × 64
constexpr int BINS = 128;         // bins a band: f0 … f0 + 127
constexpr int COLS = 2 * BINS;    // interleaved cos/sin columns: wgmma's N
constexpr int KSTEP = 64;         // samples a stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int CLUSTER = 2;        // tiles of one band to a cluster (grid y)
constexpr int THREADS = 384;      // producer warpgroup + two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int A_BYTES = ROWS * 128;
constexpr int B_BYTES = COLS * 128;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
// The power plane, over the ring: local bin j = 4·Q + s of frame row t at
// s·QS + Q·PS + t. A thread's accumulator pairs are bins 4·Q + lane % 4 of
// rows lane / 4 (+ 8), so QS ≡ 8 (mod 32) puts the 32 lanes' stores of one
// pair in 32 banks; the mel pass reads 32 consecutive rows of one bin.
constexpr int PS = ROWS;
constexpr int QS = BINS / 4 * PS + 8;
constexpr int P_BYTES = 4 * QS * 4;
static_assert(P_BYTES <= RING_BYTES, "the power plane lies over the ring");
// the band's mel tables (weights, then ends, of both parities), copied to
// shared memory while the first stages load
constexpr int TAB_QUADS = 2 * BINS / 4;
constexpr int TAB_BYTES = 2 * TAB_QUADS * 16;
// 1024 bytes of slack to align the ring for the swizzle, the tables, then
// the barriers
constexpr int SMEM = 1024 + RING_BYTES + TAB_BYTES + 2 * STAGES * 8;

struct Params {
    const int* band_f0;     // [bands]: band k is bins band_f0[k] … + BINS − 1
    const float4* mel_w;    // [bands, 2, BINS / 4]: ops/cuda_melspec.band_tables' weights,
    const int4* mel_end;    // ends (mel whose last bin a local bin is, or −1)
    const int* quads;       // and quads [bands, 2, 2] of the even (0) and odd (1) mels
    float* mel;             // [windows, n_mels, n_frames]
    int windows, nb, n_frames, n_mels, hop, ksteps;
};

// the two consumer warpgroups only (the producer warpgroup is not in it)
__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// the powers of local bins 4·q … 4·q + 3 of one frame (pt: the frame's
// column of the power plane)
__device__ __forceinline__ float4 load_powers(const float* pt, int q) {
    const float* pq = pt + q * PS;
    return make_float4(pq[0], pq[QS], pq[2 * QS], pq[3 * QS]);
}

// the running mel sum over one bin: add power × weight; at a mel's last bin
// (end ≥ 0) store the sum and start the next
__device__ __forceinline__ void mel_step(float& s, float pv, float w, int end, float* out,
                                         int n_frames) {
    s = fmaf(pv, w, s);
    if (end >= 0) {
        out[(size_t)end * n_frames] = s;
        s = 0.f;
    }
}

// a: the strips [k][windows·nb][hop]; b: the interleaved cos|sin [rows,
// n_fft] (row 2f the cos of bin f, row 2f + 1 its sin), as boxes of
// COLS / CLUSTER rows. CLUSTER tiles of one band form a cluster (grid y).
__global__ void __launch_bounds__(THREADS, 1)
strip_dft_kernel(const __grid_constant__ CUtensorMap tmap_a,
                 const __grid_constant__ CUtensorMap tmap_b, const Params p) {
    extern __shared__ uint8_t smem_raw[];
    // 128-byte swizzle repeats every 1024 bytes of shared address
    const uint32_t raw = sad::smem_u32(smem_raw);
    const uint32_t ring = (raw + 1023u) & ~1023u;
    uint8_t* work = smem_raw + (ring - raw);
    float4* tab_w = reinterpret_cast<float4*>(work + RING_BYTES);
    int4* tab_end = reinterpret_cast<int4*>(work + RING_BYTES) + TAB_QUADS;
    const uint32_t full = ring + RING_BYTES + TAB_BYTES;  // STAGES barriers, then STAGES "empty"
    const uint32_t empty = full + STAGES * 8;
    const int band = blockIdx.x;
    const int row0 = blockIdx.y * ROWS;  // the tile's first row, counted over all windows
    const int f0 = __ldg(p.band_f0 + band);

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            sad::mbar_init(full + 8 * s, 1);  // the producer's arrive + the TMA bytes
            // one arrive per consumer warpgroup of every CTA that the
            // stage's multicast half of B feeds
            sad::mbar_init(empty + 8 * s, 2 * CLUSTER);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    sad::cluster_sync();  // the peer's barriers exist before any multicast lands

    if (threadIdx.x < 128) {
        // ---- producer: one thread streams the K-steps through the ring ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == 0) {
            const int kstrip = p.hop / KSTEP;
            const uint32_t rank = sad::cluster_ctarank();
            for (int k = 0; k < p.ksteps; ++k) {
                const int s = k % STAGES;
                const int i = k / kstrip, c = (k - i * kstrip) * KSTEP;
                const uint32_t stage = ring + s * STAGE_BYTES;
                sad::mbar_wait(empty + 8 * s, ((k / STAGES) & 1) ^ 1);
                sad::mbar_expect_tx(full + 8 * s, STAGE_BYTES);
                sad::tma_load_3d(stage, &tmap_a, full + 8 * s, c, row0 + i, i);
                sad::tma_load_2d_multicast(stage + A_BYTES + rank * (B_BYTES / CLUSTER), &tmap_b,
                                           full + 8 * s, i * p.hop + c,
                                           2 * f0 + rank * (COLS / CLUSTER),
                                           (uint16_t)((1u << CLUSTER) - 1));
            }
        }
    } else {
        // ---- consumers: wgmma on the ring, then the epilogue ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int ct = threadIdx.x - 128;
        const int cw = ct >> 7;  // rows [64·cw, 64·cw + 64) of the tile
        const int warp = (ct >> 5) & 3, lane = ct & 31;
        const bool signaller = (ct & 127) == 0;
        // the band's mel tables to shared memory, read after the mainloop
        if (ct < TAB_QUADS)
            tab_w[ct] = __ldg(p.mel_w + band * TAB_QUADS + ct);
        else if (ct < 2 * TAB_QUADS)
            tab_end[ct - TAB_QUADS] = __ldg(p.mel_end + band * TAB_QUADS + ct - TAB_QUADS);
        float acc[COLS / 2];
#pragma unroll
        for (int i = 0; i < COLS / 2; ++i) acc[i] = 0.f;
        for (int k = 0; k < p.ksteps; ++k) {
            const int s = k % STAGES;
            sad::mbar_wait(full + 8 * s, (k / STAGES) & 1);
            const uint32_t a = ring + s * STAGE_BYTES + cw * 64 * 128;
            const uint32_t b = ring + s * STAGE_BYTES + A_BYTES;
            sad::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                sad::wgmma_m64n256k16(acc, sad::wgmma_desc_sw128(a + 32 * kk),
                                      sad::wgmma_desc_sw128(b + 32 * kk));
            sad::wgmma_commit();
            // the previous step's products have retired: hand its stage back
            // (to every CTA whose producer writes into it)
            sad::wgmma_wait<1>();
            if (k > 0 && signaller) {
                const uint32_t bar = empty + 8 * ((k - 1) % STAGES);
                for (int r = 0; r < CLUSTER; ++r) sad::mbar_arrive_cluster(bar, r);
            }
        }
        sad::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < COLS / 2; ++i) sad::fence_operand(acc[i]);

        // the power of each bin to shared memory, over the ring both
        // warpgroups have finished reading: accumulator 4·j + 2·h + e of
        // this thread is row 16·warp + lane / 4 + 8·h of the warpgroup's
        // 64, column 8·j + 2·(lane % 4) + e, so e = 0, 1 are the re and im
        // of local bin 4·j + lane % 4
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumers_sync();
        float* pw = reinterpret_cast<float*>(work);
        {
            float* pr = pw + (lane & 3) * QS + cw * 64 + warp * 16 + (lane >> 2);
#pragma unroll
            for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const float re = acc[4 * j + 2 * h], im = acc[4 * j + 2 * h + 1];
                    pr[j * PS + 8 * h] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
                }
        }
        consumers_sync();

        // the sparse mel product: warpgroup cw sums the band's mels of
        // parity cw, one thread per frame row, as one running sum over the
        // parity's bins in order (one multiply-add per filterbank weight,
        // and one for each of the few bins inside its groups of 4 that no
        // mel of the parity weighs); a mel's sum is stored at its last bin
        const int t = ct & 127;
        const int row = row0 + t;
        const int b = row / p.nb, tb = row - b * p.nb;
        // a row that starts no frame: a window's last k − 1 rows, or past the batch
        if (b < p.windows && tb < p.n_frames) {
            const int tab = 2 * band + cw;
            const float4* wq = tab_w + cw * (BINS / 4);
            const int4* eq = tab_end + cw * (BINS / 4);
            float* out = p.mel + (size_t)b * p.n_mels * p.n_frames + tb;
            const float* pt = pw + t;
            const int q1 = __ldg(p.quads + 2 * tab + 1);
            // each group of 4 bins is loaded one group ahead: the stores of
            // finished mels may alias the loads as far as the compiler knows
            int q = __ldg(p.quads + 2 * tab);
            float4 pv = load_powers(pt, q), w = wq[q];
            int4 e = eq[q];
            float s = 0.f;
            for (; q < q1; ++q) {
                const int qn = q + 1 < q1 ? q + 1 : q;
                const float4 pn = load_powers(pt, qn), wn = wq[qn];
                const int4 en = eq[qn];
                if (max(max(e.x, e.y), max(e.z, e.w)) < 0) {  // no mel ends here: most groups
                    s = fmaf(pv.x, w.x, s);
                    s = fmaf(pv.y, w.y, s);
                    s = fmaf(pv.z, w.z, s);
                    s = fmaf(pv.w, w.w, s);
                } else {
                    mel_step(s, pv.x, w.x, e.x, out, p.n_frames);
                    mel_step(s, pv.y, w.y, e.y, out, p.n_frames);
                    mel_step(s, pv.z, w.z, e.z, out, p.n_frames);
                    mel_step(s, pv.w, w.w, e.w, out, p.n_frames);
                }
                pv = pn;
                w = wn;
                e = en;
            }
        }
    }
    // a CTA leaves only when its peer no longer arrives on its barriers
    sad::cluster_sync();
}

// ---- launch 3: dB, clamp, standardize ----------------------------------------

// mel: [windows, n] float32 → out: [windows, n] float32, n = n_mels ·
// n_frames: the tail shared with the factored kernel, under a name of its
// own in a profile.
__global__ void __launch_bounds__(sad::TAIL_THREADS)
strip_tail_kernel(const float* __restrict__ mel, float* __restrict__ out, int n, float top_db,
                  float eps) {
    __shared__ float red[33];
    const size_t base = (size_t)blockIdx.x * n;
    float v[sad::TAIL_PER_THREAD];
#pragma unroll
    for (int k = 0; k < sad::TAIL_PER_THREAD; ++k) {
        const int idx = threadIdx.x + k * sad::TAIL_THREADS;
        v[k] = idx < n ? mel[base + idx] : 0.f;
    }
    sad::db_standardize_store(v, out + base, n, top_db, eps, 1, red);
}

cudaError_t launch_dft(const CUtensorMap& tmap_a, const CUtensorMap& tmap_b, const Params& p,
                       int n_bands, int tiles, cudaStream_t s) {
    cudaError_t e = cudaFuncSetAttribute(strip_dft_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_bands, tiles);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = CLUSTER;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, strip_dft_kernel, tmap_a, tmap_b, p);
}

}  // namespace

// x: [n_windows, T] float32; hann: [n_fft] float32; cs: [cs_rows, n_fft]
// bf16 (row 2f the cos of bin f, row 2f + 1 its sin); band_f0 [n_bands]
// int32 (ops/cuda_melspec_strip.band_plan); mel_w, mel_end, quads:
// ops/cuda_melspec.band_tables of those bands (local bin j = bin f0 + j);
// strips: [n_fft / hop, n_windows·nb, hop] bf16 scratch; mel: [n_windows,
// n_mels, n_frames] float32 scratch; out: the same shape, float32. Tensors
// 16-byte aligned. nb and n_frames must be the geometry of T: nb = ceil((T +
// n_fft) / hop), n_frames = 1 + T / hop. band_bins and tile_rows are the
// host's band and tile sizes, for which it planned the bands and counted the
// tiles; they must be BINS and ROWS. tiles must be a multiple of CLUSTER.
extern "C" int sad_melspec_strip(const void* x, const void* hann, const void* cs,
                                 const void* band_f0, const void* mel_w, const void* mel_end,
                                 const void* quads, void* strips, void* mel, void* out,
                                 int n_windows, int T, int n_fft, int hop, int nb, int n_frames,
                                 int n_bands, int cs_rows, int n_mels, int band_bins,
                                 int tile_rows, int tiles, float top_db, float eps,
                                 void* stream) {
    const int pad = n_fft / 2;
    if (band_bins != BINS || tile_rows != ROWS || n_windows <= 0 || hop <= 0 || hop % KSTEP != 0 || n_fft % hop != 0 || T <= pad ||
        n_bands <= 0 || n_bands > 65535 || cs_rows <= 0 || n_mels <= 0 ||
        reinterpret_cast<uintptr_t>(hann) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(cs) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(strips) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(mel_w) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(mel_end) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const int k = n_fft / hop;
    const long long padded = (long long)T + 2 * pad;
    const long long need = ((long long)(n_windows - 1) * nb + n_frames + ROWS - 1) / ROWS;
    if (nb != (padded + hop - 1) / hop || n_frames != 1 + T / hop || n_frames + k - 1 > nb ||
        (long long)n_mels * n_frames > sad::TAIL_THREADS * sad::TAIL_PER_THREAD ||
        tiles < need || tiles % CLUSTER != 0 || tiles > 65535 ||
        (long long)tiles * ROWS + k > 2147483647LL)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);

    const int row_len = nb * hop;
    const long long n8 = (long long)n_windows * row_len / 8;
    strip_bf16_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(hann),
        static_cast<__nv_bfloat16*>(strips), T, pad, hop, k, row_len, n8);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;

    // A: the strips as [k][n_windows·nb][hop], a box of 128 rows × 64
    // samples of one strip; B: cos|sin as [cs_rows][n_fft], a box of
    // COLS / CLUSTER rows × 64 samples
    alignas(64) CUtensorMap tmap_a, tmap_b;
    const cuuint64_t a_dims[3] = {(cuuint64_t)hop, (cuuint64_t)n_windows * nb, (cuuint64_t)k};
    const cuuint64_t a_strides[2] = {(cuuint64_t)hop * 2, (cuuint64_t)n_windows * nb * hop * 2};
    const cuuint32_t a_box[3] = {KSTEP, ROWS, 1};
    const cuuint64_t b_dims[2] = {(cuuint64_t)n_fft, (cuuint64_t)cs_rows};
    const cuuint64_t b_strides[1] = {(cuuint64_t)n_fft * 2};
    const cuuint32_t b_box[2] = {KSTEP, (cuuint32_t)(COLS / CLUSTER)};
    const cuuint32_t elem[3] = {1, 1, 1};
    int rc = sad::encode_bf16_sw128(&tmap_a, 3, strips, a_dims, a_strides, a_box, elem);
    if (rc != 0) return rc;
    rc = sad::encode_bf16_sw128(&tmap_b, 2, cs, b_dims, b_strides, b_box, elem);
    if (rc != 0) return rc;

    Params p;
    p.band_f0 = static_cast<const int*>(band_f0);
    p.mel_w = static_cast<const float4*>(mel_w);
    p.mel_end = static_cast<const int4*>(mel_end);
    p.quads = static_cast<const int*>(quads);
    p.mel = static_cast<float*>(mel);
    p.windows = n_windows;
    p.nb = nb;
    p.n_frames = n_frames;
    p.n_mels = n_mels;
    p.hop = hop;
    p.ksteps = n_fft / KSTEP;
    e = launch_dft(tmap_a, tmap_b, p, n_bands, tiles, s);
    if (e != cudaSuccess) return (int)e;
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;

    strip_tail_kernel<<<n_windows, sad::TAIL_THREADS, 0, s>>>(
        static_cast<const float*>(mel), static_cast<float*>(out), n_mels * n_frames, top_db, eps);
    return (int)cudaGetLastError();
}

extern "C" const char* sad_cuda_error_string(int code) { return sad::error_string(code); }
