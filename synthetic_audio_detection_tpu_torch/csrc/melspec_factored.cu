// Factored-DFT log-mel front end for Hopper (sm_90a).
//
// Replaces the TPU kernel synthetic_audio_detection_tpu/ops/pallas_melspec.py
// :_factored_kernel (entries fused_log_mel_factored / serving_log_mel) with
// standardize and lowp_tail as flags: [B, T] windows → [B, n_mels, n_frames].
// With n_fft = 4·hop, frame t of a window is hop blocks t … t+3 of the
// centre-padded signal, and X_t[f] = Σ_i c_i[f]·Y[t+i, f], Y[h, f] the DFT of
// block h at the n_fft-point frequencies (bf16 operands, float32
// accumulation) and c_i[f] = (−j)^(i·(f mod 4)). The periodic Hann is the
// 3-tap conv W[f] = 0.5·X[f] − 0.25·(X[f−1] + X[f+1]) with X[−1] = conj(X[1]);
// bin n_sig is a guard bin (a real DFT value) for the last bin's f+1 tap.
// power = |W|², mel = power · fb in float32 (both rounded to bf16 under
// lowp_tail), then dB, the top_db clamp and the standardization.
//
// What bounds it, at [128, 128000] (254 hop blocks and 251 frames a window,
// 768 bins with mel weight, 1,514 filterbank nonzeros): the block DFT on the
// tensor cores, 61.3 GFLOP of bf16 with this tiling's halos (51.2 without),
// 0.062 ms at 989 TFLOP/s; 65.5 MB of waveforms in and 16.4 MB of z-scores
// out take 0.025 ms at 3.35 TB/s. The design keeps every intermediate but a
// mel-sized plane out of device memory: no Y, frame or power scratch. One
// call runs three launches on the caller's stream:
//
//   1. pad_bf16_kernel  the reflect pad of n_fft/2 on both sides, the zero
//      tail to a hop multiple and the one rounding to bf16 that the JAX
//      kernel applies to the same values: the DFT's A operand, bf16 hop
//      blocks [B·nb, hop] (int16 PCM is dequantized on the way).
//   2. dft_mel_kernel  one block per (band of bins, tile of 128 hop blocks).
//      Tiles run over all windows' blocks back to back, 125 apart, so each
//      yields 125 frames (the 3 blocks of overlap are the frames' halo; a
//      window's last three blocks start no frame and are skipped). A band
//      is 128 bins f0−1 … f0+126 as 256 interleaved columns (column 2j the
//      cos of bin f0−1+j over the block's samples, 2j+1 its sin; "bin −1"
//      holds conj(bin 1), so X[−1] needs no special case) and has power for
//      its 126 inner bins. The host's band plan (ops/cuda_melspec.band_plan)
//      puts each mel's whole span of bins in one band, so a band completes
//      the mels it owns and no partial sum crosses blocks, and starts bands
//      at f0 ≡ 1 (mod 4), so local bin j has the phases of j mod 4.
//      Mainloop: Y [128, 256] = A·Bᵀ, K = hop, on wgmma m64n256k16, two
//      consumer warpgroups of 64 rows each; A and B stream through a
//      4-stage ring filled by TMA (one producer thread, 128-byte swizzle;
//      rows past the last block and bins outside the table are zero-filled
//      by the TMA). The band's mel tables go to shared memory meanwhile.
//      Epilogue, in shared memory over the ring: Y staged in float32; each
//      warp takes 16 frames, each lane 4 adjacent bins (compile-time
//      phases), forms X_t, takes the Hann taps across lanes by shuffles
//      and writes the power (bf16-rounded under lowp_tail) to a power
//      plane; then each thread keeps, for one frame, one running sum over
//      the band's bins for its even mels (warpgroup 0) or its odd ones
//      (warpgroup 1) — a triangle's support ends where the next but one
//      begins, so the mels of one parity never share a bin — and stores a
//      mel's sum at its last bin: one multiply-add per filterbank nonzero
//      but for the few bins that round a parity's bins out to groups of 4
//      (1,564 for 1,514 a frame at the defaults). Every mel cell is written
//      once, in a fixed order, with no atomics: repeated runs give
//      identical bits.
//   3. db_standardize_kernel  one 1024-thread block per window runs the
//      tail shared with the strip kernel (melspec_tail.cuh).
//
// On an H100 the DFT mainloop runs near the tensor cores' rate; the
// epilogue, which keeps the tensor cores idle (one block per SM: the ring
// and the epilogue share its shared memory), and the pre-pass take most of
// the rest (PERF.md).
//
// The kernel allocates nothing: the caller passes the bf16 blocks, the mel
// plane and the output. sad_melspec_factored returns cudaErrorInvalidValue
// for shapes it does not take, −CUresult if encoding a tensor map failed,
// else the first cudaGetLastError() after a launch (sad_cuda_error_string
// names either).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "melspec_tail.cuh"
#include "tma_sm90.cuh"
#include "wgmma_bf16.cuh"

namespace {

// ---- launch 1: reflect pad, zero tail, bf16 ---------------------------------

__device__ __forceinline__ float sample(const float* x, int i) { return x[i]; }
__device__ __forceinline__ float sample(const int16_t* x, int i) {
    return (float)x[i] / 32768.f;
}

// x: [windows, T]; blocks: [windows, row_len] bf16, row_len = nb·hop (a
// multiple of 8). Sample p of a row is x[p − pad] reflected at both edges
// (numpy's 'reflect': the edge sample is not repeated) for p < T + 2·pad,
// else 0. n8: the number of 8-sample groups of all rows.
template <typename InT>
__global__ void __launch_bounds__(256)
pad_bf16_kernel(const InT* __restrict__ x, __nv_bfloat16* __restrict__ blocks, int T, int pad,
                int row_len, long long n8) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n8) return;
    const long long e = i * 8;
    const int b = (int)(e / row_len);
    const int p0 = (int)(e - (long long)b * row_len);
    const InT* xb = x + (size_t)b * T;
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        int s = p0 + k - pad;
        float f = 0.f;
        if (s < T + pad) {
            s = s < 0 ? -s : (s >= T ? 2 * (T - 1) - s : s);
            f = sample(xb, s);
        }
        v[k] = __float2bfloat16_rn(f);
    }
    *reinterpret_cast<uint4*>(blocks + e) = *reinterpret_cast<const uint4*>(v);
}

// ---- launch 2: block DFT on wgmma, frames, Hann, power, sparse mel ----------

constexpr int ROWS = 128;           // hop blocks a tile: two consumer warpgroups × 64
constexpr int FRAMES = ROWS - 3;    // frames a tile: frame t reads blocks t … t+3
constexpr int BINS = 128;           // bins a band: f0 − 1 … f0 + 126
constexpr int COLS = 2 * BINS;      // interleaved cos/sin columns: wgmma's N
constexpr int KSTEP = 64;           // samples a stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int THREADS = 384;        // producer warpgroup + two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int A_BYTES = ROWS * 128;
constexpr int B_BYTES = COLS * 128;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
// The epilogue's shared memory, over the ring: Y [ROWS][YS] float32 (8
// floats of row padding, so a half-warp's float2 stores to 4 rows hit 32
// banks), then the power plane: local bin j = 4·Q + s of frame t at
// s·QS + Q·PS + t (PS odd, so the 32 lanes' stores of one slot, and the
// reads of 32 frames of one bin, hit 32 banks).
constexpr int YS = COLS + 8;
constexpr int PS = FRAMES + 4;
constexpr int QS = BINS / 4 * PS;
constexpr int Y_BYTES = ROWS * YS * 4;
constexpr int P_BYTES = BINS * PS * 4;
constexpr int WORK_BYTES = RING_BYTES > Y_BYTES + P_BYTES ? RING_BYTES : Y_BYTES + P_BYTES;
// the band's mel tables (weights, then ends, of both parities), copied to
// shared memory while the first stage loads
constexpr int TAB_QUADS = 2 * BINS / 4;
constexpr int TAB_BYTES = 2 * TAB_QUADS * 16;
// 1024 bytes of slack to align the ring for the swizzle, the tables, then
// the barriers
constexpr int SMEM = 1024 + WORK_BYTES + TAB_BYTES + 2 * STAGES * 8;
// the power pass: each consumer warp takes FRUN frames, its lane L bins
// 4L … 4L + 3
constexpr int FRUN = 16;
static_assert(CONSUMERS / 32 * FRUN >= FRAMES && BINS == 4 * 32, "power-pass tiling");

struct Params {
    const int* band_f0;     // [bands]: band k has power for bins band_f0[k] … + BINS − 3
    const float4* mel_w;    // [bands, 2, BINS / 4]: ops/cuda_melspec.band_tables' weights,
    const int4* mel_end;    // ends (mel whose last bin a local bin is, or −1)
    const int* quads;       // and quads [bands, 2, 2] of the even (0) and odd (1) mels
    float* mel;             // [windows, n_mels, n_frames]
    int windows, nb, n_frames, n_mels, ksteps, lowp;
};

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// the two consumer warpgroups only (the producer warpgroup has left)
__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// (re, im) += c·v for c = (−j)^K
template <int K>
__device__ __forceinline__ void add_term(float& re, float& im, float2 v) {
    if constexpr (K == 0) {
        re += v.x;
        im += v.y;
    } else if constexpr (K == 1) {
        re += v.y;
        im -= v.x;
    } else if constexpr (K == 2) {
        re -= v.x;
        im -= v.y;
    } else {
        re -= v.y;
        im += v.x;
    }
}

// X = y0 + c1·y1 + c2·y2 + c3·y3 with c_i = (−j)^(i·q) for a bin f ≡ q
// (mod 4), summed in the plain version's order
template <int Q>
__device__ __forceinline__ float2 combine(float2 y0, float2 y1, float2 y2, float2 y3) {
    float re = y0.x, im = y0.y;
    add_term<(1 * Q) & 3>(re, im, y1);
    add_term<(2 * Q) & 3>(re, im, y2);
    add_term<(3 * Q) & 3>(re, im, y3);
    return make_float2(re, im);
}

// Y of a lane's 4 bins in one row: (re, im) of bins 4L, 4L + 1 in lo, of
// 4L + 2, 4L + 3 in hi
struct Quad {
    float4 lo, hi;
};

__device__ __forceinline__ Quad load_quad(const float* row) {
    const float4* q = reinterpret_cast<const float4*>(row);
    return {q[0], q[1]};
}

template <int S>
__device__ __forceinline__ float2 slot(const Quad& q) {
    if constexpr (S == 0) return make_float2(q.lo.x, q.lo.y);
    else if constexpr (S == 1) return make_float2(q.lo.z, q.lo.w);
    else if constexpr (S == 2) return make_float2(q.hi.x, q.hi.y);
    else return make_float2(q.hi.z, q.hi.w);
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

// a: the bf16 blocks [windows·nb, hop]; b: the interleaved cos|sin [rows, hop]
// (row 2·(f + 1) the cos of bin f, row 2·(f + 1) + 1 its sin, f ≥ −1).
__global__ void __launch_bounds__(THREADS, 1)
dft_mel_kernel(const __grid_constant__ CUtensorMap tmap_a,
               const __grid_constant__ CUtensorMap tmap_b, const Params p) {
    extern __shared__ uint8_t smem_raw[];
    // 128-byte swizzle repeats every 1024 bytes of shared address
    const uint32_t raw = sad::smem_u32(smem_raw);
    const uint32_t ring = (raw + 1023u) & ~1023u;
    uint8_t* work = smem_raw + (ring - raw);
    float4* tab_w = reinterpret_cast<float4*>(work + WORK_BYTES);
    int4* tab_end = reinterpret_cast<int4*>(work + WORK_BYTES) + TAB_QUADS;
    const uint32_t full = ring + WORK_BYTES + TAB_BYTES;  // STAGES barriers, then STAGES "empty"
    const uint32_t empty = full + STAGES * 8;
    const int band = blockIdx.x;
    const int row0 = blockIdx.y * FRAMES;  // the tile's first block, counted over all windows
    const int f0 = __ldg(p.band_f0 + band);

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            sad::mbar_init(full + 8 * s, 1);   // the producer's arrive + the TMA bytes
            sad::mbar_init(empty + 8 * s, 2);  // one arrive per consumer warpgroup
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x < 128) {
        // ---- producer: one thread streams the K-steps through the ring ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == 0) {
            for (int k = 0; k < p.ksteps; ++k) {
                const int s = k % STAGES;
                const uint32_t stage = ring + s * STAGE_BYTES;
                sad::mbar_wait(empty + 8 * s, ((k / STAGES) & 1) ^ 1);
                sad::mbar_expect_tx(full + 8 * s, STAGE_BYTES);
                sad::tma_load_2d(stage, &tmap_a, full + 8 * s, k * KSTEP, row0);
                sad::tma_load_2d(stage + A_BYTES, &tmap_b, full + 8 * s, k * KSTEP, 2 * f0);
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
            sad::wgmma_wait<1>();
            if (k > 0 && signaller) sad::mbar_arrive(empty + 8 * ((k - 1) % STAGES));
        }
        sad::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < COLS / 2; ++i) sad::fence_operand(acc[i]);

        // Y to shared memory, over the ring both warpgroups have finished
        // reading: row r, column c (c = 2j + e: bin f0 − 1 + j, e = re / im)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumers_sync();
        float* ys = reinterpret_cast<float*>(work);
        {
            const int r = cw * 64 + warp * 16 + (lane >> 2);
            const int c = 2 * (lane & 3);
#pragma unroll
            for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    *reinterpret_cast<float2*>(ys + (r + 8 * h) * YS + 8 * j + c) =
                        make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
        consumers_sync();

        // frames, the Hann taps and the power of local bin j = 4·L + s (bin
        // f0 − 1 + j ≡ s mod 4, as the band plan's f0 ≡ 1 makes it: the
        // phases of slot s are compile-time) in lane L, frames t0 … t0 + 15
        // in each warp; the taps across lanes by shuffles
        float* pw = reinterpret_cast<float*>(work + Y_BYTES);
        {
            const int t0 = (ct >> 5) * FRUN;
            const float* yl = ys + 8 * lane;
            Quad r0 = load_quad(yl + t0 * YS), r1 = load_quad(yl + (t0 + 1) * YS),
                 r2 = load_quad(yl + (t0 + 2) * YS);
            // unrolled, so several frames' loads and shuffles are in flight;
            // frames past the tile read its last row and store nothing
#pragma unroll
            for (int dt = 0; dt < FRUN; ++dt) {
                const int t = t0 + dt;
                const Quad r3 = load_quad(yl + min(t + 3, ROWS - 1) * YS);
                float2 x[4];
                x[0] = combine<0>(slot<0>(r0), slot<0>(r1), slot<0>(r2), slot<0>(r3));
                x[1] = combine<1>(slot<1>(r0), slot<1>(r1), slot<1>(r2), slot<1>(r3));
                x[2] = combine<2>(slot<2>(r0), slot<2>(r1), slot<2>(r2), slot<2>(r3));
                x[3] = combine<3>(slot<3>(r0), slot<3>(r1), slot<3>(r2), slot<3>(r3));
                // X[4L − 1] from the lane below, X[4L + 4] from the lane above
                // (lanes 0 and 31 get their own: local bins 0 and 127 are
                // the band's halo, whose power no mel weighs)
                const float2 xl = make_float2(__shfl_up_sync(0xffffffffu, x[3].x, 1),
                                              __shfl_up_sync(0xffffffffu, x[3].y, 1));
                const float2 xr = make_float2(__shfl_down_sync(0xffffffffu, x[0].x, 1),
                                              __shfl_down_sync(0xffffffffu, x[0].y, 1));
#pragma unroll
                for (int s = 0; s < 4; ++s) {
                    const float2 l = s == 0 ? xl : x[s - 1];
                    const float2 r = s == 3 ? xr : x[s + 1];
                    // W = 0.5·X − 0.25·(X[f−1] + X[f+1]) = (2·X − (X[f−1] + X[f+1])) / 4
                    // and |W|² = (ur² + ui²) / 16: scaling by powers of 2 is
                    // exact, so these are the plain version's roundings
                    const float ur = fmaf(2.f, x[s].x, -__fadd_rn(l.x, r.x));
                    const float ui = fmaf(2.f, x[s].y, -__fadd_rn(l.y, r.y));
                    float pv = 0.0625f * __fadd_rn(__fmul_rn(ur, ur), __fmul_rn(ui, ui));
                    if (p.lowp) pv = round_bf16(pv);
                    if (t < FRAMES) pw[s * QS + lane * PS + t] = pv;
                }
                r0 = r1;
                r1 = r2;
                r2 = r3;
            }
        }
        consumers_sync();

        // the sparse mel product: warpgroup cw sums the band's mels of
        // parity cw, one thread per frame, as one running sum over the
        // parity's bins in order (one multiply-add per filterbank weight,
        // and one for each of the few bins inside its groups of 4 that no
        // mel of the parity weighs); a mel's sum is stored at its last bin
        const int t = ct & 127;
        const int row = row0 + t;  // the frame's first block
        const int b = row / p.nb, tb = row - b * p.nb;
        // not a frame's first block: past the tile, a window's last 3 blocks, past the batch
        if (t < FRAMES && b < p.windows && tb < p.n_frames) {
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
}

// ---- launch 3: dB, clamp, standardize ----------------------------------------

// mel: [windows, n] float32, out: [windows, n] OutT, n = n_mels · n_frames
// (the same layout).
template <typename OutT>
__global__ void __launch_bounds__(sad::TAIL_THREADS)
db_standardize_kernel(const float* __restrict__ mel, OutT* __restrict__ out, int n,
                      float top_db, float eps, int standardize) {
    __shared__ float red[33];
    const size_t base = (size_t)blockIdx.x * n;
    float v[sad::TAIL_PER_THREAD];
#pragma unroll
    for (int k = 0; k < sad::TAIL_PER_THREAD; ++k) {
        const int idx = threadIdx.x + k * sad::TAIL_THREADS;
        v[k] = idx < n ? mel[base + idx] : 0.f;
    }
    sad::db_standardize_store(v, out + base, n, top_db, eps, standardize, red);
}

}  // namespace

// x: [n_windows, T] float32, or int16 PCM with x_int16; cs: [cs_rows, hop]
// bf16, 16-byte aligned (ops/cuda_melspec.dft_rows); band_f0 [n_bands] int32
// (ops/cuda_melspec.band_plan, f0 ≡ 1 mod 4); mel_w, mel_end, quads:
// ops/cuda_melspec.band_tables (the weights rounded to bf16 for lowp_tail),
// 16-byte aligned; blocks: [n_windows·nb, hop] bf16 scratch, 16-byte
// aligned; mel: [n_windows, n_mels, n_frames] float32 scratch; out: the
// same shape, bf16 with lowp_tail, else float32. nb and n_frames must be the
// geometry of T: nb = ceil((T + n_fft) / hop), n_frames = 1 + T / hop.
// band_bins and tile_rows are the host's band and tile sizes, for which it
// planned the bands and counted the tiles; they must be BINS and ROWS.
extern "C" int sad_melspec_factored(const void* x, int x_int16, const void* cs,
                                    const void* band_f0, const void* mel_w, const void* mel_end,
                                    const void* quads, void* blocks, void* mel, void* out,
                                    int n_windows, int T, int n_fft, int hop, int nb,
                                    int n_frames, int n_bands, int cs_rows, int n_mels,
                                    int band_bins, int tile_rows, float top_db, float eps,
                                    int standardize, int lowp_tail, void* stream) {
    const int pad = n_fft / 2;
    if (band_bins != BINS || tile_rows != ROWS || n_windows <= 0 || hop <= 0 ||
        hop % KSTEP != 0 || n_fft != 4 * hop || T <= pad ||
        n_bands <= 0 || n_bands > 65535 || cs_rows <= 0 || n_mels <= 0 ||
        reinterpret_cast<uintptr_t>(blocks) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(cs) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(mel_w) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(mel_end) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const long long padded = (long long)T + 2 * pad;
    const long long tiles = ((long long)(n_windows - 1) * nb + n_frames + FRAMES - 1) / FRAMES;
    if (nb != (padded + hop - 1) / hop || n_frames != 1 + T / hop || n_frames + 3 > nb ||
        (long long)n_mels * n_frames > sad::TAIL_THREADS * sad::TAIL_PER_THREAD ||
        tiles > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);

    const int row_len = nb * hop;
    const long long n8 = (long long)n_windows * row_len / 8;
    const unsigned g1 = (unsigned)((n8 + 255) / 256);
    if (x_int16)
        pad_bf16_kernel<<<g1, 256, 0, s>>>(static_cast<const int16_t*>(x),
                                           static_cast<__nv_bfloat16*>(blocks), T, pad, row_len,
                                           n8);
    else
        pad_bf16_kernel<<<g1, 256, 0, s>>>(static_cast<const float*>(x),
                                           static_cast<__nv_bfloat16*>(blocks), T, pad, row_len,
                                           n8);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;

    // A: the blocks as [n_windows·nb][hop], a box of 128 blocks × 64 samples;
    // B: cos|sin as [cs_rows][hop], a box of 256 rows (one band) × 64 samples
    alignas(64) CUtensorMap tmap_a, tmap_b;
    const cuuint64_t a_dims[2] = {(cuuint64_t)hop, (cuuint64_t)n_windows * nb};
    const cuuint64_t b_dims[2] = {(cuuint64_t)hop, (cuuint64_t)cs_rows};
    const cuuint64_t strides[1] = {(cuuint64_t)hop * 2};
    const cuuint32_t a_box[2] = {KSTEP, ROWS};
    const cuuint32_t b_box[2] = {KSTEP, COLS};
    const cuuint32_t elem[2] = {1, 1};
    int rc = sad::encode_bf16_sw128(&tmap_a, 2, blocks, a_dims, strides, a_box, elem);
    if (rc != 0) return rc;
    rc = sad::encode_bf16_sw128(&tmap_b, 2, cs, b_dims, strides, b_box, elem);
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
    p.ksteps = hop / KSTEP;
    p.lowp = lowp_tail;
    e = cudaFuncSetAttribute(dft_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    dft_mel_kernel<<<dim3(n_bands, (unsigned)tiles), THREADS, SMEM, s>>>(tmap_a, tmap_b, p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;

    const float* mel_f = static_cast<const float*>(mel);
    if (lowp_tail)
        db_standardize_kernel<<<n_windows, sad::TAIL_THREADS, 0, s>>>(
            mel_f, static_cast<__nv_bfloat16*>(out), n_mels * n_frames, top_db, eps, standardize);
    else
        db_standardize_kernel<<<n_windows, sad::TAIL_THREADS, 0, s>>>(
            mel_f, static_cast<float*>(out), n_mels * n_frames, top_db, eps, standardize);
    return (int)cudaGetLastError();
}

extern "C" const char* sad_cuda_error_string(int code) { return sad::error_string(code); }
