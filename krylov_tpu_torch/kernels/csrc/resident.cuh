// The pieces the resident whole-solve kernels share: K2/K3
// (fused_resident.cu) and K5/K6 (fused_kskip_resident.cu).  Each block of
// kResThreads threads owns a band of rows for the whole solve (at most one
// block an SM); its solver state stays in registers and shared memory, and
// what crosses blocks (a partial sum, a total, an edge-row entry) travels
// as a step-tagged 16-byte Word (see the head of fused_resident.cu for the
// ordering argument of the sums, and of fused_kskip_resident.cu for that of
// the neighbour exchange).
//
// The pointwise arithmetic rounds as the plain PyTorch versions do: the
// _rn intrinsics below, which the compiler may not contract into FMAs.
#pragma once

#include <cuda_runtime.h>

#include "reduce.cuh"
#include "stencil.cuh"

namespace {

constexpr int kResThreads = 512;  // threads a block; kernels/fused.py RESIDENT_THREADS
constexpr int kResWarps = kResThreads / 32;
constexpr int kResSums = 3;       // most sums in one grid_allsum
constexpr int kGather = 5;        // partials a lane of a reducing warp loads
constexpr int kResMaxBlocks = 32 * kGather;  // kernels/fused.py RESIDENT_MAX_BLOCKS
static_assert(KRYLOV_MAX_TERMS <= 32, "a point's terms are a 32-bit mask");

// Pointwise arithmetic the compiler may not contract into FMAs.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// A value that crosses blocks and the step that wrote it.  Zero at launch:
// steps start at 1.
struct alignas(16) Word {
    unsigned long long bits;
    long long step;
};

__device__ __forceinline__ unsigned long long to_bits(double v) { return __double_as_longlong(v); }
__device__ __forceinline__ unsigned long long to_bits(float v) { return __float_as_uint(v); }
template <typename T>
__device__ __forceinline__ T from_bits(unsigned long long b);
template <>
__device__ __forceinline__ double from_bits<double>(unsigned long long b) {
    return __longlong_as_double(b);
}
template <>
__device__ __forceinline__ float from_bits<float>(unsigned long long b) {
    return __uint_as_float(static_cast<unsigned>(b));
}

template <typename T>
__device__ __forceinline__ void put_word(Word* p, T v, long long step) {
    asm volatile("st.relaxed.gpu.global.v2.b64 [%0], {%1, %2};" ::"l"(p), "l"(to_bits(v)), "l"(step)
                 : "memory");
}

__device__ __forceinline__ Word get_word(const Word* p) {
    Word w;
    asm volatile("ld.relaxed.gpu.global.v2.b64 {%0, %1}, [%2];"
                 : "=l"(w.bits), "=l"(w.step)
                 : "l"(p)
                 : "memory");
    return w;
}

__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// Most nanoseconds a K5/K6 block waits for a word before it traps: a
// wait of the resident route lasts microseconds, so a longer one is a fault
// (a block that left the loop early, a wrong step), and the trap ends the
// launch with an error instead of leaving the card spinning.
constexpr unsigned long long kWaitLimitNs = 10ull * 1000 * 1000 * 1000;

// Loads w[u] from p[u] (each u whose p[u] is not null) until it carries
// step `step` or later.  Each round reloads every word still pending, all
// loads in flight together, so a wait costs one L2 round trip a round and
// not one a stale word.
template <int N>
__device__ __forceinline__ void wait_words(Word (&w)[N], const Word* const (&p)[N], long long step) {
    unsigned pending = 0;
#pragma unroll
    for (int u = 0; u < N; ++u)
        if (p[u] != nullptr) pending |= 1u << u;
    unsigned long long t0 = 0;  // read at the 1024th round: a wait that short needs no clock
    for (unsigned spins = 1; pending; ++spins) {
#pragma unroll
        for (int u = 0; u < N; ++u)
            if (pending >> u & 1u) w[u] = get_word(p[u]);
#pragma unroll
        for (int u = 0; u < N; ++u)
            if ((pending >> u & 1u) && w[u].step >= step) pending &= ~(1u << u);
        if ((spins & 1023u) == 0) {
            if (t0 == 0) t0 = global_ns();
            else if (global_ns() - t0 > kWaitLimitNs) __trap();
        }
    }
}

// The rows a block owns: g0 rows split as evenly as the blocks allow
// (kernels/fused.py::band_rows computes the same split).
struct Band {
    int row0, rows;  // first row and row count
    int p0, p1;      // the flat points [p0, p1)
    int lo;          // the mirror's first row, row0 - h
    int hg;          // points in h rows
};

__device__ __forceinline__ Band band_of(const StencilGeom& g, int h) {
    const int base = g.g0 / gridDim.x, extra = g.g0 % gridDim.x;
    const int blk = blockIdx.x;
    Band bd;
    bd.rows = base + (blk < extra);
    bd.row0 = blk * base + min(blk, extra);
    bd.p0 = bd.row0 * g.g1;
    bd.p1 = bd.p0 + bd.rows * g.g1;
    bd.lo = bd.row0 - h;
    bd.hg = h * g.g1;
    return bd;
}

// The terms of point e whose neighbour lies on the grid (bit s: term s), by
// the boundary rules of apply_stencil (stencil.cuh), the sub mask included.
__device__ __forceinline__ unsigned term_mask(const StencilGeom& g, int e) {
    const int i0 = e / g.g1;
    const int i1 = e - i0 * g.g1;
    const int i2 = g.g2 > 0 ? i1 % g.g2 : 0;
    unsigned mask = 0;
    for (int s = 0; s < g.ns; ++s) {
        const int j0 = i0 + g.d0[s];
        const int j1 = i1 + g.d1[s];
        bool in = j0 >= 0 && j0 < g.g0 && j1 >= 0 && j1 < g.g1;
        if (g.g2 > 0 && g.d2[s] != 0) {
            const int c2 = i2 + g.d2[s];
            in = in && c2 >= 0 && c2 < g.g2;
        }
        mask |= unsigned(in) << s;
    }
    return mask;
}

// The stencil at the thread's PPT points, y[k] = sum_s coef_s(e) * x[e +
// (d0_s, d1_s)] over the terms of mask[k], added in stencil order, with x
// read from the block's shared-memory mirror xs.  The terms are a loop at
// run time, unrolled by two: unrolled in full, the compiler hoists every
// (term, point) address out of the solve's loop and spills them.  Each
// term's loads for all points go out before its products.  A term off the
// grid loads the point's own entry and adds nothing; a point past the band
// has mask 0 and gets 0.
template <typename T, int PPT>
__device__ __forceinline__ void stencil_band(const StencilGeom& g, const T* __restrict__ coef,
                                             const T* xs, const Band& bd,
                                             const unsigned (&mask)[PPT], T (&y)[PPT]) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) y[k] = T(0);
    if (g.is_const) {
#pragma unroll 2
        for (int s = 0; s < g.ns; ++s) {
            const int off = g.d0[s] * g.g1 + g.d1[s];
            const T c = __ldg(coef + s);
            T xv[PPT];
#pragma unroll
            for (int k = 0; k < PPT; ++k)
                xv[k] = xs[bd.hg + ((mask[k] >> s & 1u) ? threadIdx.x + k * kResThreads + off : 0)];
#pragma unroll
            for (int k = 0; k < PPT; ++k)
                if (mask[k] >> s & 1u) y[k] = add(y[k], mul(c, xv[k]));
        }
        return;
    }
    const long long n = (long long)g.g0 * g.g1;
#pragma unroll 2
    for (int s = 0; s < g.ns; ++s) {
        const int off = g.d0[s] * g.g1 + g.d1[s];
        const T* cs = coef + s * n + bd.p0;
        T xv[PPT], cv[PPT];
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
            const int local = threadIdx.x + k * kResThreads;
            const bool in = mask[k] >> s & 1u;
            xv[k] = xs[bd.hg + (in ? local + off : 0)];
            cv[k] = __ldg(cs + (in ? local : 0));
        }
#pragma unroll
        for (int k = 0; k < PPT; ++k)
            if (mask[k] >> s & 1u) y[k] = add(y[k], mul(cv[k], xv[k]));
    }
}

template <typename T, int K>
__device__ __forceinline__ void warp_allsum(T (&v)[K]) {
    // butterfly: lanes i and i ^ off add the same two values (a + b == b + a),
    // so every lane ends with the same bits
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = add(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
}

// The scratch of the grid sums: two sets of kResSums partial words a block
// and two sets of kResSums total words, zero at launch, and the number of
// sums so far, the same in every block.
struct Exchange {
    Word* partials;
    long long t;
};

// Grid-wide sums of v[k], and a grid barrier.  Each block sums its v[k] in
// a fixed order (a butterfly in each warp, then over the warps in warp 0)
// and publishes the block sums as words of step t in set t % 2.  Block 0
// reduces: its warp k loads every block's word k together (5 a lane) until
// all carry step t, sums them in block order (lane by lane, then a
// butterfly) and publishes the total as a word of step t.  The other blocks
// wait for the total words.  Every block so holds the same bits and takes
// the same branch, and one warp per sum, not every block, reads the
// partials.  wsum is kResSums * (kResWarps + 1) of shared memory.
template <typename T, int K>
__device__ void grid_allsum(Exchange& ex, T (&v)[K], T* wsum) {
    static_assert(K <= kResSums, "grid_allsum: too many sums");
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nb = gridDim.x;
    const long long t = ++ex.t;
    Word* set = ex.partials + (size_t)(t & 1) * kResSums * nb;
    Word* total = ex.partials + (size_t)2 * kResSums * nb + (t & 1) * kResSums;
    T* out = wsum + kResSums * kResWarps;
    warp_allsum(v);
    if (lane == 0)
#pragma unroll
        for (int k = 0; k < K; ++k) wsum[k * kResWarps + warp] = v[k];
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = lane < kResWarps ? wsum[k * kResWarps + lane] : T(0);
        warp_allsum(v);
#pragma unroll
        for (int k = 0; k < K; ++k)
            if (lane == k) put_word(set + k * nb + blockIdx.x, v[k], t);
    }
    if (blockIdx.x == 0) {
        if (warp < K) {
            T got[kGather];
            unsigned pending = 0;
#pragma unroll
            for (int u = 0; u < kGather; ++u)
                if (lane + 32 * u < nb) pending |= 1u << u;
            const Word* mine = set + warp * nb + lane;
            while (pending) {
                Word w[kGather];
#pragma unroll
                for (int u = 0; u < kGather; ++u)
                    if (pending >> u & 1u) w[u] = get_word(mine + 32 * u);
#pragma unroll
                for (int u = 0; u < kGather; ++u)
                    if ((pending >> u & 1u) && w[u].step >= t) {
                        got[u] = from_bits<T>(w[u].bits);
                        pending &= ~(1u << u);
                    }
            }
            T s[1] = {lane < nb ? got[0] : T(0)};
#pragma unroll
            for (int u = 1; u < kGather; ++u)
                if (lane + 32 * u < nb) s[0] = add(s[0], got[u]);
            warp_allsum(s);
            if (lane == 0) {
                put_word(total + warp, s[0], t);
                out[warp] = s[0];
            }
        }
    } else if (warp == 0 && lane < K) {
        Word w;
        do w = get_word(total + lane); while (w.step < t);
        out[lane] = from_bits<T>(w.bits);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = out[k];
}

// The scratch of the bundle sums (K5/K6): two sets of `cap` partial words a
// block and two sets of `cap` totals, zero at launch, and the number of
// bundle sums so far, the same in every block.
struct BundleExchange {
    Word* partials;
    int cap;
    long long t;
};

// Grid-wide sums of m <= cap entries whose per-warp sums wait in shared
// memory (wsum[j * kResWarps + w]: entry j of warp w), into out[0..m) of
// every block, with the same bits in every block: grid_allsum for any m.
// Each block adds an entry's warp sums in warp order (thread j: entry j)
// and publishes the block sum as a word of step t in set t % 2.  The
// entries are spread over the blocks: warp (j / nb) % kResWarps of block
// j % nb gathers every block's word of entry j (5 a lane), adds them in
// block order as grid_allsum does and publishes the total as a word of
// step t; then every block loads the m totals.  Total j is formed once,
// by one warp, so all blocks hold the same bits.  The ordering argument is
// grid_allsum's, for this sequence of sums alone: a block writes sum t +
// 2's partials only after it has read every total of sum t + 1, which each
// gathering warp formed after it had read its partials of sum t; m may
// only shrink along the sequence (adaptive K5 lowers k), so an entry that
// drops out is never written again.  Ends with a __syncthreads, after
// which out holds the totals.
template <typename T>
__device__ void bundle_allsum(BundleExchange& ex, int m, const T* wsum, T* out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nb = gridDim.x;
    const long long t = ++ex.t;
    Word* set = ex.partials + (size_t)(t & 1) * ex.cap * nb;
    Word* total = ex.partials + (size_t)2 * ex.cap * nb + (t & 1) * ex.cap;
    __syncthreads();  // every warp's sums are in wsum
    for (int j = threadIdx.x; j < m; j += kResThreads) {
        T s = wsum[j * kResWarps];
#pragma unroll
        for (int w = 1; w < kResWarps; ++w) s = add(s, wsum[j * kResWarps + w]);
        put_word(set + (size_t)j * nb + blockIdx.x, s, t);
    }
    for (int j = blockIdx.x + nb * warp; j < m; j += nb * kResWarps) {
        const Word* mine = set + (size_t)j * nb + lane;
        Word w[kGather];
        const Word* src[kGather];
#pragma unroll
        for (int u = 0; u < kGather; ++u) src[u] = lane + 32 * u < nb ? mine + 32 * u : nullptr;
        wait_words(w, src, t);
        T s[1] = {lane < nb ? from_bits<T>(w[0].bits) : T(0)};
#pragma unroll
        for (int u = 1; u < kGather; ++u)
            if (lane + 32 * u < nb) s[0] = add(s[0], from_bits<T>(w[u].bits));
        warp_allsum(s);
        if (lane == 0) put_word(total + j, s[0], t);
    }
    for (int j = threadIdx.x; j < m; j += kResThreads) {
        Word w[1];
        const Word* src[1] = {total + j};
        wait_words(w, src, t);
        out[j] = from_bits<T>(w[0].bits);
    }
    __syncthreads();
}

// Loads b into the mirror (band and halo rows that lie on the grid).
template <typename T>
__device__ __forceinline__ void mirror_from(T* xs, const T* __restrict__ b, const StencilGeom& g,
                                            const Band& bd) {
    const int len = bd.rows * g.g1 + 2 * bd.hg;
    for (int j = threadIdx.x; j < len; j += kResThreads) {
        const int row = bd.lo + j / g.g1;
        if (row >= 0 && row < g.g0) xs[j] = __ldg(b + (long long)bd.lo * g.g1 + j);
    }
}

}  // namespace
