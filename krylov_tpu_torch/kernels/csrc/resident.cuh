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
static_assert(KRYLOV_MAX_TERMS <= 30, "a point's terms are the low bits of a 32-bit mask");

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
// read from the block's shared-memory mirror xs: the masked pass, for any
// stencil (K4's NS = 0; stencil_pass below).  The terms are a loop at
// run time, unrolled by two: unrolled in full, the compiler hoists every
// (term, point) address out of the solve's loop and spills them.  Each
// term's loads for all points go out before its products.  A term off the
// grid loads the band's first entry and adds nothing; a point past the band
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

// K4, the resident stencil pass (replaces the stencil application of
// krylov_tpu/kernels/fused.py::_apply_stencil inside K2/K3/K5/K6).  Its
// data are on chip, the mirror in shared memory, so its bound is the
// shared-memory bytes: NS loads a point, 128 bytes a clock an SM.  What
// the masked pass above spends beside those loads, and what the pass
// specialised on the term count NS does about it:
//  - a weight loaded a term a pass, and the offset d0 g1 + d1 formed: both
//    arrive as kernel arguments (Terms), uniform operands;
//  - the term loop at run time, unrolled by two: NS is a template argument,
//    so the loop unrolls in full;
//  - a select a term and a point for the load's index: a term off the grid
//    is not loaded at all, its load and its add predicated on the term's
//    bit (kPredicated); or, where the registers allow, a slice k of a warp
//    whose 32 points all have every term on the grid (kSliceFull; at
//    N = 250k all but the slices that hold a row's ends or a grid edge)
//    loads its terms with no test and G points' loads go out before their
//    adds (SHAPE = G), the other slices predicated.
// The second form spends fewer instructions but more registers, and most
// resident kernels sit at the 128-register cap, where it spills.  Each
// kernel takes the form kPassShape names for it, and the masked pass's own
// body (kMasked) where no specialised form both ran faster and spilled no
// more.  The term addresses and the term tests are formed each pass
// from a base and masks the optimiser cannot see through (the masks in
// place, so no copy takes a register): hoisted out of the solve loop, the
// PPT x NS of each would hold registers for the whole solve and spill.
// Every point adds its terms from 0 in stencil order with the _rn mul and
// add, skipping a term off the grid, as the masked pass does, so the two
// give the same bits (tests/test_torch_cuda.py, chip_smoke.py).  NS = 0
// is the masked pass, for the grid-coefficient form and other term
// counts; kernels/fused.py::pass_terms picks NS.

// The constant form's weights and flat offsets d0 g1 + d1, by value in the
// kernel's arguments (filled once by the launcher, from the host copy of
// the weights that K1 keeps), read by the specialised pass.
template <typename T>
struct Terms {
    T w[KRYLOV_MAX_TERMS];
    int off[KRYLOV_MAX_TERMS];
};

// The launcher's Terms: offsets from the geometry, weights (ns doubles,
// or null for the grid form) cast to T.
template <typename T>
inline Terms<T> make_terms(const StencilGeom& g, const double* weights) {
    Terms<T> tm{};
    for (int s = 0; s < g.ns; ++s) {
        tm.off[s] = g.d0[s] * g.g1 + g.d1[s];
        tm.w[s] = weights ? static_cast<T>(weights[s]) : T(0);
    }
    return tm;
}

// The index of the launch's specialisation among those the build holds (0:
// NS = 0, 1: NS = 5, 2: NS = 7), or -1 where the pass cannot take ns_pass:
// NS > 0 needs the constant form with NS terms and its weights.
inline int pass_index(const StencilGeom& g, int ns_pass, const double* weights) {
    if (ns_pass == 0) return 0;
    if ((ns_pass != 5 && ns_pass != 7) || !g.is_const || g.ns != ns_pass || weights == nullptr) return -1;
    return ns_pass == 5 ? 1 : 2;
}

// A thread's PPT points, worked out once before the solve loop: mask[k]
// holds point k's terms on the grid (bit s: term s; none past the band) and
// two flags of the warp's slice k, the same in every lane: kSliceFull (every
// lane's point k has all its terms on the grid) and kSliceLive (some lane's
// point k lies in the band).  The flags ride in bits no term uses, so they
// take no register of their own; the masked pass (NS = 0) gets none.  Every
// thread of the block must call it.
// The specialised pass takes the masks by reference and marks them
// rewritten each pass (stencil_pass), so a kernel keeps its Points
// mutable.
constexpr unsigned kSliceFull = 1u << 31;
constexpr unsigned kSliceLive = 1u << 30;

template <int PPT>
struct Points {
    unsigned mask[PPT];
};

template <int PPT, int NS>
__device__ __forceinline__ Points<PPT> band_points(const StencilGeom& g, const Band& bd) {
    Points<PPT> pt;
    const unsigned all = (1u << g.ns) - 1u;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
        const int e = bd.p0 + threadIdx.x + k * kResThreads;
        const unsigned m = e < bd.p1 ? term_mask(g, e) : 0u;
        pt.mask[k] = m;
        if constexpr (NS > 0)  // the masked pass reads no flag
            pt.mask[k] |= (__all_sync(0xffffffffu, m == all) ? kSliceFull : 0u) |
                          (__any_sync(0xffffffffu, m != 0u) ? kSliceLive : 0u);
    }
    return pt;
}

// The forms of the specialised pass (stencil_pass's SHAPE): kPredicated,
// one point at a time, each term's load and add predicated on its bit; G
// in 1..PPT, G points at a time, a slice whose points have every term on
// the grid loading them with no test, their G x NS loads before their adds;
// or kMasked, the masked pass's body (stencil_band, which reads no flag
// bit: they lie above every term's).
constexpr int kPredicated = 0;
constexpr int kMasked = -1;

// K4: y[k] at the thread's PPT points from the mirror xs, specialised on
// NS terms (5, 7; 0: the masked pass) in the form SHAPE.
template <typename T, int PPT, int NS, int SHAPE>
__device__ __forceinline__ void stencil_pass(const StencilGeom& g, const T* __restrict__ coef, const Terms<T>& tm,
                                             const T* xs, const Band& bd, Points<PPT>& pt, T (&y)[PPT]) {
    if constexpr (NS == 0 || SHAPE == kMasked) {
        stencil_band(g, coef, xs, bd, pt.mask, y);
    } else {
        int base = bd.hg + static_cast<int>(threadIdx.x);
        unsigned(&m)[PPT] = pt.mask;
        asm volatile("" : "+r"(base));  // formed anew each pass (see above)
#pragma unroll
        for (int k = 0; k < PPT; ++k) asm volatile("" : "+r"(m[k]));
        if constexpr (SHAPE == kPredicated) {
#pragma unroll
            for (int k = 0; k < PPT; ++k) {
                const int q = base + k * kResThreads;
                T acc = T(0);
                if (m[k] & kSliceLive) {
#pragma unroll
                    for (int s = 0; s < NS; ++s)
                        if (m[k] >> s & 1u) acc = add(acc, mul(tm.w[s], xs[q + tm.off[s]]));
                }
                y[k] = acc;
            }
        } else {
            constexpr int G = SHAPE < PPT ? SHAPE : PPT;
            static_assert(G >= 1 && PPT % G == 0, "stencil_pass: G must divide PPT");
#pragma unroll
            for (int k0 = 0; k0 < PPT; k0 += G) {
                T xv[G][NS];
#pragma unroll
                for (int j = 0; j < G; ++j) {
                    const int k = k0 + j;
                    const int q = base + k * kResThreads;
                    if (m[k] & kSliceFull) {
#pragma unroll
                        for (int s = 0; s < NS; ++s) xv[j][s] = xs[q + tm.off[s]];
                    } else if (m[k] & kSliceLive) {
#pragma unroll
                        for (int s = 0; s < NS; ++s)
                            if (m[k] >> s & 1u) xv[j][s] = xs[q + tm.off[s]];
                    }
                }
#pragma unroll
                for (int j = 0; j < G; ++j) {
                    const int k = k0 + j;
                    T acc = T(0);
                    if (m[k] & kSliceFull) {
#pragma unroll
                        for (int s = 0; s < NS; ++s) acc = add(acc, mul(tm.w[s], xv[j][s]));
                    } else if (m[k] & kSliceLive) {
#pragma unroll
                        for (int s = 0; s < NS; ++s)
                            if (m[k] >> s & 1u) acc = add(acc, mul(tm.w[s], xv[j][s]));
                    }
                    y[k] = acc;
                }
            }
        }
    }
}

// The form of K4's pass in kernel K (2, 3, 5, 6: K2/K3/K5/K6) at (T, PPT,
// NS), from readings on an H100 (PERF.md, the K4 findings).  The main
// path's instances (4 points a thread, NS 5) take a specialised form only
// where their solves beat the masked pass's in 9 of 10 alternating pairs,
// the medians further apart than the masked pass's own quartiles
// (two builds' solves timed in turns on one card), else kMasked.  The others
// take kPredicated, but kMasked where it spilled more than the masked pass
// (nvcc -Xptxas -v).
constexpr int pass_shape(int K, bool f64, int ppt, int ns) {
    if (ppt == 4 && ns == 5) {
        switch (K) {
            case 5: return kMasked;
            case 6: return f64 ? kPredicated : 2;
            default: return f64 ? kPredicated : kMasked;
        }
    }
    const bool spills_more = (K == 3 && f64 && ppt == 8) || (K == 6 && !f64 && ppt == 8) ||
                             (K == 5 && f64 && (ppt == 2 || (ns == 7 && ppt == 4))) ||
                             (K == 5 && !f64 && (ppt == 1 || (ns == 7 && ppt >= 4)));
    return spills_more ? kMasked : kPredicated;
}

template <int K, typename T, int PPT, int NS>
constexpr int kPassShape = pass_shape(K, sizeof(T) == 8, PPT, NS);

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
