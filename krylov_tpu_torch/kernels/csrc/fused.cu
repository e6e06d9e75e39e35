// K2/K3, streaming route: whole-solve MrR and CG on a 2-D (or collapsed
// 3-D) stencil operator, the entire iteration loop in one launch, for
// systems too large for the resident route (fused_resident.cu), whose bands
// must fit one block an SM's registers and shared memory
// (kernels/fused.py::plan decides): a 2-D system above about 0.54M points,
// a 3-D one from 65^3 up, BASELINE row 5's laplace3d(216) (N = 10.08M).
//
// Replaces krylov_tpu/kernels/fused.py::fused_mrr_solve_2d
// (_mrr_fused_kernel) and ::fused_cg_solve_2d (_cg_fused_kernel).  On the
// TPU one core ran the loop with every vector resident in VMEM.  Here the
// loop runs in a persistent cooperative grid (cudaLaunchCooperativeKernel)
// and the vectors live in device memory, streamed through L2 on every pass.
//
// Grid-wide agreement: every inner product goes through grid_sum
// (reduce.cuh): a fixed-order block sum, one partial per block, a grid
// sync, and then every block sums all partials in the same fixed order.
// So every block holds bit-identical scalars, takes the same convergence
// branch (no block can stall alone in a grid sync), and results repeat from
// run to run: there are no atomics in the sums.
//
// Bound: bytes.  At these sizes every vector a pass touches comes from
// device memory (a stencil's neighbours are L1/L2 hits: rows are
// contiguous), so an iteration costs the words a point its passes move
// (kernels/fused.py::stream_words).  On an H100 the pointwise passes reach
// 75-90% of 3.35 TB/s, the stencil passes 20-50%: a stencil pass costs
// about what six pointwise words do, so forming A p or A r again to save
// the word that stores it lost, or spilled, wherever it was timed
// (PERF.md).  The forms (kernels/fused.py::STREAM_SHIPPED names the one
// each instance is built in):
// - CG, three-pass (11 words, 3 syncs): v = A p with <p,v> (p read, v
//   written), the x/r update with <r,r> (x, p, r, v read, x, r written),
//   p = r + beta p (r, p read, p written) and a grid sync, so that every
//   block's p is in memory before the next stencil reads it.
// - CG, stored (10 words, 2 syncs): p = r + beta p is folded into the next
//   iteration's stencil pass.  p lives in two buffers swapped each
//   iteration; the pass forms p = r + beta p_prev at its points and at each
//   stencil neighbour (stencil.cuh's Axpy source: two loads a neighbour),
//   writes p_cur and v = A p and sums <p, A p> (r, p_prev read, p_cur, v
//   written: 4 words).  The update pass reads p_cur, which the grid sum's
//   sync has published, and v (6 words).
// - MrR (15 words, 3 syncs: gamma must be summed before s = Ar - gamma y):
//   A r stored, then read back by the <r,s> pass and the update pass.
// A point's arithmetic is the plain version's (fused.py's
// fused_*_solve_2d_reference): the same r + beta p (one fused multiply-add
// wherever it is formed, so a neighbour's p is the bits its owner stores),
// the same stencil term order; only the order of the block sums follows the
// walk.
//
// The walk: for the constant 5- and 7-term stencils (NS = 5, 7) the pass
// specialised on the term count (stencil.cuh's StreamSweep: the weights as
// arguments, no division and no test for a chunk whose terms lie on the
// grid), on one of three walks: one point a thread on the grid-stride walk
// built for four blocks an SM ("points", NS = 5), or tiles of 16-byte
// chunks of one row (16-byte loads where rows and buffers start on 16
// bytes) built for four blocks an SM with at most 16 stencil values in
// flight ("tiles-4", NS = 7) or for two ("tiles", MrR float32 at NS = 7,
// whose tiles-4 build spills); else the masked pass (apply_stencil, one
// point a thread on the grid-stride walk, built with no minimum of blocks
// an SM).  Each (dtype, pass, method) is built in one form on one walk,
// the fastest the H100 timed (PERF.md); kernels/_build.py compiles this file once for
// each KRYLOV_PART of 0..5 (the pass, masked, NS = 5, NS = 7, times the
// method), part 0 with the entry points.  The grid is the plan's
// (fused.py::STREAM_BLOCKS_PER_SM blocks an SM), no more than can be
// resident or than the points need.
#include <cuda_runtime.h>

#include "reduce.cuh"
#include "stencil.cuh"

#ifndef KRYLOV_PART
#define KRYLOV_PART -1
#endif

namespace {

// The forms by method (kernels/fused.py::STREAM_FORMS names them): CG's
// three-pass and stored; MrR's one, A r stored.
constexpr int kCgThreePass = 0, kCgStored = 1;
constexpr int kForms[2] = {2, 1};
// The walks (kernels/fused.py::STREAM_WALKS): one point a thread on the
// grid-stride walk (the masked pass's too), tiles of 16-byte chunks built
// for four blocks an SM, the same built for two.
constexpr int kWalkPoints = 0, kWalkTiles4 = 1, kWalkTiles = 2, kWalks = 3;

// The form and walk of each instance, by dtype, pass and method (0 CG, 1
// MrR): kernels/fused.py::STREAM_SHIPPED.
template <typename T, int NS, int METHOD>
constexpr int kFormOf = METHOD == 0 && NS != 0 && !(NS == 5 && sizeof(T) == 4) ? kCgStored : 0;
template <typename T, int NS, int METHOD>
constexpr int kWalkOf = NS == 7 ? (METHOD == 1 && sizeof(T) == 4 ? kWalkTiles : kWalkTiles4) : kWalkPoints;
// Blocks an SM each instance is built for, its launch bounds' minimum: two
// on tiles (at most 128 registers a thread), four on tiles-4 and points
// (64), which hide the neighbour loads' latency better; none (0) for the
// masked pass, built as it was before the specialised pass (with a minimum
// of one, ptxas gives it 71-128 registers, one or two blocks an SM, where
// with none it takes 32-48, PERF.md).
template <typename T, int NS, int METHOD>
constexpr int kBlocksOf = NS == 0 ? 0 : kWalkOf<T, NS, METHOD> == kWalkTiles ? 2 : 4;
// The instance's sweep: one point a chunk on points, 16-byte chunks on the
// tiles, at most 16 values of a stencil in flight on tiles-4 (float32's
// chunks of 4 in 64 registers); the masked pass for NS = 0.
template <typename T, int NS, int METHOD>
using SweepFor = SweepOf<T, NS, kThreads, kWalkOf<T, NS, METHOD> == kWalkPoints ? 1 : kVecWidth<T>,
                         kWalkOf<T, NS, METHOD> == kWalkTiles4 ? 16 : 0>;

// Per-block partial-sum slots (MrR uses all 8: init 3, <r,r> 1, <y,y>/<y,Ar>
// 2, <r,s>/<s,s> 2; CG 2).
constexpr int kPartialSlots = 8;
// n-vectors of the pass probe's work space
constexpr int kProbeVectors = 5;

// n-vectors of work by method (0 CG, 1 MrR) and form: CG three-pass r, p,
// v; stored r, two p, v; MrR r, y, z, Ar.
constexpr int work_vectors(int method, int form) {
    return method == 0 && form == kCgThreePass ? 3 : 4;
}

// ---- CG's passes; each returns this thread's part of its sum ----

// r = b, p = b (the first direction; for the stored form p_prev, as r + 0
// b = b), x = 0; <b,b>.
template <typename T, typename S>
__device__ __forceinline__ T cg_init(const S& sw, const T* b, T* r, T* p, T* x) {
    constexpr int V = S::V;
    T s = T(0);
    sw.each([&](const Chunk& c) {
        T be[V], zero[V];
        sw.load(be, b, c);
#pragma unroll
        for (int q = 0; q < V; ++q) zero[q] = T(0);
        sw.store(r, be, c);
        sw.store(p, be, c);
        sw.store(x, zero, c);
#pragma unroll
        for (int q = 0; q < V; ++q) s += be[q] * be[q];
    });
    return s;
}

// Three-pass: v = A p; <p,v>.
template <typename T, typename S>
__device__ __forceinline__ T cg_stencil(const S& sw, const T* p, T* v) {
    constexpr int V = S::V;
    T s = T(0);
    sw.each([&](const Chunk& c) {
        T a[V], pe[V];
        sw.stencil(a, p, c);
        sw.load(pe, p, c);
        sw.store(v, a, c);
#pragma unroll
        for (int q = 0; q < V; ++q) s += pe[q] * a[q];
    });
    return s;
}

// Stored: p = r + beta q, formed at every point the stencil reads, stored
// to p; v = A p; <p, A p>.
template <typename T, typename S>
__device__ __forceinline__ T cg_form(const S& sw, const T* r, const T* q, T beta, T* p, T* v) {
    constexpr int V = S::V;
    T s = T(0);
    sw.each([&](const Chunk& c) {
        T a[V], pe[V], qe[V];
        sw.stencil_of(a, Axpy<T>{r, q, beta}, c);
        sw.load(pe, r, c);
        sw.load(qe, q, c);
#pragma unroll
        for (int e = 0; e < V; ++e) pe[e] = fma(beta, qe[e], pe[e]);
        sw.store(p, pe, c);
        sw.store(v, a, c);
#pragma unroll
        for (int e = 0; e < V; ++e) s += pe[e] * a[e];
    });
    return s;
}

// x += alpha p, r -= alpha v; <r,r>.
template <typename T, typename S>
__device__ __forceinline__ T cg_update(const S& sw, const T* p, const T* v, T* x, T* r, T alpha) {
    constexpr int V = S::V;
    T s = T(0);
    sw.each([&](const Chunk& c) {
        T a[V], pe[V], xe[V], re[V];
        sw.load(a, v, c);
        sw.load(pe, p, c);
        sw.load(xe, x, c);
        sw.load(re, r, c);
#pragma unroll
        for (int q = 0; q < V; ++q) {
            xe[q] += alpha * pe[q];
            re[q] = re[q] - alpha * a[q];
            s += re[q] * re[q];
        }
        sw.store(x, xe, c);
        sw.store(r, re, c);
    });
    return s;
}

// Three-pass: p = r + beta p.
template <typename T, typename S>
__device__ __forceinline__ void cg_direction(const S& sw, const T* r, T* p, T beta) {
    constexpr int V = S::V;
    sw.each([&](const Chunk& c) {
        T re[V], pe[V];
        sw.load(re, r, c);
        sw.load(pe, p, c);
#pragma unroll
        for (int q = 0; q < V; ++q) pe[q] = fma(beta, pe[q], re[q]);
        sw.store(p, pe, c);
    });
}

// ---- MrR's passes ----

// Init, first pass (r0 = b): Ar = A b; <b,b>, <b,Ab>, <Ab,Ab>.
template <typename T, typename S>
__device__ __forceinline__ void mrr_init_sums(const S& sw, const T* b, T* Ar, T (&s)[3]) {
    constexpr int V = S::V;
    sw.each([&](const Chunk& c) {
        T a[V], be[V];
        sw.stencil(a, b, c);
        sw.load(be, b, c);
        sw.store(Ar, a, c);
#pragma unroll
        for (int q = 0; q < V; ++q) {
            s[0] += be[q] * be[q];
            s[1] += be[q] * a[q];
            s[2] += a[q] * a[q];
        }
    });
}

// Init, second pass: y = zeta0 A b, z = -zeta0 b, r = b - y, x = -z;
// <r,r>.
template <typename T, typename S>
__device__ __forceinline__ T mrr_init_update(const S& sw, const T* b, const T* Ar, T zeta0, T* r, T* y, T* z,
                                             T* x) {
    constexpr int V = S::V;
    T s = T(0);
    sw.each([&](const Chunk& c) {
        T a[V], be[V], ye[V], ze[V], re[V], xe[V];
        sw.load(a, Ar, c);
        sw.load(be, b, c);
#pragma unroll
        for (int q = 0; q < V; ++q) {
            ye[q] = zeta0 * a[q];
            ze[q] = -zeta0 * be[q];
            re[q] = be[q] - ye[q];
            xe[q] = -ze[q];
            s += re[q] * re[q];
        }
        sw.store(y, ye, c);
        sw.store(z, ze, c);
        sw.store(r, re, c);
        sw.store(x, xe, c);
    });
    return s;
}

// Pass 1: Ar = A r; <y,y>, <y,Ar>.
template <typename T, typename S>
__device__ __forceinline__ void mrr_sums_y(const S& sw, const T* r, const T* y, T* Ar, T (&s)[2]) {
    constexpr int V = S::V;
    sw.each([&](const Chunk& c) {
        T a[V], ye[V];
        sw.stencil(a, r, c);
        sw.load(ye, y, c);
        sw.store(Ar, a, c);
#pragma unroll
        for (int q = 0; q < V; ++q) {
            s[0] += ye[q] * ye[q];
            s[1] += ye[q] * a[q];
        }
    });
}

// Pass 2: s = Ar - gamma y; <r,s>, <s,s>.
template <typename T, typename S>
__device__ __forceinline__ void mrr_sums_s(const S& sw, const T* r, const T* y, const T* Ar, T gamma, T (&s)[2]) {
    constexpr int V = S::V;
    sw.each([&](const Chunk& c) {
        T a[V], re[V], ye[V];
        sw.load(a, Ar, c);
        sw.load(re, r, c);
        sw.load(ye, y, c);
#pragma unroll
        for (int q = 0; q < V; ++q) {
            const T se = a[q] - gamma * ye[q];
            s[0] += re[q] * se;
            s[1] += se * se;
        }
    });
}

// Pass 3: y = eta y + zeta Ar, z = eta z - zeta r, r -= y, x -= z;
// <r,r>.
template <typename T, typename S>
__device__ __forceinline__ T mrr_update(const S& sw, T* r, T* y, T* z, T* x, const T* Ar, T zeta, T eta) {
    constexpr int V = S::V;
    T s = T(0);
    sw.each([&](const Chunk& c) {
        T a[V], re[V], ye[V], ze[V], xe[V];
        sw.load(a, Ar, c);
        sw.load(re, r, c);
        sw.load(ye, y, c);
        sw.load(ze, z, c);
        sw.load(xe, x, c);
#pragma unroll
        for (int q = 0; q < V; ++q) {
            ye[q] = eta * ye[q] + zeta * a[q];
            ze[q] = eta * ze[q] - zeta * re[q];
            re[q] = re[q] - ye[q];
            xe[q] -= ze[q];
            s += re[q] * re[q];
        }
        sw.store(y, ye, c);
        sw.store(z, ze, c);
        sw.store(r, re, c);
        sw.store(x, xe, c);
    });
    return s;
}

// The parameters of a solve kernel, and the arguments that pass them on.
#define K23_SOLVE_PARAMS                                                                                   \
    StencilGeom g, StreamPass<T> sp, int vec, const T *__restrict__ coef, const T *__restrict__ b,           \
        const T *__restrict__ scal, T *x, T *trace, int *stats, T *work, T *partials, int maxiter, int trace_len
#define K23_SOLVE_ARGS g, sp, vec, coef, b, scal, x, trace, stats, work, partials, maxiter, trace_len

// Whole MrR solve of A x = b from x0 = 0 (the wrapper shifts for x0).
// work holds r, y, z, Ar (4 n); partials holds kPartialSlots slots of
// gridDim.x.  sp and vec are the specialised pass's.
template <typename T, int NS>
__device__ __forceinline__ void mrr_solve(K23_SOLVE_PARAMS) {
    using Sweep = typename SweepFor<T, NS, 1>::type;
    cg::grid_group grid = cg::this_grid();
    __shared__ T smem[kBlockSumSmem];
    const Sweep sw = SweepFor<T, NS, 1>::make(g, sp, vec, coef);
    const size_t n = (size_t)g.g0 * g.g1;
    const int nb = gridDim.x;
    const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
    T* r = work;
    T* y = work + n;
    T* z = work + 2 * n;
    T* Ar = work + 3 * n;
    T* s_init = partials;
    T* s_rr = partials + 3 * nb;
    T* s_mn = partials + 4 * nb;
    T* s_rs = partials + 6 * nb;
    const T tol = scal[0];
    const T b_norm = scal[1];

    // init half-iteration: zeta = <r,Ar>/<Ar,Ar> with r0 = b
    T init[3] = {T(0), T(0), T(0)};
    mrr_init_sums(sw, b, Ar, init);
    grid_sum(grid, init, s_init, smem);
    if (lead) trace[0] = sqrt(init[0]) / b_norm;
    T rr[1] = {mrr_init_update(sw, b, Ar, safe_div(init[1], init[2]), r, y, z, x)};
    grid_sum(grid, rr, s_rr, smem);

    int i = 1;
    bool conv = false;
    while (i < maxiter) {
        const T res = sqrt(rr[0]) / b_norm;
        if (lead) trace[min(i, trace_len - 1)] = res;
        if (res < tol) {  // the same in every block: rr is bit-identical
            conv = true;
            break;
        }
        T mn[2] = {T(0), T(0)};  // <y,y>, <y,Ar>
        mrr_sums_y(sw, r, y, Ar, mn);
        grid_sum(grid, mn, s_mn, smem);
        const T gamma = safe_div(mn[1], mn[0]);
        T rs[2] = {T(0), T(0)};  // <r,s>, <s,s> with s = Ar - gamma y
        mrr_sums_s(sw, r, y, Ar, gamma, rs);
        grid_sum(grid, rs, s_rs, smem);
        const T zeta = safe_div(rs[0], rs[1]);
        const T eta = -zeta * gamma;
        rr[0] = mrr_update(sw, r, y, z, x, Ar, zeta, eta);
        grid_sum(grid, rr, s_rr, smem);
        ++i;
    }
    if (lead) {
        if (!conv) trace[min(i, trace_len - 1)] = sqrt(rr[0]) / b_norm;
        stats[0] = i;
        stats[1] = conv;
    }
}

// Whole CG solve of A x = b from x0 = 0 in the instance's form.  work holds
// work_vectors(0, form) n-vectors; partials 2 slots of gridDim.x.
template <typename T, int NS>
__device__ __forceinline__ void cg_solve(K23_SOLVE_PARAMS) {
    using Sweep = typename SweepFor<T, NS, 0>::type;
    constexpr bool kThreePass = kFormOf<T, NS, 0> == kCgThreePass;
    cg::grid_group grid = cg::this_grid();
    __shared__ T smem[kBlockSumSmem];
    const Sweep sw = SweepFor<T, NS, 0>::make(g, sp, vec, coef);
    const size_t n = (size_t)g.g0 * g.g1;
    const int nb = gridDim.x;
    const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
    T* r = work;
    // three-pass: p (p_prev) and v; stored: p_prev and p_cur, swapped each
    // iteration, and v
    T* p_prev = work + n;
    T* p_cur = work + 2 * n;
    T* v = kThreePass ? work + 2 * n : work + 3 * n;
    T* s_gamma = partials;
    T* s_sigma = partials + nb;
    const T tol = scal[0];
    const T b_norm = scal[1];

    T gam[1] = {cg_init(sw, b, r, p_prev, x)};
    grid_sum(grid, gam, s_gamma, smem);
    T gamma = gam[0];
    T beta = T(0);

    int i = 0;
    bool conv = false;
    while (i < maxiter) {
        const T res = sqrt(gamma) / b_norm;
        if (lead) trace[min(i, trace_len - 1)] = res;
        if (res < tol) {
            conv = true;
            break;
        }
        T sig[1];  // <p, Ap>
        if constexpr (kThreePass)
            sig[0] = cg_stencil(sw, p_prev, v);
        else
            sig[0] = cg_form(sw, r, p_prev, beta, p_cur, v);
        grid_sum(grid, sig, s_sigma, smem);
        const T alpha = safe_div(gamma, sig[0]);
        gam[0] = cg_update(sw, kThreePass ? p_prev : p_cur, v, x, r, alpha);
        grid_sum(grid, gam, s_gamma, smem);
        beta = safe_div(gam[0], gamma);
        if constexpr (kThreePass) {
            cg_direction(sw, r, p_prev, beta);
            grid.sync();  // every block's p before the next stencil reads it
        } else {
            T* const swap = p_prev;
            p_prev = p_cur;
            p_cur = swap;
        }
        gamma = gam[0];
        ++i;
    }
    if (lead) {
        if (!conv) trace[min(i, trace_len - 1)] = sqrt(gamma) / b_norm;
        stats[0] = i;
        stats[1] = conv;
    }
}

// One of K2/K3's passes alone on the instance's walk, reps times, each
// ending in its grid sum as in a solve (the three-pass direction pass in
// its grid sync), at fixed coefficients, for timing it
// (diagnostics/grid_sweep.py --k23) and for holding it against the masked
// pass (chip_smoke.py phases 6c and 6f).  work holds kProbeVectors
// n-vectors w0..w4 (kernels/fused.py::PROBE_PASSES names the passes and
// the vectors each reads and writes); partials 2 slots of gridDim.x.  The
// values are whatever the passes make of work's; a pass that writes none
// of what it reads (CG's stencil and form passes, MrR's first) gives its
// own result after any number of repetitions.
#define K23_PROBE_PARAMS \
    StencilGeom g, StreamPass<T> sp, int vec, const T *__restrict__ coef, T *work, T *partials, int pass, int reps
#define K23_PROBE_ARGS g, sp, vec, coef, work, partials, pass, reps
template <typename T, int NS, int METHOD>
__device__ __forceinline__ void pass_probe(K23_PROBE_PARAMS) {
    using Sweep = typename SweepFor<T, NS, METHOD>::type;
    cg::grid_group grid = cg::this_grid();
    __shared__ T smem[kBlockSumSmem];
    const Sweep sw = SweepFor<T, NS, METHOD>::make(g, sp, vec, coef);
    const size_t n = (size_t)g.g0 * g.g1;
    T* const w[kProbeVectors] = {work, work + n, work + 2 * n, work + 3 * n, work + 4 * n};
    const T c0 = T(0.5), c1 = T(0.25), c2 = T(-0.25);
    for (int rep = 0; rep < reps; ++rep) {
        T s[2] = {T(0), T(0)};
        if constexpr (METHOD == 0) {
            switch (pass) {
                case 0: s[0] = cg_stencil(sw, w[1], w[3]); break;              // v = A p
                case 1: s[0] = cg_update(sw, w[1], w[3], w[4], w[0], c1); break;  // x, r from v
                case 2: cg_direction(sw, w[0], w[1], c0); break;               // p = r + beta p
                default: s[0] = cg_form(sw, w[0], w[1], c0, w[2], w[3]);        // p formed, v stored
            }
        } else {
            switch (pass) {
                case 0: mrr_sums_y(sw, w[0], w[1], w[3], s); break;
                case 1: mrr_sums_s(sw, w[0], w[1], w[3], c0, s); break;
                default: s[0] = mrr_update(sw, w[0], w[1], w[2], w[4], w[3], c0, c2);
            }
        }
        if (METHOD == 0 && pass == 2)
            grid.sync();
        else
            grid_sum(grid, s, partials, smem);
    }
}

// The entries, one a method and the probe, each with its instance's launch
// bounds: a minimum of kBlocksOf blocks an SM, or none.
template <typename T, int NS>
__global__ void __launch_bounds__(kThreads, kBlocksOf<T, NS, 0>) cg_stream_kernel(K23_SOLVE_PARAMS) {
    cg_solve<T, NS>(K23_SOLVE_ARGS);
}
template <typename T, int NS>
__global__ void __launch_bounds__(kThreads) cg_stream_kernel_nomin(K23_SOLVE_PARAMS) {
    cg_solve<T, NS>(K23_SOLVE_ARGS);
}
template <typename T, int NS>
__global__ void __launch_bounds__(kThreads, kBlocksOf<T, NS, 1>) mrr_stream_kernel(K23_SOLVE_PARAMS) {
    mrr_solve<T, NS>(K23_SOLVE_ARGS);
}
template <typename T, int NS>
__global__ void __launch_bounds__(kThreads) mrr_stream_kernel_nomin(K23_SOLVE_PARAMS) {
    mrr_solve<T, NS>(K23_SOLVE_ARGS);
}
template <typename T, int NS, int METHOD>
__global__ void __launch_bounds__(kThreads, kBlocksOf<T, NS, METHOD>) k23_pass_probe(K23_PROBE_PARAMS) {
    pass_probe<T, NS, METHOD>(K23_PROBE_ARGS);
}
template <typename T, int NS, int METHOD>
__global__ void __launch_bounds__(kThreads) k23_pass_probe_nomin(K23_PROBE_PARAMS) {
    pass_probe<T, NS, METHOD>(K23_PROBE_ARGS);
}

// The kernel of a form (-1: the pass probe) on a walk; null where the
// instance of this dtype, pass and method is not built in them.
template <typename T, int NS, int METHOD>
const void* kernel_of(int form, int walk) {
    if (walk != kWalkOf<T, NS, METHOD>) return nullptr;
    if (form != -1 && form != kFormOf<T, NS, METHOD>) return nullptr;
    const void* k = nullptr;
    if constexpr (kBlocksOf<T, NS, METHOD> > 0) {
        if (form == -1)
            k = reinterpret_cast<const void*>(&k23_pass_probe<T, NS, METHOD>);
        else if constexpr (METHOD == 0)
            k = reinterpret_cast<const void*>(&cg_stream_kernel<T, NS>);
        else
            k = reinterpret_cast<const void*>(&mrr_stream_kernel<T, NS>);
    } else {
        if (form == -1)
            k = reinterpret_cast<const void*>(&k23_pass_probe_nomin<T, NS, METHOD>);
        else if constexpr (METHOD == 0)
            k = reinterpret_cast<const void*>(&cg_stream_kernel_nomin<T, NS>);
        else
            k = reinterpret_cast<const void*>(&mrr_stream_kernel_nomin<T, NS>);
    }
    return k;
}

}  // namespace

// The kernel of part P = 2 s + method for a form, walk and dtype, each
// defined in the compilation of its part: s = 0 the masked pass, 1 the
// pass specialised on NS = 5, 2 on NS = 7.
#define FUSED_STREAM_DECL(P) const void* fused_stream_part##P(int form, int walk, int dtype);
FUSED_STREAM_DECL(0) FUSED_STREAM_DECL(1) FUSED_STREAM_DECL(2) FUSED_STREAM_DECL(3) FUSED_STREAM_DECL(4)
FUSED_STREAM_DECL(5)
#undef FUSED_STREAM_DECL

#define FUSED_STREAM_PART(P, NS, METHOD)                                                    \
    const void* fused_stream_part##P(int form, int walk, int dtype) {                       \
        return dtype == 8 ? kernel_of<double, NS, METHOD>(form, walk)                       \
                          : kernel_of<float, NS, METHOD>(form, walk);                       \
    }

#if KRYLOV_PART < 0 || KRYLOV_PART == 0
FUSED_STREAM_PART(0, 0, 0)
#endif
#if KRYLOV_PART < 0 || KRYLOV_PART == 1
FUSED_STREAM_PART(1, 0, 1)
#endif
#if KRYLOV_PART < 0 || KRYLOV_PART == 2
FUSED_STREAM_PART(2, 5, 0)
#endif
#if KRYLOV_PART < 0 || KRYLOV_PART == 3
FUSED_STREAM_PART(3, 5, 1)
#endif
#if KRYLOV_PART < 0 || KRYLOV_PART == 4
FUSED_STREAM_PART(4, 7, 0)
#endif
#if KRYLOV_PART < 0 || KRYLOV_PART == 5
FUSED_STREAM_PART(5, 7, 1)
#endif

#if KRYLOV_PART <= 0
namespace {

// The kernel of a launch: method 0 = CG, 1 = MrR; form one of its forms or
// -1 (the pass probe); walk one of the walks; dtype the element size;
// ns_pass the pass (0, 5 or 7).  Null for anything else and for what is
// not built.
const void* fused_kernel(int method, int form, int walk, int dtype, int ns_pass) {
    if ((method != 0 && method != 1) || form < -1 || form >= kForms[method] || walk < 0 || walk >= kWalks ||
        (dtype != 4 && dtype != 8))
        return nullptr;
    typedef const void* (*Part)(int, int, int);
    static const Part parts[6] = {fused_stream_part0, fused_stream_part1, fused_stream_part2,
                                  fused_stream_part3, fused_stream_part4, fused_stream_part5};
    const int s = ns_pass == 0 ? 0 : ns_pass == 5 ? 1 : ns_pass == 7 ? 2 : -1;
    return s < 0 ? nullptr : parts[2 * s + method](form, walk, dtype);
}

}  // namespace

// The work space of a solve of n points: the blocks of the cooperative grid
// (max_blocks, the plan's, but no more than can be resident on the current
// device at once or than n needs) and the elements of the work and partials
// buffers that krylov_fused_solve takes.  method 0 = CG, 1 = MrR; form one
// of the method's forms, or -1 for the pass probe (krylov_fused_pass_probe);
// walk the instance's walk; dtype is the element size in bytes; ns_pass the
// stencil pass (0, 5 or 7), whose kernel's occupancy counts.
extern "C" int krylov_fused_workspace(int method, int form, int walk, int dtype, int n, int max_blocks,
                                      int ns_pass, int* blocks, long long* work_elems, long long* partial_elems) {
    const void* kernel = fused_kernel(method, form, walk, dtype, ns_pass);
    if (kernel == nullptr || max_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int need = (n + kThreads - 1) / kThreads;
    int fit = per_sm * sms;
    if (max_blocks < fit) fit = max_blocks;
    *blocks = need < fit ? (need > 0 ? need : 1) : fit;
    *work_elems = static_cast<long long>(form < 0 ? kProbeVectors : work_vectors(method, form)) * n;
    *partial_elems = static_cast<long long>(kPartialSlots) * *blocks;
    return 0;
}

// work and partials are sized by krylov_fused_workspace for the same
// method, form, walk, dtype, n, ns_pass and blocks; disp is the (3, ns)
// displacement array; ns_pass the pass (0: masked; 5 or 7: specialised,
// with the ns constant weights as doubles).
extern "C" int krylov_fused_solve(int method, int form, int walk, int dtype, int blocks, const void* coef,
                                  const void* b,
                                  const void* scal, void* x, void* trace, void* stats, void* work, void* partials,
                                  int ns, int g0, int g1, int g2, int is_const, const int* disp, int maxiter,
                                  int trace_len, int ns_pass, const double* weights, void* stream) {
    StencilGeom g;
    if (!make_geom(ns, g0, g1, g2, is_const, disp, &g) || (long long)g0 * g1 >= (1LL << 31) || form < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const void* kernel = fused_kernel(method, form, walk, dtype, ns_pass);
    const bool aligned = walk != kWalkPoints && aligned16({b, x, work});
    StreamPass<double> spd;
    StreamPass<float> spf;
    int vec = 0;
    const bool ok = dtype == 8 ? stream_pass(g, ns_pass, weights, aligned, kThreads, &spd, &vec)
                               : stream_pass(g, ns_pass, weights, aligned, kThreads, &spf, &vec);
    if (kernel == nullptr || !ok) return static_cast<int>(cudaErrorInvalidValue);
    void* sp = dtype == 8 ? static_cast<void*>(&spd) : static_cast<void*>(&spf);
    void* args[] = {&g,     sp,    &vec,  &coef,     &b,       &scal,     &x,
                    &trace, &stats, &work, &partials, &maxiter, &trace_len};
    const cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, 0,
                                                        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// k23_pass_probe: reps of pass `pass` of a method's probe on the grid
// krylov_fused_workspace sizes for form -1 (work and partials from it),
// with the pass ns_pass as in krylov_fused_solve.
extern "C" int krylov_fused_pass_probe(int method, int pass, int walk, int dtype, int blocks, int reps,
                                       const void* coef,
                                       void* work, void* partials, int ns, int g0, int g1, int g2, int is_const,
                                       const int* disp, int ns_pass, const double* weights, void* stream) {
    StencilGeom g;
    if (!make_geom(ns, g0, g1, g2, is_const, disp, &g) || (long long)g0 * g1 >= (1LL << 31) || pass < 0 ||
        pass > (method == 0 ? 3 : 2) || reps < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const void* kernel = fused_kernel(method, -1, walk, dtype, ns_pass);
    const bool aligned = walk != kWalkPoints && aligned16({work});
    StreamPass<double> spd;
    StreamPass<float> spf;
    int vec = 0;
    const bool ok = dtype == 8 ? stream_pass(g, ns_pass, weights, aligned, kThreads, &spd, &vec)
                               : stream_pass(g, ns_pass, weights, aligned, kThreads, &spf, &vec);
    if (kernel == nullptr || !ok) return static_cast<int>(cudaErrorInvalidValue);
    void* sp = dtype == 8 ? static_cast<void*>(&spd) : static_cast<void*>(&spf);
    void* args[] = {&g, sp, &vec, &coef, &work, &partials, &pass, &reps};
    const cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, 0,
                                                        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
#endif
