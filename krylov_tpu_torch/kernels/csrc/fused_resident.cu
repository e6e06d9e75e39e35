// K2/K3, resident route: whole-solve MrR and CG on a 2-D (or collapsed 3-D)
// stencil operator with the solver state on chip, the entire iteration loop
// in one launch.
//
// Replaces krylov_tpu/kernels/fused.py::fused_mrr_solve_2d
// (_mrr_fused_kernel) and ::fused_cg_solve_2d (_cg_fused_kernel) for every
// system whose bands fit the plan of kernels/fused.py::plan (at N = 250k in
// float32 and float64); larger systems take the streaming route of fused.cu.
// The TPU kernels kept the whole working set in one core's VMEM.  Here it is
// spread over the SMs: registers and shared memory.
//
// Bound (H100 SXM at 700 W: 3.35 TB/s, 34 TFLOP/s float64 and 67 TFLOP/s
// float32 outside the tensor cores): an MrR iteration does 2 ns + 20 flops
// a point and a CG iteration 2 ns + 10 (30 and 20 for the 5-point stencil);
// each reads b and writes x once.  At N = 250k in float64 that is ~7.0
// GFLOP for MrR's 934 iterations (~0.21 ms) and ~5.3 GFLOP for CG's 1053
// (~0.15 ms): compute sets the bound, 4 MB in and out.  What a design can
// reach is set by the chain of dependent grid-wide reductions, two an
// iteration for either method (CG: sigma, then gamma; MrR: <y,y>/<y,Ar>,
// then <r,s>/<s,s>), each a grid barrier plus a short pass.
//
// What held the streaming kernels back, and what this design does:
// 1. The vectors streamed through L2 on every pass (~28 MB an MrR iteration
//    in float64).  Here each thread owns the same PPT points (a template
//    parameter) for the whole solve and keeps their r, y, Ar (MrR) or r, p,
//    v (CG) in registers and their x (and MrR's z), which are only ever
//    updated, in shared memory.  b is read at the start and x written at
//    the end.  The stencil's input (r for MrR, p for CG) is mirrored in
//    dynamic shared memory: the block's band of rows and h = max |d0| halo
//    rows on either side.  Grid coefficients are read through __ldg.  Which
//    terms of a point stay on the grid is worked out once, as a mask; the
//    pass itself is K4 (stencil_pass, resident.cuh), specialised on the
//    term count as a template argument (NS, the launcher's pick).
// 2. Three grid syncs an iteration.  Here two.  Blocks exchange only the h
//    edge rows of their band (published to a small global buffer between
//    the syncs, read after the second), and each block recomputes its halo
//    rows from its own halo copies with the band's own update function
//    (cg_direction, mrr_step), so the copies are bitwise equal to the
//    owner's values.  CG folds p = r + beta p into the next stencil pass: the
//    edge rows of the new r go out before the gamma sync.  MrR sums <r,r>
//    with <y,y> and <y,Ar> of the next stencil pass and tests convergence
//    after that sync, before any update (a converged exit leaves x as it
//    is); the edge rows of Ar go out before the <r,s>/<s,s> sync, and the
//    halo rows of the new y and r follow from them.  Each inner product is
//    still summed from the same pointwise products; only the order of the
//    sums changed.
// 3. Every block summed every partial (nb^2 loads from L2), after a grid
//    sync of its own.  Here at most one block an SM, and the sync is the sum
//    (grid_allsum): each block publishes its block sums; block 0 loads the
//    <= 160 partials of a sum together (5 a lane, one warp a sum), adds
//    them in a fixed order and publishes the total, which every other block
//    waits for.  So every block holds the same bits and takes the same
//    branch, and one warp a sum polls the partials instead of every block
//    (all blocks polling all partials contend for the same lines of L2).
//    A sum so costs two L2 hops: about 1.3 us alone on an H100 (the sync
//    probe of diagnostics/grid_sweep.py), against 1.1 us for cooperative
//    groups' grid.sync(), which carries no value.
// 4. The grid was sized by occupancy and N.  Here it is one block an SM, at
//    most, each owning a contiguous band of at least h rows (the plan).
//
// The pointwise arithmetic rounds as the plain PyTorch versions do (no FMA
// contraction, the _rn intrinsics of resident.cuh), so a kernel differs from its plain
// version only by the order of the sums.
//
// Ordering of the exchanges, without a fence.  Every value that crosses
// blocks (a partial sum, an edge-row entry) travels with the step that wrote
// it in one 16-byte word, stored and loaded by one relaxed vector access,
// which the card performs whole (CUB's single-pass scan publishes its tile
// states the same way).  A reader loads until the step is the one it waits
// for, so seeing the step is seeing the value.  Sum t (counted alike in
// every block) writes partial and total set t % 2.  A block writes its
// partial of sum t + 2 only after it has read the total of sum t + 1, which
// block 0 forms once every block's partial of sum t + 1 has arrived; each
// block computes that partial from the total of sum t, which block 0 formed
// after it had read every partial of sum t.  Edge rows are written once an
// iteration with the iteration's step and read after the second sum; the
// next write follows the next iteration's first sum, whose total needs
// every block's partial, computed from the halo that block read.  So no
// value is overwritten before every reader has it, and one set of edge
// words suffices.
#include "resident.cuh"

// kernels/_build.py compiles this file once for each KRYLOV_PART of 0..2,
// all at once: part P instantiates the kernels of K4's specialisation P
// (resident_partP), and part 0 also holds the launcher and the sync probe.
// Compiled without KRYLOV_PART it holds every part.
#ifndef KRYLOV_PART
#define KRYLOV_PART -1
#endif

namespace {

// CG's new direction p = r + beta p, for the band and for the halo copies.
template <typename T>
__device__ __forceinline__ T cg_direction(T beta, T r, T p) {
    return add(r, mul(beta, p));
}

// MrR's first step y = zeta Ar, r = b - y, for the band and the halo.
template <typename T>
__device__ __forceinline__ void mrr_start(T zeta, T ar, T& y, T& r) {
    y = mul(zeta, ar);
    r = sub(r, y);
}

// MrR's step y = eta y + zeta Ar, r = r - y, for the band and the halo.
template <typename T>
__device__ __forceinline__ void mrr_step(T eta, T zeta, T ar, T& y, T& r) {
    y = add(mul(eta, y), mul(zeta, ar));
    r = sub(r, y);
}

// Writes v, the value at point e of the band, to the block's edge rows in
// xbuf with step `step` if e lies in its first or last h rows (both when the
// band has fewer than 2h rows).  xbuf holds 2 h g1 words a block: top edge,
// bottom edge.
template <typename T>
__device__ __forceinline__ void publish_edge(Word* xbuf, const Band& bd, int e, T v, long long step) {
    Word* mine = xbuf + (size_t)blockIdx.x * 2 * bd.hg;
    const int top = e - bd.p0, bottom = e - (bd.p1 - bd.hg);
    if (top < bd.hg) put_word(mine + top, v, step);
    if (bottom >= 0) put_word(mine + bd.hg + bottom, v, step);
}

// Halo entry j of 2 h g1 (the h rows above the band, then the h below):
// the neighbour's published edge word, or nullptr where the halo lies off
// the grid; *m is the entry's index in the mirror.
__device__ __forceinline__ const Word* halo_source(const Word* xbuf, const Band& bd, int j, int* m) {
    if (j < bd.hg) {
        *m = j;
        return blockIdx.x == 0 ? nullptr : xbuf + ((size_t)(blockIdx.x - 1) * 2 + 1) * bd.hg + j;
    }
    j -= bd.hg;
    *m = bd.hg + (bd.p1 - bd.p0) + j;
    return blockIdx.x + 1 == gridDim.x ? nullptr : xbuf + (size_t)(blockIdx.x + 1) * 2 * bd.hg + j;
}

// The halo entries a thread applies: 2 h g1 entries, kHaloWords a thread
// loaded early (halo_fetch, before the sum whose scalars the update needs)
// and the rest, if any, loaded by halo_apply.
constexpr int kHaloWords = 2;

struct HaloFetch {
    Word w[kHaloWords];
};

// Issues the loads of this thread's first kHaloWords halo entries.
__device__ __forceinline__ HaloFetch halo_fetch(const Word* xbuf, const Band& bd) {
    HaloFetch hf;
#pragma unroll
    for (int q = 0; q < kHaloWords; ++q) {
        const int j = threadIdx.x + q * kResThreads;
        int m;
        const Word* src = j < 2 * bd.hg ? halo_source(xbuf, bd, j, &m) : nullptr;
        hf.w[q] = src ? get_word(src) : Word{0, 0};
    }
    return hf;
}

// For each halo entry on the grid: waits for the neighbour's edge value of
// step `step` (reloading a fetched word that was older) and calls f(j, m,
// value).
template <typename T, typename F>
__device__ __forceinline__ void halo_apply(const Word* xbuf, const Band& bd, long long step,
                                           HaloFetch& hf, F f) {
#pragma unroll
    for (int q = 0; q < kHaloWords; ++q) {
        const int j = threadIdx.x + q * kResThreads;
        int m;
        const Word* src = j < 2 * bd.hg ? halo_source(xbuf, bd, j, &m) : nullptr;
        if (src) {
            while (hf.w[q].step < step) hf.w[q] = get_word(src);
            f(j, m, from_bits<T>(hf.w[q].bits));
        }
    }
    for (int j = threadIdx.x + kHaloWords * kResThreads; j < 2 * bd.hg; j += kResThreads) {
        int m;
        const Word* src = halo_source(xbuf, bd, j, &m);
        if (src) {
            Word w;
            do w = get_word(src); while (w.step < step);
            f(j, m, from_bits<T>(w.bits));
        }
    }
}

// Whole CG solve of A x = b from x0 = 0.  Dynamic shared memory: the p
// mirror, (rows + 2h) g1 entries, then x, rows g1 (x is only ever updated,
// so it waits in shared memory and leaves the registers to r, p and v).
// xbuf: 2 h g1 words a block; partials: 2 sets of kResSums words a block
// and 2 more sets; both zero at launch.
template <typename T, int PPT, int NS>
__global__ void __launch_bounds__(kResThreads, 1)
cg_resident_kernel(StencilGeom g, Terms<T> tm, int h, const T* __restrict__ coef, const T* __restrict__ b,
                   const T* __restrict__ scal, T* __restrict__ x_out, T* trace, int* stats,
                   Word* xbuf, Word* partials, int maxiter, int trace_len) {
    extern __shared__ __align__(16) unsigned char dyn[];
    T* ps = reinterpret_cast<T*>(dyn);
    const Band bd = band_of(g, h);
    T* xs = ps + bd.rows * g.g1 + 2 * bd.hg;
    __shared__ T wsum[kResSums * (kResWarps + 1)];
    const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
    Exchange ex{partials, 0};
    const T tol = scal[0];
    const T b_norm = scal[1];

    T rr[PPT], pr[PPT], vr[PPT];
    Points<PPT> pt = band_points<PPT, NS>(g, bd);
    T gam[1] = {T(0)};
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
        const int e = bd.p0 + threadIdx.x + k * kResThreads;
        const T be = e < bd.p1 ? b[e] : T(0);
        rr[k] = be;
        pr[k] = be;
        if (e < bd.p1) xs[e - bd.p0] = T(0);
        gam[0] = add(gam[0], mul(be, be));
    }
    mirror_from(ps, b, g, bd);
    grid_allsum(ex, gam, wsum);  // its barriers also complete the mirror
    T gamma = gam[0];

    // iteration i tests the residual of gamma_i, then (if it goes on) makes
    // gamma_{i+1}; the test of the next iteration sits at the end of the
    // loop, so its sqrt and division overlap the halo exchange
    int i = 0;
    bool conv = false;
    if (maxiter > 0) {
        const T res = sqrt(gamma) / b_norm;
        if (lead) trace[0] = res;
        conv = res < tol;
    }
    while (!conv && i < maxiter) {
        stencil_pass<T, PPT, NS, kPassShape<3, T, PPT, NS>>(g, coef, tm, ps, bd, pt, vr);
        T sig[1] = {T(0)};  // <p, Ap>
#pragma unroll
        for (int k = 0; k < PPT; ++k)
            if (bd.p0 + threadIdx.x + k * kResThreads < bd.p1) sig[0] = add(sig[0], mul(pr[k], vr[k]));
        grid_allsum(ex, sig, wsum);
        const T alpha = safe_div(gamma, sig[0]);
        T gn[1] = {T(0)};  // <r, r> of the new r
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
            const int e = bd.p0 + threadIdx.x + k * kResThreads;
            if (e < bd.p1) {
                xs[e - bd.p0] = add(xs[e - bd.p0], mul(alpha, pr[k]));
                rr[k] = sub(rr[k], mul(alpha, vr[k]));
                gn[0] = add(gn[0], mul(rr[k], rr[k]));
                publish_edge(xbuf, bd, e, rr[k], i + 1);
            }
        }
        HaloFetch hf = halo_fetch(xbuf, bd);  // the neighbours' new r edges, early
        grid_allsum(ex, gn, wsum);
        const T beta = safe_div(gn[0], gamma);
        gamma = gn[0];
        ++i;
        const T res = sqrt(gamma) / b_norm;
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
            const int e = bd.p0 + threadIdx.x + k * kResThreads;
            if (e < bd.p1) {
                pr[k] = cg_direction(beta, rr[k], pr[k]);
                ps[bd.hg + e - bd.p0] = pr[k];
            }
        }
        halo_apply<T>(xbuf, bd, i, hf, [&](int, int m, T r) { ps[m] = cg_direction(beta, r, ps[m]); });
        __syncthreads();  // the whole mirror before the next stencil
        if (i < maxiter) {  // the same in every block: gamma is bit-identical
            if (lead) trace[min(i, trace_len - 1)] = res;
            conv = res < tol;
        }
    }
    if (lead) {
        if (!conv) trace[min(i, trace_len - 1)] = sqrt(gamma) / b_norm;
        stats[0] = i;
        stats[1] = conv;
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
        const int e = bd.p0 + threadIdx.x + k * kResThreads;
        if (e < bd.p1) x_out[e] = xs[e - bd.p0];
    }
}

// Whole MrR solve of A x = b from x0 = 0.  Dynamic shared memory: the r
// mirror, (rows + 2h) g1 entries, the halo copy of y, 2 h g1, then x and z,
// rows g1 each (only ever updated; the registers hold r, y and Ar).
template <typename T, int PPT, int NS>
__global__ void __launch_bounds__(kResThreads, 1)
mrr_resident_kernel(StencilGeom g, Terms<T> tm, int h, const T* __restrict__ coef, const T* __restrict__ b,
                    const T* __restrict__ scal, T* __restrict__ x_out, T* trace, int* stats,
                    Word* xbuf, Word* partials, int maxiter, int trace_len) {
    extern __shared__ __align__(16) unsigned char dyn[];
    const Band bd = band_of(g, h);
    T* rs = reinterpret_cast<T*>(dyn);
    T* yh = rs + bd.rows * g.g1 + 2 * bd.hg;
    T* xs = yh + 2 * bd.hg;
    T* zs = xs + bd.rows * g.g1;
    __shared__ T wsum[kResSums * (kResWarps + 1)];
    const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
    Exchange ex{partials, 0};
    const T tol = scal[0];
    const T b_norm = scal[1];

    // start half-iteration on r0 = b: zeta = <r,Ar>/<Ar,Ar>
    T rr[PPT], yr[PPT], ar[PPT];
    Points<PPT> pt = band_points<PPT, NS>(g, bd);
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
        const int e = bd.p0 + threadIdx.x + k * kResThreads;
        rr[k] = e < bd.p1 ? b[e] : T(0);
        yr[k] = T(0);
    }
    mirror_from(rs, b, g, bd);
    __syncthreads();
    stencil_pass<T, PPT, NS, kPassShape<2, T, PPT, NS>>(g, coef, tm, rs, bd, pt, ar);
    T st[3] = {T(0), T(0), T(0)};  // <b,b>, <b,Ab>, <Ab,Ab>
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
        const int e = bd.p0 + threadIdx.x + k * kResThreads;
        if (e < bd.p1) {
            st[0] = add(st[0], mul(rr[k], rr[k]));
            st[1] = add(st[1], mul(rr[k], ar[k]));
            st[2] = add(st[2], mul(ar[k], ar[k]));
            publish_edge(xbuf, bd, e, ar[k], 1);
        }
    }
    grid_allsum(ex, st, wsum);
    if (lead) trace[0] = sqrt(st[0]) / b_norm;
    const T zeta0 = safe_div(st[1], st[2]);
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
        const int e = bd.p0 + threadIdx.x + k * kResThreads;
        if (e < bd.p1) {
            const T z = mul(-zeta0, rr[k]);
            zs[e - bd.p0] = z;
            xs[e - bd.p0] = -z;
            mrr_start(zeta0, ar[k], yr[k], rr[k]);
            rs[bd.hg + e - bd.p0] = rr[k];
        }
    }
    HaloFetch hf0 = halo_fetch(xbuf, bd);
    halo_apply<T>(xbuf, bd, 1, hf0, [&](int j, int m, T a) {
        T y, r = rs[m];
        mrr_start(zeta0, a, y, r);
        yh[j] = y;
        rs[m] = r;
    });
    __syncthreads();

    int i = 1;
    bool conv = false;
    while (i < maxiter) {
        stencil_pass<T, PPT, NS, kPassShape<2, T, PPT, NS>>(g, coef, tm, rs, bd, pt, ar);
        T mn[3] = {T(0), T(0), T(0)};  // <y,y>, <y,Ar>, and <r,r> for the test
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
            if (bd.p0 + threadIdx.x + k * kResThreads < bd.p1) {
                mn[0] = add(mn[0], mul(yr[k], yr[k]));
                mn[1] = add(mn[1], mul(yr[k], ar[k]));
                mn[2] = add(mn[2], mul(rr[k], rr[k]));
            }
        }
        grid_allsum(ex, mn, wsum);
        // the test reads <r,r> of this sum; its sqrt and division overlap
        // the <r,s>/<s,s> pass, whose edge words a converged exit leaves
        // unread
        const T res = sqrt(mn[2]) / b_norm;
        const T gamma = safe_div(mn[1], mn[0]);
        T rs2[2] = {T(0), T(0)};  // <r,s>, <s,s> with s = Ar - gamma y
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
            const int e = bd.p0 + threadIdx.x + k * kResThreads;
            if (e < bd.p1) {
                const T s = sub(ar[k], mul(gamma, yr[k]));
                rs2[0] = add(rs2[0], mul(rr[k], s));
                rs2[1] = add(rs2[1], mul(s, s));
                publish_edge(xbuf, bd, e, ar[k], i + 1);
            }
        }
        if (lead) trace[min(i, trace_len - 1)] = res;
        if (res < tol) {  // the same in every block: mn is bit-identical
            conv = true;
            break;
        }
        HaloFetch hf = halo_fetch(xbuf, bd);  // the neighbours' Ar edges, early
        grid_allsum(ex, rs2, wsum);
        const T zeta = safe_div(rs2[0], rs2[1]);
        const T eta = mul(-zeta, gamma);
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
            const int e = bd.p0 + threadIdx.x + k * kResThreads;
            if (e < bd.p1) {
                const T z = sub(mul(eta, zs[e - bd.p0]), mul(zeta, rr[k]));
                zs[e - bd.p0] = z;
                xs[e - bd.p0] = sub(xs[e - bd.p0], z);
                mrr_step(eta, zeta, ar[k], yr[k], rr[k]);
                rs[bd.hg + e - bd.p0] = rr[k];
            }
        }
        halo_apply<T>(xbuf, bd, i + 1, hf, [&](int j, int m, T a) {
            T y = yh[j], r = rs[m];
            mrr_step(eta, zeta, a, y, r);
            yh[j] = y;
            rs[m] = r;
        });
        __syncthreads();  // the whole mirror before the next stencil
        ++i;
    }
    if (!conv) {  // diverged exit: one more sum for the final residual
        T rr1[1] = {T(0)};
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
            const int e = bd.p0 + threadIdx.x + k * kResThreads;
            if (e < bd.p1) rr1[0] = add(rr1[0], mul(rr[k], rr[k]));
        }
        grid_allsum(ex, rr1, wsum);
        if (lead) trace[min(i, trace_len - 1)] = sqrt(rr1[0]) / b_norm;
    }
    if (lead) {
        stats[0] = i;
        stats[1] = conv;
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
        const int e = bd.p0 + threadIdx.x + k * kResThreads;
        if (e < bd.p1) x_out[e] = xs[e - bd.p0];
    }
}

template <typename T, int NS>
const void* resident_kernel_ns(int method, int ppt) {
    switch (ppt) {
#define RESIDENT_PPT(P)                                                                       \
        case P:                                                                               \
            return method == 0 ? reinterpret_cast<const void*>(&cg_resident_kernel<T, P, NS>) \
                               : reinterpret_cast<const void*>(&mrr_resident_kernel<T, P, NS>);
        RESIDENT_PPT(1)
        RESIDENT_PPT(2)
        RESIDENT_PPT(4)
        RESIDENT_PPT(8)
#undef RESIDENT_PPT
        default: return nullptr;
    }
}

#if KRYLOV_PART <= 0
// A cooperative grid that only syncs, reps times: mode 0 through
// cooperative groups' grid.sync(), mode 1 through grid_allsum of one
// float64 (the resident kernels' sync).  partials: 2 kResSums words a
// block and 2 kResSums more, zero at launch.
__global__ void sync_probe_kernel(int reps, int mode, Word* partials) {
    if (mode == 0) {
        cg::grid_group grid = cg::this_grid();
        for (int i = 0; i < reps; ++i) grid.sync();
        return;
    }
    __shared__ double wsum[kResSums * (kResWarps + 1)];
    Exchange ex{partials, 0};
    double v[1] = {double(threadIdx.x == 0)};
    for (int i = 0; i < reps; ++i) grid_allsum(ex, v, wsum);
}
#endif

}  // namespace

// The kernel of K4's specialisation P (0: NS = 0, 1: NS = 5, 2: NS = 7;
// pass_index) for dtype (the element size), method and ppt (1, 2, 4 or 8;
// else null).  Each is defined in the compilation of its part.
const void* resident_part0(int dtype, int method, int ppt);
const void* resident_part1(int dtype, int method, int ppt);
const void* resident_part2(int dtype, int method, int ppt);

#define RESIDENT_PART(P, NS)                                                                           \
    const void* resident_part##P(int dtype, int method, int ppt) {                                     \
        return dtype == 8 ? resident_kernel_ns<double, NS>(method, ppt)                                \
               : dtype == 4 ? resident_kernel_ns<float, NS>(method, ppt)                               \
                            : nullptr;                                                                 \
    }

#if KRYLOV_PART < 0 || KRYLOV_PART == 0
RESIDENT_PART(0, 0)
#endif
#if KRYLOV_PART < 0 || KRYLOV_PART == 1
RESIDENT_PART(1, 5)
#endif
#if KRYLOV_PART < 0 || KRYLOV_PART == 2
RESIDENT_PART(2, 7)
#endif

#if KRYLOV_PART <= 0

// One resident solve (method 0 = CG, 1 = MrR; dtype the element size in
// bytes) on blocks bands of the (g0, g1) grid, each of ppt * 512 points at
// most and h = max |d0| halo rows, with smem_bytes of dynamic shared memory
// a block.  xbuf holds 2 h g1 16-byte words a block and partials 2 * 3 a
// block and 2 * 3 more, all zero.  Returns a cudaError_t: an invalid plan, a refused
// attribute or a refused cooperative launch is reported, never worked
// around.
extern "C" int krylov_resident_solve(int method, int dtype, int blocks, int threads, int ppt, int h,
                                     int smem_bytes, const void* coef, const void* b,
                                     const void* scal, void* x, void* trace, void* stats,
                                     void* xbuf, void* partials, int ns, int g0, int g1, int g2,
                                     int is_const, const int* disp, int maxiter, int trace_len,
                                     int ns_pass, const double* weights, void* stream) {
    StencilGeom g;
    if (!make_geom(ns, g0, g1, g2, is_const, disp, &g) || (method != 0 && method != 1) ||
        threads != kResThreads || blocks < 1 || blocks > g0 || blocks > kResMaxBlocks || h < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long rows = (g0 + blocks - 1) / blocks;
    const int part = pass_index(g, ns_pass, weights);
    if (rows * g1 > (long long)ppt * kResThreads || (blocks > 1 && g0 / blocks < h) || part < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const void* kernel = part == 0 ? resident_part0(dtype, method, ppt)
                         : part == 1 ? resident_part1(dtype, method, ppt)
                                     : resident_part2(dtype, method, ppt);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    Terms<double> tmd = make_terms<double>(g, weights);
    Terms<float> tmf = make_terms<float>(g, weights);
    void* tm = dtype == 8 ? static_cast<void*>(&tmd) : static_cast<void*>(&tmf);
    void* args[] = {&g, tm, &h, &coef, &b, &scal, &x, &trace, &stats, &xbuf, &partials,
                    &maxiter, &trace_len};
    err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kResThreads), args, smem_bytes,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// Launches the sync-only cooperative grid: blocks of threads, reps syncs of
// the given mode (see sync_probe_kernel), with its zeroed scratch.
extern "C" int krylov_sync_probe(int blocks, int threads, int reps, int mode, void* partials,
                                 void* stream) {
    if (blocks < 1 || (mode == 1 && (blocks > kResMaxBlocks || threads != kResThreads)))
        return static_cast<int>(cudaErrorInvalidValue);
    void* args[] = {&reps, &mode, &partials};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(&sync_probe_kernel), dim3(blocks), dim3(threads), args, 0,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
#endif
