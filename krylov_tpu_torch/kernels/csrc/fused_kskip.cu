// K5/K6: whole-solve k-skip MrR (static or adaptive) and k-skip CG on a
// 2-D (or collapsed 3-D) stencil operator, the entire communication-
// avoiding outer loop in one launch.
//
// Replaces krylov_tpu/kernels/fused_kskip.py::fused_kskipmrr_solve_2d
// (_kskipmrr_fused_kernel) and ::fused_kskipcg_solve_2d
// (_kskipcg_fused_kernel).  On the TPU one core ran the loop with the
// vectors in VMEM and the scalar recurrences in SMEM.  Here, as in K2/K3
// (fused.cu), the loop runs in a persistent cooperative grid and the
// vectors live in device memory: K5 touches ~12 n-vectors (b, x, two r,
// y, z, Ar[1], pre_x and two 2-slot rings), ~24 MB in f64 at N = 250k,
// which stays in the 50 MB L2.
//
// An outer iteration, for K6 (K5 alike with Ar/Ay for Ar/Ap):
// - Stream: the Krylov bases are never materialised.  Stage s reads
//   Ar[s] and Ap[s], Ap[s+1] pointwise and the neighbours of Ar[s] and
//   Ap[s+1], writes Ar[s+1] and Ap[s+2] into 2-slot rings (Ar[0] is r,
//   Ap[0] is p, Ap[1] a carried A p, so nothing is copied), and adds the
//   stage's 6 inner products into per-block partials, one slot per bundle
//   entry.  A slot of a ring is overwritten one stage after the last
//   stencil that read it, so one grid sync a stage is enough.
// - One reduction for the whole 6k+6 bundle, the point of the method: block
//   j sums the partials of entry j over all blocks in a fixed order and
//   writes the total; after a grid sync every block reads the 6k+6 totals.
//   Each block reads 6k+6 scalars instead of (6k+6) * nb partials, and all
//   blocks hold the same bits, so they take the same branch.
// - The scalar recurrences read no vector, so thread 0 of every block
//   derives all k+1 step coefficients at once, in dynamic shared memory
//   sized by k_max (no compile-time cap on k); every block runs the same
//   instructions on the same bits.
// - k+1 vector steps.  The vector the stencil reads (p for CG, r for MrR)
//   is double-buffered, so the stencil of step t and the pointwise update
//   of step t+1 share one pass and one grid sync; one more pass forms the
//   carried A p (A r) for the next outer iteration.
// That is about 2k+4 grid syncs and one bundle reduction per k+1 solution
// updates, against 3 syncs and 1-2 full reductions per update in K2/K3.
//
// The adaptive mode of K5 reads the residual from the bundle's <r,r>: the
// stream runs first, then the guard `res > pre_res || !isfinite(res)`
// (the same in every block).  A rollback recomputes r = b - A pre_x, takes
// one MrR half-step and lowers k (floor 1), then streams again from the
// new state at the new k.  The TPU kernel's zero padding (_prep) and its
// halo are gone: the stencil device function checks bounds (stencil.cuh).
//
// Bound: at N = 250k the grid syncs (a few microseconds each) and the
// stencil passes through L2; the bundle reduction is one pass over
// (6k+6) * nb partials spread over the blocks.
#include <cuda_runtime.h>

#include "reduce.cuh"
#include "stencil.cuh"

namespace {

constexpr int kSumSlots = 3;  // grid_sum slots: init (3 sums), rollback, final
// n-vectors of work space.  CG: r, two p, A p, Ar ring (2), Ap ring (2).
// MrR: two r, y, z, Ar[1], pre_x, Ar ring (2), Ay ring (2).
constexpr int kWorkVectors[2] = {8, 10};

__host__ __device__ constexpr int bundle_size(int k) { return 6 * k + 6; }

// Elements of dynamic shared memory: the bundle and 2 (k_max + 1) step
// coefficients.
__host__ __device__ constexpr int dyn_elems(int k_max) {
    return bundle_size(k_max) + 2 * (k_max + 1);
}

// Per-block view of the persistent grid: this thread's first point and
// the stride of the grid-stride loops.
struct Walk {
    int n, first, stride;
    bool lead;  // block 0, thread 0: writes the traces and stats
};

__device__ __forceinline__ Walk make_walk(const StencilGeom& g) {
    Walk w;
    w.n = g.g0 * g.g1;
    w.first = blockIdx.x * kThreads + threadIdx.x;
    w.stride = gridDim.x * kThreads;
    w.lead = blockIdx.x == 0 && threadIdx.x == 0;
    return w;
}

// Adds this block's sums of a stage's 6 inner products to the partials:
// v[d] goes to entry ent[d] (slot ent[d] * nb + block).
template <typename T>
__device__ void stage_partials(T (&v)[6], const int (&ent)[6], T* partials, T* smem) {
    block_sum(v, smem);
    if (threadIdx.x == 0)
        for (int d = 0; d < 6; ++d) partials[(size_t)ent[d] * gridDim.x + blockIdx.x] = v[d];
}

// After the stream's last grid sync: block j sums entry j (and j + nb, ...)
// over all blocks in a fixed order and writes totals[j]; after a grid sync
// every block copies the m totals into its shared bundle.
template <typename T>
__device__ void reduce_bundle(cg::grid_group& grid, const T* partials, T* totals, int m,
                              T* bundle, T* smem) {
    const int nb = gridDim.x;
    for (int j = blockIdx.x; j < m; j += nb) {
        T v[1] = {T(0)};
        for (int t = threadIdx.x; t < nb; t += kThreads) v[0] += __ldcg(partials + (size_t)j * nb + t);
        block_sum(v, smem);
        if (threadIdx.x == 0) totals[j] = v[0];
    }
    grid.sync();
    for (int j = threadIdx.x; j < m; j += kThreads) bundle[j] = __ldcg(totals + j);
    __syncthreads();
}

// ||v||: a grid_sum over the slots (contains a grid sync).
template <typename T>
__device__ T grid_norm(cg::grid_group& grid, const Walk& w, const T* v, T* slots, T* smem) {
    T s[1] = {T(0)};
    for (int e = w.first; e < w.n; e += w.stride) s[0] += v[e] * v[e];
    grid_sum(grid, s, slots, smem);
    return sqrt(s[0]);
}

// The k+1 (alpha, beta) of the k-skip CG steps from the bundle a/f/c,
// which the recurrences advance in place (one thread).
template <typename T>
__device__ void kskipcg_scalars(T* a, T* f, T* c, int k, T* alphas, T* betas) {
    T alpha = safe_div(a[0], f[1]);
    T beta = safe_div(alpha * alpha * f[2], a[0]) - T(1);
    alphas[0] = alpha;
    betas[0] = beta;
    for (int j = 0; j < k; ++j) {
        for (int l = 0; l < 2 * (k - j) + 1; ++l) {
            a[l] = a[l] + alpha * (alpha * f[l + 2] - T(2) * c[l + 1]);
            const T d = c[l] - alpha * f[l + 1];
            c[l] = a[l] + d * beta;
            f[l] = c[l] + beta * (d + beta * f[l]);
        }
        alpha = safe_div(a[0], f[1]);
        beta = safe_div(alpha * alpha * f[2], a[0]) - T(1);
        alphas[j + 1] = alpha;
        betas[j + 1] = beta;
    }
}

// The k+1 (zeta, eta) of the k-skip MrR steps from the bundle al/be/de
// (be[0] is set to 0), advanced in place by the recurrences (one thread).
template <typename T>
__device__ void kskipmrr_scalars(T* al, T* be, T* de, int k, T* zetas, T* etas) {
    be[0] = T(0);
    T d0 = al[2] * de[0] - be[1] * be[1];
    T zeta = safe_div(al[1] * de[0], d0);
    T eta = -safe_div(al[1] * be[1], d0);
    zetas[0] = zeta;
    etas[0] = eta;
    for (int j = 0; j < k; ++j) {
        de[0] = zeta * zeta * al[2] + eta * zeta * be[1];
        al[0] = al[0] - zeta * al[1];
        de[1] = eta * eta * de[1] + T(2) * eta * zeta * be[2] + zeta * zeta * al[3];
        be[1] = eta * be[1] + zeta * al[2] - de[1];
        al[1] = -be[1];
        for (int l = 2; l < 2 * (k - j) + 1; ++l) {
            de[l] = eta * eta * de[l] + T(2) * eta * zeta * be[l + 1] + zeta * zeta * al[l + 2];
            const T tau = eta * be[l] + zeta * al[l + 1];
            be[l] = tau - de[l];
            al[l] = al[l] - tau - be[l];
        }
        d0 = al[2] * de[0] - be[1] * be[1];
        zeta = safe_div(al[1] * de[0], d0);
        eta = -safe_div(al[1] * be[1], d0);
        zetas[j + 1] = zeta;
        etas[j + 1] = eta;
    }
}

// Whole k-skip CG solve of A x = b from x0 = 0 (the wrapper shifts for x0).
// work holds kWorkVectors[0] n-vectors; partials holds the bundle partials
// (bundle_size(k_max) * nb), kSumSlots * nb grid_sum slots and the
// bundle_size(k_max) totals.  ktrace and adaptive are unused (K5's
// signature, so one launcher serves both).
template <typename T>
__global__ void __launch_bounds__(kThreads)
kskipcg_fused_kernel(StencilGeom g, const T* __restrict__ coef, const T* __restrict__ b,
                     const T* __restrict__ scal, T* x, T* trace, int* nosl, int* ktrace,
                     int* stats, T* work, T* partials, int k, int k_max, int adaptive,
                     int maxiter, int trace_len) {
    cg::grid_group grid = cg::this_grid();
    __shared__ T smem[kBlockSumSmem];
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    T* bundle = reinterpret_cast<T*>(dyn_smem);  // a | f | c
    T* alphas = bundle + bundle_size(k_max);
    T* betas = alphas + k_max + 1;
    const Walk w = make_walk(g);
    const size_t n = w.n;
    T* r = work;
    T* pbuf[2] = {work + n, work + 2 * n};
    T* ap1 = work + 3 * n;  // A p, carried across outer iterations
    T* ar_ring[2] = {work + 4 * n, work + 5 * n};
    T* ap_ring[2] = {work + 6 * n, work + 7 * n};
    T* slots = partials + (size_t)bundle_size(k_max) * gridDim.x;
    T* totals = slots + (size_t)kSumSlots * gridDim.x;
    const T tol = scal[0];
    const T b_norm = scal[1];
    const int fo = 2 * k + 1;  // offset of f in the bundle
    const int co = 4 * k + 4;  // offset of c

    // r = p = b, x = 0, A p
    for (int e = w.first; e < w.n; e += w.stride) {
        const T be = b[e];
        r[e] = be;
        pbuf[0][e] = be;
        x[e] = T(0);
        ap1[e] = apply_stencil(g, coef, b, e);
    }
    grid.sync();

    int pc = 0;  // pbuf[pc] holds p
    int i = 0, index = 0;
    bool conv = false;
    while (i < maxiter) {
        // stream: Ar[s] (Ar[0] = r) and Ap[s] (Ap[0] = p, Ap[1] = ap1)
        for (int s = 0; s <= k; ++s) {
            const T* ar_s = s == 0 ? r : ar_ring[s & 1];
            const T* ap_s = s == 0 ? pbuf[pc] : (s == 1 ? ap1 : ap_ring[s & 1]);
            const T* ap_s1 = s == 0 ? ap1 : ap_ring[(s + 1) & 1];
            T* ar_next = ar_ring[(s + 1) & 1];  // Ar[s+1]
            T* ap_next = ap_ring[s & 1];        // Ap[s+2]
            const bool grow = s < k;
            T v[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
            for (int e = w.first; e < w.n; e += w.stride) {
                const T ar = ar_s[e];
                const T ap = ap_s[e];
                const T aq = ap_s1[e];
                v[0] += ar * ar;  // a[2s]
                v[1] += ap * ap;  // f[2s]
                v[2] += ap * aq;  // f[2s+1]
                v[3] += ar * ap;  // c[2s]
                v[4] += ar * aq;  // c[2s+1]
                if (grow) {
                    const T ar1 = apply_stencil(g, coef, ar_s, e);
                    const T apn = apply_stencil(g, coef, ap_s1, e);
                    ar_next[e] = ar1;
                    ap_next[e] = apn;
                    v[5] += ar * ar1;  // a[2s+1]
                } else {
                    v[5] += aq * aq;  // f[2s+2]
                }
            }
            const int ent[6] = {2 * s, fo + 2 * s, fo + 2 * s + 1, co + 2 * s, co + 2 * s + 1,
                                grow ? 2 * s + 1 : fo + 2 * s + 2};
            stage_partials(v, ent, partials, smem);
            grid.sync();
        }
        reduce_bundle(grid, partials, totals, bundle_size(k), bundle, smem);

        const T res = sqrt(bundle[0]) / b_norm;
        if (w.lead) trace[min(index, trace_len - 1)] = res;
        if (res < tol) {  // the same in every block: the bundle is bit-identical
            conv = true;
            break;
        }
        __syncthreads();  // every thread has read bundle[0]
        if (threadIdx.x == 0) kskipcg_scalars(bundle, bundle + fo, bundle + co, k, alphas, betas);
        __syncthreads();

        // k+1 CG steps: the stencil of step t's p and the update of step t
        // share a pass; step 0 takes the carried A p
        for (int t = 0; t <= k; ++t) {
            const T alpha = alphas[t];
            const T beta = betas[t];
            const T* p = pbuf[pc];
            T* p_next = pbuf[pc ^ 1];
            for (int e = w.first; e < w.n; e += w.stride) {
                const T ap = t == 0 ? ap1[e] : apply_stencil(g, coef, p, e);
                const T pe = p[e];
                x[e] += alpha * pe;
                const T rn = r[e] - alpha * ap;
                r[e] = rn;
                p_next[e] = rn + beta * pe;
            }
            grid.sync();
            pc ^= 1;
        }
        for (int e = w.first; e < w.n; e += w.stride) ap1[e] = apply_stencil(g, coef, pbuf[pc], e);
        grid.sync();

        if (w.lead) nosl[min(index + 1, trace_len - 1)] = i + k + 1;
        i += k + 1;
        ++index;
    }
    if (!conv) {  // diverged exit writes the final residual
        const T res = grid_norm(grid, w, r, slots, smem) / b_norm;
        if (w.lead) trace[min(index, trace_len - 1)] = res;
    }
    if (w.lead) {
        stats[0] = i;
        stats[1] = conv;
        stats[2] = index;
    }
}

// The stream of one k-skip MrR outer iteration at k: bases Ar[0..k+1]
// (Ar[0] = r, Ar[1] = the carried ar1) and Ay[0..k] (Ay[0] = y), then the
// bundle alpha | beta | delta reduced into every block's shared bundle.
template <typename T>
__device__ void kskipmrr_stream(cg::grid_group& grid, const StencilGeom& g, const Walk& w,
                                const T* __restrict__ coef, const T* r, const T* ar1, const T* y,
                                T* const (&ar_ring)[2], T* const (&ay_ring)[2], int k,
                                T* partials, T* totals, T* bundle, T* smem) {
    const int bo = 2 * k + 3;  // offset of beta in the bundle
    const int dof = 4 * k + 5;  // offset of delta
    for (int s = 0; s <= k; ++s) {
        const T* ar_s = s == 0 ? r : (s == 1 ? ar1 : ar_ring[s & 1]);
        const T* ar_s1 = s == 0 ? ar1 : ar_ring[(s + 1) & 1];
        const T* ay_s = s == 0 ? y : ay_ring[s & 1];
        T* ar_next = ar_ring[s & 1];        // Ar[s+2]
        T* ay_next = ay_ring[(s + 1) & 1];  // Ay[s+1]
        const bool grow = s < k;
        T v[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
        for (int e = w.first; e < w.n; e += w.stride) {
            const T ar = ar_s[e];
            const T aq = ar_s1[e];
            const T ay = ay_s[e];
            v[0] += ar * ar;  // alpha[2s]
            v[1] += ar * aq;  // alpha[2s+1]
            v[2] += ay * ar;  // beta[2s]
            v[3] += ay * aq;  // beta[2s+1]
            v[4] += ay * ay;  // delta[2s]
            if (grow) {
                const T arn = apply_stencil(g, coef, ar_s1, e);
                const T ayn = apply_stencil(g, coef, ay_s, e);
                ar_next[e] = arn;
                ay_next[e] = ayn;
                v[5] += ay * ayn;  // delta[2s+1]
            } else {
                v[5] += aq * aq;  // alpha[2s+2]
            }
        }
        const int ent[6] = {2 * s, 2 * s + 1, bo + 2 * s, bo + 2 * s + 1, dof + 2 * s,
                            grow ? dof + 2 * s + 1 : 2 * s + 2};
        stage_partials(v, ent, partials, smem);
        grid.sync();
    }
    reduce_bundle(grid, partials, totals, bundle_size(k), bundle, smem);
}

// Whole k-skip MrR solve of A x = b from x0 = 0, adaptive (rollback and
// k decrement) when `adaptive` is nonzero.  Buffers as in the CG kernel,
// with kWorkVectors[1] n-vectors of work.
template <typename T>
__global__ void __launch_bounds__(kThreads)
kskipmrr_fused_kernel(StencilGeom g, const T* __restrict__ coef, const T* __restrict__ b,
                      const T* __restrict__ scal, T* x, T* trace, int* nosl, int* ktrace,
                      int* stats, T* work, T* partials, int k, int k_max, int adaptive,
                      int maxiter, int trace_len) {
    cg::grid_group grid = cg::this_grid();
    __shared__ T smem[kBlockSumSmem];
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    T* bundle = reinterpret_cast<T*>(dyn_smem);  // alpha | beta | delta
    T* zetas = bundle + bundle_size(k_max);
    T* etas = zetas + k_max + 1;
    const Walk w = make_walk(g);
    const size_t n = w.n;
    T* rbuf[2] = {work, work + n};
    T* y = work + 2 * n;
    T* z = work + 3 * n;
    T* ar1 = work + 4 * n;  // A r, carried across outer iterations
    T* pre_x = work + 5 * n;
    T* const ar_ring[2] = {work + 6 * n, work + 7 * n};
    T* const ay_ring[2] = {work + 8 * n, work + 9 * n};
    T* slots = partials + (size_t)bundle_size(k_max) * gridDim.x;
    T* totals = slots + (size_t)kSumSlots * gridDim.x;
    const T tol = scal[0];
    const T b_norm = scal[1];

    // init half-step from r0 = b: zeta = <r,Ar>/<Ar,Ar>
    T s3[3] = {T(0), T(0), T(0)};
    for (int e = w.first; e < w.n; e += w.stride) {
        const T a = apply_stencil(g, coef, b, e);
        const T be = b[e];
        ar1[e] = a;
        s3[0] += be * be;
        s3[1] += be * a;
        s3[2] += a * a;
    }
    grid_sum(grid, s3, slots, smem);
    const T res0 = sqrt(s3[0]) / b_norm;
    if (w.lead) {
        trace[0] = res0;
        nosl[1] = 1;
        ktrace[0] = k;
        ktrace[1] = k;
    }
    int rc = 0;  // rbuf[rc] holds r
    {
        const T zeta = safe_div(s3[1], s3[2]);
        for (int e = w.first; e < w.n; e += w.stride) {
            const T be = b[e];
            const T ye = zeta * ar1[e];
            const T ze = -zeta * be;
            y[e] = ye;
            z[e] = ze;
            rbuf[rc][e] = be - ye;
            x[e] = -ze;
            if (adaptive) pre_x[e] = -ze;
        }
        grid.sync();
        for (int e = w.first; e < w.n; e += w.stride) ar1[e] = apply_stencil(g, coef, rbuf[rc], e);
        grid.sync();
    }

    T pre_res = res0;
    int kk = k, i = 1, index = 1;
    bool conv = false;
    while (i < maxiter) {
        kskipmrr_stream(grid, g, w, coef, rbuf[rc], ar1, y, ar_ring, ay_ring, kk, partials, totals,
                        bundle, smem);
        T res = sqrt(bundle[0]) / b_norm;  // <r, r> = alpha[0]
        if (w.lead) trace[min(index, trace_len - 1)] = res;
        bool accept = true;  // copy x to pre_x before this iteration's steps
        if (adaptive) {
            // non-finite counts as rose (NaN compares false)
            if (res > pre_res || !isfinite(res)) {
                accept = false;
                T* r = rbuf[rc];
                // roll back: r = b - A pre_x, one MrR half-step, A r
                for (int e = w.first; e < w.n; e += w.stride)
                    r[e] = b[e] - apply_stencil(g, coef, pre_x, e);
                grid.sync();
                T s2[2] = {T(0), T(0)};
                for (int e = w.first; e < w.n; e += w.stride) {
                    const T a = apply_stencil(g, coef, r, e);
                    const T re = r[e];
                    ar1[e] = a;
                    s2[0] += re * a;
                    s2[1] += a * a;
                }
                grid_sum(grid, s2, slots, smem);
                const T zeta = safe_div(s2[0], s2[1]);
                for (int e = w.first; e < w.n; e += w.stride) {
                    const T re = r[e];
                    const T ye = zeta * ar1[e];
                    const T ze = -zeta * re;
                    y[e] = ye;
                    z[e] = ze;
                    r[e] = re - ye;
                    x[e] = pre_x[e] - ze;
                }
                grid.sync();
                for (int e = w.first; e < w.n; e += w.stride) ar1[e] = apply_stencil(g, coef, r, e);
                grid.sync();
                kk = kk > 1 ? kk - 1 : kk;
                ++i;
                ++index;
                if (w.lead) {
                    nosl[min(index, trace_len - 1)] = i;
                    ktrace[min(index, trace_len - 1)] = kk;
                }
                kskipmrr_stream(grid, g, w, coef, r, ar1, y, ar_ring, ay_ring, kk, partials,
                                totals, bundle, smem);
                res = sqrt(bundle[0]) / b_norm;
                if (w.lead) trace[min(index, trace_len - 1)] = res;
            } else {
                pre_res = res;
            }
        }
        if (res < tol) {  // the same in every block
            conv = true;
            break;
        }
        __syncthreads();  // every thread has read bundle[0]
        if (threadIdx.x == 0)
            kskipmrr_scalars(bundle, bundle + 2 * kk + 3, bundle + 4 * kk + 5, kk, zetas, etas);
        __syncthreads();

        // k+1 MrR steps: the stencil A r of step t and the update of step t
        // share a pass; step 0 takes the carried A r
        for (int t = 0; t <= kk; ++t) {
            const T zeta = zetas[t];
            const T eta = etas[t];
            const T* r = rbuf[rc];
            T* r_next = rbuf[rc ^ 1];
            const bool save = t == 0 && adaptive && accept;
            for (int e = w.first; e < w.n; e += w.stride) {
                const T a = t == 0 ? ar1[e] : apply_stencil(g, coef, r, e);
                const T re = r[e];
                const T yn = eta * y[e] + zeta * a;
                const T zn = eta * z[e] - zeta * re;
                y[e] = yn;
                z[e] = zn;
                r_next[e] = re - yn;
                const T xe = x[e];
                if (save) pre_x[e] = xe;
                x[e] = xe - zn;
            }
            grid.sync();
            rc ^= 1;
        }
        for (int e = w.first; e < w.n; e += w.stride) ar1[e] = apply_stencil(g, coef, rbuf[rc], e);
        grid.sync();

        if (w.lead) {
            nosl[min(index + 1, trace_len - 1)] = i + kk + 1;
            if (adaptive) ktrace[min(index + 1, trace_len - 1)] = kk;
        }
        i += kk + 1;
        ++index;
    }
    if (!conv) {  // diverged exit writes the final residual
        const T res = grid_norm(grid, w, rbuf[rc], slots, smem) / b_norm;
        if (w.lead) trace[min(index, trace_len - 1)] = res;
    }
    if (w.lead) {
        stats[0] = i;
        stats[1] = conv;
        stats[2] = index;
        stats[3] = kk;
    }
}

template <typename T>
const void* kernel_for(int method) {
    return method == 0 ? reinterpret_cast<const void*>(&kskipcg_fused_kernel<T>)
                       : reinterpret_cast<const void*>(&kskipmrr_fused_kernel<T>);
}

const void* kernel_for(int method, int dtype) {
    return dtype == 8 ? kernel_for<double>(method) : kernel_for<float>(method);
}

}  // namespace

// The work space of a solve of n points with k <= k_max: the blocks of the
// cooperative grid (as many as can be resident on the current device at
// once, and no more than n needs), the elements of the work and partials
// buffers that krylov_kskip_solve takes, and the bytes of dynamic shared
// memory a block takes.  method 0 = k-skip CG, 1 = k-skip MrR; dtype is
// the element size in bytes; max_blocks > 0 caps the grid (for grid-size
// sweeps).
extern "C" int krylov_kskip_workspace(int method, int dtype, int n, int k_max, int max_blocks,
                                      int* blocks, long long* work_elems,
                                      long long* partial_elems, int* smem_bytes) {
    if ((method != 0 && method != 1) || (dtype != 4 && dtype != 8) || k_max < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = dyn_elems(k_max) * dtype;
    const void* kernel = kernel_for(method, dtype);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && smem > 48 * 1024)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int need = (n + kThreads - 1) / kThreads;
    int fit = per_sm * sms;
    if (max_blocks > 0 && max_blocks < fit) fit = max_blocks;
    *blocks = need < fit ? (need > 0 ? need : 1) : fit;
    *work_elems = static_cast<long long>(kWorkVectors[method]) * n;
    *partial_elems = static_cast<long long>(bundle_size(k_max) + kSumSlots) * *blocks +
                     bundle_size(k_max);
    *smem_bytes = smem;
    return 0;
}

// work, partials and smem_bytes are sized by krylov_kskip_workspace for the
// same method, dtype, n, k_max and blocks; disp is the (3, ns) displacement
// array.  ktrace is written by the MrR kernel only.
extern "C" int krylov_kskip_solve(int method, int dtype, int blocks, int smem_bytes, int k,
                                  int k_max, int adaptive, const void* coef, const void* b,
                                  const void* scal, void* x, void* trace, void* nosl,
                                  void* ktrace, void* stats, void* work, void* partials,
                                  int ns, int g0, int g1, int g2, int is_const, const int* disp,
                                  int maxiter, int trace_len, void* stream) {
    StencilGeom g;
    if (!make_geom(ns, g0, g1, g2, is_const, disp, &g) || k < 0 || k > k_max ||
        (method != 0 && method != 1) || (dtype != 4 && dtype != 8))
        return static_cast<int>(cudaErrorInvalidValue);
    void* args[] = {&g,     &coef,     &b, &scal,  &x,     &trace,   &nosl,      &ktrace,
                    &stats, &work, &partials, &k, &k_max, &adaptive, &maxiter, &trace_len};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        kernel_for(method, dtype), dim3(blocks), dim3(kThreads), args,
        static_cast<size_t>(smem_bytes), static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
