// K5/K6: whole-solve k-skip MrR (static or adaptive) and k-skip CG on a
// 2-D (or collapsed 3-D) stencil operator, the entire communication-
// avoiding outer loop in one launch.
//
// Replaces krylov_tpu/kernels/fused_kskip.py::fused_kskipmrr_solve_2d
// (_kskipmrr_fused_kernel) and ::fused_kskipcg_solve_2d
// (_kskipcg_fused_kernel).  On the TPU one core ran the loop with the
// vectors in VMEM and the scalar recurrences in SMEM.  Here, as in K2/K3
// (fused.cu), the loop runs in a persistent cooperative grid and the
// vectors live in device memory: K5 keeps ten n-vectors of work (two r, y,
// z, Ar[1], pre_x and two 2-slot rings) besides b and x.  This is the
// route of the systems whose bands do not fit the resident kernels
// (fused_kskip_resident.cu; kernels/fused_kskip.py::plan): every 3-D
// Laplacian from 65^3 points up, and BASELINE row 5, laplace3d(216), N =
// 10.08M, whose work vectors (806 MB in float64) are far above the 50 MB
// L2, so every sweep goes to device memory.
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
// halo are gone: the stencil pass checks bounds (stencil.cuh).
//
// Bound: bytes.  Every sweep reads and writes whole vectors of device
// memory (a stencil's neighbours come from L1/L2): at k a K5 outer
// iteration is k stream stages of 3 reads and 2 writes and a last of 3
// reads (5k + 3 words a point), k + 1 steps of 4 reads and 4 writes, step
// 0 also reading A r and writing pre_x (8k + 10), and the A r pass (2):
// 13k + 15 words, 119 at k = 8, 9.59 GB an outer iteration at row 5 in
// float64, 2.86 ms at 3.35 TB/s.  K6: 5k + 3 + 6k + 7 + 2 = 11k + 12
// words.  The 2k + 3 grid syncs (about 1.5 us each) and the bundle
// reduction (about 3 us) are below 2% of that at row 5.  The stencil pass
// is stencil.cuh's streaming pass: the masked one (NS = 0, one point a
// thread on the grid-stride walk), or for the constant 5- and 7-term
// stencils the one specialised on the term count (tiles of 16-byte chunks
// of one row, the weights as arguments, no division and no test for a
// chunk whose terms lie on the grid), whose instances are built for two
// blocks an SM.
#include <cuda_runtime.h>

#include "reduce.cuh"
#include "stencil.cuh"

#ifndef KRYLOV_PART
#define KRYLOV_PART -1
#endif

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

// Blocks an SM the kernels are built for: two for the specialised pass, so
// that its loads in flight do not cost the second block (at most 128
// registers a thread); the masked pass's instances are built as before.
template <int NS>
constexpr int kMinBlocks = NS > 0 ? 2 : 1;

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
template <typename T, typename Sweep>
__device__ T grid_norm(cg::grid_group& grid, const Sweep& sw, const T* v, T* slots, T* smem) {
    constexpr int V = Sweep::V;
    T s[1] = {T(0)};
    sw.each([&](const Chunk& c) {
        T a[V];
        sw.load(a, v, c);
#pragma unroll
        for (int p = 0; p < V; ++p) s[0] += a[p] * a[p];
    });
    grid_sum(grid, s, slots, smem);
    return sqrt(s[0]);
}

// Whole k-skip CG solve of A x = b from x0 = 0 (the wrapper shifts for x0).
// work holds kWorkVectors[0] n-vectors; partials holds the bundle partials
// (bundle_size(k_max) * nb), kSumSlots * nb grid_sum slots and the
// bundle_size(k_max) totals.  ktrace and adaptive are unused (K5's
// signature, so one launcher serves both).  sp and vec are the specialised
// pass's (NS > 0; see stencil.cuh's SweepOf).
template <typename T, int NS>
__global__ void __launch_bounds__(kThreads, kMinBlocks<NS>)
kskipcg_fused_kernel(StencilGeom g, StreamPass<T> sp, int vec, const T* __restrict__ coef,
                     const T* __restrict__ b, const T* __restrict__ scal, T* x, T* trace, int* nosl,
                     int* ktrace, int* stats, T* work, T* partials, int k, int k_max, int adaptive,
                     int maxiter, int trace_len) {
    using Sweep = typename SweepOf<T, NS, kThreads>::type;
    constexpr int V = Sweep::V;
    cg::grid_group grid = cg::this_grid();
    __shared__ T smem[kBlockSumSmem];
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    T* bundle = reinterpret_cast<T*>(dyn_smem);  // a | f | c
    T* alphas = bundle + bundle_size(k_max);
    T* betas = alphas + k_max + 1;
    const Sweep sw = SweepOf<T, NS, kThreads>::make(g, sp, vec, coef);
    const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
    const size_t n = (size_t)g.g0 * g.g1;
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
    sw.each([&](const Chunk& c) {
        T be[V], zero[V], a[V];
        sw.load(be, b, c);
#pragma unroll
        for (int q = 0; q < V; ++q) zero[q] = T(0);
        sw.store(r, be, c);
        sw.store(pbuf[0], be, c);
        sw.store(x, zero, c);
        sw.stencil(a, b, c);
        sw.store(ap1, a, c);
    });
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
            sw.each([&](const Chunk& c) {
                T ar[V], ap[V], aq[V], ar1[V], apn[V];
                sw.load(ar, ar_s, c);
                sw.load(ap, ap_s, c);
                sw.load(aq, ap_s1, c);
                if (grow) {
                    sw.stencil(ar1, ar_s, c);
                    sw.stencil(apn, ap_s1, c);
                    sw.store(ar_next, ar1, c);
                    sw.store(ap_next, apn, c);
                }
#pragma unroll
                for (int q = 0; q < V; ++q) {
                    v[0] += ar[q] * ar[q];  // a[2s]
                    v[1] += ap[q] * ap[q];  // f[2s]
                    v[2] += ap[q] * aq[q];  // f[2s+1]
                    v[3] += ar[q] * ap[q];  // c[2s]
                    v[4] += ar[q] * aq[q];  // c[2s+1]
                    if (grow)
                        v[5] += ar[q] * ar1[q];  // a[2s+1]
                    else
                        v[5] += aq[q] * aq[q];  // f[2s+2]
                }
            });
            const int ent[6] = {2 * s, fo + 2 * s, fo + 2 * s + 1, co + 2 * s, co + 2 * s + 1,
                                grow ? 2 * s + 1 : fo + 2 * s + 2};
            stage_partials(v, ent, partials, smem);
            grid.sync();
        }
        reduce_bundle(grid, partials, totals, bundle_size(k), bundle, smem);

        const T res = sqrt(bundle[0]) / b_norm;
        if (lead) trace[min(index, trace_len - 1)] = res;
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
            sw.each([&](const Chunk& c) {
                T ap[V], pe[V], xe[V], re[V], pn[V];
                if (t == 0)
                    sw.load(ap, ap1, c);
                else
                    sw.stencil(ap, p, c);
                sw.load(pe, p, c);
                sw.load(xe, x, c);
                sw.load(re, r, c);
#pragma unroll
                for (int q = 0; q < V; ++q) {
                    xe[q] += alpha * pe[q];
                    const T rn = re[q] - alpha * ap[q];
                    re[q] = rn;
                    pn[q] = rn + beta * pe[q];
                }
                sw.store(x, xe, c);
                sw.store(r, re, c);
                sw.store(p_next, pn, c);
            });
            grid.sync();
            pc ^= 1;
        }
        sw.each([&](const Chunk& c) {
            T a[V];
            sw.stencil(a, pbuf[pc], c);
            sw.store(ap1, a, c);
        });
        grid.sync();

        if (lead) nosl[min(index + 1, trace_len - 1)] = i + k + 1;
        i += k + 1;
        ++index;
    }
    if (!conv) {  // diverged exit writes the final residual
        const T res = grid_norm(grid, sw, r, slots, smem) / b_norm;
        if (lead) trace[min(index, trace_len - 1)] = res;
    }
    if (lead) {
        stats[0] = i;
        stats[1] = conv;
        stats[2] = index;
    }
}

// The stream of one k-skip MrR outer iteration at k: bases Ar[0..k+1]
// (Ar[0] = r, Ar[1] = the carried ar1) and Ay[0..k] (Ay[0] = y), then the
// bundle alpha | beta | delta reduced into every block's shared bundle.
template <typename T, typename Sweep>
__device__ void kskipmrr_stream(cg::grid_group& grid, const Sweep& sw, const T* r, const T* ar1,
                                const T* y, T* const (&ar_ring)[2], T* const (&ay_ring)[2], int k,
                                T* partials, T* totals, T* bundle, T* smem) {
    constexpr int V = Sweep::V;
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
        sw.each([&](const Chunk& c) {
            T ar[V], aq[V], ay[V], arn[V], ayn[V];
            sw.load(ar, ar_s, c);
            sw.load(aq, ar_s1, c);
            sw.load(ay, ay_s, c);
            if (grow) {
                sw.stencil(arn, ar_s1, c);
                sw.stencil(ayn, ay_s, c);
                sw.store(ar_next, arn, c);
                sw.store(ay_next, ayn, c);
            }
#pragma unroll
            for (int q = 0; q < V; ++q) {
                v[0] += ar[q] * ar[q];  // alpha[2s]
                v[1] += ar[q] * aq[q];  // alpha[2s+1]
                v[2] += ay[q] * ar[q];  // beta[2s]
                v[3] += ay[q] * aq[q];  // beta[2s+1]
                v[4] += ay[q] * ay[q];  // delta[2s]
                if (grow)
                    v[5] += ay[q] * ayn[q];  // delta[2s+1]
                else
                    v[5] += aq[q] * aq[q];  // alpha[2s+2]
            }
        });
        const int ent[6] = {2 * s, 2 * s + 1, bo + 2 * s, bo + 2 * s + 1, dof + 2 * s,
                            grow ? dof + 2 * s + 1 : 2 * s + 2};
        stage_partials(v, ent, partials, smem);
        grid.sync();
    }
    reduce_bundle(grid, partials, totals, bundle_size(k), bundle, smem);
}

// k+1 MrR steps at the (zeta, eta) of the outer iteration: the stencil A r
// of step t and the update of step t share a pass; step 0 takes the
// carried A r, and saves x into pre_x first where `save`.  Then the pass
// forming the carried A r of the new r.  Returns the ring index of r.
template <typename T, typename Sweep>
__device__ int kskipmrr_steps(cg::grid_group& grid, const Sweep& sw, T* const (&rbuf)[2], int rc, T* y, T* z,
                              T* x, T* pre_x, T* ar1, const T* zetas, const T* etas, int k, bool save) {
    constexpr int V = Sweep::V;
    for (int t = 0; t <= k; ++t) {
        const T zeta = zetas[t];
        const T eta = etas[t];
        const T* r = rbuf[rc];
        T* r_next = rbuf[rc ^ 1];
        const bool keep = t == 0 && save;
        sw.each([&](const Chunk& c) {
            T a[V], re[V], ye[V], ze[V], xe[V], rn[V];
            if (t == 0)
                sw.load(a, ar1, c);
            else
                sw.stencil(a, r, c);
            sw.load(re, r, c);
            sw.load(ye, y, c);
            sw.load(ze, z, c);
            sw.load(xe, x, c);
#pragma unroll
            for (int q = 0; q < V; ++q) {
                const T yn = eta * ye[q] + zeta * a[q];
                const T zn = eta * ze[q] - zeta * re[q];
                ye[q] = yn;
                ze[q] = zn;
                rn[q] = re[q] - yn;
            }
            sw.store(y, ye, c);
            sw.store(z, ze, c);
            sw.store(r_next, rn, c);
            if (keep) sw.store(pre_x, xe, c);
#pragma unroll
            for (int q = 0; q < V; ++q) xe[q] = xe[q] - ze[q];
            sw.store(x, xe, c);
        });
        grid.sync();
        rc ^= 1;
    }
    sw.each([&](const Chunk& c) {
        T a[V];
        sw.stencil(a, rbuf[rc], c);
        sw.store(ar1, a, c);
    });
    grid.sync();
    return rc;
}

// Whole k-skip MrR solve of A x = b from x0 = 0, adaptive (rollback and
// k decrement) when `adaptive` is nonzero.  Buffers as in the CG kernel,
// with kWorkVectors[1] n-vectors of work.
template <typename T, int NS>
__global__ void __launch_bounds__(kThreads, kMinBlocks<NS>)
kskipmrr_fused_kernel(StencilGeom g, StreamPass<T> sp, int vec, const T* __restrict__ coef,
                      const T* __restrict__ b, const T* __restrict__ scal, T* x, T* trace, int* nosl,
                      int* ktrace, int* stats, T* work, T* partials, int k, int k_max, int adaptive,
                      int maxiter, int trace_len) {
    using Sweep = typename SweepOf<T, NS, kThreads>::type;
    constexpr int V = Sweep::V;
    cg::grid_group grid = cg::this_grid();
    __shared__ T smem[kBlockSumSmem];
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    T* bundle = reinterpret_cast<T*>(dyn_smem);  // alpha | beta | delta
    T* zetas = bundle + bundle_size(k_max);
    T* etas = zetas + k_max + 1;
    const Sweep sw = SweepOf<T, NS, kThreads>::make(g, sp, vec, coef);
    const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
    const size_t n = (size_t)g.g0 * g.g1;
    T* const rbuf[2] = {work, work + n};
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
    sw.each([&](const Chunk& c) {
        T a[V], be[V];
        sw.stencil(a, b, c);
        sw.load(be, b, c);
        sw.store(ar1, a, c);
#pragma unroll
        for (int q = 0; q < V; ++q) {
            s3[0] += be[q] * be[q];
            s3[1] += be[q] * a[q];
            s3[2] += a[q] * a[q];
        }
    });
    grid_sum(grid, s3, slots, smem);
    const T res0 = sqrt(s3[0]) / b_norm;
    if (lead) {
        trace[0] = res0;
        nosl[1] = 1;
        ktrace[0] = k;
        ktrace[1] = k;
    }
    int rc = 0;  // rbuf[rc] holds r
    {
        const T zeta = safe_div(s3[1], s3[2]);
        sw.each([&](const Chunk& c) {
            T be[V], a[V], ye[V], ze[V], re[V], xe[V];
            sw.load(be, b, c);
            sw.load(a, ar1, c);
#pragma unroll
            for (int q = 0; q < V; ++q) {
                ye[q] = zeta * a[q];
                ze[q] = -zeta * be[q];
                re[q] = be[q] - ye[q];
                xe[q] = -ze[q];
            }
            sw.store(y, ye, c);
            sw.store(z, ze, c);
            sw.store(rbuf[rc], re, c);
            sw.store(x, xe, c);
            if (adaptive) sw.store(pre_x, xe, c);
        });
        grid.sync();
        sw.each([&](const Chunk& c) {
            T a[V];
            sw.stencil(a, rbuf[rc], c);
            sw.store(ar1, a, c);
        });
        grid.sync();
    }

    T pre_res = res0;
    int kk = k, i = 1, index = 1;
    bool conv = false;
    while (i < maxiter) {
        kskipmrr_stream(grid, sw, rbuf[rc], ar1, y, ar_ring, ay_ring, kk, partials, totals, bundle, smem);
        T res = sqrt(bundle[0]) / b_norm;  // <r, r> = alpha[0]
        if (lead) trace[min(index, trace_len - 1)] = res;
        bool accept = true;  // copy x to pre_x before this iteration's steps
        if (adaptive) {
            // non-finite counts as rose (NaN compares false)
            if (res > pre_res || !isfinite(res)) {
                accept = false;
                T* r = rbuf[rc];
                // roll back: r = b - A pre_x, one MrR half-step, A r
                sw.each([&](const Chunk& c) {
                    T a[V], be[V];
                    sw.stencil(a, pre_x, c);
                    sw.load(be, b, c);
#pragma unroll
                    for (int q = 0; q < V; ++q) be[q] = be[q] - a[q];
                    sw.store(r, be, c);
                });
                grid.sync();
                T s2[2] = {T(0), T(0)};
                sw.each([&](const Chunk& c) {
                    T a[V], re[V];
                    sw.stencil(a, r, c);
                    sw.load(re, r, c);
                    sw.store(ar1, a, c);
#pragma unroll
                    for (int q = 0; q < V; ++q) {
                        s2[0] += re[q] * a[q];
                        s2[1] += a[q] * a[q];
                    }
                });
                grid_sum(grid, s2, slots, smem);
                const T zeta = safe_div(s2[0], s2[1]);
                sw.each([&](const Chunk& c) {
                    T re[V], a[V], px[V], ye[V], ze[V];
                    sw.load(re, r, c);
                    sw.load(a, ar1, c);
                    sw.load(px, pre_x, c);
#pragma unroll
                    for (int q = 0; q < V; ++q) {
                        ye[q] = zeta * a[q];
                        ze[q] = -zeta * re[q];
                        re[q] = re[q] - ye[q];
                        px[q] = px[q] - ze[q];
                    }
                    sw.store(y, ye, c);
                    sw.store(z, ze, c);
                    sw.store(r, re, c);
                    sw.store(x, px, c);
                });
                grid.sync();
                sw.each([&](const Chunk& c) {
                    T a[V];
                    sw.stencil(a, r, c);
                    sw.store(ar1, a, c);
                });
                grid.sync();
                kk = kk > 1 ? kk - 1 : kk;
                ++i;
                ++index;
                if (lead) {
                    nosl[min(index, trace_len - 1)] = i;
                    ktrace[min(index, trace_len - 1)] = kk;
                }
                kskipmrr_stream(grid, sw, r, ar1, y, ar_ring, ay_ring, kk, partials, totals, bundle, smem);
                res = sqrt(bundle[0]) / b_norm;
                if (lead) trace[min(index, trace_len - 1)] = res;
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

        rc = kskipmrr_steps(grid, sw, rbuf, rc, y, z, x, pre_x, ar1, zetas, etas, kk, adaptive && accept);

        if (lead) {
            nosl[min(index + 1, trace_len - 1)] = i + kk + 1;
            if (adaptive) ktrace[min(index + 1, trace_len - 1)] = kk;
        }
        i += kk + 1;
        ++index;
    }
    if (!conv) {  // diverged exit writes the final residual
        const T res = grid_norm(grid, sw, rbuf[rc], slots, smem) / b_norm;
        if (lead) trace[min(index, trace_len - 1)] = res;
    }
    if (lead) {
        stats[0] = i;
        stats[1] = conv;
        stats[2] = index;
        stats[3] = kk;
    }
}

// One kind of K5's sweeps alone, reps times, for timing them
// (diagnostics/grid_sweep.py --stream): mode 0 the k + 1 stream stages and
// the bundle reduction (kskipmrr_stream), mode 1 the k + 1 steps and the
// A r pass (kskipmrr_steps, at fixed coefficients, pre_x saved), mode 2 the
// 2k + 3 grid syncs of an outer iteration alone, mode 3 the bundle
// reduction alone, mode 4 the stencil pass alone (the second work vector
// = A times the first, a grid sync after each pass).  work holds 11 n-vectors (K5's ten and x), partials and
// the dynamic shared memory as a solve's at k_max = k.  The values are
// whatever the sweeps make of work's; only the time is read.
template <typename T, int NS>
__global__ void __launch_bounds__(kThreads)
kskip_sweep_probe(StencilGeom g, StreamPass<T> sp, int vec, const T* __restrict__ coef, T* work,
                  T* partials, int mode, int k, int reps) {
    using Sweep = typename SweepOf<T, NS, kThreads>::type;
    cg::grid_group grid = cg::this_grid();
    __shared__ T smem[kBlockSumSmem];
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    T* bundle = reinterpret_cast<T*>(dyn_smem);
    T* zetas = bundle + bundle_size(k);
    T* etas = zetas + k + 1;
    const Sweep sw = SweepOf<T, NS, kThreads>::make(g, sp, vec, coef);
    const size_t n = (size_t)g.g0 * g.g1;
    T* const rbuf[2] = {work, work + n};
    T* const ar_ring[2] = {work + 6 * n, work + 7 * n};
    T* const ay_ring[2] = {work + 8 * n, work + 9 * n};
    T* totals = partials + (size_t)(bundle_size(k) + kSumSlots) * gridDim.x;
    for (int j = threadIdx.x; j <= k; j += kThreads) {
        zetas[j] = T(0.5);
        etas[j] = T(-0.25);
    }
    __syncthreads();
    int rc = 0;
    for (int rep = 0; rep < reps; ++rep) {
        if (mode == 0) {
            kskipmrr_stream(grid, sw, rbuf[rc], work + 4 * n, work + 2 * n, ar_ring, ay_ring, k, partials,
                            totals, bundle, smem);
        } else if (mode == 1) {
            rc = kskipmrr_steps(grid, sw, rbuf, rc, work + 2 * n, work + 3 * n, work + 10 * n, work + 5 * n,
                                work + 4 * n, zetas, etas, k, true);
        } else if (mode == 2) {
            for (int s = 0; s < 2 * k + 3; ++s) grid.sync();
        } else if (mode == 3) {
            reduce_bundle(grid, partials, totals, bundle_size(k), bundle, smem);
        } else {
            sw.each([&](const Chunk& c) {
                T a[Sweep::V];
                sw.stencil(a, work, c);
                sw.store(work + n, a, c);
            });
            grid.sync();
        }
    }
}

// kernel 0 = k-skip CG, 1 = k-skip MrR, 2 = the sweep probe.
template <typename T, int NS>
const void* kernel_of(int kernel) {
    return kernel == 0   ? reinterpret_cast<const void*>(&kskipcg_fused_kernel<T, NS>)
           : kernel == 1 ? reinterpret_cast<const void*>(&kskipmrr_fused_kernel<T, NS>)
                         : reinterpret_cast<const void*>(&kskip_sweep_probe<T, NS>);
}

}  // namespace

// The kernel of part P: kernels/_build.py compiles this file once for each
// KRYLOV_PART of 0..2, all at once, so that no one nvcc holds the build up;
// part P instantiates the kernels of one specialisation of the pass (0:
// the masked pass, 1: NS = 5, 2: NS = 7) for both methods and dtypes, and
// part 0 also holds the entry points.  Compiled without KRYLOV_PART it
// holds every part.
#define KSKIP_STREAM_DECL(P) const void* kskip_stream_part##P(int kernel, int dtype);
KSKIP_STREAM_DECL(0) KSKIP_STREAM_DECL(1) KSKIP_STREAM_DECL(2)
#undef KSKIP_STREAM_DECL

#define KSKIP_STREAM_PART(P, NS)                                                              \
    const void* kskip_stream_part##P(int kernel, int dtype) {                                 \
        return dtype == 8 ? kernel_of<double, NS>(kernel) : kernel_of<float, NS>(kernel);     \
    }

#if KRYLOV_PART < 0 || KRYLOV_PART == 0
KSKIP_STREAM_PART(0, 0)
#endif
#if KRYLOV_PART < 0 || KRYLOV_PART == 1
KSKIP_STREAM_PART(1, 5)
#endif
#if KRYLOV_PART < 0 || KRYLOV_PART == 2
KSKIP_STREAM_PART(2, 7)
#endif

#if KRYLOV_PART <= 0
namespace {

// The kernel for a launch: kernel as in kernel_of, dtype the element size,
// ns_pass the specialisation (0, 5 or 7; else null).
const void* stream_kernel(int kernel, int dtype, int ns_pass) {
    switch (ns_pass) {
        case 0: return kskip_stream_part0(kernel, dtype);
        case 5: return kskip_stream_part1(kernel, dtype);
        case 7: return kskip_stream_part2(kernel, dtype);
        default: return nullptr;
    }
}

}  // namespace

// The work space of a solve of n points with k <= k_max: the blocks of the
// cooperative grid (as many as can be resident on the current device at
// once, and no more than n needs), the elements of the work and partials
// buffers that krylov_kskip_solve takes, and the bytes of dynamic shared
// memory a block takes.  method 0 = k-skip CG, 1 = k-skip MrR, 2 the sweep
// probe; dtype is the element size in bytes; ns_pass the pass (0, 5, 7),
// whose kernel's occupancy sizes the grid; max_blocks > 0 caps the grid
// (for grid-size sweeps).
extern "C" int krylov_kskip_workspace(int method, int dtype, int n, int k_max, int max_blocks, int ns_pass,
                                      int* blocks, long long* work_elems, long long* partial_elems,
                                      int* smem_bytes) {
    if (method < 0 || method > 2 || (dtype != 4 && dtype != 8) || k_max < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = dyn_elems(k_max) * dtype;
    const void* kernel = stream_kernel(method, dtype, ns_pass);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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
    *work_elems = static_cast<long long>(method == 2 ? 11 : kWorkVectors[method]) * n;
    *partial_elems = static_cast<long long>(bundle_size(k_max) + kSumSlots) * *blocks +
                     bundle_size(k_max);
    *smem_bytes = smem;
    return 0;
}

// work, partials and smem_bytes are sized by krylov_kskip_workspace for the
// same method, dtype, n, k_max, ns_pass and blocks; disp is the (3, ns)
// displacement array; ns_pass the pass (0: masked; 5 or 7: specialised,
// with the ns constant weights as doubles).  ktrace is written by the MrR
// kernel only.
extern "C" int krylov_kskip_solve(int method, int dtype, int blocks, int smem_bytes, int k,
                                  int k_max, int adaptive, const void* coef, const void* b,
                                  const void* scal, void* x, void* trace, void* nosl,
                                  void* ktrace, void* stats, void* work, void* partials,
                                  int ns, int g0, int g1, int g2, int is_const, const int* disp,
                                  int maxiter, int trace_len, int ns_pass, const double* weights,
                                  void* stream) {
    StencilGeom g;
    if (!make_geom(ns, g0, g1, g2, is_const, disp, &g) || k < 0 || k > k_max ||
        (method != 0 && method != 1) || (dtype != 4 && dtype != 8) || (long long)g0 * g1 >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const void* kernel = stream_kernel(method, dtype, ns_pass);
    const bool aligned = aligned16({b, x, work});
    StreamPass<double> spd;
    StreamPass<float> spf;
    int vec = 0;
    const bool ok = dtype == 8 ? stream_pass(g, ns_pass, weights, aligned, kThreads, &spd, &vec)
                               : stream_pass(g, ns_pass, weights, aligned, kThreads, &spf, &vec);
    if (kernel == nullptr || !ok) return static_cast<int>(cudaErrorInvalidValue);
    void* sp = dtype == 8 ? static_cast<void*>(&spd) : static_cast<void*>(&spf);
    void* args[] = {&g,     sp,    &vec,  &coef,     &b, &scal,  &x,     &trace,    &nosl,    &ktrace,
                    &stats, &work, &partials, &k, &k_max, &adaptive, &maxiter, &trace_len};
    const cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args,
                                                        static_cast<size_t>(smem_bytes),
                                                        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// kskip_sweep_probe: reps of one kind of K5's sweeps (mode 0..4) at k on
// the grid krylov_kskip_workspace sizes for method 2 (work, partials and
// smem_bytes from it, k_max = k), with the pass ns_pass as in
// krylov_kskip_solve.
extern "C" int krylov_kskip_sweep_probe(int dtype, int blocks, int smem_bytes, int mode, int k, int reps,
                                        const void* coef, void* work, void* partials, int ns, int g0, int g1,
                                        int g2, int is_const, const int* disp, int ns_pass,
                                        const double* weights, void* stream) {
    StencilGeom g;
    if (!make_geom(ns, g0, g1, g2, is_const, disp, &g) || k < 1 || mode < 0 || mode > 4 || reps < 0 ||
        (dtype != 4 && dtype != 8) || (long long)g0 * g1 >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const void* kernel = stream_kernel(2, dtype, ns_pass);
    StreamPass<double> spd;
    StreamPass<float> spf;
    int vec = 0;
    const bool ok = dtype == 8 ? stream_pass(g, ns_pass, weights, aligned16({work}), kThreads, &spd, &vec)
                               : stream_pass(g, ns_pass, weights, aligned16({work}), kThreads, &spf, &vec);
    if (kernel == nullptr || !ok) return static_cast<int>(cudaErrorInvalidValue);
    void* sp = dtype == 8 ? static_cast<void*>(&spd) : static_cast<void*>(&spf);
    void* args[] = {&g, sp, &vec, &coef, &work, &partials, &mode, &k, &reps};
    const cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args,
                                                        static_cast<size_t>(smem_bytes),
                                                        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
#endif
