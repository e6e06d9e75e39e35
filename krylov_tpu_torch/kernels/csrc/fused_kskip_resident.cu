// K5/K6, resident route: whole-solve k-skip MrR (static or adaptive) and
// k-skip CG on a 2-D (or collapsed 3-D) stencil operator with the solver
// state and the Krylov bases on chip, the entire outer loop in one launch.
//
// Replaces krylov_tpu/kernels/fused_kskip.py::fused_kskipmrr_solve_2d
// (_kskipmrr_fused_kernel) and ::fused_kskipcg_solve_2d
// (_kskipcg_fused_kernel) for every system whose bands fit the plan of
// kernels/fused_kskip.py::plan (N = 250k in float32 and float64); larger
// systems take the streaming route of fused_kskip.cu.  The TPU kernels kept
// every vector in one core's VMEM; here each of at most one block an SM owns
// a band of rows for the whole solve, as K2/K3's resident route
// (fused_resident.cu) does.
//
// Bound (H100 SXM at 700 W: 34 TFLOP/s float64, 67 float32, 3.35 TB/s): an
// outer iteration at k does 3k + 2 stencils, 6k + 6 products of the bundle
// and k + 1 vector steps; at N = 250k float64 and k = 4 that is about 0.35
// ms of operations a solve against 4 MB of b in and x out, so compute sets
// the bound.  What a design reaches is set by the chain of dependent
// passes: 2k + 2 stencil passes an outer iteration, each needing the halo
// its neighbours produced in the pass before, and one grid-wide sum.
//
// What held the streaming kernels back, and what this design does:
// 1. Every vector lived in device memory (~10 n-vectors for K5), so every
//    pass streamed through L2.  Here a thread owns the same PPT points for
//    the whole solve.  The vectors a stage reads pointwise stay in
//    registers and are carried from stage to stage (K6: Ar[s], Ap[s],
//    Ap[s+1]; K5: Ar[s], Ar[s+1], Ay[s]), as are r, p and the carried A p
//    (K6) or r, y and the carried A r (K5).  Only a vector some stencil
//    reads has a shared-memory mirror of band and 2h halo rows, and only
//    two chains are ever read by stencils at once, so each kernel has two
//    mirrors: K6 the Ar chain (r before the stream) and the Ap chain (the
//    carried A p before the stream, p during the steps); K5 the Ar chain
//    (the carried A r before the stream, r during the steps and the
//    rollback, which borrows it for pre_x) and the Ay chain (y before the
//    stream).  A stage's result overwrites the mirror it was computed from
//    after a __syncthreads.  The vectors only ever updated pointwise live
//    band-only in shared memory: x (both), z and pre_x (K5).  b is read at
//    the start (K5's rollback reads it again) and x written at the end.
// 2. Each of the 11 passes of an outer iteration at k = 4 ended in a grid
//    barrier.  Here no pass does: a stencil needs only the two neighbouring
//    bands' edge rows of the pass before, so each block publishes its edge
//    rows as step-tagged Words and polls its two neighbours' (below).  A
//    stage's six products and their warp sums run while the edge words are
//    in flight.  2k + 1 of these neighbour exchanges an outer iteration
//    (k + 1 for the steps' p or r, one for the carried product, k - 1 in
//    the stream) and no grid barrier at all.  Forming the stencil's
//    interior rows across the wait as well measured slower, with more
//    spills (PERF.md).
// 3. The bundle took one pass over (6k+6) * nb partials and a grid sync of
//    its own.  Here each stage's six products are summed per warp into
//    shared memory; after the last stage one value-carrying grid sum of
//    the 6k+6 entries (bundle_allsum, resident.cuh: each entry gathered by
//    one warp of one block, the entries spread over the blocks) gives every
//    block the same bits, so all take the same branch.  The init
//    half-step, the rollback and the diverged exit keep small sums
//    (grid_allsum).
// 4. The scalar recurrences ran on one thread.  Within one j the l-loop
//    reads only entries l, l+1 and l+2 as they were before j, so warp 0
//    runs it across l (rounds of 32, every lane reading before any writes)
//    to the same bits, in the _rn arithmetic of the plain versions, so
//    every block derives the same coefficients.
// k is a runtime value <= k_max: the per-warp sums, the bundle and the
// coefficients take (kResWarps + 1)(6 k_max + 6) + 2 (k_max + 1) values of
// dynamic shared memory, which the plan counts.
//
// Ordering of the neighbour exchange, without a fence.  Exchanges are
// counted alike in every block (Halo::step); exchange t writes the band's
// edge rows (first and last h rows, up to kEdgeVectors vectors) into the
// block's words of set t % 2, each word carrying t, then reads the two
// neighbours' words of set t % 2 until they carry t.  Every block
// alternates strictly: it writes exchange t + 1 only after it has read
// exchange t.  So a block B writes exchange t + 2 (over the words of t)
// only after reading its neighbour N's t + 1, which N wrote only after it
// had read B's t: no word is overwritten before both its readers have it,
// and a reader sees either t - 2 or t in a word it waits on.  Each wait
// traps after kWaitLimitNs, so a fault ends the launch with an error.
//
// kernels/_build.py compiles this file once for each KSKIP_PART of 0..3,
// all at once, so that no one nvcc holds the build up: part P instantiates
// the kernels of one (dtype, method) pair (kskip_resident_partP), and part
// 0 also holds the launcher and the probe.  Compiled without KSKIP_PART it
// holds every part.
#include "resident.cuh"

#ifndef KSKIP_PART
#define KSKIP_PART -1
#endif

namespace {

constexpr int kEdgeVectors = 2;  // most vectors one exchange carries

__host__ __device__ constexpr int bundle_entries(int k) { return 6 * k + 6; }

// Values of dynamic shared memory after the mirrors and band arrays: the
// per-warp bundle sums, the bundle and the 2 (k_max + 1) coefficients
// (kernels/fused_kskip.py::plan counts the same).
__host__ __device__ constexpr int scalar_elems(int k_max) {
    return (kResWarps + 1) * bundle_entries(k_max) + 2 * (k_max + 1);
}

// Band-only arrays in shared memory: x (K6); x, z and pre_x (K5).
__host__ __device__ constexpr int band_arrays(int method) { return method == 0 ? 1 : 3; }

// The neighbour exchange: 2 sets of nb blocks x kEdgeVectors vectors x
// 2 h g1 words (top edge, bottom edge), zero at launch, and the number of
// exchanges so far.
struct Halo {
    Word* buf;
    long long step;
};

__device__ __forceinline__ Word* edge_words(const Halo& hx, const Band& bd, long long step, int blk,
                                            int vec) {
    return hx.buf + (((size_t)(step & 1) * gridDim.x + blk) * kEdgeVectors + vec) * 2 * bd.hg;
}

// Writes this thread's points v into the band rows of mirror ms and
// publishes those in the band's first or last h rows as vector `vec` of
// the next exchange (both edges when the band has fewer than 2h rows).
template <typename T, int PPT>
__device__ __forceinline__ void put_band(const Halo& hx, const Band& bd, T* ms, int vec,
                                         const T (&v)[PPT]) {
    const long long step = hx.step + 1;
    Word* mine = edge_words(hx, bd, step, blockIdx.x, vec);
    const int n = bd.p1 - bd.p0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
        const int q = threadIdx.x + k * kResThreads;
        if (q < n) {
            ms[bd.hg + q] = v[k];
            if (q < bd.hg) put_word(mine + q, v[k], step);
            const int bottom = q - (n - bd.hg);
            if (bottom >= 0) put_word(mine + bd.hg + bottom, v[k], step);
        }
    }
}

// Completes the exchange the put_band calls began: waits for the two
// neighbours' edge words of nv vectors (vector 0 into the halo rows of m0,
// vector 1 into m1), then __syncthreads, after which the mirrors are whole.
// A thread polls up to 4 words together (wait_words).
template <typename T>
__device__ __forceinline__ void halo_wait(Halo& hx, const Band& bd, int nv, T* m0, T* m1) {
    constexpr int kBatch = 4;
    const long long step = ++hx.step;
    const int per = 2 * bd.hg, total = nv * per, blk = blockIdx.x;
    const bool up = blk > 0, down = blk + 1 < (int)gridDim.x;
    for (int j0 = threadIdx.x; j0 < total; j0 += kBatch * kResThreads) {
        const Word* src[kBatch];
        T* dst[kBatch];
        Word w[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int j = j0 + u * kResThreads;
            src[u] = nullptr;
            if (j < total) {
                const int vec = j >= per;
                const int jj = j - vec * per;
                T* ms = vec ? m1 : m0;
                if (jj < bd.hg) {  // the h rows above: the upper neighbour's bottom edge
                    if (up) {
                        src[u] = edge_words(hx, bd, step, blk - 1, vec) + bd.hg + jj;
                        dst[u] = ms + jj;
                    }
                } else if (down) {  // the h rows below: the lower neighbour's top edge
                    src[u] = edge_words(hx, bd, step, blk + 1, vec) + (jj - bd.hg);
                    dst[u] = ms + (bd.p1 - bd.p0) + jj;
                }
            }
        }
        wait_words(w, src, step);
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
            if (src[u]) *dst[u] = from_bits<T>(w[u].bits);
    }
    __syncthreads();
}

// Sums a stage's six products over the warp and writes the warp sums to
// the entries ent[d] of wsum (entry j of warp w at j * kResWarps + w).
template <typename T>
__device__ __forceinline__ void stage_sums(T (&v)[6], const int (&ent)[6], T* wsum) {
    warp_allsum(v);
    if ((threadIdx.x & 31) == 0)
#pragma unroll
        for (int d = 0; d < 6; ++d) wsum[ent[d] * kResWarps + (threadIdx.x >> 5)] = v[d];
}

// The k+1 (alpha, beta) of the k-skip CG steps from the bundle a/f/c (in
// shared memory), advanced in place by the recurrences, run by one warp:
// the l-loop of each j in rounds of warpSize (32) entries, each lane
// reading its old entries before any lane writes.  Every lane ends with
// the same bits.  The stride is warpSize, not the literal 32: a stride the
// compiler knows unrolls these loops into the kernels and makes them spill
// more (K6 5% slower, PERF.md).
template <typename T>
__device__ void kskipcg_scalars(T* a, T* f, T* c, int k, T* alphas, T* betas) {
    const int lane = threadIdx.x & 31;
    T alpha = safe_div(a[0], f[1]);
    T beta = sub(safe_div(mul(mul(alpha, alpha), f[2]), a[0]), T(1));
    if (lane == 0) {
        alphas[0] = alpha;
        betas[0] = beta;
    }
    for (int j = 0; j < k; ++j) {
        const int len = 2 * (k - j) + 1;
        for (int l0 = 0; l0 < len; l0 += warpSize) {
            const int l = l0 + lane;
            const bool mine = l < len;
            T an = T(0), cn = T(0), fn = T(0);
            if (mine) {
                an = add(a[l], mul(alpha, sub(mul(alpha, f[l + 2]), mul(T(2), c[l + 1]))));
                const T d = sub(c[l], mul(alpha, f[l + 1]));
                cn = add(an, mul(d, beta));
                fn = add(cn, mul(beta, add(d, mul(beta, f[l]))));
            }
            __syncwarp();
            if (mine) {
                a[l] = an;
                c[l] = cn;
                f[l] = fn;
            }
            __syncwarp();
        }
        alpha = safe_div(a[0], f[1]);
        beta = sub(safe_div(mul(mul(alpha, alpha), f[2]), a[0]), T(1));
        if (lane == 0) {
            alphas[j + 1] = alpha;
            betas[j + 1] = beta;
        }
    }
}

// The k+1 (zeta, eta) of the k-skip MrR steps from the bundle al/be/de
// (be[0] is set to 0), advanced in place by the recurrences, by one warp as
// kskipcg_scalars: item 1 of each j is the head (entries 0 and 1), item
// i >= 2 the l-loop's entry l = i.
template <typename T>
__device__ void kskipmrr_scalars(T* al, T* be, T* de, int k, T* zetas, T* etas) {
    const int lane = threadIdx.x & 31;
    if (lane == 0) be[0] = T(0);
    __syncwarp();
    T d0 = sub(mul(al[2], de[0]), mul(be[1], be[1]));
    T zeta = safe_div(mul(al[1], de[0]), d0);
    T eta = -safe_div(mul(al[1], be[1]), d0);
    if (lane == 0) {
        zetas[0] = zeta;
        etas[0] = eta;
    }
    for (int j = 0; j < k; ++j) {
        const int len = 2 * (k - j);
        const T ee = mul(eta, eta), ez2 = mul(mul(T(2), eta), zeta), zz = mul(zeta, zeta);
        for (int i0 = 1; i0 <= len; i0 += warpSize) {
            const int i = i0 + lane;
            const bool mine = i <= len;
            T v0 = T(0), v1 = T(0), v2 = T(0), v3 = T(0);
            if (mine && i == 1) {
                v0 = add(mul(zz, al[2]), mul(mul(eta, zeta), be[1]));  // de[0]
                v1 = sub(al[0], mul(zeta, al[1]));                     // al[0]
                v2 = add(add(mul(ee, de[1]), mul(ez2, be[2])), mul(zz, al[3]));  // de[1]
                v3 = sub(add(mul(eta, be[1]), mul(zeta, al[2])), v2);  // be[1]
            } else if (mine) {
                v0 = add(add(mul(ee, de[i]), mul(ez2, be[i + 1])), mul(zz, al[i + 2]));  // de[l]
                const T tau = add(mul(eta, be[i]), mul(zeta, al[i + 1]));
                v1 = sub(tau, v0);          // be[l]
                v2 = sub(sub(al[i], tau), v1);  // al[l]
            }
            __syncwarp();
            if (mine && i == 1) {
                de[0] = v0;
                al[0] = v1;
                de[1] = v2;
                be[1] = v3;
                al[1] = -v3;
            } else if (mine) {
                de[i] = v0;
                be[i] = v1;
                al[i] = v2;
            }
            __syncwarp();
        }
        d0 = sub(mul(al[2], de[0]), mul(be[1], be[1]));
        zeta = safe_div(mul(al[1], de[0]), d0);
        eta = -safe_div(mul(al[1], be[1]), d0);
        if (lane == 0) {
            zetas[j + 1] = zeta;
            etas[j + 1] = eta;
        }
    }
}

// The resident solve's view of shared memory and scratch, common to K5/K6.
template <typename T>
struct Layout {
    T* m0;      // first mirror (rows + 2h) g1: the Ar chain
    T* m1;      // second mirror: the Ap (K6) or Ay (K5) chain
    T* band;    // band-only arrays, rows g1 each
    T* wsum;    // per-warp bundle sums, (6 k_max + 6) kResWarps
    T* bundle;  // 6 k_max + 6
    T* coef0;   // k_max + 1 step coefficients, then k_max + 1 more
};

template <typename T>
__device__ __forceinline__ Layout<T> layout(unsigned char* dyn, const StencilGeom& g, const Band& bd,
                                            int bands, int k_max) {
    Layout<T> L;
    const int mirror = bd.rows * g.g1 + 2 * bd.hg, rows = bd.rows * g.g1;
    L.m0 = reinterpret_cast<T*>(dyn);
    L.m1 = L.m0 + mirror;
    L.band = L.m1 + mirror;
    L.wsum = L.band + bands * rows;
    L.bundle = L.wsum + kResWarps * bundle_entries(k_max);
    L.coef0 = L.bundle + bundle_entries(k_max);
    return L;
}

// Whole k-skip CG solve of A x = b from x0 = 0 (the wrapper shifts for
// x0).  xbuf: the exchange (Halo); partials: the small sums' scratch
// (Exchange, 6 nb + 6 words), then the bundle's (BundleExchange, 2 (6 k_max
// + 6)(nb + 1) words); all zero at launch.  ktrace and adaptive are unused
// (K5's signature, so one launcher serves both).
template <typename T, int PPT>
__global__ void __launch_bounds__(kResThreads, 1)
kskipcg_resident_kernel(StencilGeom g, int h, const T* __restrict__ coef, const T* __restrict__ b,
                        const T* __restrict__ scal, T* __restrict__ x_out, T* trace, int* nosl,
                        int* ktrace, int* stats, Word* xbuf, Word* partials, int k, int k_max,
                        int adaptive, int maxiter, int trace_len) {
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ T ssum[kResSums * (kResWarps + 1)];
    const Band bd = band_of(g, h);
    const Layout<T> L = layout<T>(dyn, g, bd, band_arrays(0), k_max);
    T* const ma = L.m0;  // Ar chain; r before the stream
    T* const mb = L.m1;  // Ap chain; A p before the stream, p in the steps
    T* const xs = L.band;
    T* const alphas = L.coef0;
    T* const betas = alphas + k_max + 1;
    const int nb = gridDim.x, n = bd.p1 - bd.p0;
    Exchange ex{partials, 0};
    BundleExchange bx{partials + 2 * kResSums * nb + 2 * kResSums, bundle_entries(k_max), 0};
    Halo hx{xbuf, 0};
    const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
    const T tol = scal[0];
    const T b_norm = scal[1];
    const int fo = 2 * k + 1;  // offset of f in the bundle
    const int co = 4 * k + 4;  // offset of c

    // r = p = b, x = 0, the carried A p
    T rr[PPT], pr[PPT], ap1[PPT];
    unsigned mask[PPT];
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
        const int e = bd.p0 + threadIdx.x + q * kResThreads;
        const bool in = e < bd.p1;
        rr[q] = in ? b[e] : T(0);
        pr[q] = rr[q];
        mask[q] = in ? term_mask(g, e) : 0u;
        if (in) xs[e - bd.p0] = T(0);
    }
    mirror_from(ma, b, g, bd);
    mirror_from(mb, b, g, bd);
    __syncthreads();
    stencil_band(g, coef, mb, bd, mask, ap1);
    __syncthreads();
    put_band(hx, bd, mb, 0, ap1);
    halo_wait(hx, bd, 1, mb, mb);

    int i = 0, index = 0;
    bool conv = false;
    while (i < maxiter) {
        // stream: stage s holds Ar[s], Ap[s], Ap[s+1] in registers and
        // Ar[s], Ap[s+1] in the mirrors; it forms Ar[s+1] and Ap[s+2]
        T ar[PPT], ap[PPT], aq[PPT];
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
            ar[q] = rr[q];
            ap[q] = pr[q];
            aq[q] = ap1[q];
        }
        for (int s = 0; s <= k; ++s) {
            const bool grow = s < k, pass = s + 1 < k;  // pass: stage s+1 stencils them
            T ar1[PPT], apn[PPT];
            if (grow) {
                stencil_band(g, coef, ma, bd, mask, ar1);
                stencil_band(g, coef, mb, bd, mask, apn);
            }
            if (pass) {
                __syncthreads();
                put_band(hx, bd, ma, 0, ar1);
                put_band(hx, bd, mb, 1, apn);
            }
            T v[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
#pragma unroll
            for (int q = 0; q < PPT; ++q) {
                if (threadIdx.x + q * kResThreads < n) {
                    v[0] = add(v[0], mul(ar[q], ar[q]));  // a[2s]
                    v[1] = add(v[1], mul(ap[q], ap[q]));  // f[2s]
                    v[2] = add(v[2], mul(ap[q], aq[q]));  // f[2s+1]
                    v[3] = add(v[3], mul(ar[q], ap[q]));  // c[2s]
                    v[4] = add(v[4], mul(ar[q], aq[q]));  // c[2s+1]
                    v[5] = add(v[5], grow ? mul(ar[q], ar1[q]) : mul(aq[q], aq[q]));  // a[2s+1] | f[2s+2]
                }
            }
            const int ent[6] = {2 * s, fo + 2 * s, fo + 2 * s + 1, co + 2 * s, co + 2 * s + 1,
                                grow ? 2 * s + 1 : fo + 2 * s + 2};
            stage_sums(v, ent, L.wsum);
            if (pass) halo_wait(hx, bd, 2, ma, mb);
            if (grow) {
#pragma unroll
                for (int q = 0; q < PPT; ++q) {
                    ar[q] = ar1[q];
                    ap[q] = aq[q];
                    aq[q] = apn[q];
                }
            }
        }
        bundle_allsum(bx, bundle_entries(k), L.wsum, L.bundle);

        const T res = sqrt(L.bundle[0]) / b_norm;
        if (lead) trace[min(index, trace_len - 1)] = res;
        if (res < tol) {  // the same in every block: the bundle is bit-identical
            conv = true;
            break;
        }
        __syncthreads();  // every thread has read bundle[0]
        if (threadIdx.x < 32) kskipcg_scalars(L.bundle, L.bundle + fo, L.bundle + co, k, alphas, betas);
        __syncthreads();

        // k+1 CG steps: step 0 takes the carried A p, step t > 0 the stencil
        // of p from the mirror; each shares the new p (and at the last
        // step r, for the stream) with the neighbours
        for (int t = 0; t <= k; ++t) {
            const T alpha = alphas[t];
            const T beta = betas[t];
            T v[PPT];
            if (t == 0) {
#pragma unroll
                for (int q = 0; q < PPT; ++q) v[q] = ap1[q];
            } else {
                stencil_band(g, coef, mb, bd, mask, v);
                __syncthreads();
            }
#pragma unroll
            for (int q = 0; q < PPT; ++q) {
                const int local = threadIdx.x + q * kResThreads;
                if (local < n) {
                    xs[local] = add(xs[local], mul(alpha, pr[q]));
                    rr[q] = sub(rr[q], mul(alpha, v[q]));
                    pr[q] = add(rr[q], mul(beta, pr[q]));
                }
            }
            put_band(hx, bd, mb, 0, pr);
            if (t == k) put_band(hx, bd, ma, 1, rr);
            halo_wait(hx, bd, t == k ? 2 : 1, mb, ma);
        }
        stencil_band(g, coef, mb, bd, mask, ap1);  // the carried A p
        __syncthreads();
        put_band(hx, bd, mb, 0, ap1);
        halo_wait(hx, bd, 1, mb, mb);

        if (lead) nosl[min(index + 1, trace_len - 1)] = i + k + 1;
        i += k + 1;
        ++index;
    }
    if (!conv) {  // diverged exit writes the final residual
        T rr1[1] = {T(0)};
#pragma unroll
        for (int q = 0; q < PPT; ++q)
            if (threadIdx.x + q * kResThreads < n) rr1[0] = add(rr1[0], mul(rr[q], rr[q]));
        grid_allsum(ex, rr1, ssum);
        if (lead) trace[min(index, trace_len - 1)] = sqrt(rr1[0]) / b_norm;
    }
    if (lead) {
        stats[0] = i;
        stats[1] = conv;
        stats[2] = index;
    }
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
        const int e = bd.p0 + threadIdx.x + q * kResThreads;
        if (e < bd.p1) x_out[e] = xs[e - bd.p0];
    }
}

// K5: r and y to the mirrors (when share_ry), then the carried A r, into
// ar1 and the Ar mirror.
template <typename T, int PPT>
__device__ __forceinline__ void kskipmrr_carry(const StencilGeom& g, const T* __restrict__ coef,
                                               const Band& bd, const unsigned (&mask)[PPT], Halo& hx,
                                               const Layout<T>& L, bool share_ry, const T (&rr)[PPT],
                                               const T (&yr)[PPT], T (&ar1)[PPT]) {
    if (share_ry) {
        put_band(hx, bd, L.m0, 0, rr);
        put_band(hx, bd, L.m1, 1, yr);
        halo_wait(hx, bd, 2, L.m0, L.m1);
    }
    stencil_band(g, coef, L.m0, bd, mask, ar1);
    __syncthreads();
    put_band(hx, bd, L.m0, 0, ar1);
    halo_wait(hx, bd, 1, L.m0, L.m0);
}

// K5's stream at kq: stage s holds Ar[s], Ar[s+1], Ay[s] in registers and
// Ar[s+1], Ay[s] in the mirrors; it forms Ar[s+2] and Ay[s+1].  Then the
// bundle alpha | beta | delta in every block's L.bundle.
template <typename T, int PPT>
__device__ __forceinline__ void kskipmrr_stream(const StencilGeom& g, const T* __restrict__ coef,
                                                const Band& bd, const unsigned (&mask)[PPT], Halo& hx,
                                                BundleExchange& bx, const Layout<T>& L, int kq,
                                                const T (&rr)[PPT], const T (&yr)[PPT],
                                                const T (&ar1)[PPT]) {
    T* const ma = L.m0;
    T* const my = L.m1;
    const int n = bd.p1 - bd.p0;
    const int bo = 2 * kq + 3;   // offset of beta
    const int dof = 4 * kq + 5;  // offset of delta
    T ar[PPT], aq[PPT], ay[PPT];
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
        ar[q] = rr[q];
        aq[q] = ar1[q];
        ay[q] = yr[q];
    }
    for (int s = 0; s <= kq; ++s) {
        const bool grow = s < kq, pass = s + 1 < kq;  // pass: stage s+1 stencils them
        T arn[PPT], ayn[PPT];
        if (grow) {
            stencil_band(g, coef, ma, bd, mask, arn);
            stencil_band(g, coef, my, bd, mask, ayn);
        }
        if (pass) {
            __syncthreads();
            put_band(hx, bd, ma, 0, arn);
            put_band(hx, bd, my, 1, ayn);
        }
        T v[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
            if (threadIdx.x + q * kResThreads < n) {
                v[0] = add(v[0], mul(ar[q], ar[q]));  // alpha[2s]
                v[1] = add(v[1], mul(ar[q], aq[q]));  // alpha[2s+1]
                v[2] = add(v[2], mul(ay[q], ar[q]));  // beta[2s]
                v[3] = add(v[3], mul(ay[q], aq[q]));  // beta[2s+1]
                v[4] = add(v[4], mul(ay[q], ay[q]));  // delta[2s]
                v[5] = add(v[5], grow ? mul(ay[q], ayn[q]) : mul(aq[q], aq[q]));  // delta[2s+1] | alpha[2s+2]
            }
        }
        const int ent[6] = {2 * s, 2 * s + 1, bo + 2 * s, bo + 2 * s + 1, dof + 2 * s,
                            grow ? dof + 2 * s + 1 : 2 * s + 2};
        stage_sums(v, ent, L.wsum);
        if (pass) halo_wait(hx, bd, 2, ma, my);
        if (grow) {
#pragma unroll
            for (int q = 0; q < PPT; ++q) {
                ar[q] = aq[q];
                aq[q] = arn[q];
                ay[q] = ayn[q];
            }
        }
    }
    bundle_allsum(bx, bundle_entries(kq), L.wsum, L.bundle);
}

// Whole k-skip MrR solve of A x = b from x0 = 0, adaptive (rollback and k
// decrement) when `adaptive` is nonzero.  Buffers as in the CG kernel.
template <typename T, int PPT>
__global__ void __launch_bounds__(kResThreads, 1)
kskipmrr_resident_kernel(StencilGeom g, int h, const T* __restrict__ coef, const T* __restrict__ b,
                         const T* __restrict__ scal, T* __restrict__ x_out, T* trace, int* nosl,
                         int* ktrace, int* stats, Word* xbuf, Word* partials, int k, int k_max,
                         int adaptive, int maxiter, int trace_len) {
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ T ssum[kResSums * (kResWarps + 1)];
    const Band bd = band_of(g, h);
    const Layout<T> L = layout<T>(dyn, g, bd, band_arrays(1), k_max);
    // L.m0: the Ar chain (A r before the stream, r in the steps and the
    // rollback); L.m1: the Ay chain (y before the stream)
    T* const ma = L.m0;
    const int n = bd.p1 - bd.p0;
    T* const xs = L.band;
    T* const zs = xs + n;
    T* const pxs = zs + n;  // pre_x
    T* const zetas = L.coef0;
    T* const etas = zetas + k_max + 1;
    const int nb = gridDim.x;
    Exchange ex{partials, 0};
    BundleExchange bx{partials + 2 * kResSums * nb + 2 * kResSums, bundle_entries(k_max), 0};
    Halo hx{xbuf, 0};
    const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
    const T tol = scal[0];
    const T b_norm = scal[1];

    T rr[PPT], yr[PPT], ar1[PPT];
    unsigned mask[PPT];

    // init half-step from r0 = b: zeta = <r,Ar>/<Ar,Ar>
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
        const int e = bd.p0 + threadIdx.x + q * kResThreads;
        rr[q] = e < bd.p1 ? b[e] : T(0);
        mask[q] = e < bd.p1 ? term_mask(g, e) : 0u;
        yr[q] = T(0);
    }
    mirror_from(ma, b, g, bd);
    __syncthreads();
    stencil_band(g, coef, ma, bd, mask, ar1);
    T s3[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
        if (threadIdx.x + q * kResThreads < n) {
            s3[0] = add(s3[0], mul(rr[q], rr[q]));
            s3[1] = add(s3[1], mul(rr[q], ar1[q]));
            s3[2] = add(s3[2], mul(ar1[q], ar1[q]));
        }
    }
    grid_allsum(ex, s3, ssum);
    const T res0 = sqrt(s3[0]) / b_norm;
    if (lead) {
        trace[0] = res0;
        nosl[1] = 1;
        ktrace[0] = k;
        ktrace[1] = k;
    }
    {
        const T zeta = safe_div(s3[1], s3[2]);
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
            const int local = threadIdx.x + q * kResThreads;
            if (local < n) {
                yr[q] = mul(zeta, ar1[q]);
                const T z = mul(-zeta, rr[q]);
                zs[local] = z;
                xs[local] = -z;
                if (adaptive) pxs[local] = -z;
                rr[q] = sub(rr[q], yr[q]);
            }
        }
    }
    kskipmrr_carry(g, coef, bd, mask, hx, L, true, rr, yr, ar1);

    T pre_res = res0;
    int kk = k, i = 1, index = 1;
    bool conv = false;
    while (i < maxiter) {
        kskipmrr_stream(g, coef, bd, mask, hx, bx, L, kk, rr, yr, ar1);
        T res = sqrt(L.bundle[0]) / b_norm;  // <r, r> = alpha[0]
        if (lead) trace[min(index, trace_len - 1)] = res;
        bool accept = true;  // copy x to pre_x before this iteration's steps
        if (adaptive) {
            // non-finite counts as rose (NaN compares false)
            if (res > pre_res || !isfinite(res)) {
                accept = false;
                // roll back: r = b - A pre_x (pre_x borrows the Ar mirror),
                // one MrR half-step, A r
                T a[PPT];
#pragma unroll
                for (int q = 0; q < PPT; ++q) {
                    const int local = threadIdx.x + q * kResThreads;
                    a[q] = local < n ? pxs[local] : T(0);
                }
                put_band(hx, bd, ma, 0, a);
                halo_wait(hx, bd, 1, ma, ma);
                stencil_band(g, coef, ma, bd, mask, a);
#pragma unroll
                for (int q = 0; q < PPT; ++q) {
                    const int e = bd.p0 + threadIdx.x + q * kResThreads;
                    if (e < bd.p1) rr[q] = sub(b[e], a[q]);
                }
                __syncthreads();
                put_band(hx, bd, ma, 0, rr);
                halo_wait(hx, bd, 1, ma, ma);
                stencil_band(g, coef, ma, bd, mask, a);
                T s2[2] = {T(0), T(0)};
#pragma unroll
                for (int q = 0; q < PPT; ++q) {
                    if (threadIdx.x + q * kResThreads < n) {
                        s2[0] = add(s2[0], mul(rr[q], a[q]));
                        s2[1] = add(s2[1], mul(a[q], a[q]));
                    }
                }
                grid_allsum(ex, s2, ssum);
                const T zeta = safe_div(s2[0], s2[1]);
#pragma unroll
                for (int q = 0; q < PPT; ++q) {
                    const int local = threadIdx.x + q * kResThreads;
                    if (local < n) {
                        yr[q] = mul(zeta, a[q]);
                        const T z = mul(-zeta, rr[q]);
                        zs[local] = z;
                        rr[q] = sub(rr[q], yr[q]);
                        xs[local] = sub(pxs[local], z);
                    }
                }
                kskipmrr_carry(g, coef, bd, mask, hx, L, true, rr, yr, ar1);
                kk = kk > 1 ? kk - 1 : kk;
                ++i;
                ++index;
                if (lead) {
                    nosl[min(index, trace_len - 1)] = i;
                    ktrace[min(index, trace_len - 1)] = kk;
                }
                kskipmrr_stream(g, coef, bd, mask, hx, bx, L, kk, rr, yr, ar1);
                res = sqrt(L.bundle[0]) / b_norm;
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
        if (threadIdx.x < 32)
            kskipmrr_scalars(L.bundle, L.bundle + 2 * kk + 3, L.bundle + 4 * kk + 5, kk, zetas, etas);
        __syncthreads();

        // k+1 MrR steps: step 0 takes the carried A r, step t > 0 the
        // stencil of r from the mirror; each shares the new r (and at the
        // last step y, for the stream) with the neighbours
        for (int t = 0; t <= kk; ++t) {
            const T zeta = zetas[t];
            const T eta = etas[t];
            const bool save = t == 0 && adaptive && accept;
            T a[PPT];
            if (t == 0) {
#pragma unroll
                for (int q = 0; q < PPT; ++q) a[q] = ar1[q];
            } else {
                stencil_band(g, coef, ma, bd, mask, a);
                __syncthreads();
            }
#pragma unroll
            for (int q = 0; q < PPT; ++q) {
                const int local = threadIdx.x + q * kResThreads;
                if (local < n) {
                    yr[q] = add(mul(eta, yr[q]), mul(zeta, a[q]));
                    const T z = sub(mul(eta, zs[local]), mul(zeta, rr[q]));
                    zs[local] = z;
                    rr[q] = sub(rr[q], yr[q]);
                    const T xe = xs[local];
                    if (save) pxs[local] = xe;
                    xs[local] = sub(xe, z);
                }
            }
            put_band(hx, bd, ma, 0, rr);
            if (t == kk) put_band(hx, bd, L.m1, 1, yr);
            halo_wait(hx, bd, t == kk ? 2 : 1, ma, L.m1);
        }
        kskipmrr_carry(g, coef, bd, mask, hx, L, false, rr, yr, ar1);

        if (lead) {
            nosl[min(index + 1, trace_len - 1)] = i + kk + 1;
            if (adaptive) ktrace[min(index + 1, trace_len - 1)] = kk;
        }
        i += kk + 1;
        ++index;
    }
    if (!conv) {  // diverged exit writes the final residual
        T rr1[1] = {T(0)};
#pragma unroll
        for (int q = 0; q < PPT; ++q)
            if (threadIdx.x + q * kResThreads < n) rr1[0] = add(rr1[0], mul(rr[q], rr[q]));
        grid_allsum(ex, rr1, ssum);
        if (lead) trace[min(index, trace_len - 1)] = sqrt(rr1[0]) / b_norm;
    }
    if (lead) {
        stats[0] = i;
        stats[1] = conv;
        stats[2] = index;
        stats[3] = kk;
    }
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
        const int e = bd.p0 + threadIdx.x + q * kResThreads;
        if (e < bd.p1) x_out[e] = xs[e - bd.p0];
    }
}

#if KSKIP_PART <= 0
// A cooperative grid that runs one piece of the resident K5/K6's outer
// iteration alone, reps times, on the bands of a (g0, g1) grid with h halo
// rows: mode 0 the neighbour exchange of `count` (1 or 2) vectors of
// float64 edge rows (put_band, halo_wait), mode 1 the grid sum of `count`
// bundle entries (bundle_allsum).  xbuf is the kernels' exchange, partials
// 2 count (blocks + 1) words, both zero at launch.  Dynamic shared memory:
// two mirrors, then count (kResWarps + 1) sums.
__global__ void __launch_bounds__(kResThreads, 1)
kskip_probe_kernel(int mode, int g0, int g1, int h, int count, int reps, Word* xbuf, Word* partials) {
    extern __shared__ __align__(16) unsigned char dyn[];
    StencilGeom g{};
    g.g0 = g0;
    g.g1 = g1;
    const Band bd = band_of(g, h);
    double* const m0 = reinterpret_cast<double*>(dyn);
    double* const m1 = m0 + bd.rows * g1 + 2 * bd.hg;
    double* const wsum = m1 + bd.rows * g1 + 2 * bd.hg;
    Halo hx{xbuf, 0};
    BundleExchange bx{partials, count, 0};
    const double v[8] = {};
    for (int j = threadIdx.x; j < count * kResWarps; j += kResThreads) wsum[j] = 1.0;
    for (int i = 0; i < reps; ++i) {
        if (mode == 0) {
            put_band(hx, bd, m0, 0, v);
            if (count > 1) put_band(hx, bd, m1, 1, v);
            halo_wait(hx, bd, count, m0, m1);
        } else {
            bundle_allsum(bx, count, wsum, wsum + count * kResWarps);
        }
    }
}
#endif

}  // namespace

// The kernel of (dtype, method) pair P at ppt points a thread (1, 2, 4 or
// 8; else null): part 0 float64 k-skip CG, 1 float64 k-skip MrR, 2 float32
// k-skip CG, 3 float32 k-skip MrR.  Each is defined in the compilation of
// its part.
const void* kskip_resident_part0(int ppt);
const void* kskip_resident_part1(int ppt);
const void* kskip_resident_part2(int ppt);
const void* kskip_resident_part3(int ppt);

#define KSKIP_RESIDENT_PART(P, T, KERNEL)                                      \
    const void* kskip_resident_part##P(int ppt) {                              \
        switch (ppt) {                                                         \
            case 1: return reinterpret_cast<const void*>(&KERNEL<T, 1>);       \
            case 2: return reinterpret_cast<const void*>(&KERNEL<T, 2>);       \
            case 4: return reinterpret_cast<const void*>(&KERNEL<T, 4>);       \
            case 8: return reinterpret_cast<const void*>(&KERNEL<T, 8>);       \
            default: return nullptr;                                           \
        }                                                                      \
    }

#if KSKIP_PART < 0 || KSKIP_PART == 0
KSKIP_RESIDENT_PART(0, double, kskipcg_resident_kernel)
#endif
#if KSKIP_PART < 0 || KSKIP_PART == 1
KSKIP_RESIDENT_PART(1, double, kskipmrr_resident_kernel)
#endif
#if KSKIP_PART < 0 || KSKIP_PART == 2
KSKIP_RESIDENT_PART(2, float, kskipcg_resident_kernel)
#endif
#if KSKIP_PART < 0 || KSKIP_PART == 3
KSKIP_RESIDENT_PART(3, float, kskipmrr_resident_kernel)
#endif

#if KSKIP_PART <= 0
// One resident k-skip solve (method 0 = k-skip CG, 1 = k-skip MrR; dtype
// the element size in bytes) on `blocks` bands of the (g0, g1) grid, each
// of ppt * 512 points at most and h = max |d0| halo rows, with smem_bytes
// of dynamic shared memory a block (at least what the layout needs: two
// mirrors, the band arrays and scalar_elems(k_max) values).  xbuf holds
// 2 * blocks * 2 * 2 h g1 16-byte words, partials 6 blocks + 6 words, then
// 2 (6 k_max + 6)(blocks + 1), all zero.  Returns a cudaError_t: an
// invalid plan, a refused attribute or a refused cooperative launch is
// reported, never worked around.
extern "C" int krylov_kskip_resident_solve(int method, int dtype, int blocks, int threads, int ppt, int h,
                                           int smem_bytes, int k, int k_max, int adaptive, const void* coef,
                                           const void* b, const void* scal, void* x, void* trace, void* nosl,
                                           void* ktrace, void* stats, void* xbuf, void* partials, int ns,
                                           int g0, int g1, int g2, int is_const, const int* disp, int maxiter,
                                           int trace_len, void* stream) {
    StencilGeom g;
    if (!make_geom(ns, g0, g1, g2, is_const, disp, &g) || (method != 0 && method != 1) ||
        (dtype != 4 && dtype != 8) || threads != kResThreads || blocks < 1 || blocks > g0 ||
        blocks > kResMaxBlocks || h < 0 || k < 0 || k > k_max)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long rows = (g0 + blocks - 1) / blocks;
    const long long need = (2 * (rows + 2 * h) * g1 + band_arrays(method) * rows * g1 + scalar_elems(k_max)) *
                           (long long)dtype;
    if (rows * g1 > (long long)ppt * kResThreads || (blocks > 1 && g0 / blocks < h) || smem_bytes < need)
        return static_cast<int>(cudaErrorInvalidValue);
    const int part = (dtype == 8 ? 0 : 2) + method;
    const void* kernel = part == 0 ? kskip_resident_part0(ppt)
                         : part == 1 ? kskip_resident_part1(ppt)
                         : part == 2 ? kskip_resident_part2(ppt)
                                     : kskip_resident_part3(ppt);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* args[] = {&g,    &h,     &coef, &b,        &scal, &x,     &trace,    &nosl,   &ktrace,
                    &stats, &xbuf, &partials, &k, &k_max, &adaptive, &maxiter, &trace_len};
    err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kResThreads), args, smem_bytes,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// Launches kskip_probe_kernel on `blocks` bands (at most 8 points a thread)
// with its zeroed scratch: reps exchanges (mode 0) or bundle sums (mode 1)
// of `count` vectors or entries.
extern "C" int krylov_kskip_probe(int mode, int blocks, int g0, int g1, int h, int count, int reps, void* xbuf,
                                  void* partials, void* stream) {
    if (blocks < 1 || blocks > g0 || blocks > kResMaxBlocks || h < 0 || (blocks > 1 && g0 / blocks < h) ||
        (mode == 0 && count != 1 && count != 2) || (mode == 1 && count < 1) || mode < 0 || mode > 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long rows = (g0 + blocks - 1) / blocks;
    if (rows * g1 > 8LL * kResThreads) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = static_cast<int>((2 * (rows + 2 * h) * g1 + (long long)count * (kResWarps + 1)) * 8);
    const void* kernel = reinterpret_cast<const void*>(&kskip_probe_kernel);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* args[] = {&mode, &g0, &g1, &h, &count, &reps, &xbuf, &partials};
    err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kResThreads), args, smem,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
#endif
