// K2/K3, streaming route: whole-solve MrR and CG on a 2-D (or collapsed
// 3-D) stencil operator, the entire iteration loop in one launch, for
// systems too large for the resident route (fused_resident.cu), whose bands
// must fit one block an SM's registers and shared memory
// (kernels/fused.py::plan decides).
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
// Races on the stencil input: blocks read neighbours' entries of r (MrR) or
// p (CG), so those vectors are rewritten only after every block has passed
// the stencil, and the next stencil starts only after a grid sync.  That is
// three grid syncs an iteration for either method.
//
// Bound: as the resident route (fused_resident.cu): compute, ~0.21 ms for
// MrR's and ~0.15 ms for CG's float64 solve at N = 250k.  Each pass here
// streams the vectors it touches through L2 (device memory above the 50 MB
// L2) and ends in a grid sync whose grid sum loads every block's partial in
// every block.  The grid is the plan's: 4 blocks of 256 threads an SM (528
// on an H100), where a sweep of grid sizes found the time an iteration
// lowest (PERF.md), and no more blocks than the points need.
//
// The stencil pass is the streaming pass of stencil.cuh: for the constant
// 5- and 7-term stencils (NS = 5, 7) the specialised one at one point a
// chunk on the grid-stride walk (StreamSweep with VW = 1: the weights as
// arguments, the point's row from a FastDiv, no test for an interior
// point), else the masked one (apply_stencil).  Both walk the same points
// in the same order with the same arithmetic a point, so a solve's bits do
// not depend on the pass.  kernels/_build.py compiles this file once for
// each KRYLOV_PART of 0..2 (the pass: masked, NS = 5, NS = 7), part 0 with
// the entry points.
#include <cuda_runtime.h>

#include "reduce.cuh"
#include "stencil.cuh"

#ifndef KRYLOV_PART
#define KRYLOV_PART -1
#endif

namespace {

// Per-block partial-sum slots (MrR uses all 8: init 3, <r,r> 1, <y,y>/<y,Ar>
// 2, <r,s>/<s,s> 2; CG 2) and n-vectors of work space, by method.
constexpr int kPartialSlots = 8;
constexpr int kWorkVectors[2] = {3, 4};  // CG: r, p, v; MrR: r, y, z, Ar

// The sweep of an instance: the specialised pass at one point a chunk for
// NS = 5 or 7, else the masked pass.
template <typename T, int NS>
struct PassOf {
    using type = StreamSweep<T, NS, kThreads, 1>;
    __device__ static type make(const StencilGeom& g, const StreamPass<T>& sp, const T*) {
        return type{g, sp, false};
    }
};
template <typename T>
struct PassOf<T, 0> {
    using type = MaskedSweep<T, kThreads>;
    __device__ static type make(const StencilGeom& g, const StreamPass<T>&, const T* coef) {
        return type{g, coef};
    }
};

// Whole MrR solve of A x = b from x0 = 0 (the wrapper shifts for x0).
// work holds r, y, z, Ar (4 n); partials holds kPartialSlots slots of gridDim.x.
template <typename T, int NS>
__global__ void __launch_bounds__(kThreads)
mrr_fused_kernel(StencilGeom g, StreamPass<T> sp, const T* __restrict__ coef, const T* __restrict__ b,
                 const T* __restrict__ scal, T* x, T* trace, int* stats, T* work,
                 T* partials, int maxiter, int trace_len) {
    using Sweep = typename PassOf<T, NS>::type;
    cg::grid_group grid = cg::this_grid();
    __shared__ T smem[kBlockSumSmem];
    const Sweep sw = PassOf<T, NS>::make(g, sp, coef);
    const int n = g.g0 * g.g1;
    const int nb = gridDim.x;
    const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
    T* r = work;
    T* y = work + (size_t)n;
    T* z = work + 2 * (size_t)n;
    T* Ar = work + 3 * (size_t)n;
    T* s_init = partials;
    T* s_rr = partials + 3 * nb;
    T* s_mn = partials + 4 * nb;
    T* s_rs = partials + 6 * nb;
    const T tol = scal[0];
    const T b_norm = scal[1];

    // init half-iteration: zeta = <r,Ar>/<Ar,Ar> with r0 = b
    T init[3] = {T(0), T(0), T(0)};
    sw.each([&](const Chunk& c) {
        T a[1];
        sw.stencil(a, b, c);
        const int e = c.e;
        const T be = b[e];
        Ar[e] = a[0];
        init[0] += be * be;
        init[1] += be * a[0];
        init[2] += a[0] * a[0];
    });
    grid_sum(grid, init, s_init, smem);
    if (lead) trace[0] = sqrt(init[0]) / b_norm;
    const T zeta0 = safe_div(init[1], init[2]);
    T rr[1] = {T(0)};
    sw.each([&](const Chunk& c) {
        const int e = c.e;
        const T be = b[e];
        const T ye = zeta0 * Ar[e];
        const T ze = -zeta0 * be;
        const T re = be - ye;
        y[e] = ye;
        z[e] = ze;
        r[e] = re;
        x[e] = -ze;
        rr[0] += re * re;
    });
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
        sw.each([&](const Chunk& c) {
            T a[1];
            sw.stencil(a, r, c);
            const int e = c.e;
            const T ye = y[e];
            Ar[e] = a[0];
            mn[0] += ye * ye;
            mn[1] += ye * a[0];
        });
        grid_sum(grid, mn, s_mn, smem);
        const T gamma = safe_div(mn[1], mn[0]);
        T rs[2] = {T(0), T(0)};  // <r,s>, <s,s> with s = Ar - gamma y
        sw.each([&](const Chunk& c) {
            const int e = c.e;
            const T s = Ar[e] - gamma * y[e];
            rs[0] += r[e] * s;
            rs[1] += s * s;
        });
        grid_sum(grid, rs, s_rs, smem);
        const T zeta = safe_div(rs[0], rs[1]);
        const T eta = -zeta * gamma;
        rr[0] = T(0);
        sw.each([&](const Chunk& c) {
            const int e = c.e;
            const T re = r[e];
            const T yn = eta * y[e] + zeta * Ar[e];
            const T zn = eta * z[e] - zeta * re;
            const T rn = re - yn;
            y[e] = yn;
            z[e] = zn;
            r[e] = rn;
            x[e] -= zn;
            rr[0] += rn * rn;
        });
        grid_sum(grid, rr, s_rr, smem);
        ++i;
    }
    if (lead) {
        if (!conv) trace[min(i, trace_len - 1)] = sqrt(rr[0]) / b_norm;
        stats[0] = i;
        stats[1] = conv;
    }
}

// Whole CG solve of A x = b from x0 = 0.  work holds r, p, v (3 n).
template <typename T, int NS>
__global__ void __launch_bounds__(kThreads)
cg_fused_kernel(StencilGeom g, StreamPass<T> sp, const T* __restrict__ coef, const T* __restrict__ b,
                const T* __restrict__ scal, T* x, T* trace, int* stats, T* work,
                T* partials, int maxiter, int trace_len) {
    using Sweep = typename PassOf<T, NS>::type;
    cg::grid_group grid = cg::this_grid();
    __shared__ T smem[kBlockSumSmem];
    const Sweep sw = PassOf<T, NS>::make(g, sp, coef);
    const int n = g.g0 * g.g1;
    const int nb = gridDim.x;
    const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
    T* r = work;
    T* p = work + (size_t)n;
    T* v = work + 2 * (size_t)n;
    T* s_gamma = partials;
    T* s_sigma = partials + nb;
    const T tol = scal[0];
    const T b_norm = scal[1];

    T gam[1] = {T(0)};
    sw.each([&](const Chunk& c) {
        const int e = c.e;
        const T be = b[e];
        r[e] = be;
        p[e] = be;
        x[e] = T(0);
        gam[0] += be * be;
    });
    grid_sum(grid, gam, s_gamma, smem);
    T gamma = gam[0];

    int i = 0;
    bool conv = false;
    while (i < maxiter) {
        const T res = sqrt(gamma) / b_norm;
        if (lead) trace[min(i, trace_len - 1)] = res;
        if (res < tol) {
            conv = true;
            break;
        }
        T sig[1] = {T(0)};  // <p, Ap>
        sw.each([&](const Chunk& c) {
            T ve[1];
            sw.stencil(ve, p, c);
            v[c.e] = ve[0];
            sig[0] += p[c.e] * ve[0];
        });
        grid_sum(grid, sig, s_sigma, smem);
        const T alpha = safe_div(gamma, sig[0]);
        gam[0] = T(0);
        sw.each([&](const Chunk& c) {
            const int e = c.e;
            x[e] += alpha * p[e];
            const T rn = r[e] - alpha * v[e];
            r[e] = rn;
            gam[0] += rn * rn;
        });
        grid_sum(grid, gam, s_gamma, smem);
        const T beta = safe_div(gam[0], gamma);
        sw.each([&](const Chunk& c) { p[c.e] = r[c.e] + beta * p[c.e]; });
        grid.sync();  // every block's p before the next stencil reads it
        gamma = gam[0];
        ++i;
    }
    if (lead) {
        if (!conv) trace[min(i, trace_len - 1)] = sqrt(gamma) / b_norm;
        stats[0] = i;
        stats[1] = conv;
    }
}

template <typename T, int NS>
const void* kernel_of(int method) {
    return method == 0 ? reinterpret_cast<const void*>(&cg_fused_kernel<T, NS>)
                       : reinterpret_cast<const void*>(&mrr_fused_kernel<T, NS>);
}

}  // namespace

// The kernel of part P (0: the masked pass, 1: NS = 5, 2: NS = 7) for a
// method and dtype, each defined in the compilation of its part.
#define FUSED_STREAM_DECL(P) const void* fused_stream_part##P(int method, int dtype);
FUSED_STREAM_DECL(0) FUSED_STREAM_DECL(1) FUSED_STREAM_DECL(2)
#undef FUSED_STREAM_DECL

#define FUSED_STREAM_PART(P, NS)                                                              \
    const void* fused_stream_part##P(int method, int dtype) {                                 \
        return dtype == 8 ? kernel_of<double, NS>(method) : kernel_of<float, NS>(method);     \
    }

#if KRYLOV_PART < 0 || KRYLOV_PART == 0
FUSED_STREAM_PART(0, 0)
#endif
#if KRYLOV_PART < 0 || KRYLOV_PART == 1
FUSED_STREAM_PART(1, 5)
#endif
#if KRYLOV_PART < 0 || KRYLOV_PART == 2
FUSED_STREAM_PART(2, 7)
#endif

#if KRYLOV_PART <= 0
namespace {

const void* fused_kernel(int method, int dtype, int ns_pass) {
    switch (ns_pass) {
        case 0: return fused_stream_part0(method, dtype);
        case 5: return fused_stream_part1(method, dtype);
        case 7: return fused_stream_part2(method, dtype);
        default: return nullptr;
    }
}

}  // namespace

// The work space of a solve of n points: the blocks of the cooperative grid
// (max_blocks, the plan's, but no more than can be resident on the current
// device at once or than n needs) and the elements of the work and partials
// buffers that krylov_fused_solve takes.  method 0 = CG, 1 = MrR; dtype is
// the element size in bytes; ns_pass the stencil pass (0, 5 or 7), whose
// kernel's occupancy counts.
extern "C" int krylov_fused_workspace(int method, int dtype, int n, int max_blocks, int ns_pass, int* blocks,
                                      long long* work_elems, long long* partial_elems) {
    if ((method != 0 && method != 1) || max_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    const void* kernel = fused_kernel(method, dtype, ns_pass);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int need = (n + kThreads - 1) / kThreads;
    int fit = per_sm * sms;
    if (max_blocks < fit) fit = max_blocks;
    *blocks = need < fit ? (need > 0 ? need : 1) : fit;
    *work_elems = static_cast<long long>(kWorkVectors[method]) * n;
    *partial_elems = static_cast<long long>(kPartialSlots) * *blocks;
    return 0;
}

// work and partials are sized by krylov_fused_workspace for the same
// method, dtype, n, ns_pass and blocks; disp is the (3, ns) displacement
// array; ns_pass the pass (0: masked; 5 or 7: specialised, with the ns
// constant weights as doubles).
extern "C" int krylov_fused_solve(int method, int dtype, int blocks,
                                  const void* coef, const void* b,
                                  const void* scal, void* x, void* trace,
                                  void* stats, void* work, void* partials,
                                  int ns, int g0, int g1, int g2, int is_const,
                                  const int* disp, int maxiter, int trace_len,
                                  int ns_pass, const double* weights, void* stream) {
    StencilGeom g;
    if (!make_geom(ns, g0, g1, g2, is_const, disp, &g) || (long long)g0 * g1 >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const void* kernel = fused_kernel(method, dtype, ns_pass);
    const bool takes = ns_pass == 0 || (g.is_const && g.ns == ns_pass && weights != nullptr);
    if (kernel == nullptr || !takes) return static_cast<int>(cudaErrorInvalidValue);
    StreamPass<double> spd{};
    StreamPass<float> spf{};
    if (ns_pass != 0) {
        spd = make_stream_pass<double>(g, weights, kThreads, false);
        spf = make_stream_pass<float>(g, weights, kThreads, false);
    }
    void* sp = dtype == 8 ? static_cast<void*>(&spd) : static_cast<void*>(&spf);
    void* args[] = {&g,    sp,    &coef,  &b,    &scal,     &x,       &trace,
                    &stats, &work, &partials, &maxiter, &trace_len};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        kernel, dim3(blocks), dim3(kThreads), args, 0,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
#endif
