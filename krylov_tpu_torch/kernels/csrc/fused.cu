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
// streams the vectors it touches through L2 and ends in a grid sync whose
// grid sum loads every block's partial in every block.  The grid is the
// plan's: 4 blocks of 256 threads an SM (528 on an H100), where a sweep of
// grid sizes found the time an iteration lowest (PERF.md), and no more
// blocks than the points need.
#include <cuda_runtime.h>

#include "reduce.cuh"
#include "stencil.cuh"

namespace {

// Per-block partial-sum slots (MrR uses all 8: init 3, <r,r> 1, <y,y>/<y,Ar>
// 2, <r,s>/<s,s> 2; CG 2) and n-vectors of work space, by method.
constexpr int kPartialSlots = 8;
constexpr int kWorkVectors[2] = {3, 4};  // CG: r, p, v; MrR: r, y, z, Ar

// Whole MrR solve of A x = b from x0 = 0 (the wrapper shifts for x0).
// work holds r, y, z, Ar (4 n); partials holds kPartialSlots slots of gridDim.x.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mrr_fused_kernel(StencilGeom g, const T* __restrict__ coef, const T* __restrict__ b,
                 const T* __restrict__ scal, T* x, T* trace, int* stats, T* work,
                 T* partials, int maxiter, int trace_len) {
    cg::grid_group grid = cg::this_grid();
    __shared__ T smem[kBlockSumSmem];
    const int n = g.g0 * g.g1;
    const int nb = gridDim.x;
    const int first = blockIdx.x * kThreads + threadIdx.x;
    const int stride = nb * kThreads;
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
    for (int e = first; e < n; e += stride) {
        const T a = apply_stencil(g, coef, b, e);
        const T be = b[e];
        Ar[e] = a;
        init[0] += be * be;
        init[1] += be * a;
        init[2] += a * a;
    }
    grid_sum(grid, init, s_init, smem);
    if (lead) trace[0] = sqrt(init[0]) / b_norm;
    const T zeta0 = safe_div(init[1], init[2]);
    T rr[1] = {T(0)};
    for (int e = first; e < n; e += stride) {
        const T be = b[e];
        const T ye = zeta0 * Ar[e];
        const T ze = -zeta0 * be;
        const T re = be - ye;
        y[e] = ye;
        z[e] = ze;
        r[e] = re;
        x[e] = -ze;
        rr[0] += re * re;
    }
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
        for (int e = first; e < n; e += stride) {
            const T a = apply_stencil(g, coef, r, e);
            const T ye = y[e];
            Ar[e] = a;
            mn[0] += ye * ye;
            mn[1] += ye * a;
        }
        grid_sum(grid, mn, s_mn, smem);
        const T gamma = safe_div(mn[1], mn[0]);
        T rs[2] = {T(0), T(0)};  // <r,s>, <s,s> with s = Ar - gamma y
        for (int e = first; e < n; e += stride) {
            const T s = Ar[e] - gamma * y[e];
            rs[0] += r[e] * s;
            rs[1] += s * s;
        }
        grid_sum(grid, rs, s_rs, smem);
        const T zeta = safe_div(rs[0], rs[1]);
        const T eta = -zeta * gamma;
        rr[0] = T(0);
        for (int e = first; e < n; e += stride) {
            const T re = r[e];
            const T yn = eta * y[e] + zeta * Ar[e];
            const T zn = eta * z[e] - zeta * re;
            const T rn = re - yn;
            y[e] = yn;
            z[e] = zn;
            r[e] = rn;
            x[e] -= zn;
            rr[0] += rn * rn;
        }
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
template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_fused_kernel(StencilGeom g, const T* __restrict__ coef, const T* __restrict__ b,
                const T* __restrict__ scal, T* x, T* trace, int* stats, T* work,
                T* partials, int maxiter, int trace_len) {
    cg::grid_group grid = cg::this_grid();
    __shared__ T smem[kBlockSumSmem];
    const int n = g.g0 * g.g1;
    const int nb = gridDim.x;
    const int first = blockIdx.x * kThreads + threadIdx.x;
    const int stride = nb * kThreads;
    const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
    T* r = work;
    T* p = work + (size_t)n;
    T* v = work + 2 * (size_t)n;
    T* s_gamma = partials;
    T* s_sigma = partials + nb;
    const T tol = scal[0];
    const T b_norm = scal[1];

    T gam[1] = {T(0)};
    for (int e = first; e < n; e += stride) {
        const T be = b[e];
        r[e] = be;
        p[e] = be;
        x[e] = T(0);
        gam[0] += be * be;
    }
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
        for (int e = first; e < n; e += stride) {
            const T ve = apply_stencil(g, coef, p, e);
            v[e] = ve;
            sig[0] += p[e] * ve;
        }
        grid_sum(grid, sig, s_sigma, smem);
        const T alpha = safe_div(gamma, sig[0]);
        gam[0] = T(0);
        for (int e = first; e < n; e += stride) {
            x[e] += alpha * p[e];
            const T rn = r[e] - alpha * v[e];
            r[e] = rn;
            gam[0] += rn * rn;
        }
        grid_sum(grid, gam, s_gamma, smem);
        const T beta = safe_div(gam[0], gamma);
        for (int e = first; e < n; e += stride) p[e] = r[e] + beta * p[e];
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

template <typename T>
const void* kernel_for(int method) {
    return method == 0 ? reinterpret_cast<const void*>(&cg_fused_kernel<T>)
                       : reinterpret_cast<const void*>(&mrr_fused_kernel<T>);
}

const void* kernel_for(int method, int dtype) {
    return dtype == 8 ? kernel_for<double>(method) : kernel_for<float>(method);
}

}  // namespace

// The work space of a solve of n points: the blocks of the cooperative grid
// (max_blocks, the plan's, but no more than can be resident on the current
// device at once or than n needs) and the elements of the work and partials
// buffers that krylov_fused_solve takes.  method 0 = CG, 1 = MrR; dtype is
// the element size in bytes.
extern "C" int krylov_fused_workspace(int method, int dtype, int n, int max_blocks, int* blocks,
                                      long long* work_elems, long long* partial_elems) {
    if ((method != 0 && method != 1) || max_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel_for(method, dtype), kThreads, 0);
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
// method, dtype, n and blocks; disp is the (3, ns) displacement array.
extern "C" int krylov_fused_solve(int method, int dtype, int blocks,
                                  const void* coef, const void* b,
                                  const void* scal, void* x, void* trace,
                                  void* stats, void* work, void* partials,
                                  int ns, int g0, int g1, int g2, int is_const,
                                  const int* disp, int maxiter, int trace_len,
                                  void* stream) {
    StencilGeom g;
    if (!make_geom(ns, g0, g1, g2, is_const, disp, &g))
        return static_cast<int>(cudaErrorInvalidValue);
    void* args[] = {&g,    &coef,  &b,    &scal,     &x,       &trace,
                    &stats, &work, &partials, &maxiter, &trace_len};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        kernel_for(method, dtype), dim3(blocks), dim3(kThreads), args, 0,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
