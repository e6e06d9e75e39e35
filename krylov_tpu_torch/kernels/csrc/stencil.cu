// K1: structured-grid stencil SpMV, y = A x on a 2-D (or collapsed 3-D) grid,
// for one vector or a (batch, n) block of them; and beside it the Chebyshev
// step, K1 with the Chebyshev preconditioner's vector updates in its
// epilogue (cheb_step2d_kernel, below).
//
// Replaces krylov_tpu/kernels/stencil.py::stencil_matvec_2d
// (_stencil2d_kernel).  The TPU kernel walked row slabs with an 8-row
// aligned halo in VMEM.  Here K1 is the SpMV of every eager loop on a
// stencil operator on the card (StencilMatrix.matvec): one launch an
// iteration, besides the x0 shift of a warm-started fused solve.  A
// degree-d Chebyshev preconditioner application on such an operator makes
// no K1 launch: it is d - 1 launches of the Chebyshev step.
//
// Bound: bytes.  x in and y out, 2 N words a member (4 MB in f64 at
// N = 250k, in the 50 MB L2), about a microsecond at the HBM rate, so the
// launch, its ramp and the instructions a point are what a call costs.
// The design spends as few instructions a point as it can:
//  - one thread a point; a grid sized to the SMs strides over the points,
//    the members of a block on the grid's second axis (at N = 250k that is
//    one wave, and more warps hide more L2 latency than more points a
//    thread: PERF.md);
//  - one interior test a point: a point whose neighbours all lie inside the
//    grid (and, for a collapsed 3-D constant stencil, inside its inner-axis
//    block) reads them with no test; only the points at the boundary test
//    each term;
//  - the term loop unrolled to the count where the launch knows it (5, 7),
//    so each term's load is issued before the earlier terms' sums;
//  - the constant form's weights arrive as kernel arguments, so no point
//    reads a weight from memory.
// The arithmetic is that of the shared apply_stencil (stencil.cuh): for
// each point acc = 0, then acc += c * x term by term in stencil order
// (contracted to a fused multiply-add under the build's flags), a
// neighbour outside the grid skipped.  apply_stencil itself stays as it
// is: the streaming K2/K3/K5/K6 call it.
//
// The Chebyshev step replaces no TPU kernel: the JAX package applies the
// preconditioner as d SpMVs and 3d + 2 vector operations, and so did the
// port, 38 launches and about 186 MB at degree 6 and N = 250k in f64.
// Bound: bytes, as K1.  A round reads d_k through K1's stencil sum
// (k1_point, so A d_k is K1's bit for bit) and z_k, r_k at the point, and
// writes z_{k+1}, r_{k+1}, d_{k+1}: 12 MB a middle round at N = 250k in
// f64; the first forms d_0 = v / theta where it reads it and never writes
// v, the last writes z alone and skips the recurrence's last SpMV, which
// nothing reads.  So an application is degree - 1 launches and about
// 52 MB at degree 6.  The updates round each operation on its own
// (__dadd_rn and its kind), as torch's separate passes do, so z is the
// unfused loop's bit for bit.
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

constexpr int kThreads = 256;

// The launch's arguments: the geometry; the extents of the displacements
// along each axis (lo <= 0 <= hi; axis 2 counts only the terms that the
// inner-axis mask tests, d2 != 0); each term's flat offset d0 * g1 + d1;
// the constant form's weights.
template <typename T>
struct K1Args {
    StencilGeom g;
    int lo0, hi0, lo1, hi1, lo2, hi2;
    int off[KRYLOV_MAX_TERMS];
    T w[KRYLOV_MAX_TERMS];
};

// What a point loads of the vector the stencil reads: the value in memory
// (Same), or that value times a scale rounded once (Scaled: the Chebyshev
// step's first direction d_0 = v / theta, formed where it is read).
struct Same {
    template <typename T>
    __device__ __forceinline__ T operator()(T v) const { return v; }
};

// Each rounded once, never contracted into a fused multiply-add: torch
// rounds each of the Chebyshev loop's operations on its own.
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }

template <typename T>
struct Scaled {
    T s;
    __device__ __forceinline__ T operator()(T v) const { return mul_rn(v, s); }
};

// (A x)[e] of K1, with x[j] read as load(x[j]): for each point acc = 0,
// then acc += c * x term by term in stencil order (contracted to a fused
// multiply-add under the build's flags), a neighbour outside the grid
// skipped.  NS: the number of terms where the launch knows it (5: the 2-D
// 5-point stencil, 7: the collapsed 3-D 7-point one), so the term loop has
// no runtime bound; 0: any count up to KRYLOV_MAX_TERMS, tested term by
// term.  Both kernels of this file sum A x here, so the Chebyshev step's
// SpMV is K1's bit for bit.
template <typename T, int NS, typename Load>
__device__ __forceinline__ T k1_point(const K1Args<T>& a, const T* __restrict__ coef, const T* __restrict__ xm,
                                      const Load& load, int e, int n) {
    constexpr int NT = NS > 0 ? NS : KRYLOV_MAX_TERMS;
    const StencilGeom& g = a.g;
    const int i0 = e / g.g1;
    const int i1 = e - i0 * g.g1;
    const int i2 = g.g2 > 0 ? i1 % g.g2 : 0;
    const bool interior = i0 + a.lo0 >= 0 && i0 + a.hi0 < g.g0 && i1 + a.lo1 >= 0 && i1 + a.hi1 < g.g1 &&
                          (g.g2 == 0 || (i2 + a.lo2 >= 0 && i2 + a.hi2 < g.g2));
    T acc = T(0);
    if (interior) {
        if (g.is_const) {
#pragma unroll
            for (int s = 0; s < NT; ++s) {
                if (NS == 0 && s >= g.ns) break;
                acc += a.w[s] * load(xm[e + a.off[s]]);
            }
        } else {
#pragma unroll
            for (int s = 0; s < NT; ++s) {
                if (NS == 0 && s >= g.ns) break;
                acc += coef[(long long)s * n + e] * load(xm[e + a.off[s]]);
            }
        }
    } else {
        // a boundary point: each term tested, as in apply_stencil
#pragma unroll
        for (int s = 0; s < NT; ++s) {
            if (NS == 0 && s >= g.ns) break;
            const int j0 = i0 + g.d0[s];
            const int j1 = i1 + g.d1[s];
            bool in = j0 >= 0 && j0 < g.g0 && j1 >= 0 && j1 < g.g1;
            if (g.g2 > 0 && g.d2[s] != 0) {
                const int t2 = i2 + g.d2[s];
                in = in && t2 >= 0 && t2 < g.g2;
            }
            if (in) {
                const T c = g.is_const ? a.w[s] : coef[(long long)s * n + e];
                acc += c * load(xm[j0 * g.g1 + j1]);
            }
        }
    }
    return acc;
}

template <typename T, int NS>
__global__ void __launch_bounds__(kThreads)
    stencil2d_kernel(K1Args<T> a, const T* __restrict__ coef, const T* __restrict__ x, T* __restrict__ y,
                     int batch) {
    const int n = a.g.g0 * a.g.g1;
    for (int m = blockIdx.y; m < batch; m += gridDim.y) {
        const T* __restrict__ xm = x + (long long)m * n;
        T* __restrict__ ym = y + (long long)m * n;
        for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x)
            ym[e] = k1_point<T, NS>(a, coef, xm, Same{}, e, n);
    }
}

// One round k of the Chebyshev recurrence of precond.py's chebyshev_loop
// at each point, A d_k summed as K1 sums it:
//   z_{k+1} = z_k + d_k,  r_{k+1} = r_k - A d_k,  d_{k+1} = c1 d_k + c2 r_{k+1}.
// FIRST (k = 0): d is the caller's v, d_0 = v * inv (torch's v / theta on
// the card: a product with the float64 reciprocal rounded to T, as the
// entry points round inv) formed at each index read,
// z_0 = 0 and r_0 = v; nothing is written to v.  LAST (k = degree - 2):
// z_degree = z_{k+1} + d_{k+1} is the one output (the recurrence's last
// SpMV, whose results nothing reads, is not made).  z and r are read and
// written at the point alone, so in place; d_out is another buffer than
// d, whose neighbours other threads read.
template <typename T, int NS, bool FIRST, bool LAST>
__global__ void __launch_bounds__(kThreads)
    cheb_step2d_kernel(K1Args<T> a, const T* __restrict__ coef, const T* __restrict__ d, T* z, T* r,
                       T* __restrict__ d_out, T inv, T c1, T c2, int batch) {
    const int n = a.g.g0 * a.g.g1;
    for (int m = blockIdx.y; m < batch; m += gridDim.y) {
        const long long at = (long long)m * n;
        const T* __restrict__ dm = d + at;
        for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
            T dk, ad, zk, rk;
            if (FIRST) {
                rk = dm[e];
                dk = mul_rn(rk, inv);
                zk = T(0);
                ad = k1_point<T, NS>(a, coef, dm, Scaled<T>{inv}, e, n);
            } else {
                dk = dm[e];
                zk = z[at + e];
                rk = r[at + e];
                ad = k1_point<T, NS>(a, coef, dm, Same{}, e, n);
            }
            const T z1 = add_rn(zk, dk);
            const T r1 = sub_rn(rk, ad);
            const T d1 = add_rn(mul_rn(c1, dk), mul_rn(c2, r1));
            if (LAST) {
                z[at + e] = add_rn(z1, d1);
            } else {
                z[at + e] = z1;
                r[at + e] = r1;
                d_out[at + e] = d1;
            }
        }
    }
}

// A degree-1 application, z = 0 + v * inv: no SpMV.
template <typename T>
__global__ void __launch_bounds__(kThreads) cheb_scale_kernel(const T* __restrict__ v, T* __restrict__ z, T inv,
                                                              long long count) {
    for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < count;
         e += (long long)gridDim.x * blockDim.x)
        z[e] = add_rn(T(0), mul_rn(v[e], inv));
}

// The grid of a launch of `kernel` over n points a member: enough blocks
// for the points of one member, no more than the SMs hold at once, shared
// among the members on the second axis.  per_sm caches the kernel's
// occupancy.
template <typename Kernel>
cudaError_t grid_of(Kernel kernel, int* per_sm, long long n, int batch, dim3* grid) {
    if (*per_sm == 0) {
        cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, 0);
        if (err != cudaSuccess) return err;
    }
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const int gy = batch < 65535 ? batch : 65535;
    long long cap = (long long)sms * (*per_sm > 0 ? *per_sm : 1) / gy;
    if (cap < 1) cap = 1;
    long long gx = (n + kThreads - 1) / kThreads;
    if (gx > cap) gx = cap;
    *grid = dim3(static_cast<unsigned>(gx), gy);
    return cudaSuccess;
}

template <typename T, int NS>
int launch(const K1Args<T>& a, const void* coef, const void* x, void* y, int batch, cudaStream_t s) {
    static int per_sm = 0;
    dim3 grid;
    cudaError_t err = grid_of(stencil2d_kernel<T, NS>, &per_sm, (long long)a.g.g0 * a.g.g1, batch, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    stencil2d_kernel<T, NS><<<grid, kThreads, 0, s>>>(a, static_cast<const T*>(coef), static_cast<const T*>(x),
                                                      static_cast<T*>(y), batch);
    return static_cast<int>(cudaGetLastError());
}

// The arguments of one Chebyshev round besides K1's.
struct ChebRound {
    const void* d;
    void* z;
    void* r;
    void* d_out;
    double inv, c1, c2;
    bool first, last;
};

template <typename T, int NS, bool FIRST, bool LAST>
int launch_step(const K1Args<T>& a, const void* coef, const ChebRound& c, int batch, cudaStream_t s) {
    static int per_sm = 0;
    dim3 grid;
    cudaError_t err =
        grid_of(cheb_step2d_kernel<T, NS, FIRST, LAST>, &per_sm, (long long)a.g.g0 * a.g.g1, batch, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    cheb_step2d_kernel<T, NS, FIRST, LAST><<<grid, kThreads, 0, s>>>(
        a, static_cast<const T*>(coef), static_cast<const T*>(c.d), static_cast<T*>(c.z), static_cast<T*>(c.r),
        static_cast<T*>(c.d_out), static_cast<T>(c.inv), static_cast<T>(c.c1), static_cast<T>(c.c2), batch);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int NS>
int launch_round(const K1Args<T>& a, const void* coef, const ChebRound& c, int batch, cudaStream_t s) {
    if (c.first) return c.last ? launch_step<T, NS, true, true>(a, coef, c, batch, s)
                               : launch_step<T, NS, true, false>(a, coef, c, batch, s);
    return c.last ? launch_step<T, NS, false, true>(a, coef, c, batch, s)
                  : launch_step<T, NS, false, false>(a, coef, c, batch, s);
}

template <typename T>
K1Args<T> k1_args(const StencilGeom& g, const int* ext, const double* weights) {
    K1Args<T> a{};
    a.g = g;
    a.lo0 = ext[0], a.hi0 = ext[1], a.lo1 = ext[2], a.hi1 = ext[3], a.lo2 = ext[4], a.hi2 = ext[5];
    for (int t = 0; t < g.ns; ++t) {
        a.off[t] = g.d0[t] * g.g1 + g.d1[t];
        if (g.is_const) a.w[t] = static_cast<T>(weights[t]);
    }
    return a;
}

// K1 (round null) or a Chebyshev round, on the instance of the term count.
template <typename T>
int launch_ns(const StencilGeom& g, const int* ext, const double* weights, const void* coef, const void* x,
              void* y, const ChebRound* round, int batch, cudaStream_t s) {
    const K1Args<T> a = k1_args<T>(g, ext, weights);
    switch (g.ns) {
        case 5:
            return round ? launch_round<T, 5>(a, coef, *round, batch, s) : launch<T, 5>(a, coef, x, y, batch, s);
        case 7:
            return round ? launch_round<T, 7>(a, coef, *round, batch, s) : launch<T, 7>(a, coef, x, y, batch, s);
        default:
            return round ? launch_round<T, 0>(a, coef, *round, batch, s) : launch<T, 0>(a, coef, x, y, batch, s);
    }
}

}  // namespace

// What a call needs besides its pointers, built once per operator by the
// wrapper (kernels/stencil.py, _K1Params): the geometry, disp the (3, ns)
// displacements (see make_geom), and the constant form's ns weights (read
// only when is_const).
struct K1Params {
    int ns, g0, g1, g2, is_const;
    int disp[3 * KRYLOV_MAX_TERMS];
    double weights[KRYLOV_MAX_TERMS];
};

namespace {

// The geometry of a launch from its parameters, and the extents of the
// displacements along each axis (lo0, hi0, lo1, hi1, lo2, hi2); false on
// parameters the kernels do not take.
bool geom_of(const K1Params* p, int batch, StencilGeom* g, int* ext) {
    const int ns = p->ns, g0 = p->g0, g1 = p->g1, g2 = p->g2;
    if (!make_geom(ns, g0, g1, g2, p->is_const, p->disp, g) || batch < 0 || (long long)g0 * g1 >= (1LL << 31))
        return false;
    for (int t = 0; t < 6; ++t) ext[t] = 0;
    for (int s = 0; s < ns; ++s) {
        ext[0] = g->d0[s] < ext[0] ? g->d0[s] : ext[0];
        ext[1] = g->d0[s] > ext[1] ? g->d0[s] : ext[1];
        ext[2] = g->d1[s] < ext[2] ? g->d1[s] : ext[2];
        ext[3] = g->d1[s] > ext[3] ? g->d1[s] : ext[3];
        if (g2 > 0 && g->d2[s] != 0) {
            ext[4] = g->d2[s] < ext[4] ? g->d2[s] : ext[4];
            ext[5] = g->d2[s] > ext[5] ? g->d2[s] : ext[5];
        }
    }
    return true;
}

int run(int dtype, const void* coef, const void* x, void* y, const ChebRound* round, int batch, const K1Params* p,
        void* stream) {
    StencilGeom g;
    int ext[6];
    if (!geom_of(p, batch, &g, ext)) return static_cast<int>(cudaErrorInvalidValue);
    if ((long long)g.g0 * g.g1 == 0 || batch == 0) return static_cast<int>(cudaSuccess);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 8 ? launch_ns<double>(g, ext, p->weights, coef, x, y, round, batch, s)
                      : launch_ns<float>(g, ext, p->weights, coef, x, y, round, batch, s);
}

}  // namespace

// dtype is the element size in bytes (4: float, 8: double); x and y hold
// batch vectors of g0 * g1 entries one after another.
extern "C" int krylov_stencil2d(int dtype, const void* coef, const void* x, void* y, int batch,
                                const K1Params* p, void* stream) {
    return run(dtype, coef, x, y, nullptr, batch, p, stream);
}

// One round of a Chebyshev application (cheb_step2d_kernel): first and last
// as the kernel's FIRST and LAST, d the direction it reads (the caller's v
// in the first round), z and r updated in place, d_out the next direction
// (unused in the last round), inv, c1 and c2 the round's scalars as
// doubles, cast to the dtype here.  Each vector holds batch members of
// g0 * g1 entries one after another.
extern "C" int krylov_cheb_step2d(int dtype, const void* coef, const void* d, void* z, void* r, void* d_out,
                                  int batch, const K1Params* p, int first, int last, double inv, double c1,
                                  double c2, void* stream) {
    const ChebRound round{d, z, r, d_out, inv, c1, c2, first != 0, last != 0};
    return run(dtype, coef, nullptr, nullptr, &round, batch, p, stream);
}

// A degree-1 application over count entries: z = 0 + v * inv.
extern "C" int krylov_cheb_scale(int dtype, const void* v, void* z, long long count, double inv, void* stream) {
    if (count <= 0) return static_cast<int>(cudaSuccess);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    static int per_sm[2] = {0, 0};
    int* cached = &per_sm[dtype == 8];
    dim3 grid;
    cudaError_t err = dtype == 8 ? grid_of(cheb_scale_kernel<double>, cached, count, 1, &grid)
                                 : grid_of(cheb_scale_kernel<float>, cached, count, 1, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dtype == 8)
        cheb_scale_kernel<double><<<grid, kThreads, 0, s>>>(static_cast<const double*>(v), static_cast<double*>(z),
                                                            inv, count);
    else
        cheb_scale_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(v), static_cast<float*>(z),
                                                           static_cast<float>(inv), count);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* krylov_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
