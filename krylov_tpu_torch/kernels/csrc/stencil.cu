// K1: structured-grid stencil SpMV, y = A x on a 2-D (or collapsed 3-D) grid,
// for one vector or a (batch, n) block of them.
//
// Replaces krylov_tpu/kernels/stencil.py::stencil_matvec_2d
// (_stencil2d_kernel).  The TPU kernel walked row slabs with an 8-row
// aligned halo in VMEM.  Here K1 is the SpMV of every eager loop on a
// stencil operator on the card (StencilMatrix.matvec): one launch an
// iteration, d more for each degree-d Chebyshev preconditioner
// application, besides the x0 shift of a warm-started fused solve.
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

// NS: the number of terms where the launch knows it (5: the 2-D 5-point
// stencil, 7: the collapsed 3-D 7-point one), so the term loop has no
// runtime bound; 0: any count up to KRYLOV_MAX_TERMS, tested term by term.
template <typename T, int NS>
__global__ void __launch_bounds__(kThreads)
    stencil2d_kernel(K1Args<T> a, const T* __restrict__ coef, const T* __restrict__ x, T* __restrict__ y,
                     int batch) {
    constexpr int NT = NS > 0 ? NS : KRYLOV_MAX_TERMS;
    const StencilGeom& g = a.g;
    const int n = g.g0 * g.g1;
    for (int m = blockIdx.y; m < batch; m += gridDim.y) {
        const T* __restrict__ xm = x + (long long)m * n;
        T* __restrict__ ym = y + (long long)m * n;
        for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
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
                        acc += a.w[s] * xm[e + a.off[s]];
                    }
                } else {
#pragma unroll
                    for (int s = 0; s < NT; ++s) {
                        if (NS == 0 && s >= g.ns) break;
                        acc += coef[(long long)s * n + e] * xm[e + a.off[s]];
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
                        acc += c * xm[j0 * g.g1 + j1];
                    }
                }
            }
            ym[e] = acc;
        }
    }
}

template <typename T, int NS>
int launch(const K1Args<T>& a, const void* coef, const void* x, void* y, int batch, cudaStream_t s) {
    // the grid: enough blocks for the points of one member, no more than
    // the SMs hold at once, shared among the members on the second axis
    static int per_sm = 0;
    if (per_sm == 0) {
        cudaError_t err =
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stencil2d_kernel<T, NS>, kThreads, 0);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long n = (long long)a.g.g0 * a.g.g1;
    const int gy = batch < 65535 ? batch : 65535;
    long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1) / gy;
    if (cap < 1) cap = 1;
    long long gx = (n + kThreads - 1) / kThreads;
    if (gx > cap) gx = cap;
    stencil2d_kernel<T, NS><<<dim3(static_cast<unsigned>(gx), gy), kThreads, 0, s>>>(
        a, static_cast<const T*>(coef), static_cast<const T*>(x), static_cast<T*>(y), batch);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ns(const StencilGeom& g, const int* ext, const double* weights, const void* coef, const void* x,
              void* y, int batch, cudaStream_t s) {
    K1Args<T> a{};
    a.g = g;
    a.lo0 = ext[0], a.hi0 = ext[1], a.lo1 = ext[2], a.hi1 = ext[3], a.lo2 = ext[4], a.hi2 = ext[5];
    for (int t = 0; t < g.ns; ++t) {
        a.off[t] = g.d0[t] * g.g1 + g.d1[t];
        if (g.is_const) a.w[t] = static_cast<T>(weights[t]);
    }
    switch (g.ns) {
        case 5:
            return launch<T, 5>(a, coef, x, y, batch, s);
        case 7:
            return launch<T, 7>(a, coef, x, y, batch, s);
        default:
            return launch<T, 0>(a, coef, x, y, batch, s);
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

// dtype is the element size in bytes (4: float, 8: double); x and y hold
// batch vectors of g0 * g1 entries one after another.
extern "C" int krylov_stencil2d(int dtype, const void* coef, const void* x, void* y, int batch,
                                const K1Params* p, void* stream) {
    const int ns = p->ns, g0 = p->g0, g1 = p->g1, g2 = p->g2;
    StencilGeom g;
    if (!make_geom(ns, g0, g1, g2, p->is_const, p->disp, &g) || batch < 0 || (long long)g0 * g1 >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    int ext[6] = {0, 0, 0, 0, 0, 0};  // lo0, hi0, lo1, hi1, lo2, hi2
    for (int s = 0; s < ns; ++s) {
        ext[0] = g.d0[s] < ext[0] ? g.d0[s] : ext[0];
        ext[1] = g.d0[s] > ext[1] ? g.d0[s] : ext[1];
        ext[2] = g.d1[s] < ext[2] ? g.d1[s] : ext[2];
        ext[3] = g.d1[s] > ext[3] ? g.d1[s] : ext[3];
        if (g2 > 0 && g.d2[s] != 0) {
            ext[4] = g.d2[s] < ext[4] ? g.d2[s] : ext[4];
            ext[5] = g.d2[s] > ext[5] ? g.d2[s] : ext[5];
        }
    }
    if ((long long)g0 * g1 == 0 || batch == 0) return static_cast<int>(cudaSuccess);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return dtype == 8 ? launch_ns<double>(g, ext, p->weights, coef, x, y, batch, s)
                      : launch_ns<float>(g, ext, p->weights, coef, x, y, batch, s);
}

extern "C" const char* krylov_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
