// K1: structured-grid stencil SpMV, y = A x on a 2-D (or collapsed 3-D) grid.
//
// Replaces krylov_tpu/kernels/stencil.py::stencil_matvec_2d
// (_stencil2d_kernel).  The TPU kernel walked row slabs with an 8-row
// aligned halo in VMEM; here one thread computes one output point with the
// shared apply_stencil (stencil.cuh), whose bounds checks stand in for the
// zero padding.
//
// Bound: memory.  At N = 250k the vector is 1 MB (f32) / 2 MB (f64) and sits
// in the 50 MB L2, so a launch is short and its fixed launch cost is a large
// share of it; neighbouring threads read neighbouring addresses, so the
// loads coalesce.  Making it faster (several points a thread, shared-memory
// row tiles) is later work.
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

template <typename T>
__global__ void stencil2d_kernel(StencilGeom g, const T* __restrict__ coef,
                                 const T* __restrict__ x, T* __restrict__ y) {
    const int n = g.g0 * g.g1;
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
         e += gridDim.x * blockDim.x) {
        y[e] = apply_stencil(g, coef, x, e);
    }
}

}  // namespace

// dtype is the element size in bytes (4: float, 8: double); disp is the
// (3, ns) int array of displacements (see make_geom).
extern "C" int krylov_stencil2d(int dtype, const void* coef, const void* x, void* y,
                                int ns, int g0, int g1, int g2, int is_const,
                                const int* disp, void* stream) {
    StencilGeom g;
    if (!make_geom(ns, g0, g1, g2, is_const, disp, &g))
        return static_cast<int>(cudaErrorInvalidValue);
    const int n = g.g0 * g.g1;
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n > 0) {
        if (dtype == 8) {
            stencil2d_kernel<double><<<blocks, threads, 0, s>>>(
                g, static_cast<const double*>(coef),
                static_cast<const double*>(x), static_cast<double*>(y));
        } else {
            stencil2d_kernel<float><<<blocks, threads, 0, s>>>(
                g, static_cast<const float*>(coef),
                static_cast<const float*>(x), static_cast<float*>(y));
        }
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* krylov_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
