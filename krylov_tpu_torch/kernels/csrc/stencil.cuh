// Stencil application on a 2-D (g0, g1) grid: the device function shared by
// the standalone SpMV (stencil.cu) and the fused whole-solve kernels
// (fused.cu).
//
// Replaces krylov_tpu/kernels/fused.py::_apply_stencil (and the body of
// kernels/stencil.py::_stencil2d_kernel).  The TPU version applied the
// stencil to a zero-padded VMEM copy of the vector with an 8-row sublane
// halo and masked the alignment-padding rows; here there is no padding at
// all: a neighbour outside [0, g0) x [0, g1) is skipped, which is what
// reading a zero pad gives.  A 3-D stencil arrives collapsed to
// (g0, g1 * g2) with column displacement d1 * g2 + d2; for the constant
// form `g2 > 0` and a term with d2 != 0 is also skipped where
// (col % g2) + d2 leaves [0, g2) (the `sub` mask of the TPU kernels).
// Grid-coefficient operators store their boundary zeros and pass g2 = 0.
//
// Bound: memory.  Per output point the kernel reads ns vector entries
// (neighbours hit L1/L2: rows are contiguous) and, for the grid form, ns
// coefficients streamed from device memory; the arithmetic is ns FMAs.
#pragma once

// The largest number of terms, set by the build (kernels/_build.py passes
// -DKRYLOV_MAX_TERMS=MAX_TERMS).
#ifndef KRYLOV_MAX_TERMS
#error "KRYLOV_MAX_TERMS must be defined by the build"
#endif

struct StencilGeom {
    int ns;        // number of stencil terms
    int g0, g1;    // grid (rows, columns)
    int g2;        // inner-axis length of a collapsed 3-D constant stencil, else 0
    int is_const;  // coef is (ns,) weights rather than (ns, g0, g1) grids
    int d0[KRYLOV_MAX_TERMS];
    int d1[KRYLOV_MAX_TERMS];
    int d2[KRYLOV_MAX_TERMS];
};

// Geometry from the arguments of the C entry points; disp is the (3, ns)
// int array whose rows are the displacements d0, d1 and d2.  False when ns
// is out of range.
inline bool make_geom(int ns, int g0, int g1, int g2, int is_const, const int* disp,
                      StencilGeom* g) {
    if (ns < 1 || ns > KRYLOV_MAX_TERMS) return false;
    *g = StencilGeom{};
    g->ns = ns;
    g->g0 = g0;
    g->g1 = g1;
    g->g2 = g2;
    g->is_const = is_const;
    for (int s = 0; s < ns; ++s) {
        g->d0[s] = disp[s];
        g->d1[s] = disp[ns + s];
        g->d2[s] = disp[2 * ns + s];
    }
    return true;
}

// y[e] = sum_s coef_s(e) * x[e + (d0_s, d1_s)], terms added in stencil
// order.  `x` is deliberately not __restrict__: inside the fused kernels
// other blocks rewrite it between grid syncs, so it must not go through the
// non-coherent read-only cache.
template <typename T>
__device__ __forceinline__ T apply_stencil(const StencilGeom& g,
                                           const T* __restrict__ coef,
                                           const T* x, int e) {
    const int i0 = e / g.g1;
    const int i1 = e - i0 * g.g1;
    const int i2 = g.g2 > 0 ? i1 % g.g2 : 0;
    const long long n = (long long)g.g0 * g.g1;
    T acc = T(0);
#pragma unroll
    for (int s = 0; s < KRYLOV_MAX_TERMS; ++s) {
        if (s < g.ns) {
            const int j0 = i0 + g.d0[s];
            const int j1 = i1 + g.d1[s];
            bool in = j0 >= 0 && j0 < g.g0 && j1 >= 0 && j1 < g.g1;
            if (g.g2 > 0 && g.d2[s] != 0) {
                const int c2 = i2 + g.d2[s];
                in = in && c2 >= 0 && c2 < g.g2;
            }
            if (in) {
                const T c = g.is_const ? coef[s] : coef[s * n + e];
                acc += c * x[(long long)j0 * g.g1 + j1];
            }
        }
    }
    return acc;
}
