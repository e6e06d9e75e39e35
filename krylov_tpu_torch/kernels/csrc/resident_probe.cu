// K4 alone: the resident stencil pass (resident.cuh: stencil_pass) of
// K2/K3/K5/K6, run reps times over the bands of a resident plan, with a
// __syncthreads after each pass as in the solves.  diagnostics/grid_sweep.py
// times a pass with it, as it times a grid sync: (time of 2000 reps - time
// of 200) / 1800; tests/test_torch_cuda.py and chip_smoke.py hold the
// specialised pass, in each of its forms, against the masked one (NS = 0)
// bitwise on the same mirror, and all against the plain version of the
// stencil.
#include "resident.cuh"

namespace {

// Each block mirrors its band of x (and the halo rows on the grid) in
// shared memory, runs the pass reps times, and writes the last pass's y at
// its band's points; sum holds the passes' sum there, which keeps every
// pass live, and cycles[block] the block's clock cycles over the passes.
template <typename T, int PPT, int NS, int SHAPE>
__global__ void __launch_bounds__(kResThreads, 1)
stencil_probe_kernel(StencilGeom g, Terms<T> tm, int h, const T* __restrict__ coef, const T* __restrict__ x,
                     T* __restrict__ y, T* __restrict__ sum, long long* cycles, int reps) {
    extern __shared__ __align__(16) unsigned char dyn[];
    T* const xs = reinterpret_cast<T*>(dyn);
    const Band bd = band_of(g, h);
    Points<PPT> pt = band_points<PPT, NS>(g, bd);
    mirror_from(xs, x, g, bd);
    __syncthreads();
    T yv[PPT], acc[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) yv[k] = acc[k] = T(0);
    const long long t0 = clock64();
    for (int r = 0; r < reps; ++r) {
        stencil_pass<T, PPT, NS, SHAPE>(g, coef, tm, xs, bd, pt, yv);
#pragma unroll
        for (int k = 0; k < PPT; ++k) acc[k] = add(acc[k], yv[k]);
        __syncthreads();
    }
    const long long t1 = clock64();
    if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
        const int e = bd.p0 + threadIdx.x + k * kResThreads;
        if (e < bd.p1) {
            y[e] = yv[k];
            sum[e] = acc[k];
        }
    }
}

template <typename T, int NS, int SHAPE>
const void* probe_kernel_ns(int ppt) {
    switch (ppt) {
        case 1: return reinterpret_cast<const void*>(&stencil_probe_kernel<T, 1, NS, SHAPE>);
        case 2: return reinterpret_cast<const void*>(&stencil_probe_kernel<T, 2, NS, SHAPE>);
        case 4: return reinterpret_cast<const void*>(&stencil_probe_kernel<T, 4, NS, SHAPE>);
        case 8: return reinterpret_cast<const void*>(&stencil_probe_kernel<T, 8, NS, SHAPE>);
        default: return nullptr;
    }
}

// The split form the probe times: G = 2, as K6 takes it in float32 at 4
// points a thread (kPassShape).
constexpr int kProbeSplit = 2;

template <typename T, int NS>
const void* probe_kernel_form(int split, int ppt) {
    return split ? probe_kernel_ns<T, NS, kProbeSplit>(ppt) : probe_kernel_ns<T, NS, kPredicated>(ppt);
}

template <typename T>
const void* probe_kernel(int spec, int split, int ppt) {
    return spec == 0   ? probe_kernel_ns<T, 0, kPredicated>(ppt)
           : spec == 1 ? probe_kernel_form<T, 5>(split, ppt)
                       : probe_kernel_form<T, 7>(split, ppt);
}

// Dynamic shared memory the probe asks for at least: more than half an SM,
// so that one block runs on an SM, as in the resident solves.
constexpr int kProbeSmem = 116 * 1024;

}  // namespace

// Runs the pass with K4's specialisation ns_pass (0, 5 or 7; see
// pass_index), in its split form (kProbeSplit) where `split` is nonzero
// (else kPredicated), reps times on `blocks` bands of the (g0, g1) grid, each of
// ppt * 512 points at most and h = max |d0| halo rows, as a resident solve
// of that plan would (dtype the element size; weights the constant form's
// ns weights on the host, or null).  y and sum are the grid's n entries,
// cycles one a block.  Returns a cudaError_t.
extern "C" int krylov_stencil_probe(int dtype, int ns_pass, int split, int blocks, int ppt, int h, const void* coef,
                                    const void* x, void* y, void* sum, void* cycles, int ns, int g0, int g1,
                                    int g2, int is_const, const int* disp, const double* weights, int reps,
                                    void* stream) {
    StencilGeom g;
    if (!make_geom(ns, g0, g1, g2, is_const, disp, &g) || blocks < 1 || blocks > g0 || h < 0 || reps < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long rows = (g0 + blocks - 1) / blocks;
    const int spec = pass_index(g, ns_pass, weights);
    if (rows * g1 > (long long)ppt * kResThreads || (blocks > 1 && g0 / blocks < h) || spec < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const void* kernel = dtype == 8 ? probe_kernel<double>(spec, split, ppt)
                         : dtype == 4 ? probe_kernel<float>(spec, split, ppt)
                                      : nullptr;
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const long long mirror = (rows + 2LL * h) * g1 * dtype;
    const int smem = static_cast<int>(mirror > kProbeSmem ? mirror : kProbeSmem);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    Terms<double> tmd = make_terms<double>(g, weights);
    Terms<float> tmf = make_terms<float>(g, weights);
    void* tm = dtype == 8 ? static_cast<void*>(&tmd) : static_cast<void*>(&tmf);
    void* args[] = {&g, tm, &h, &coef, &x, &y, &sum, &cycles, &reps};
    err = cudaLaunchKernel(kernel, dim3(blocks), dim3(kResThreads), args, smem, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
