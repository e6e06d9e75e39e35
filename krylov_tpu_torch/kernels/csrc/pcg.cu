// The vector and scalar work of preconditioned CG's eager body
// (solvers/pipelined.py, pcg_kernel) on the card: four kernels around the
// body's SpMV (K1, A p) and its preconditioner (M r), which run as they
// are.
//
// Replaces no TPU kernel: the JAX package leaves these updates and inner
// products to XLA's fusions.  Run by torch they were some 36 launches a
// body (three cuBLAS dots and their reductions, the x/r/p updates with
// their scalar products, safe_div's and tree_select's wheres, the trace
// write), about 67 us of a replayed body's 87.5 us at N = 250k in f64.
// Here a body is four launches around A p and M r:
//   pcg_alpha_kernel  <s, p>; then res = sqrt(rr) / |b|, trace[i] = res,
//                     conv = res < tol, alpha = safe_div(ru, <s, p>),
//                     i + !conv
//   pcg_xr_kernel     x' = conv ? x : x + alpha p, r' = conv ? r : r - alpha s,
//                     rr' = conv ? rr : <r', r'>
//   pcg_ru_kernel     <r', u'> (u' = M r'); ru' = conv ? ru : <r', u'>,
//                     beta = safe_div(<r', u'>, ru) (0 where conv: unread)
//   pcg_p_kernel      p' = conv ? p : u' + beta p
// rr, the squared residual norm, is carried from one body to the next in
// place of a fourth dot.
//
// Bound: bytes.  A body moves about 26 MB at N = 250k in f64 (read s, p;
// read x, p, r, s and write x, r; read r, u; read u, p and write p), about
// 8 us at the HBM rate, and less where the vectors sit in the 50 MB L2.
// What a launch costs besides is its ramp and, in the three kernels with a
// reduction, one grid-wide sum: each block sums its points in a fixed
// order (reduce.cuh's block_sum) and writes one partial; the block that
// takes the last ticket of its member sums the partials in a fixed order,
// does the scalar work and puts the ticket back to 0, so a CUDA graph
// replays the kernel as it ran.  No block waits for another.  On an H100
// the four take about 16 us a body at N = 250k in f64, 14 in f32.
//
// Arithmetic: the updates round each operation on its own (__dadd_rn and
// its kind, never contracted into a fused multiply-add), so x, r and p are
// torch's scale-then-add bit for bit for given scalars; the selects keep
// the old bits; sqrt, the division and safe_div round as torch's do.  The
// inner products are the new arithmetic: a fixed tree in the dtype, in
// place of cuBLAS's order, so a solve repeats bit for bit but is not the
// torch body's.  A (batch, n) block takes one member a grid row
// (blockIdx.y) on the grid a solo vector gets, so each member sums in its
// solo solve's order and ends with its bits.
#include <cuda/atomic>
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }

// A grid-stride loop's first index and stride, in 64 bits: within one
// stride of n < 2**31 an int index would overflow.
__device__ __forceinline__ long long first_index() { return (long long)blockIdx.x * kThreads + threadIdx.x; }
__device__ __forceinline__ long long grid_stride() { return (long long)gridDim.x * kThreads; }

// The grid's blocks a member: ceil(n / kThreads), at most what the SMs
// hold at once and, for a kernel with a grid sum, kSumBlocksPerSm a SM:
// fewer partials and tickets for the sum's tail.  On an H100 at N = 250k
// in f64 a sum's kernel takes 4.3-5.0 us so, 5.2-5.6 at 8 a SM (2 a SM:
// as 4); the update alone is fastest on the full grid.  The wrapper sizes
// the partials for ceil(n / kThreads).
constexpr int kSumBlocksPerSm = 4;

template <typename Kernel>
cudaError_t blocks_of(Kernel kernel, int* per_sm, int n, bool sums, int* gx) {
    if (*per_sm == 0) {
        cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, 0);
        if (err != cudaSuccess) return err;
    }
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    int each = *per_sm > 0 ? *per_sm : 1;
    if (sums && each > kSumBlocksPerSm) each = kSumBlocksPerSm;
    const long long cap = (long long)sms * each;
    const long long need = ((long long)n + kThreads - 1) / kThreads;
    *gx = static_cast<int>(need < cap ? need : cap);
    return cudaSuccess;
}

// The scratch of the grid sums: the partials of each member's blocks, then
// one ticket a member (zero between launches).
template <typename T>
struct Scratch {
    T* partials;
    unsigned int* tickets;
};

template <typename T>
Scratch<T> scratch_of(void* scratch, int n, int batch) {
    T* partials = static_cast<T*>(scratch);
    const long long slots = (long long)batch * (((long long)n + kThreads - 1) / kThreads);
    return Scratch<T>{partials, reinterpret_cast<unsigned int*>(partials + slots)};
}

// The sum over the grid row of member blockIdx.y of each thread's v: true
// in the one block that arrives last, where v is then the member's sum on
// every thread, summed in a fixed order; that block puts the ticket back.
template <typename T>
__device__ bool last_block_sum(T& v, const Scratch<T>& s, T* smem) {
    __shared__ bool last;
    T part[1] = {v};
    block_sum(part, smem);
    const unsigned int gx = gridDim.x;
    T* partials = s.partials + (long long)blockIdx.y * gx;
    if (threadIdx.x == 0) {
        partials[blockIdx.x] = part[0];
        // release: the partial is visible before the ticket counts it;
        // acquire: the last block sees every partial the tickets counted
        cuda::atomic_ref<unsigned int, cuda::thread_scope_device> ticket(s.tickets[blockIdx.y]);
        last = ticket.fetch_add(1u, cuda::memory_order_acq_rel) == gx - 1;
    }
    __syncthreads();
    if (!last) return false;
    T total[1] = {T(0)};
    for (unsigned int j = threadIdx.x; j < gx; j += kThreads) total[0] += __ldcg(partials + j);
    block_sum(total, smem);
    v = total[0];
    if (threadIdx.x == 0) s.tickets[blockIdx.y] = 0u;
    return true;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pcg_alpha_kernel(const T* __restrict__ s, const T* __restrict__ p, int n, const T* __restrict__ rr,
                     const T* __restrict__ b_norm, const T* __restrict__ ru, const T* __restrict__ tol_at, T tol,
                     T* __restrict__ trace, long long trace_len, const long long* __restrict__ i,
                     bool* __restrict__ conv, T* __restrict__ alpha, long long* __restrict__ i_out, Scratch<T> sc) {
    __shared__ T smem[kBlockSumSmem];
    const int m = blockIdx.y;
    const long long at = (long long)m * n;
    // the tail's scalars, loaded ahead of the sum (the last block's thread
    // 0 reads them)
    const T rr_m = rr[m], b_norm_m = b_norm[m], ru_m = ru[m], tol_m = tol_at ? *tol_at : tol;
    const long long k = i[m];
    T v = T(0);
    for (long long e = first_index(); e < n; e += grid_stride())
        v += s[at + e] * p[at + e];
    if (!last_block_sum(v, sc, smem) || threadIdx.x != 0) return;
    const T res = div_rn(sqrt_rn(rr_m), b_norm_m);
    if (k >= 0 && k < trace_len) trace[m * trace_len + k] = res;
    const bool c = res < tol_m;
    conv[m] = c;
    alpha[m] = safe_div(ru_m, v);
    i_out[m] = c ? k : k + 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pcg_xr_kernel(const T* __restrict__ x, const T* __restrict__ p, const T* __restrict__ r,
                  const T* __restrict__ s, int n, const T* __restrict__ alpha, const bool* __restrict__ conv,
                  const T* __restrict__ rr, T* __restrict__ x_out, T* __restrict__ r_out, T* __restrict__ rr_out,
                  Scratch<T> sc) {
    __shared__ T smem[kBlockSumSmem];
    const int m = blockIdx.y;
    const long long at = (long long)m * n;
    const bool c = conv[m];
    const T a = alpha[m], rr_m = rr[m];
    T v = T(0);
    for (long long e = first_index(); e < n; e += grid_stride()) {
        T xe = x[at + e], re = r[at + e];
        if (!c) {
            xe = add_rn(xe, mul_rn(a, p[at + e]));
            re = sub_rn(re, mul_rn(a, s[at + e]));
            v += re * re;
        }
        x_out[at + e] = xe;
        r_out[at + e] = re;
    }
    if (!last_block_sum(v, sc, smem) || threadIdx.x != 0) return;
    rr_out[m] = c ? rr_m : v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pcg_ru_kernel(const T* __restrict__ r, const T* __restrict__ u, int n, const T* __restrict__ ru,
                  const bool* __restrict__ conv, T* __restrict__ ru_out, T* __restrict__ beta, Scratch<T> sc) {
    __shared__ T smem[kBlockSumSmem];
    const int m = blockIdx.y;
    const long long at = (long long)m * n;
    const bool c = conv[m];
    const T ru_m = ru[m];
    T v = T(0);
    if (!c)
        for (long long e = first_index(); e < n; e += grid_stride())
            v += r[at + e] * u[at + e];
    if (!last_block_sum(v, sc, smem) || threadIdx.x != 0) return;
    beta[m] = safe_div(v, ru_m);
    ru_out[m] = c ? ru_m : v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pcg_p_kernel(const T* __restrict__ u, const T* __restrict__ p, int n, const T* __restrict__ beta,
                 const bool* __restrict__ conv, T* __restrict__ p_out) {
    const int m = blockIdx.y;
    const long long at = (long long)m * n;
    const bool c = conv[m];
    const T b = beta[m];
    for (long long e = first_index(); e < n; e += grid_stride())
        p_out[at + e] = c ? p[at + e] : add_rn(u[at + e], mul_rn(b, p[at + e]));
}

template <typename T>
int alpha_on(int n, int batch, const void* s, const void* p, const void* rr, const void* b_norm, const void* ru,
             const void* tol_at, double tol, void* trace, long long trace_len, const void* i, void* conv,
             void* alpha, void* i_out, void* scratch, cudaStream_t st) {
    static int per_sm = 0;
    int gx = 0;
    const cudaError_t err = blocks_of(pcg_alpha_kernel<T>, &per_sm, n, true, &gx);
    if (err != cudaSuccess) return static_cast<int>(err);
    pcg_alpha_kernel<T><<<dim3(gx, batch), kThreads, 0, st>>>(
        static_cast<const T*>(s), static_cast<const T*>(p), n, static_cast<const T*>(rr),
        static_cast<const T*>(b_norm), static_cast<const T*>(ru), static_cast<const T*>(tol_at), static_cast<T>(tol),
        static_cast<T*>(trace), trace_len, static_cast<const long long*>(i), static_cast<bool*>(conv),
        static_cast<T*>(alpha), static_cast<long long*>(i_out), scratch_of<T>(scratch, n, batch));
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int xr_on(int n, int batch, const void* x, const void* p, const void* r, const void* s, const void* alpha,
          const void* conv, const void* rr, void* x_out, void* r_out, void* rr_out, void* scratch, cudaStream_t st) {
    static int per_sm = 0;
    int gx = 0;
    const cudaError_t err = blocks_of(pcg_xr_kernel<T>, &per_sm, n, true, &gx);
    if (err != cudaSuccess) return static_cast<int>(err);
    pcg_xr_kernel<T><<<dim3(gx, batch), kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(p), static_cast<const T*>(r), static_cast<const T*>(s), n,
        static_cast<const T*>(alpha), static_cast<const bool*>(conv), static_cast<const T*>(rr),
        static_cast<T*>(x_out), static_cast<T*>(r_out), static_cast<T*>(rr_out), scratch_of<T>(scratch, n, batch));
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int ru_on(int n, int batch, const void* r, const void* u, const void* ru, const void* conv, void* ru_out,
          void* beta, void* scratch, cudaStream_t st) {
    static int per_sm = 0;
    int gx = 0;
    const cudaError_t err = blocks_of(pcg_ru_kernel<T>, &per_sm, n, true, &gx);
    if (err != cudaSuccess) return static_cast<int>(err);
    pcg_ru_kernel<T><<<dim3(gx, batch), kThreads, 0, st>>>(
        static_cast<const T*>(r), static_cast<const T*>(u), n, static_cast<const T*>(ru),
        static_cast<const bool*>(conv), static_cast<T*>(ru_out), static_cast<T*>(beta),
        scratch_of<T>(scratch, n, batch));
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int p_on(int n, int batch, const void* u, const void* p, const void* beta, const void* conv, void* p_out,
         cudaStream_t st) {
    static int per_sm = 0;
    int gx = 0;
    const cudaError_t err = blocks_of(pcg_p_kernel<T>, &per_sm, n, false, &gx);
    if (err != cudaSuccess) return static_cast<int>(err);
    pcg_p_kernel<T><<<dim3(gx, batch), kThreads, 0, st>>>(static_cast<const T*>(u), static_cast<const T*>(p), n,
                                                          static_cast<const T*>(beta),
                                                          static_cast<const bool*>(conv), static_cast<T*>(p_out));
    return static_cast<int>(cudaGetLastError());
}

bool takes(int dtype, int n, int batch) {
    return (dtype == 4 || dtype == 8) && n >= 1 && batch >= 1 && batch <= 65535;
}

}  // namespace

// dtype is the element size in bytes (4: float, 8: double).  Vectors hold
// batch members of n entries one after another; scalars and counters one
// a member (conv as bool, i and i_out as int64).  scratch holds
// batch * ceil(n / 256) partials of the dtype, then batch tickets
// (unsigned int), zero before the first launch and after each.  tol_at,
// where not null, points to tol on the card (one for all members); else
// tol, rounded to the dtype, is used.
extern "C" int krylov_pcg_alpha(int dtype, int n, int batch, const void* s, const void* p, const void* rr,
                                const void* b_norm, const void* ru, const void* tol_at, double tol, void* trace,
                                long long trace_len, const void* i, void* conv, void* alpha, void* i_out,
                                void* scratch, void* stream) {
    if (!takes(dtype, n, batch)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return dtype == 8 ? alpha_on<double>(n, batch, s, p, rr, b_norm, ru, tol_at, tol, trace, trace_len, i, conv,
                                         alpha, i_out, scratch, st)
                      : alpha_on<float>(n, batch, s, p, rr, b_norm, ru, tol_at, tol, trace, trace_len, i, conv,
                                        alpha, i_out, scratch, st);
}

extern "C" int krylov_pcg_xr(int dtype, int n, int batch, const void* x, const void* p, const void* r,
                             const void* s, const void* alpha, const void* conv, const void* rr, void* x_out,
                             void* r_out, void* rr_out, void* scratch, void* stream) {
    if (!takes(dtype, n, batch)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return dtype == 8 ? xr_on<double>(n, batch, x, p, r, s, alpha, conv, rr, x_out, r_out, rr_out, scratch, st)
                      : xr_on<float>(n, batch, x, p, r, s, alpha, conv, rr, x_out, r_out, rr_out, scratch, st);
}

extern "C" int krylov_pcg_ru(int dtype, int n, int batch, const void* r, const void* u, const void* ru,
                             const void* conv, void* ru_out, void* beta, void* scratch, void* stream) {
    if (!takes(dtype, n, batch)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return dtype == 8 ? ru_on<double>(n, batch, r, u, ru, conv, ru_out, beta, scratch, st)
                      : ru_on<float>(n, batch, r, u, ru, conv, ru_out, beta, scratch, st);
}

extern "C" int krylov_pcg_p(int dtype, int n, int batch, const void* u, const void* p, const void* beta,
                            const void* conv, void* p_out, void* stream) {
    if (!takes(dtype, n, batch)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return dtype == 8 ? p_on<double>(n, batch, u, p, beta, conv, p_out, st)
                      : p_on<float>(n, batch, u, p, beta, conv, p_out, st);
}
