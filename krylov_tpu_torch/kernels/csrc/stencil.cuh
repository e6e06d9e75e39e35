// Stencil application on a 2-D (g0, g1) grid: the device functions shared by
// the standalone SpMV (stencil.cu) and the fused whole-solve kernels
// (fused.cu, fused_kskip.cu).
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
// Two forms of the pass over vectors in device memory (the streaming
// routes; the resident one is resident.cuh's stencil_pass):
//  - apply_stencil, the masked pass: one point, its row and column from a
//    division, every term of a run-time count tested against the grid.
//    Any stencil, either coefficient form.
//  - StreamSweep, the pass specialised on the term count NS (5: the 2-D
//    5-point stencil, 7: the collapsed 3-D 7-point one) of the constant
//    form: the points go in tiles of THREADS * V contiguous points of one
//    row, V = 16 bytes of values, so each thread owns V contiguous points
//    and works their row, column and inner-axis index out once, with no
//    division instruction (FastDiv); the weights arrive as kernel
//    arguments; a chunk whose terms all lie on the grid (but for the inner-
//    axis mask, a predicate a point) loads its neighbours with no test, a
//    term at a 16-byte-aligned offset as one 16-byte load, the terms at
//    -1 and +1 from the centre's 16 bytes and one more value.  The other
//    chunks (the grid's edge rows and columns, a row's ragged end) take the
//    tested body of apply_stencil with the same weights.  Each point's sum
//    is apply_stencil's, term by term in stencil order, so a point's value
//    is the masked pass's bit for bit.
//
// Bound: memory.  Per output point the pass reads ns vector entries
// (neighbours hit L1/L2: rows are contiguous) and, for the grid form, ns
// coefficients streamed from device memory; the arithmetic is ns FMAs.
#pragma once

#include <cstdint>
#include <initializer_list>

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

// The vector a stencil pass reads, by flat index: one in device memory
// (Direct), or p = r + beta q formed at each index it reads from two
// (Axpy: K3's search direction, which its streaming route forms where the
// stencil reads it instead of storing it a pass earlier).  Neither is
// __restrict__: inside the fused kernels other blocks rewrite the vectors
// between grid syncs, so they must not go through the non-coherent
// read-only cache.
template <typename T>
struct Direct {
    static constexpr int kLoads = 1;  // vectors loaded a value
    const T* x;
    __device__ __forceinline__ T at(long long i) const { return x[i]; }
};

template <typename T>
struct Axpy {
    static constexpr int kLoads = 2;
    const T* r;
    const T* q;
    T beta;
    __device__ __forceinline__ T at(long long i) const { return fma(beta, q[i], r[i]); }
};

// y[e] = sum_s coef_s(e) * x[e + (d0_s, d1_s)], terms added in stencil
// order, x a source as above.
template <typename T, typename Src>
__device__ __forceinline__ T apply_stencil_of(const StencilGeom& g, const T* __restrict__ coef, const Src& x,
                                              int e) {
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
                acc += c * x.at((long long)j0 * g.g1 + j1);
            }
        }
    }
    return acc;
}

template <typename T>
__device__ __forceinline__ T apply_stencil(const StencilGeom& g, const T* __restrict__ coef, const T* x, int e) {
    return apply_stencil_of(g, coef, Direct<T>{x}, e);
}

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31 with a multiply-high, an add
// and a shift: m = floor(2^32 (2^s - d) / d) + 1 with s = ceil(log2 d)
// (Granlund and Montgomery's round-up method).
struct FastDiv {
    unsigned m;
    int s;
};

inline FastDiv make_fastdiv(int d) {
    FastDiv f{0u, 0};
    while ((1LL << f.s) < d) ++f.s;
    f.m = static_cast<unsigned>((((1ULL << 32) * ((1ULL << f.s) - static_cast<unsigned long long>(d))) /
                                 static_cast<unsigned long long>(d)) + 1);
    return f;
}

__device__ __forceinline__ int fast_div(const FastDiv& f, int n) {
    return static_cast<int>((__umulhi(static_cast<unsigned>(n), f.m) + static_cast<unsigned>(n)) >> f.s);
}

// How the V values of a term at a chunk load: kTermVec one 16-byte load at
// a 16-byte-aligned offset; kTermLeft (offset -1) and kTermRight (+1) from
// the centre's 16 bytes and one value beside them; kTermScalar V loads.
enum : unsigned { kTermVec = 0, kTermLeft = 1, kTermRight = 2, kTermScalar = 3 };

// What the specialised pass needs besides the geometry, made once per
// launch by make_stream_pass: the weights (the constant form's, cast to
// T), each term's flat offset d0 * g1 + d1 and its load kind (2 bits a
// term), the terms masked on the inner axis, the extents of the
// displacements (lo <= 0 <= hi), the tiles of a row and the dividers of
// the tile index and the inner axis.
template <typename T>
struct StreamPass {
    T w[KRYLOV_MAX_TERMS];
    int off[KRYLOV_MAX_TERMS];
    unsigned kinds;
    unsigned masked;  // bit s: term s has d2 != 0 (collapsed 3-D constant form)
    int lo0, hi0, lo1, hi1;
    int per_row;      // tiles of a row
    int tiles;        // g0 * per_row
    FastDiv row_of;   // tile -> row
    FastDiv inner_of; // column -> column / g2 (g2 > 0)
    FastDiv point_of; // flat index -> row (one point a chunk)
};

// V: the values of one 16-byte load.
template <typename T>
constexpr int kVecWidth = 16 / static_cast<int>(sizeof(T));

// The pass of a launch on a tile of `threads` threads: vec is true where
// rows and every vector the kernel loads start on 16 bytes (g1 % V == 0 and
// aligned buffers), so that every chunk starts on 16 bytes too.
template <typename T>
inline StreamPass<T> make_stream_pass(const StencilGeom& g, const double* weights, int threads, bool vec) {
    constexpr int V = kVecWidth<T>;
    StreamPass<T> sp{};
    for (int s = 0; s < g.ns; ++s) {
        const int off = g.d0[s] * g.g1 + g.d1[s];
        sp.off[s] = off;
        sp.w[s] = static_cast<T>(weights[s]);
        unsigned kind = kTermScalar;
        if (vec) kind = off % V == 0 ? kTermVec : off == -1 ? kTermLeft : off == 1 ? kTermRight : kTermScalar;
        sp.kinds |= kind << (2 * s);
        if (g.g2 > 0 && g.d2[s] != 0) sp.masked |= 1u << s;
        sp.lo0 = g.d0[s] < sp.lo0 ? g.d0[s] : sp.lo0;
        sp.hi0 = g.d0[s] > sp.hi0 ? g.d0[s] : sp.hi0;
        sp.lo1 = g.d1[s] < sp.lo1 ? g.d1[s] : sp.lo1;
        sp.hi1 = g.d1[s] > sp.hi1 ? g.d1[s] : sp.hi1;
    }
    const int tile = threads * V;
    sp.per_row = (g.g1 + tile - 1) / tile;
    sp.tiles = g.g0 * sp.per_row;
    sp.row_of = make_fastdiv(sp.per_row);
    sp.inner_of = make_fastdiv(g.g2 > 0 ? g.g2 : 1);
    sp.point_of = make_fastdiv(g.g1);
    return sp;
}

// A thread's points in one tile: n (0..V) contiguous points of row i0 from
// column i1 (flat index e); i2 the first one's inner-axis index (0 in 2-D);
// fast when n == V and every term of every point lies on the grid but for
// the inner-axis mask.
struct Chunk {
    int e, n, i0, i1, i2;
    bool fast;
};

template <typename T>
struct Vec16;
template <>
struct Vec16<double> {
    using type = double2;
};
template <>
struct Vec16<float> {
    using type = float4;
};

// V values from p (16-byte aligned).  x is not __restrict__ (see
// apply_stencil), so this is a plain coherent load.
template <typename T>
__device__ __forceinline__ void load16(T (&v)[kVecWidth<T>], const T* p) {
    const typename Vec16<T>::type q = *reinterpret_cast<const typename Vec16<T>::type*>(p);
    if constexpr (kVecWidth<T> == 2) {
        v[0] = q.x;
        v[1] = q.y;
    } else {
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
    }
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const T (&v)[kVecWidth<T>]) {
    typename Vec16<T>::type q;
    if constexpr (kVecWidth<T> == 2) {
        q.x = v[0];
        q.y = v[1];
    } else {
        q.x = v[0];
        q.y = v[1];
        q.z = v[2];
        q.w = v[3];
    }
    *reinterpret_cast<typename Vec16<T>::type*>(p) = q;
}

// The specialised pass over the points of a persistent grid of blocks of
// THREADS threads: each() walks this thread's chunks, tile by tile (tile t
// to block t % gridDim.x), and load/store/stencil work on a chunk's V
// values (values past n load as 0 and do not store).  With VW = 1 a chunk
// is one point and each() the grid-stride walk of apply_stencil's callers
// (the same points a thread in the same order, so the same sums), its row
// from a FastDiv; vec must then be false.  INFLIGHT > 0 caps the values a
// chunk's stencil loads at once (for instances built for four blocks an
// SM, whose threads have 64 registers).
template <typename T, int NS, int THREADS, int VW = kVecWidth<T>, int INFLIGHT = 0>
struct StreamSweep {
    static constexpr int V = VW;
    // terms whose loads a chunk puts in flight together: all of them, but
    // for seven terms of 16-byte chunks of float64, where 14 values at once
    // cost the second block an SM's registers (spills), two groups; a
    // source of two vectors (Axpy) loads twice the values a term, so its
    // terms go in two groups; no more than INFLIGHT values where it is set
    template <int LOADS>
    static constexpr int kGroupAll = LOADS > 1 ? (NS + 1) / 2
                                               : (NS == 7 && V * sizeof(T) == 16 && sizeof(T) == 8) ? 4 : NS;
    template <int LOADS>
    static constexpr int kGroup =
        INFLIGHT > 0 && INFLIGHT / (LOADS * V) < kGroupAll<LOADS>
            ? (INFLIGHT / (LOADS * V) > 0 ? INFLIGHT / (LOADS * V) : 1)
            : kGroupAll<LOADS>;
    const StencilGeom& g;
    const StreamPass<T>& sp;
    bool vec;

    template <typename F>
    __device__ __forceinline__ void each(F&& body) const {
        if constexpr (V == 1) {
            const int n = g.g0 * g.g1;
            for (int e = blockIdx.x * THREADS + static_cast<int>(threadIdx.x); e < n; e += gridDim.x * THREADS) {
                Chunk c;
                c.e = e;
                c.n = 1;
                c.i0 = fast_div(sp.point_of, e);
                c.i1 = e - c.i0 * g.g1;
                c.i2 = g.g2 > 0 ? c.i1 - fast_div(sp.inner_of, c.i1) * g.g2 : 0;
                c.fast = c.i0 + sp.lo0 >= 0 && c.i0 + sp.hi0 < g.g0 && c.i1 + sp.lo1 >= 0 && c.i1 + sp.hi1 < g.g1;
                body(c);
            }
            return;
        }
        for (int t = blockIdx.x; t < sp.tiles; t += gridDim.x) {
            const int row = fast_div(sp.row_of, t);
            const int col = (t - row * sp.per_row) * (THREADS * V) + static_cast<int>(threadIdx.x) * V;
            if (col >= g.g1) continue;
            Chunk c;
            c.e = row * g.g1 + col;
            c.n = g.g1 - col < V ? g.g1 - col : V;
            c.i0 = row;
            c.i1 = col;
            c.i2 = g.g2 > 0 ? col - fast_div(sp.inner_of, col) * g.g2 : 0;
            c.fast = c.n == V && row + sp.lo0 >= 0 && row + sp.hi0 < g.g0 && col + sp.lo1 >= 0 &&
                     col + (V - 1) + sp.hi1 < g.g1;
            body(c);
        }
    }

    __device__ __forceinline__ void load(T (&v)[V], const T* a, const Chunk& c) const {
        if constexpr (V > 1) {
            if (vec && c.n == V) {
                load16(v, a + c.e);
                return;
            }
        }
#pragma unroll
        for (int p = 0; p < V; ++p) v[p] = p < c.n ? a[c.e + p] : T(0);
    }

    __device__ __forceinline__ void store(T* a, const T (&v)[V], const Chunk& c) const {
        if constexpr (V > 1) {
            if (vec && c.n == V) {
                store16(a + c.e, v);
                return;
            }
        }
#pragma unroll
        for (int p = 0; p < V; ++p)
            if (p < c.n) a[c.e + p] = v[p];
    }

    // The V values of a term at q = x + e + offset, loaded as its kind says.
    __device__ __forceinline__ static void load_term(T (&v)[V], const T* q, unsigned kind) {
        if constexpr (V == 1) {
            v[0] = q[0];
        } else {
            switch (kind) {
                case kTermVec:
                    load16(v, q);
                    break;
                case kTermLeft: {
                    T m[V];
                    load16(m, q + 1);
                    v[0] = q[0];
#pragma unroll
                    for (int p = 1; p < V; ++p) v[p] = m[p - 1];
                    break;
                }
                case kTermRight: {
                    T m[V];
                    load16(m, q - 1);
#pragma unroll
                    for (int p = 0; p < V - 1; ++p) v[p] = m[p + 1];
                    v[V - 1] = q[V - 1];
                    break;
                }
                default:
#pragma unroll
                    for (int p = 0; p < V; ++p) v[p] = q[p];
            }
        }
    }

    // The V values of a source's term at flat index i.
    __device__ __forceinline__ static void load_term(T (&v)[V], const Direct<T>& x, int i, unsigned kind) {
        load_term(v, x.x + i, kind);
    }
    __device__ __forceinline__ static void load_term(T (&v)[V], const Axpy<T>& x, int i, unsigned kind) {
        T r[V], q[V];
        load_term(r, x.r + i, kind);
        load_term(q, x.q + i, kind);
#pragma unroll
        for (int p = 0; p < V; ++p) v[p] = fma(x.beta, q[p], r[p]);
    }

    // y = A x on the chunk, each point's terms added in stencil order.
    __device__ __forceinline__ void stencil(T (&y)[V], const T* x, const Chunk& c) const {
        stencil_of(y, Direct<T>{x}, c);
    }

    // y = A x on the chunk for a source x (Direct or Axpy).
    template <typename Src>
    __device__ __forceinline__ void stencil_of(T (&y)[V], const Src& x, const Chunk& c) const {
        constexpr int G = kGroup<Src::kLoads>;
        int i2[V];  // each point's inner-axis index
        i2[0] = c.i2;
#pragma unroll
        for (int p = 1; p < V; ++p) i2[p] = i2[p - 1] + 1 == g.g2 ? 0 : i2[p - 1] + 1;
        if (c.fast) {
#pragma unroll
            for (int p = 0; p < V; ++p) y[p] = T(0);
            // the terms in groups of G, each group's values loaded before
            // its first sum, so that its loads are in flight at once
#pragma unroll
            for (int s0 = 0; s0 < NS; s0 += G) {
                T v[G][V];
#pragma unroll
                for (int j = 0; j < G && s0 + j < NS; ++j)
                    load_term(v[j], x, c.e + sp.off[s0 + j], (sp.kinds >> (2 * (s0 + j))) & 3u);
#pragma unroll
                for (int j = 0; j < G && s0 + j < NS; ++j) {
                    const int s = s0 + j;
                    if ((sp.masked >> s) & 1u) {
#pragma unroll
                        for (int p = 0; p < V; ++p) {
                            const int j2 = i2[p] + g.d2[s];
                            if (j2 >= 0 && j2 < g.g2) y[p] += sp.w[s] * v[j][p];
                        }
                    } else {
#pragma unroll
                        for (int p = 0; p < V; ++p) y[p] += sp.w[s] * v[j][p];
                    }
                }
            }
            return;
        }
        // an edge chunk: apply_stencil's tests, term by term
#pragma unroll
        for (int p = 0; p < V; ++p) {
            T acc = T(0);
            if (p < c.n) {
                const int i1 = c.i1 + p;
#pragma unroll
                for (int s = 0; s < NS; ++s) {
                    const int j0 = c.i0 + g.d0[s];
                    const int j1 = i1 + g.d1[s];
                    bool in = j0 >= 0 && j0 < g.g0 && j1 >= 0 && j1 < g.g1;
                    if ((sp.masked >> s) & 1u) {
                        const int j2 = i2[p] + g.d2[s];
                        in = in && j2 >= 0 && j2 < g.g2;
                    }
                    if (in) acc += sp.w[s] * x.at((long long)j0 * g.g1 + j1);
                }
            }
            y[p] = acc;
        }
    }
};

// The masked pass in the same shape, for the kernels that take either: one
// point a chunk (V = 1), the grid-stride walk over the points of a
// persistent grid of THREADS-thread blocks, apply_stencil.  A thread's
// points and the order of its sums are those of a plain grid-stride loop.
template <typename T, int THREADS>
struct MaskedSweep {
    static constexpr int V = 1;
    const StencilGeom& g;
    const T* coef;

    template <typename F>
    __device__ __forceinline__ void each(F&& body) const {
        const int n = g.g0 * g.g1;
        for (int e = blockIdx.x * THREADS + static_cast<int>(threadIdx.x); e < n; e += gridDim.x * THREADS) {
            Chunk c;
            c.e = e;
            c.n = 1;
            body(c);
        }
    }

    __device__ __forceinline__ void load(T (&v)[1], const T* a, const Chunk& c) const { v[0] = a[c.e]; }

    __device__ __forceinline__ void store(T* a, const T (&v)[1], const Chunk& c) const { a[c.e] = v[0]; }

    __device__ __forceinline__ void stencil(T (&y)[1], const T* x, const Chunk& c) const {
        y[0] = apply_stencil(g, coef, x, c.e);
    }

    template <typename Src>
    __device__ __forceinline__ void stencil_of(T (&y)[1], const Src& x, const Chunk& c) const {
        y[0] = apply_stencil_of(g, coef, x, c.e);
    }
};

// The sweep of a streaming kernel instance on THREADS-thread blocks: the
// pass specialised on NS terms (StreamSweep, VW contiguous points a chunk:
// a tile's 16-byte chunk, or with VW = 1 one point on the grid-stride walk)
// for NS = 5 or 7, else the masked pass (MaskedSweep: one point a chunk on
// the grid-stride walk, apply_stencil).  sp and vec are the specialised
// pass's (stream_pass); the masked one takes the coefficients.
template <typename T, int NS, int THREADS, int VW = kVecWidth<T>, int INFLIGHT = 0>
struct SweepOf {
    using type = StreamSweep<T, NS, THREADS, VW, INFLIGHT>;
    __device__ static type make(const StencilGeom& g, const StreamPass<T>& sp, int vec, const T*) {
        return type{g, sp, vec != 0};
    }
};
template <typename T, int THREADS, int VW, int INFLIGHT>
struct SweepOf<T, 0, THREADS, VW, INFLIGHT> {
    using type = MaskedSweep<T, THREADS>;
    __device__ static type make(const StencilGeom& g, const StreamPass<T>&, int, const T* coef) {
        return type{g, coef};
    }
};

// A streaming launch's pass on THREADS-thread blocks: false where the
// specialisation cannot take the operator (NS > 0 needs the constant form
// with NS terms and its weights).  vec: the 16-byte loads, where rows start
// on 16 bytes (g1 % V == 0) and so do the vectors the kernel reads and
// writes (aligned).
template <typename T>
inline bool stream_pass(const StencilGeom& g, int ns_pass, const double* weights, bool aligned, int threads,
                        StreamPass<T>* sp, int* vec) {
    *sp = StreamPass<T>{};
    *vec = 0;
    if (ns_pass == 0) return true;
    if ((ns_pass != 5 && ns_pass != 7) || !g.is_const || g.ns != ns_pass || weights == nullptr) return false;
    *vec = aligned && g.g1 % kVecWidth<T> == 0;
    *sp = make_stream_pass<T>(g, weights, threads, *vec != 0);
    return true;
}

// Whether every pointer starts on 16 bytes.
inline bool aligned16(std::initializer_list<const void*> ptrs) {
    for (const void* p : ptrs)
        if (reinterpret_cast<std::uintptr_t>(p) % 16 != 0) return false;
    return true;
}
