// Fixed-order, atomic-free sums for the persistent cooperative kernels
// (fused.cu: K2/K3, fused_kskip.cu: K5/K6).
//
// Every sum is a per-thread sum over a grid-stride loop, then a block sum
// in a fixed shuffle order, then one partial per block.  The grid-wide
// totals are formed from the partials in a fixed order as well, so every
// block holds bit-identical scalars and takes the same branch (no block can
// stall alone in a grid sync), and results repeat from run to run.
#pragma once

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSums = 6;  // most sums reduced in one block_sum call
// Shared memory a block_sum call needs, in elements.
constexpr int kBlockSumSmem = kMaxSums * kWarps + kMaxSums;

template <typename T>
__device__ __forceinline__ T safe_div(T num, T den) {
    return den == T(0) ? T(0) : num / den;
}

// Sums v[k] over the block in a fixed order; every thread gets the totals.
// smem holds kBlockSumSmem elements.
template <typename T, int K>
__device__ void block_sum(T (&v)[K], T* smem) {
    static_assert(K <= kMaxSums, "block_sum: too many sums for smem");
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    __syncthreads();  // the previous call may still be reading smem
    if (lane == 0)
        for (int k = 0; k < K; ++k) smem[k * kWarps + warp] = v[k];
    __syncthreads();
    if (warp == 0) {
        for (int k = 0; k < K; ++k) v[k] = lane < kWarps ? smem[k * kWarps + lane] : T(0);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
            for (int k = 0; k < K; ++k) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
        if (lane == 0)
            for (int k = 0; k < K; ++k) smem[kMaxSums * kWarps + k] = v[k];
    }
    __syncthreads();
    for (int k = 0; k < K; ++k) v[k] = smem[kMaxSums * kWarps + k];
}

// Grid-wide sums of v[k]: block partials go to slot[k * gridDim.x + block],
// then every block sums all partials in the same order.  Contains the grid
// sync that also publishes the vector writes made before the call.
template <typename T, int K>
__device__ void grid_sum(cg::grid_group& grid, T (&v)[K], T* slot, T* smem) {
    block_sum(v, smem);
    const int nb = gridDim.x;
    if (threadIdx.x == 0)
        for (int k = 0; k < K; ++k) slot[k * nb + blockIdx.x] = v[k];
    grid.sync();
    for (int k = 0; k < K; ++k) v[k] = T(0);
    for (int j = threadIdx.x; j < nb; j += kThreads)
        for (int k = 0; k < K; ++k) v[k] += __ldcg(slot + k * nb + j);
    block_sum(v, smem);
}
