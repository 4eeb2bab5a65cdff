// What the two terms kernels (ndt_terms.cu, icp_terms.cu) share: the block
// shape, the grid, the op-by-op point transform, and the fixed-order block
// and cross-block sums. The order of those sums fixes the last bits of both
// kernels' results, so it lives here once.
//
// The grid has at most TERMS_MAX_BLOCKS blocks (one wave of an H100: 132
// SMs x kMinBlocks); compare_kernels.py builds other sizes with -D.

#pragma once

#include <cuda_runtime.h>

#ifndef TERMS_MAX_BLOCKS
#define TERMS_MAX_BLOCKS 264
#endif

namespace terms {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;          // resident on each SM: <= 128 registers
constexpr int kMaxBlocks = TERMS_MAX_BLOCKS;
constexpr int kFinishThreads = 1024;   // the finalizer: one warp a channel
constexpr int kRowsPerLane = (kMaxBlocks + 31) / 32;  // a finalizer lane's

// The grid for n slots and groups of ``lanes``: one slot a group, at most
// kMaxBlocks blocks, at least one (an empty list writes zeros).
inline int grid_blocks(int n, int lanes) {
  const int groups = kThreads / lanes;
  const int want = (n + groups - 1) / groups;
  return want < 1 ? 1 : (want > kMaxBlocks ? kMaxBlocks : want);
}

// x*a + y*b + z*c + d, each product and sum rounded on its own (left to
// right), exactly as the plain version's element-wise tensor ops round.
__device__ __forceinline__ float affine_rn(float a, float b, float c, float d,
                                           float x, float y, float z) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), __fmul_rn(c, z)),
      d);
}

// the lanes of the calling thread's group, for shuffles inside the group
template <int kLanes>
__device__ __forceinline__ unsigned group_mask() {
  if (kLanes == 32) return 0xffffffffu;
  const unsigned first = (threadIdx.x & 31) & ~(kLanes - 1);
  return ((1u << kLanes) - 1u) << first;
}

// The block's sum of every group's running sums, in a fixed order, to
// column blockIdx.x of the channel-major (kChannels, gridDim.x) ``partials``.
// Lane j of a group holds channels j, j + kLanes, ... in ``held``. The groups
// of a warp are added by a shuffle tree (lane l adds lane l + off), then the
// warps in index order.
template <int kLanes, int kChannels>
__device__ __forceinline__ void write_block_row(
    const float (&held)[(kChannels + kLanes - 1) / kLanes], float* partials) {
  __shared__ float warp_part[kThreads / 32][kChannels];
  const int wl = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < (kChannels + kLanes - 1) / kLanes; ++r) {
    float v = held[r];
#pragma unroll
    for (int off = 16; off >= kLanes; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    const int ch = wl + r * kLanes;
    if (wl < kLanes && ch < kChannels) warp_part[warp][ch] = v;
  }
  __syncthreads();
  if (threadIdx.x < kChannels) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) acc += warp_part[w][threadIdx.x];
    partials[static_cast<size_t>(threadIdx.x) * gridDim.x + blockIdx.x] = acc;
  }
}

// One block of kFinishThreads: warp c sums channel c's num_blocks (at most
// kMaxBlocks) columns into tot[c]: lane l loads columns l, l + 32, ... all
// at once, adds them in order, then a shuffle tree.
template <int kChannels>
__device__ __forceinline__ void sum_rows(const float* __restrict__ partials,
                                         int num_blocks, float* tot) {
  const int wl = threadIdx.x & 31;
  const int ch = threadIdx.x >> 5;
  if (ch < kChannels) {
    const float* row = partials + static_cast<size_t>(ch) * num_blocks;
    float part[kRowsPerLane];
#pragma unroll
    for (int u = 0; u < kRowsPerLane; ++u) {
      const int j = wl + 32 * u;
      part[u] = j < num_blocks ? row[j] : 0.f;
    }
    float v = 0.f;
#pragma unroll
    for (int u = 0; u < kRowsPerLane; ++u) v += part[u];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (wl == 0) tot[ch] = v;
  }
  __syncthreads();
}

// Entry t (< 36, row-major) of the symmetric 6x6 H from the totals of its
// upper triangle, (0,0)..(0,5), (1,1)..(1,5), ..., (5,5).
__device__ __forceinline__ float symmetric_entry(const float* tot, int t) {
  const int r = t / 6, c = t % 6;
  const int lo = r < c ? r : c, hi = r < c ? c : r;
  return tot[lo * 6 - lo * (lo + 1) / 2 + hi];
}

}  // namespace terms
