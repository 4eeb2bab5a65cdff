// Brute-force nearest neighbours for Hopper (sm_90a), batched over pairs.
//
// Replaces the TPU kernel tpu_slam/kernels/nn_search.py::_nn_kernel
// (launched from _nn_brute_pallas). The TPU kernel swept a grid of
// (query tile of 256, target tile of 512) blocks, coordinates widened to 8
// lanes, keeping a running min/argmin in the revisited output block; that
// tiling and widening existed for VMEM and vregs.
//
// What bounds it on this card: each (query, target) pair costs 8 float ops
// (3 sub, 3 mul, 2 add), each rounded on its own so that the result is bit
// for bit the plain PyTorch version's (no FMA contraction), plus the
// running minimum: the kernel is bound by instruction issue (132 SMs x 4
// schedulers x 32 lanes a cycle), not by the bytes it reads. The design:
//
//   1. register blocking: each thread owns kR queries (kThreads * kR a
//      block) and keeps their coordinates, best d^2 and best group in
//      registers; the block stages its targets through shared memory as
//      float4 (x, y, z, 0), so one broadcast 16-byte load feeds kR
//      distance evaluations;
//   2. the target range is split across blocks when the query blocks alone
//      would leave the card under-filled: the grid is (query blocks,
//      splits, pairs) and split s scans targets [s * chunk, (s + 1) *
//      chunk). The wrapper (kernels/nn_search.py, split_plan) picks the
//      plan; every split holds at least one target;
//   3. the hot loop keeps only the running minimum of d^2 (one fminf a
//      pair, no compare and selects of an index): after each group of 32
//      targets a query notes the group if its minimum fell (strict '<',
//      from 3.0e38). The last group that lowered it holds the minimum's
//      first occurrence in the split. A ragged last group is padded with
//      NaN targets, which fminf skips. Each split writes (d^2, group) to
//      scratch;
//   4. nn_search_merge_kernel, one warp a query, takes the splits in
//      ascending order with a strict '<' (the earliest split at the
//      minimum holds its first occurrence), then recomputes that split's
//      best group, one target a lane, and takes the lowest index whose d^2
//      equals the minimum: the lowest index wins a tie, as a strict '<' in
//      ascending order does over the whole range. So the result is the
//      one-pass result bit for bit whatever the plan, and no atomics make
//      it vary run to run;
//   5. d^2 = (dx*dx + dy*dy) + dz*dz, each op rounded on its own
//      (__fsub_rn/__fmul_rn/__fadd_rn), the order of the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kR = 4;                // queries a thread
constexpr int kBlockQueries = kThreads * kR;
constexpr int kTile = 1024;          // targets a shared-memory tile (16 KB)
constexpr int kGroup = 32;           // targets a group (see step 3)
constexpr int kMergeThreads = 256;

__global__ void __launch_bounds__(kThreads)
nn_search_kernel(const float* __restrict__ query,
                 const float* __restrict__ target, int n, int m, int chunk,
                 int32_t* __restrict__ group_out,
                 float* __restrict__ d2_out) {
  __shared__ float4 tile[kTile];
  const int pair = blockIdx.z;
  const int lo = blockIdx.y * chunk;
  const int hi = min(m, lo + chunk);
  const int q0 = blockIdx.x * kBlockQueries + threadIdx.x;
  const float* q = query + static_cast<size_t>(pair) * n * 3;
  const float* t = target + static_cast<size_t>(pair) * m * 3;

  float qx[kR], qy[kR], qz[kR], best[kR], at_group[kR];
  int best_group[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = q0 + r * kThreads;
    qx[r] = qy[r] = qz[r] = 0.f;
    if (i < n) {
      qx[r] = q[3 * i];
      qy[r] = q[3 * i + 1];
      qz[r] = q[3 * i + 2];
    }
    best[r] = at_group[r] = 3.0e38f;
    best_group[r] = -1;
  }
  for (int base = lo; base < hi; base += kTile) {
    const int cnt = min(kTile, hi - base);
    const int groups = (cnt + kGroup - 1) / kGroup;
    __syncthreads();  // the previous tile is consumed
    for (int k = threadIdx.x; k < groups * kGroup; k += kThreads) {
      if (k < cnt) {
        const float* p = t + 3 * static_cast<size_t>(base + k);
        tile[k] = make_float4(p[0], p[1], p[2], 0.f);
      } else {  // a NaN target never lowers the minimum
        tile[k] = make_float4(NAN, NAN, NAN, 0.f);
      }
    }
    __syncthreads();
    for (int g = 0; g < groups; ++g) {
#pragma unroll 8
      for (int k = g * kGroup; k < (g + 1) * kGroup; ++k) {
        const float4 p = tile[k];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float dx = __fsub_rn(qx[r], p.x);
          const float dy = __fsub_rn(qy[r], p.y);
          const float dz = __fsub_rn(qz[r], p.z);
          best[r] = fminf(best[r], __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                                       __fmul_rn(dy, dy)),
                                             __fmul_rn(dz, dz)));
        }
      }
      // the last group that lowered the minimum holds its first occurrence
      const int group = (base - lo) / kGroup + g;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (best[r] < at_group[r]) {
          at_group[r] = best[r];
          best_group[r] = group;
        }
      }
    }
  }
  // scratch is (split, pair, query): the minimum and the first target of
  // the last group that lowered it (-1 if none did)
  const size_t row =
      (static_cast<size_t>(blockIdx.y) * gridDim.z + pair) * n;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = q0 + r * kThreads;
    if (i < n) {
      d2_out[row + i] = best[r];
      group_out[row + i] = best_group[r] < 0 ? -1
                                             : lo + best_group[r] * kGroup;
    }
  }
}

// One warp per (pair, query). First the split that holds the minimum's
// first occurrence: each lane takes splits lane, lane + 32, ... in
// ascending order with a strict '<', then the warp keeps the least (d^2,
// split), so the earliest split wins a tie. Then the index: lane k
// recomputes d^2 of the k-th target of that split's best group (the same
// rounded ops, one coalesced read of the group) and the lowest lane whose
// d^2 equals the minimum gives it.
__global__ void __launch_bounds__(kMergeThreads)
nn_search_merge_kernel(const float* __restrict__ query,
                       const float* __restrict__ target, int n, int m,
                       int splits, int chunk, int total,
                       const float* __restrict__ d2s,
                       const int32_t* __restrict__ groups,
                       int32_t* __restrict__ idx_out,
                       float* __restrict__ d2_out) {
  const int e = (blockIdx.x * kMergeThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (e >= total) return;  // the whole warp
  float best = 3.0e38f;
  int split = 0x7fffffff;
  for (int s = lane; s < splits; s += 32) {
    const float d2 = d2s[static_cast<size_t>(s) * total + e];
    if (d2 < best) {
      best = d2;
      split = s;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int os = __shfl_xor_sync(0xffffffffu, split, off);
    if (ob < best || (ob == best && os < split)) {
      best = ob;
      split = os;
    }
  }
  int best_i = -1;
  const int g0 = split == 0x7fffffff
                     ? -1
                     : groups[static_cast<size_t>(split) * total + e];
  if (g0 >= 0) {
    const int pair = e / n;
    const float* q = query + 3 * static_cast<size_t>(e);
    const int end = min(min(m, (split + 1) * chunk), g0 + kGroup);
    bool hit = false;
    if (g0 + lane < end) {
      const float* p = target + (static_cast<size_t>(pair) * m + g0 + lane) * 3;
      const float dx = __fsub_rn(q[0], p[0]);
      const float dy = __fsub_rn(q[1], p[1]);
      const float dz = __fsub_rn(q[2], p[2]);
      hit = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                      __fmul_rn(dz, dz)) == best;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (ballot) best_i = g0 + __ffs(ballot) - 1;
  }
  if (lane == 0) {
    idx_out[e] = best_i;
    d2_out[e] = best;
  }
}

}  // namespace

// Launch on ``stream``: query (b, n, 3), target (b, m, 3) float32,
// contiguous; writes idx (b, n) int32 and d2 (b, n) float32. The target
// range is cut into ``splits`` ranges of ``chunk`` (the last one ragged,
// none empty); ``scratch`` holds splits * b * n float32 then as many
// int32. Returns the first cudaError_t of the two launches (0 = success).
extern "C" int nn_search_launch(const void* query, const void* target, int b,
                                int n, int m, int splits, int chunk,
                                void* idx, void* d2, void* scratch,
                                void* stream) {
  if (b < 1 || n < 1 || m < 1 || b > 65535 || splits < 1 ||
      splits > 65535 || chunk < 1 ||
      static_cast<long long>(splits - 1) * chunk >= m ||
      static_cast<long long>(splits) * chunk < m ||
      static_cast<long long>(b) * n * 32 >= 0x7fffffffLL ||
      scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kBlockQueries - 1) / kBlockQueries, splits, b);
  const int total = b * n;
  float* d2_part = static_cast<float*>(scratch);
  int32_t* group_part = reinterpret_cast<int32_t*>(
      d2_part + static_cast<size_t>(splits) * total);
  nn_search_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(query), static_cast<const float*>(target), n,
      m, chunk, group_part, d2_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps_per_block = kMergeThreads / 32;
  nn_search_merge_kernel<<<(total + warps_per_block - 1) / warps_per_block,
                           kMergeThreads, 0, s>>>(
      static_cast<const float*>(query), static_cast<const float*>(target), n,
      m, splits, chunk, total, d2_part, group_part,
      static_cast<int32_t*>(idx), static_cast<float*>(d2));
  return static_cast<int>(cudaGetLastError());
}

// Queries one block covers (kThreads * kR): the wrapper's split plan
// counts query blocks with it.
extern "C" int nn_search_block_queries() { return kBlockQueries; }
