// Brute-force nearest neighbours for Hopper (sm_90a), batched over pairs.
//
// Replaces the TPU kernel tpu_slam/kernels/nn_search.py::_nn_kernel
// (launched from _nn_brute_pallas). The TPU kernel swept a grid of
// (query tile of 256, target tile of 512) blocks, coordinates widened to 8
// lanes, keeping a running min/argmin in the revisited output block; that
// tiling and widening existed for VMEM and vregs. Here one launch covers
// all B pairs of a loop-verification batch: grid (ceil(N / 256), B), one
// thread per query.
//
//   1. each thread keeps its query point, its best d^2 and best index in
//      registers;
//   2. the block stages the pair's targets through shared memory in tiles
//      of 1,024 points (structure of arrays, 12 KB) and every thread scans
//      the tile in ascending index order with a strict '<', so the lowest
//      index wins a tie, as argmin inside a tile plus the strict '<' across
//      tiles do on the TPU;
//   3. d^2 = (dx*dx + dy*dy) + dz*dz, each op rounded on its own
//      (__fsub_rn/__fmul_rn/__fadd_rn), the order of the plain PyTorch
//      version, so FMA contraction cannot reorder two candidates and the two
//      agree bit for bit;
//   4. one write of (index, d^2) per query. No atomics, no cross-block
//      reduction: the result is identical run to run.
//
// What bounds it on this card: at config 4 (B = 6 pairs, N = M = 4,096) a
// launch evaluates 1.0e8 pairs at 8 flops each (3 sub, 3 mul, 2 add),
// 8.1e8 flops, ~12 us at the 67 TFLOP/s float32 peak (which counts an FMA
// as two flops; this kernel can use none, so ~24 us is its real floor);
// it reads 0.6 MB, 0.18 us at 3.35 TB/s. Compute bounds it. The design
// keeps the inner loop to shared-memory broadcasts (every thread of a warp
// reads the same target, no bank conflicts) and register arithmetic; its
// known limit is the grid: 6 x 16 = 96 blocks of 256 threads do not fill
// 132 SMs, a first kernel's trade of speed for a simple, exact design.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
nn_search_kernel(const float* __restrict__ query,
                 const float* __restrict__ target, int n, int m,
                 int32_t* __restrict__ idx_out, float* __restrict__ d2_out) {
  __shared__ float tx[kTile];
  __shared__ float ty[kTile];
  __shared__ float tz[kTile];
  const int pair = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float* q = query + static_cast<size_t>(pair) * n * 3;
  const float* t = target + static_cast<size_t>(pair) * m * 3;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (i < n) {
    qx = q[3 * i];
    qy = q[3 * i + 1];
    qz = q[3 * i + 2];
  }
  float best = 3.0e38f;
  int best_i = -1;
  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    __syncthreads();  // the previous tile is consumed
    for (int k = threadIdx.x; k < cnt; k += kThreads) {
      const float* p = t + 3 * static_cast<size_t>(base + k);
      tx[k] = p[0];
      ty[k] = p[1];
      tz[k] = p[2];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < cnt; ++k) {
      const float dx = __fsub_rn(qx, tx[k]);
      const float dy = __fsub_rn(qy, ty[k]);
      const float dz = __fsub_rn(qz, tz[k]);
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      if (d2 < best) {
        best = d2;
        best_i = base + k;
      }
    }
  }
  if (i < n) {
    idx_out[static_cast<size_t>(pair) * n + i] = best_i;
    d2_out[static_cast<size_t>(pair) * n + i] = best;
  }
}

}  // namespace

// Launch on ``stream``: query (b, n, 3), target (b, m, 3) float32,
// contiguous; writes idx (b, n) int32 and d2 (b, n) float32. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int nn_search_launch(const void* query, const void* target, int b,
                                int n, int m, void* idx, void* d2,
                                void* stream) {
  if (b < 1 || n < 1 || m < 1 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  nn_search_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(target), n,
      m, static_cast<int32_t*>(idx), static_cast<float*>(d2));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nn_search_block_threads() { return kThreads; }
