// Fused pair-ICP terms pass for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_slam/kernels/icp_terms.py::_icp_kernel
// (launched from icp_terms_raster). The TPU kernel swept every cell of two
// dense (Wx, 4Q, 8, Wy*Wz/8) rasters, the source's and the target's, with
// static sublane/lane rolls, carrying per-slot running minima in vregs. Here
// the source arrives as the compact, cell-sorted list of its kept slots
// (point in the source frame, window cell, valid flag) and the target as the
// dense (G*Qt, 4) table of slot rows [x, y, z, valid]; each thread owns one
// source slot:
//
//   1. p = T x, rounded operation by operation (no FMA contraction) in the
//      order of the plain PyTorch version;
//   2. visit the 27 neighbour cells of the slot's frozen bin in the order
//      (dx, dy, dz), each -1, 0, +1, bound-checked on x, y and z with no
//      wrap, and within a cell its Qt target slots in order; each valid
//      slot's d2 = ((rx*rx + ry*ry) + rz*rz), rounded op by op, replaces
//      the running best (from 3.0e38) on a strict '<', so the first
//      candidate wins a tie exactly as in the TPU kernel and the plain
//      version, and nmatch agrees exactly;
//   3. gate on best d2 < float32(max_corr_dist)^2, Huber weight
//      w = 1 (d <= delta) or delta / d, and expand w J^T J and w J^T r at
//      the transformed point into H's upper triangle (21), b (6), err, nmatch
//      and wsum;
//   4. reduce the block in a fixed order (warp shuffles, then one pass over
//      the warps' partials in shared memory) into one row of a
//      (num_blocks, 30) buffer. The caller sums the rows; no float atomics,
//      so the result is identical run to run.
//
// What bounds it on this card: at bench config 1 (8,192-32,768 points,
// Qt = 8) a pass visits at most 27 x 8 target slots a source slot at ~9
// flops each, ~64 MFLOP at 32k (about a microsecond at the float32 peak),
// and it reads the slots plus the touched target rows once (under 2 MB).
// The bound is below the launch latency. Neighbouring threads hold points
// of the same or adjacent cells, so their target rows come from L1/L2; the
// design keeps the pass to one launch with one small partial buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOut = 30;  // H upper triangle (21), b (6), err, nmatch, wsum
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// x*a + y*b + z*c + d, each product and sum rounded on its own (left to
// right), exactly as the plain version's element-wise tensor ops round.
__device__ __forceinline__ float affine_rn(float a, float b, float c, float d,
                                           float x, float y, float z) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), __fmul_rn(c, z)),
      d);
}

__global__ void __launch_bounds__(kThreads)
icp_terms_kernel(const float* __restrict__ pts, const int32_t* __restrict__ cell,
                 const uint8_t* __restrict__ valid, int n,
                 const float4* __restrict__ tgt, const float* __restrict__ T,
                 int wx, int wy, int wz, int qt, float maxd2, float delta,
                 float* __restrict__ partials) {
  __shared__ float warp_part[kThreads / 32][kOut];
  const int i = blockIdx.x * kThreads + threadIdx.x;

  float out[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) out[k] = 0.f;

  // padded and dropped slots contribute nothing
  if (i < n && valid[i]) {
    const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
    const float px = affine_rn(T[0], T[1], T[2], T[3], x, y, z);
    const float py = affine_rn(T[4], T[5], T[6], T[7], x, y, z);
    const float pz = affine_rn(T[8], T[9], T[10], T[11], x, y, z);

    const int c = cell[i];
    const int cx = c / (wy * wz);
    const int cy = (c / wz) % wy;
    const int cz = c % wz;

    float best = kBig, bx = 0.f, by = 0.f, bz = 0.f;
    for (int dx = -1; dx <= 1; ++dx) {
      const int nx = cx + dx;
      if (nx < 0 || nx >= wx) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        const int ny = cy + dy;
        if (ny < 0 || ny >= wy) continue;
        for (int dz = -1; dz <= 1; ++dz) {
          const int nz = cz + dz;
          if (nz < 0 || nz >= wz) continue;
          const float4* row =
              tgt + (static_cast<size_t>(nx * wy + ny) * wz + nz) * qt;
          for (int t = 0; t < qt; ++t) {
            const float4 q = __ldg(row + t);
            if (!(q.w > 0.5f)) continue;
            const float r0 = __fsub_rn(px, q.x);
            const float r1 = __fsub_rn(py, q.y);
            const float r2 = __fsub_rn(pz, q.z);
            const float d2 = __fadd_rn(
                __fadd_rn(__fmul_rn(r0, r0), __fmul_rn(r1, r1)),
                __fmul_rn(r2, r2));
            if (d2 < best) {
              best = d2;
              bx = q.x;
              by = q.y;
              bz = q.z;
            }
          }
        }
      }
    }

    if (best < maxd2) {
      const float d = __fsqrt_rn(fmaxf(best, 1e-18f));
      const float w = d <= delta ? 1.f : __fdiv_rn(delta, d);
      const float y0 = w * __fsub_rn(px, bx);
      const float y1 = w * __fsub_rn(py, by);
      const float y2 = w * __fsub_rn(pz, bz);
      const float pp = px * px + py * py + pz * pz;
      // H = w J^T J with J = [I | -hat(p)], upper triangle row-major:
      // H_tt = w I, H_tr = -w hat(p), H_rr = w (|p|^2 I - p p^T)
      out[0] = w;
      out[4] = w * pz;
      out[5] = -w * py;
      out[6] = w;
      out[8] = -w * pz;
      out[10] = w * px;
      out[11] = w;
      out[12] = w * py;
      out[13] = -w * px;
      out[15] = w * (pp - px * px);
      out[16] = -w * px * py;
      out[17] = -w * px * pz;
      out[18] = w * (pp - py * py);
      out[19] = -w * py * pz;
      out[20] = w * (pp - pz * pz);
      out[21] = y0;
      out[22] = y1;
      out[23] = y2;
      out[24] = py * y2 - pz * y1;
      out[25] = pz * y0 - px * y2;
      out[26] = px * y1 - py * y0;
      out[27] = w * best;
      out[28] = 1.f;
      out[29] = w;
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const float v = warp_sum(out[k]);
    if (lane == 0) warp_part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kOut) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) acc += warp_part[w][threadIdx.x];
    partials[static_cast<size_t>(blockIdx.x) * kOut + threadIdx.x] = acc;
  }
}

}  // namespace

// Launch on ``stream``; ``partials`` holds num_blocks x 30 floats. Returns
// the cudaError_t of the launch (0 = success). The caller sizes num_blocks
// as ceil(n / 256), at least 1 (an empty slot list writes one zero row).
extern "C" int icp_terms_launch(const void* pts, const void* cell,
                                const void* valid, int n, const void* tgt,
                                const void* T, int wx, int wy, int wz, int qt,
                                float maxd2, float delta, void* partials,
                                int num_blocks, void* stream) {
  if (n < 0 || qt < 1 || num_blocks < 1 ||
      static_cast<long long>(num_blocks) * kThreads < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  icp_terms_kernel<<<num_blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const int32_t*>(cell),
      static_cast<const uint8_t*>(valid), n, static_cast<const float4*>(tgt),
      static_cast<const float*>(T), wx, wy, wz, qt, maxd2, delta,
      static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int icp_terms_block_threads() { return kThreads; }
