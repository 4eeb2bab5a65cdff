// Frozen-bin NDT terms pass for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_slam/kernels/ndt_terms.py::_terms_kernel
// (body _terms_plane_body, launched from ndt_terms_raster). The TPU kernel
// swept every cell of a dense (Wx, 4Q, 8, Wy*Wz/8) raster with static
// sublane/lane rolls; at the production window (192, 192, 32), Q = 4 that
// raster is 75.5 MB of which ~20k of 4.7M slots hold a point. Here the scan
// arrives as a compact list of kept slots (point in the source frame, its
// window cell, a valid flag), sorted by cell.
//
// What bounds it on this card: per call ~20k slots x 27 neighbours x ~45
// flops is ~25 MFLOP (under a microsecond at the float32 peak), and it reads
// the slots plus the touched field rows once (under 0.5 MB). Both bounds lie
// far below a launch's own latency, so the kernel is latency-bound: what
// counts is how many dependent memory round trips a slot waits for and how
// many slots are in flight. The design:
//
//   1. a group of kLanes = 8 lanes owns a slot; lane j takes the
//      neighbours k = j, j + 8, ... of the 27 (k = 9(dx+1) + 3(dy+1) +
//      (dz+1)), each bound-checked on x, y and z. It issues the three
//      float4 loads of a neighbour's (G, 16) row [mean(3), information
//      upper triangle(6), valid, pad(6)] before it tests the valid flag, so
//      the loads of its neighbours overlap instead of forming a chain;
//   2. p = T x, rounded operation by operation (no FMA contraction) in the
//      order of the plain PyTorch version, and so is the gate
//      |p - mu|^2 < max_corr_dist^2: every pair is decided identically in
//      both, and the matched count agrees exactly;
//   3. each lane sums its gated neighbours' 11 accumulators s*Lambda*r (3),
//      s*Lambda (6), s and the hit flag in visiting order; the group then
//      combines its lanes by a butterfly of shuffles (level s adds lane
//      j ^ s, so every lane ends with the same sums) and expands them once
//      into the 29 channels H's upper triangle (21), b (6), sum s, matched;
//      lane j keeps the running sums of channels j, j + 8, ...;
//   4. the grid has a fixed number of blocks (terms::grid_blocks: a
//      function of n alone, at most one wave), not one thread per slot:
//      group g walks the slots g, g + groups, ..., loading the next slot
//      while it scores the current one; each block reduces its groups once,
//      in a fixed order, into one row of a (29, num_blocks) scratch;
//   5. a one-block finalizer sums the rows in index order and writes the
//      finished result [H (6x6, symmetric), b (6), cost = -sum s, matched]:
//      no float atomics and no state kept between calls (so a call can be
//      captured in a CUDA graph as it is), the same bits run to run, and no
//      device work after it in the wrapper.
//
// Eight lanes beat 1, 4 and 32 on the card (PERF.md); compare_kernels.py
// builds the others with -DNDT_TERMS_LANES.

#include <cuda_runtime.h>
#include <stdint.h>

#include "terms_common.cuh"

#ifndef NDT_TERMS_LANES
#define NDT_TERMS_LANES 8
#endif

namespace {

using terms::affine_rn;
using terms::kFinishThreads;
using terms::kMaxBlocks;
using terms::kMinBlocks;
using terms::kThreads;

constexpr int kLanes = NDT_TERMS_LANES;   // lanes a slot
constexpr int kOut = 29;      // H upper triangle (21), b (6), sum s, matched
constexpr int kResult = 44;   // H (36), b (6), cost, matched

__global__ void __launch_bounds__(kThreads, kMinBlocks)
ndt_terms_kernel(const float* __restrict__ pts, const int32_t* __restrict__ cell,
                 const uint8_t* __restrict__ valid, int n,
                 const float* __restrict__ rows, const float* __restrict__ T,
                 int wx, int wy, int wz, float inv_2g, float maxd2,
                 float* __restrict__ partials) {
  constexpr int kPerLane = (27 + kLanes - 1) / kLanes;   // neighbours a lane
  constexpr int kBatch = kPerLane < 4 ? kPerLane : 4;
  constexpr int kHeld = (kOut + kLanes - 1) / kLanes;
  constexpr int kGroups = kThreads / kLanes;       // groups a block
  const int lane = threadIdx.x & (kLanes - 1);
  const unsigned gmask = terms::group_mask<kLanes>();
  const int stride = gridDim.x * kGroups;
  const float t00 = __ldg(T), t01 = __ldg(T + 1), t02 = __ldg(T + 2);
  const float t03 = __ldg(T + 3), t10 = __ldg(T + 4), t11 = __ldg(T + 5);
  const float t12 = __ldg(T + 6), t13 = __ldg(T + 7), t20 = __ldg(T + 8);
  const float t21 = __ldg(T + 9), t22 = __ldg(T + 10), t23 = __ldg(T + 11);

  // this lane's neighbours, decoded once: the row offset from the slot's
  // cell, and (dx+1) | (dy+1) << 2 | (dz+1) << 4, or -1 past the 27th
  int nb_off[kPerLane], nb_code[kPerLane];
#pragma unroll
  for (int m = 0; m < kPerLane; ++m) {
    const int k = lane + m * kLanes;
    const int dx = k / 9, dy = (k / 3) % 3, dz = k % 3;
    nb_off[m] = ((dx - 1) * wy + dy - 1) * wz + dz - 1;
    nb_code[m] = k < 27 ? dx | dy << 2 | dz << 4 : -1;
  }

  float held[kHeld];
#pragma unroll
  for (int r = 0; r < kHeld; ++r) held[r] = 0.f;

  // each group walks its slots with the next slot's flag, point and cell
  // loaded while the current one is scored
  int i = blockIdx.x * kGroups + threadIdx.x / kLanes;
  bool keep_next = false;
  float x_next = 0.f, y_next = 0.f, z_next = 0.f;
  int c_next = 0;
  if (i < n) {
    keep_next = valid[i];
    x_next = pts[3 * i], y_next = pts[3 * i + 1], z_next = pts[3 * i + 2];
    c_next = cell[i];
  }
  for (; i < n; i += stride) {
    // padded and dropped slots contribute nothing; they are masked before
    // any arithmetic, so their coordinates never reach the exponential
    const bool keep = keep_next;
    const float x = x_next, y = y_next, z = z_next;
    const int c = c_next;
    const int j = i + stride;
    if (j < n) {
      keep_next = valid[j];
      x_next = pts[3 * j], y_next = pts[3 * j + 1], z_next = pts[3 * j + 2];
      c_next = cell[j];
    }
    if (!keep) continue;                           // the whole group skips
    const float px = affine_rn(t00, t01, t02, t03, x, y, z);
    const float py = affine_rn(t10, t11, t12, t13, x, y, z);
    const float pz = affine_rn(t20, t21, t22, t23, x, y, z);
    // bit d of each mask: the neighbour at offset d - 1 is in the window
    const int cx = c / (wy * wz);
    const int cy = (c / wz) % wy;
    const int cz = c % wz;
    const int xm = (cx > 0) | 2 | (cx < wx - 1) << 2;
    const int ym = (cy > 0) | 2 | (cy < wy - 1) << 2;
    const int zm = (cz > 0) | 2 | (cz < wz - 1) << 2;

    // y = sum s Lambda r (3), c = sum s Lambda (6), s, hit
    float a[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) a[k] = 0.f;
    float ssum = 0.f;
    int hit = 0;
    // the lane's neighbours in batches: every load of a batch is issued
    // before the first of them is used
#pragma unroll
    for (int m0 = 0; m0 < kPerLane; m0 += kBatch) {
      float4 ra[kBatch], rb[kBatch], rv[kBatch];
      bool in[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int m = m0 + u < kPerLane ? m0 + u : 0;
        const int code = nb_code[m];
        in[u] = m0 + u < kPerLane && code >= 0 &&
                (xm >> (code & 3) & ym >> (code >> 2 & 3) &
                 zm >> (code >> 4)) & 1;
        ra[u] = rb[u] = rv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (in[u]) {
          // a row that passes the bounds check exists: load all of it, and
          // test its valid flag afterwards
          const float4* row = reinterpret_cast<const float4*>(
              rows + static_cast<size_t>(c + nb_off[m]) * 16);
          ra[u] = __ldg(row);        // mu0, mu1, mu2, l00
          rb[u] = __ldg(row + 1);    // l01, l02, l11, l12
          rv[u] = __ldg(row + 2);    // l22, valid, pad, pad
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float r0 = __fsub_rn(px, ra[u].x);
        const float r1 = __fsub_rn(py, ra[u].y);
        const float r2 = __fsub_rn(pz, ra[u].z);
        const float de2 = __fadd_rn(
            __fadd_rn(__fmul_rn(r0, r0), __fmul_rn(r1, r1)),
            __fmul_rn(r2, r2));
        if (in[u] && rv[u].y > 0.5f && de2 < maxd2) {
          const float l00 = ra[u].w, l01 = rb[u].x, l02 = rb[u].y;
          const float l11 = rb[u].z, l12 = rb[u].w, l22 = rv[u].x;
          const float q0 = l00 * r0 + l01 * r1 + l02 * r2;
          const float q1 = l01 * r0 + l11 * r1 + l12 * r2;
          const float q2 = l02 * r0 + l12 * r1 + l22 * r2;
          const float d2 = q0 * r0 + q1 * r1 + q2 * r2;
          const float s = expf(-fminf(d2 * inv_2g, 30.f));
          a[0] += s * q0; a[1] += s * q1; a[2] += s * q2;
          a[3] += s * l00; a[4] += s * l01; a[5] += s * l02;
          a[6] += s * l11; a[7] += s * l12; a[8] += s * l22;
          ssum += s;
          hit = 1;
        }
      }
    }
    a[9] = ssum;
    // combine the group's lanes: lane j adds lane j ^ s at level s, so all
    // lanes end with the same bits (a + b == b + a)
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) {
#pragma unroll
      for (int k = 0; k < 10; ++k)
        a[k] += __shfl_xor_sync(gmask, a[k], off, kLanes);
      hit |= __shfl_xor_sync(gmask, hit, off, kLanes);
    }

    // H = J^T L J and b = J^T y with J = [I | -hat(p)], expanded once:
    // H_tt = L, H_tr = -L hat(p) = -M, H_rr = -hat(p) M, b_r = p x y
    const float y0 = a[0], y1 = a[1], y2 = a[2];
    const float c00 = a[3], c01 = a[4], c02 = a[5];
    const float c11 = a[6], c12 = a[7], c22 = a[8];
    const float m00 = c01 * pz - c02 * py, m01 = -c00 * pz + c02 * px;
    const float m02 = c00 * py - c01 * px;
    const float m10 = c11 * pz - c12 * py, m11 = -c01 * pz + c12 * px;
    const float m12 = c01 * py - c11 * px;
    const float m20 = c12 * pz - c22 * py, m21 = -c02 * pz + c22 * px;
    const float m22 = c02 * py - c12 * px;
    // upper triangle, row-major: (0,0)..(0,5), (1,1)..(1,5), ..., (5,5)
    const float out[kOut] = {
        c00, c01, c02, -m00, -m01, -m02,
        c11, c12, -m10, -m11, -m12,
        c22, -m20, -m21, -m22,
        -(-pz * m10 + py * m20), -(-pz * m11 + py * m21),
        -(-pz * m12 + py * m22),
        -(pz * m01 - px * m21), -(pz * m02 - px * m22),
        -(-py * m02 + px * m12),
        y0, y1, y2, py * y2 - pz * y1, pz * y0 - px * y2, px * y1 - py * y0,
        a[9], hit ? 1.f : 0.f};
#pragma unroll
    for (int ch = 0; ch < kOut; ++ch) {
      if (ch % kLanes == lane) held[ch / kLanes] += out[ch];
    }
  }

  terms::write_block_row<kLanes, kOut>(held, partials);
}

// One block: the blocks' rows summed in index order, and the finished result
// [H (6x6, symmetric), b (6), cost = -sum s, matched] written.
__global__ void __launch_bounds__(kFinishThreads)
ndt_terms_finalize(const float* __restrict__ partials, int num_blocks,
                   float* __restrict__ result) {
  __shared__ float tot[kOut];
  terms::sum_rows<kOut>(partials, num_blocks, tot);
  const int t = threadIdx.x;
  if (t < 36) {
    result[t] = terms::symmetric_entry(tot, t);
  } else if (t < 42) {
    result[t] = tot[21 + t - 36];
  } else if (t == 42) {
    result[t] = -tot[27];
  } else if (t == 43) {
    result[t] = tot[28];
  }
}

}  // namespace

// Launch on ``stream`` the terms kernel on terms::grid_blocks(n, 8) blocks,
// then the finalizer. ``out`` holds 44 + 29 * kMaxBlocks floats: the result
// [H (36), b (6), cost, matched], then the blocks' rows. Returns the
// cudaError_t of the first launch that fails (0 = success).
extern "C" int ndt_terms_launch(const void* pts, const void* cell,
                                const void* valid, int n, const void* rows,
                                const void* T, int wx, int wy, int wz,
                                float inv_2g, float maxd2, void* out,
                                void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* result = static_cast<float*>(out);
  float* partials = result + kResult;
  const int num_blocks = terms::grid_blocks(n, kLanes);
  ndt_terms_kernel<<<num_blocks, kThreads, 0, s>>>(
      static_cast<const float*>(pts), static_cast<const int32_t*>(cell),
      static_cast<const uint8_t*>(valid), n, static_cast<const float*>(rows),
      static_cast<const float*>(T), wx, wy, wz, inv_2g, maxd2, partials);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  ndt_terms_finalize<<<1, kFinishThreads, 0, s>>>(partials, num_blocks,
                                                  result);
  return static_cast<int>(cudaGetLastError());
}

// The library's shape, for the wrapper to check: threads a block, lanes a
// slot, blocks at most.
extern "C" void ndt_terms_layout(int* out) {
  out[0] = kThreads;
  out[1] = kLanes;
  out[2] = kMaxBlocks;
}
