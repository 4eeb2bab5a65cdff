// Fused pair-ICP terms pass for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_slam/kernels/icp_terms.py::_icp_kernel
// (launched from icp_terms_raster). The TPU kernel swept every cell of two
// dense (Wx, 4Q, 8, Wy*Wz/8) rasters, the source's and the target's, with
// static sublane/lane rolls, carrying per-slot running minima in vregs. Here
// the source arrives as the compact, cell-sorted list of its kept slots
// (point in the source frame, window cell, valid flag) and the target as the
// dense (G*Qt, 4) table of slot rows [x, y, z, valid].
//
// What bounds it on this card: at bench config 1 (8,192-32,768 points,
// Qt = 8) a pass visits at most 27 x 8 target slots a source slot at ~9
// flops each, ~64 MFLOP at 32k (about a microsecond at the float32 peak),
// and it reads the slots plus the touched target rows once (under 2 MB).
// Both bounds lie below a launch's own latency: the kernel is latency-bound,
// and one thread walking 216 candidate loads in a row is what it must not
// do. The design:
//
//   1. a group of kLanes lanes owns a source slot. Its candidates are the
//      Qt target slots of each of the 27 neighbour cells, in the order
//      (dx, dy, dz, slot), each -1, 0, +1, bound-checked on x, y and z with
//      no wrap; candidate k = 9(dx+1) + 3(dy+1) + (dz+1) times Qt plus the
//      slot. At Qt = 2, 4 or 8 the group has Qt lanes and lane t reads slot
//      t of each of the 27 cells: a cell's Qt float4s come in one request,
//      and the neighbour offsets are constants (one batch of 9 loads an x
//      plane). Any other Qt takes 8 lanes, lane j every candidate
//      k = j mod 8, in batches of 8 loads;
//   2. p = T x and each candidate's d2 = ((rx*rx + ry*ry) + rz*rz) are
//      rounded op by op in the plain version's order; a lane keeps its best
//      with a strict '<' from 3.0e38 in its visiting order;
//   3. the group merges its lanes by a butterfly on the key (d2, k): the
//      lower d2 wins, on equal d2 the lower k. A sequential strict-'<' scan
//      keeps the first minimum in (dx, dy, dz, slot) order, which is exactly
//      the least (d2, k), so every slot picks the same target as the plain
//      version (and the one-thread kernel before this one): best, nmatch
//      and the Huber weight are bit-equal;
//   4. gate on best d2 < float32(max_corr_dist)^2, Huber weight
//      w = 1 (d <= delta) or delta / d, and expand w J^T J and w J^T r at
//      the transformed point into the 30 channels H's upper triangle (21),
//      b (6), err, nmatch and wsum; lane j keeps channels j, j + kLanes, ...;
//   5. the grid has a fixed number of blocks (terms::grid_blocks: a
//      function of n alone, at most one wave): group g walks the slots g,
//      g + groups, ..., loading the next slot while it scores the current
//      one; each block reduces its groups once, in a fixed order, into one
//      row of a (30, num_blocks) scratch, and a one-block finalizer sums
//      the rows in index order into the finished result [H (6x6), b (6),
//      err, nmatch, wsum]: no float atomics and no state kept between
//      calls, the same bits run to run.
//
// ``choice``, when not null, receives each slot's chosen target row (its
// index in the (G*Qt, 4) table; -1 for a dropped slot or one with no valid
// candidate), so a test can hold the choice itself against the plain version.
//
// One lane a target slot beat dealing candidates out to 1, 4 or 32 lanes on
// the card (PERF.md); compare_kernels.py builds those with -DICP_TERMS_LANES=L,
// which gives every Qt a group of L lanes (lane t on slot t when Qt = L).

#include <cuda_runtime.h>
#include <stdint.h>

#include "terms_common.cuh"

namespace {

using terms::affine_rn;
using terms::kFinishThreads;
using terms::kMaxBlocks;
using terms::kMinBlocks;
using terms::kThreads;

constexpr int kOut = 30;      // H upper triangle (21), b (6), err, nmatch,
                              // wsum
constexpr int kResult = 45;   // H (36), b (6), err, nmatch, wsum
constexpr float kBig = 3.0e38f;
constexpr int kNoCandidate = 0x7fffffff;

template <int kLanes>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
icp_terms_kernel(const float* __restrict__ pts, const int32_t* __restrict__ cell,
                 const uint8_t* __restrict__ valid, int n,
                 const float4* __restrict__ tgt, const float* __restrict__ T,
                 int wx, int wy, int wz, int qt, float maxd2, float delta,
                 float* __restrict__ partials, int32_t* __restrict__ choice) {
  constexpr int kHeld = (kOut + kLanes - 1) / kLanes;
  constexpr int kGroups = kThreads / kLanes;
  constexpr int kBatch = 8;                        // candidate loads in flight
  const int lane = threadIdx.x & (kLanes - 1);
  const unsigned gmask = terms::group_mask<kLanes>();
  const int stride = gridDim.x * kGroups;
  const float t00 = __ldg(T), t01 = __ldg(T + 1), t02 = __ldg(T + 2);
  const float t03 = __ldg(T + 3), t10 = __ldg(T + 4), t11 = __ldg(T + 5);
  const float t12 = __ldg(T + 6), t13 = __ldg(T + 7), t20 = __ldg(T + 8);
  const float t21 = __ldg(T + 9), t22 = __ldg(T + 10), t23 = __ldg(T + 11);

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
    // padded and dropped slots contribute nothing
    const bool keep = keep_next;
    const float x = x_next, y = y_next, z = z_next;
    const int c = c_next;
    const int j = i + stride;
    if (j < n) {
      keep_next = valid[j];
      x_next = pts[3 * j], y_next = pts[3 * j + 1], z_next = pts[3 * j + 2];
      c_next = cell[j];
    }
    if (!keep) {                                   // the whole group skips
      if (choice != nullptr && lane == 0) choice[i] = -1;
      continue;
    }
    const float px = affine_rn(t00, t01, t02, t03, x, y, z);
    const float py = affine_rn(t10, t11, t12, t13, x, y, z);
    const float pz = affine_rn(t20, t21, t22, t23, x, y, z);
    const int cx = c / (wy * wz);
    const int cy = (c / wz) % wy;
    const int cz = c % wz;

    float best = kBig, bx = 0.f, by = 0.f, bz = 0.f;
    int bk = kNoCandidate;
    if (qt == kLanes) {
      // lane t reads slot t of each cell, the cells in (dx, dy, dz) order
      const float4* base = tgt + static_cast<size_t>(c) * qt + lane;
      const int sx = wy * wz * qt, sy = wz * qt;
      const bool xin[3] = {cx > 0, true, cx < wx - 1};
      const bool yin[3] = {cy > 0, true, cy < wy - 1};
      const bool zin[3] = {cz > 0, true, cz < wz - 1};
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float4 q[9];
#pragma unroll
        for (int u = 0; u < 9; ++u) {
          q[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (xin[dx] && yin[u / 3] && zin[u % 3])
            q[u] = __ldg(base + (dx - 1) * sx + (u / 3 - 1) * sy +
                         (u % 3 - 1) * qt);
        }
#pragma unroll
        for (int u = 0; u < 9; ++u) {
          if (!(q[u].w > 0.5f)) continue;
          const float r0 = __fsub_rn(px, q[u].x);
          const float r1 = __fsub_rn(py, q[u].y);
          const float r2 = __fsub_rn(pz, q[u].z);
          const float d2 = __fadd_rn(
              __fadd_rn(__fmul_rn(r0, r0), __fmul_rn(r1, r1)),
              __fmul_rn(r2, r2));
          if (d2 < best) {
            best = d2;
            bk = (dx * 9 + u) * qt + lane;
            bx = q[u].x;
            by = q[u].y;
            bz = q[u].z;
          }
        }
      }
    } else {
      // this lane's m-th candidate: k = lane + m * kLanes, in batches, every
      // load of a batch issued before the first is used
      const int count = (27 * qt - lane + kLanes - 1) / kLanes;
      for (int m0 = 0; m0 < count; m0 += kBatch) {
        float4 q[kBatch];
        int kk[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int k = lane + (m0 + u) * kLanes;
          const int nb = k / qt;
          const int t = k - nb * qt;
          const int nx = cx + nb / 9 - 1;
          const int ny = cy + (nb / 3) % 3 - 1;
          const int nz = cz + nb % 3 - 1;
          kk[u] = -1;
          q[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (m0 + u < count && nx >= 0 && nx < wx && ny >= 0 && ny < wy &&
              nz >= 0 && nz < wz) {
            q[u] = __ldg(tgt + (static_cast<size_t>(nx * wy + ny) * wz + nz) *
                                   qt + t);
            kk[u] = k;
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (kk[u] < 0 || !(q[u].w > 0.5f)) continue;
          const float r0 = __fsub_rn(px, q[u].x);
          const float r1 = __fsub_rn(py, q[u].y);
          const float r2 = __fsub_rn(pz, q[u].z);
          const float d2 = __fadd_rn(
              __fadd_rn(__fmul_rn(r0, r0), __fmul_rn(r1, r1)),
              __fmul_rn(r2, r2));
          if (d2 < best) {
            best = d2;
            bk = kk[u];
            bx = q[u].x;
            by = q[u].y;
            bz = q[u].z;
          }
        }
      }
    }
    // merge the group's lanes on (d2, k); the rule is symmetric, so every
    // lane ends with the same choice
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) {
      const float ob = __shfl_xor_sync(gmask, best, off, kLanes);
      const int ok = __shfl_xor_sync(gmask, bk, off, kLanes);
      const float ox = __shfl_xor_sync(gmask, bx, off, kLanes);
      const float oy = __shfl_xor_sync(gmask, by, off, kLanes);
      const float oz = __shfl_xor_sync(gmask, bz, off, kLanes);
      if (ob < best || (ob == best && ok < bk)) {
        best = ob;
        bk = ok;
        bx = ox;
        by = oy;
        bz = oz;
      }
    }
    if (choice != nullptr && lane == 0) {
      int row = -1;
      if (bk != kNoCandidate) {
        const int nb = bk / qt;
        row = ((cx + nb / 9 - 1) * wy + cy + (nb / 3) % 3 - 1) * wz + cz +
              nb % 3 - 1;
        row = row * qt + bk - nb * qt;
      }
      choice[i] = row;
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
      const float out[kOut] = {
          w, 0.f, 0.f, 0.f, w * pz, -w * py,
          w, 0.f, -w * pz, 0.f, w * px,
          w, w * py, -w * px, 0.f,
          w * (pp - px * px), -w * px * py, -w * px * pz,
          w * (pp - py * py), -w * py * pz,
          w * (pp - pz * pz),
          y0, y1, y2, py * y2 - pz * y1, pz * y0 - px * y2, px * y1 - py * y0,
          w * best, 1.f, w};
#pragma unroll
      for (int ch = 0; ch < kOut; ++ch) {
        if (ch % kLanes == lane) held[ch / kLanes] += out[ch];
      }
    }
  }

  terms::write_block_row<kLanes, kOut>(held, partials);
}

// One block: the blocks' rows summed in index order, and the finished result
// [H (6x6, symmetric), b (6), err, nmatch, wsum] written.
__global__ void __launch_bounds__(kFinishThreads)
icp_terms_finalize(const float* __restrict__ partials, int num_blocks,
                   float* __restrict__ result) {
  __shared__ float tot[kOut];
  terms::sum_rows<kOut>(partials, num_blocks, tot);
  const int t = threadIdx.x;
  if (t < 36) {
    result[t] = terms::symmetric_entry(tot, t);
  } else if (t < kResult) {
    result[t] = tot[21 + t - 36];          // b (6), err, nmatch, wsum
  }
}

// The terms kernel with kLanes lanes a source slot on
// terms::grid_blocks(n, kLanes) blocks, then the finalizer.
template <int kLanes>
cudaError_t launch_terms(const void* pts, const void* cell, const void* valid,
                         int n, const void* tgt, const void* T, int wx,
                         int wy, int wz, int qt, float maxd2, float delta,
                         float* result, void* choice, cudaStream_t stream) {
  float* partials = result + kResult;
  const int num_blocks = terms::grid_blocks(n, kLanes);
  icp_terms_kernel<kLanes><<<num_blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(pts), static_cast<const int32_t*>(cell),
      static_cast<const uint8_t*>(valid), n, static_cast<const float4*>(tgt),
      static_cast<const float*>(T), wx, wy, wz, qt, maxd2, delta, partials,
      static_cast<int32_t*>(choice));
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  icp_terms_finalize<<<1, kFinishThreads, 0, stream>>>(partials, num_blocks,
                                                       result);
  return cudaGetLastError();
}

}  // namespace

// Launch on ``stream`` the terms kernel and the finalizer: Qt lanes a source
// slot at Qt = 2, 4 or 8, else 8 lanes dealing out candidates. ``out`` holds
// 45 + 30 * kMaxBlocks floats: the result [H (36), b (6), err, nmatch, wsum],
// then the blocks' rows. ``choice`` is null or an int32 a slot. Returns the
// cudaError_t of the first launch that fails (0 = success).
extern "C" int icp_terms_launch(const void* pts, const void* cell,
                                const void* valid, int n, const void* tgt,
                                const void* T, int wx, int wy, int wz, int qt,
                                float maxd2, float delta, void* out,
                                void* choice, void* stream) {
  if (n < 0 || qt < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* result = static_cast<float*>(out);
#define ICP_TERMS_ARGS                                                   \
  pts, cell, valid, n, tgt, T, wx, wy, wz, qt, maxd2, delta, result, choice, s
#ifdef ICP_TERMS_LANES
  return static_cast<int>(launch_terms<ICP_TERMS_LANES>(ICP_TERMS_ARGS));
#else
  switch (qt) {
    case 2:
      return static_cast<int>(launch_terms<2>(ICP_TERMS_ARGS));
    case 4:
      return static_cast<int>(launch_terms<4>(ICP_TERMS_ARGS));
    default:
      return static_cast<int>(launch_terms<8>(ICP_TERMS_ARGS));
  }
#endif
#undef ICP_TERMS_ARGS
}

// The library's shape, for the wrapper to check: threads a block, blocks at
// most.
extern "C" void icp_terms_layout(int* out) {
  out[0] = kThreads;
  out[1] = kMaxBlocks;
}
