// Frozen-bin NDT terms pass for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_slam/kernels/ndt_terms.py::_terms_kernel
// (body _terms_plane_body, launched from ndt_terms_raster). The TPU kernel
// swept every cell of a dense (Wx, 4Q, 8, Wy*Wz/8) raster with static
// sublane/lane rolls; at the production window (192, 192, 32), Q = 4 that
// raster is 75.5 MB of which ~20k of 4.7M slots hold a point. Here the scan
// arrives as a compact list of kept slots (point in the source frame, its
// window cell, a valid flag), sorted by cell, and each thread owns one slot:
//
//   1. p = T x, rounded operation by operation (no FMA contraction) in the
//      order of the plain PyTorch version, so the Euclidean gate
//      |p - mu|^2 < max_corr_dist^2 decides every pair identically in both;
//   2. visit the 27 neighbour cells of the slot's frozen bin, each bound-
//      checked on x, y and z, reading the field's (G, 16) rows
//      [mean(3), information upper triangle(6), valid, pad(6)] directly;
//   3. sum the 11 accumulators s*Lambda*r (3), s*Lambda (6), s, matched;
//   4. expand once into H's upper triangle (21), b (6), sum s, matched;
//   5. reduce the block in a fixed order (warp shuffles, then one pass over
//      the warps' partials in shared memory) into one row of a
//      (num_blocks, 29) buffer. The caller sums the rows; no float atomics,
//      so the result is identical run to run.
//
// What bounds it on this card: per launch ~20k slots x 27 neighbours x ~45
// flops is ~25 MFLOP (under a microsecond at the float32 peak), and it reads
// the slots plus the touched field rows once (a few MB at most, mostly from
// L2, since the slots are sorted by cell and neighbouring threads share
// rows). The bound is therefore far below the launch latency; the design
// keeps the launch to one kernel with no device-side allocation and one
// small partial buffer, so the per-evaluation cost is the launch itself.
// The dense window sweep of the TPU design is gone: empty cells hold no
// slot and cost nothing, which is what the per-plane flags approximated.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOut = 29;  // H upper triangle (21), b (6), sum s, matched

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
ndt_terms_kernel(const float* __restrict__ pts, const int32_t* __restrict__ cell,
                 const uint8_t* __restrict__ valid, int n,
                 const float* __restrict__ rows, const float* __restrict__ T,
                 int wx, int wy, int wz, float inv_2g, float maxd2,
                 float* __restrict__ partials) {
  __shared__ float warp_part[kThreads / 32][kOut];
  const int i = blockIdx.x * kThreads + threadIdx.x;

  float out[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) out[k] = 0.f;

  // padded and dropped slots contribute nothing; they are masked before any
  // arithmetic, so their coordinates never reach the exponential
  if (i < n && valid[i]) {
    const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
    const float px = affine_rn(T[0], T[1], T[2], T[3], x, y, z);
    const float py = affine_rn(T[4], T[5], T[6], T[7], x, y, z);
    const float pz = affine_rn(T[8], T[9], T[10], T[11], x, y, z);

    const int c = cell[i];
    const int cx = c / (wy * wz);
    const int cy = (c / wz) % wy;
    const int cz = c % wz;

    float y0 = 0.f, y1 = 0.f, y2 = 0.f;
    float c00 = 0.f, c01 = 0.f, c02 = 0.f, c11 = 0.f, c12 = 0.f, c22 = 0.f;
    float ssum = 0.f;
    bool hit = false;
    for (int dx = -1; dx <= 1; ++dx) {
      const int nx = cx + dx;
      if (nx < 0 || nx >= wx) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        const int ny = cy + dy;
        if (ny < 0 || ny >= wy) continue;
        for (int dz = -1; dz <= 1; ++dz) {
          const int nz = cz + dz;
          if (nz < 0 || nz >= wz) continue;
          const float4* row = reinterpret_cast<const float4*>(
              rows + (static_cast<size_t>(nx * wy + ny) * wz + nz) * 16);
          const float4 r2v = __ldg(row + 2);  // l22, valid, pad, pad
          if (!(r2v.y > 0.5f)) continue;
          const float4 ra = __ldg(row);       // mu0, mu1, mu2, l00
          const float4 rb = __ldg(row + 1);   // l01, l02, l11, l12
          const float r0 = __fsub_rn(px, ra.x);
          const float r1 = __fsub_rn(py, ra.y);
          const float r2 = __fsub_rn(pz, ra.z);
          const float de2 = __fadd_rn(
              __fadd_rn(__fmul_rn(r0, r0), __fmul_rn(r1, r1)),
              __fmul_rn(r2, r2));
          if (!(de2 < maxd2)) continue;
          const float l00 = ra.w, l01 = rb.x, l02 = rb.y;
          const float l11 = rb.z, l12 = rb.w, l22 = r2v.x;
          const float q0 = l00 * r0 + l01 * r1 + l02 * r2;
          const float q1 = l01 * r0 + l11 * r1 + l12 * r2;
          const float q2 = l02 * r0 + l12 * r1 + l22 * r2;
          const float d2 = q0 * r0 + q1 * r1 + q2 * r2;
          const float s = expf(-fminf(d2 * inv_2g, 30.f));
          y0 += s * q0; y1 += s * q1; y2 += s * q2;
          c00 += s * l00; c01 += s * l01; c02 += s * l02;
          c11 += s * l11; c12 += s * l12; c22 += s * l22;
          ssum += s;
          hit = true;
        }
      }
    }

    // H = J^T L J and b = J^T y with J = [I | -hat(p)], expanded once:
    // H_tt = L, H_tr = -L hat(p) = -M, H_rr = -hat(p) M, b_r = p x y
    const float m00 = c01 * pz - c02 * py, m01 = -c00 * pz + c02 * px;
    const float m02 = c00 * py - c01 * px;
    const float m10 = c11 * pz - c12 * py, m11 = -c01 * pz + c12 * px;
    const float m12 = c01 * py - c11 * px;
    const float m20 = c12 * pz - c22 * py, m21 = -c02 * pz + c22 * px;
    const float m22 = c02 * py - c12 * px;
    // upper triangle, row-major: (0,0)..(0,5), (1,1)..(1,5), ..., (5,5)
    out[0] = c00; out[1] = c01; out[2] = c02;
    out[3] = -m00; out[4] = -m01; out[5] = -m02;
    out[6] = c11; out[7] = c12;
    out[8] = -m10; out[9] = -m11; out[10] = -m12;
    out[11] = c22;
    out[12] = -m20; out[13] = -m21; out[14] = -m22;
    out[15] = -(-pz * m10 + py * m20);
    out[16] = -(-pz * m11 + py * m21);
    out[17] = -(-pz * m12 + py * m22);
    out[18] = -(pz * m01 - px * m21);
    out[19] = -(pz * m02 - px * m22);
    out[20] = -(-py * m02 + px * m12);
    out[21] = y0; out[22] = y1; out[23] = y2;
    out[24] = py * y2 - pz * y1;
    out[25] = pz * y0 - px * y2;
    out[26] = px * y1 - py * y0;
    out[27] = ssum;
    out[28] = hit ? 1.f : 0.f;
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

// Launch on ``stream``; ``partials`` holds num_blocks x 29 floats. Returns
// the cudaError_t of the launch (0 = success). The caller sizes num_blocks
// as ceil(n / 256), at least 1 (an empty slot list writes one zero row).
extern "C" int ndt_terms_launch(const void* pts, const void* cell,
                                const void* valid, int n, const void* rows,
                                const void* T, int wx, int wy, int wz,
                                float inv_2g, float maxd2, void* partials,
                                int num_blocks, void* stream) {
  if (n < 0 || num_blocks < 1 ||
      static_cast<long long>(num_blocks) * kThreads < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ndt_terms_kernel<<<num_blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const int32_t*>(cell),
      static_cast<const uint8_t*>(valid), n, static_cast<const float*>(rows),
      static_cast<const float*>(T), wx, wy, wz, inv_2g, maxd2,
      static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ndt_terms_block_threads() { return kThreads; }
