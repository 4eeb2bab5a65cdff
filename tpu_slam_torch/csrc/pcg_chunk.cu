// A chunk of the pose-graph PCG's masked CG iterations in one thread block.
//
// Replaces no TPU kernel: the reference runs its CG loop as XLA ops
// (tpu_slam/graph/pose_graph.py, _solve_pcg). The port's plain form of one
// iteration (graph/pose_graph.py, _pcg_iterations) is some 66 small
// kernels, two of them the sort-based scatter-adds of H·p, which walk the
// edge table's masked padding too; on the H100 a 16-iteration chunk of it
// took ~5.5 ms. At c4's 428 live edges an iteration does ~0.1 MFLOP, and
// a chunk needs each live edge's J_j and weighted information W_e once
// (~123 KB), but every step waits on the one before: what bounds it is
// the chain of dependent steps and block-wide syncs, not the card's bytes
// or operations.
//
// So one block of 512 threads runs all ``iters`` iterations of a chunk, a
// thread a node slot (the node capacity may not pass 512) and a thread an
// edge slot. A node's thread keeps its x, r, p and its block of Minv in
// registers. Shared memory holds p (which the edges read), the per-edge
// products q, the incidence lists, Minv on its way to the registers, and,
// in the rest of the block's 227 KB, a copy of J_j and W_e of as many edge
// slots as fit (c4's 1,024-slot table: its first 491, which hold the live
// prefix), so an iteration reads device memory only for edges past the
// copy. The copies are element-major (element c of matrix e at c * stride
// + e, an odd stride), so a warp's 32 edges read 32 banks at once; they
// are filled once a launch by asynchronous copies (cp.async), all in
// flight at once. Per iteration:
//   edge phase, a thread a live edge:
//     q_e = J_j^T W_e J_j (p_j - p_i)
//   node phase, a thread a node: (H·p)_n is the signed sum of q over the
//     node's incidence list (its edge_i edges in edge order with a minus,
//     then its edge_j edges in edge order; graph/pose_graph.py,
//     node_incidence), plus the gauge prior on node 0 and the damping;
//   block sums in a fixed tree order (lanes by the xor butterfly, then the
//     warps' partials the same way): p·Hp, then r·z and r·r together;
//   alpha, beta and the updates of x, r, z = Minv r, p.
// Every sum runs in a fixed order (a product's terms by column, a node's
// list in list order), with no scatter, no sort and no float atomic, so a
// run repeats bit for bit; where a matrix was read from changes no value.
// An iteration runs while r·r > tol, the reference loop's condition; once
// it fails r no longer changes, so the rest of the chunk is skipped, which
// is what the masked iterations of the plain form do. The count of
// iterations that ran is added to ``used`` (the device counter
// cg_iters_used), and x, r, p and rz are written back in place.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemLimit = 232448;    // what a Hopper block may use
constexpr unsigned kFull = 0xffffffffu;

// A batch of 6 x 6 float32 matrices with the strides (in elements) that
// the caller's tensor has.
struct Mat6 {
  const float* p;
  int s0, s1, s2;
};

// torch.clamp(v, min=1e-30): a NaN stays NaN.
__device__ __forceinline__ float clamp_tiny(float v) {
  return v < 1e-30f ? 1e-30f : v;
}

// (a, b) summed over the block in a fixed order; every thread returns
// the same bits (the butterfly's two partners add the same two values).
// ``slot`` holds kWarps float2 that the previous call did not use.
__device__ float2 block_sum2(float a, float b, float2* slot) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
  }
  const int lane = threadIdx.x & 31;
  if (lane == 0) slot[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 v = lane < kWarps ? slot[lane] : make_float2(0.f, 0.f);
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(kFull, v.x, o);
    v.y += __shfl_xor_sync(kFull, v.y, o);
  }
  return v;
}

// q = J^T W J d for one edge; jm(a, b) and wm(a, b) read J[a][b] and
// W[a][b] (each product's terms summed by column, from zero).
template <class JM, class WM>
__device__ __forceinline__ void edge_q(JM jm, WM wm, const float* d,
                                       float* q) {
  float u[6], w[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float s = 0.f;
#pragma unroll
    for (int b = 0; b < 6; ++b) s += jm(a, b) * d[b];
    u[a] = s;
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float s = 0.f;
#pragma unroll
    for (int b = 0; b < 6; ++b) s += wm(a, b) * u[b];
    w[a] = s;
  }
#pragma unroll
  for (int b = 0; b < 6; ++b) {
    float s = 0.f;
#pragma unroll
    for (int a = 0; a < 6; ++a) s += jm(a, b) * w[a];
    q[b] = s;
  }
}

// Matrices 0..count-1 of ``src`` into shared memory element-major:
// element c = 6a + b of matrix k at dst[c * stride + k], an odd stride so
// that a warp's stores fall in distinct banks. Consecutive threads take
// consecutive elements in the source's order, so a warp's reads fall on
// a line or two; each element is an asynchronous copy (cp.async), so a
// thread has all of its copies in flight at once and holds no register
// for them. The caller waits for them (``__pipeline_wait_prior``).
__device__ __forceinline__ void fill(Mat6 src, int count, float* dst,
                                     int stride) {
  const int total = 36 * count;
  for (int k = threadIdx.x; k < total; k += kThreads) {
    const int e = k / 36, c = k - 36 * e;
    __pipeline_memcpy_async(
        dst + c * stride + e,
        src.p + e * src.s0 + (c / 6) * src.s1 + (c % 6) * src.s2,
        sizeof(float));
  }
}

// Bytes of the fixed part of shared memory, before the edge matrices'
// copy (kernels/pcg.py, smem_plan, sizes the launch; the launch checks it
// against this layout).
size_t fixed_bytes(int n, int m) {
  return 2 * kWarps * sizeof(float2)
         + (6 * static_cast<size_t>(n) + 6 * static_cast<size_t>(m)
            + 36 * static_cast<size_t>(n | 1)) * sizeof(float)
         + (static_cast<size_t>(n) + 1 + 4 * static_cast<size_t>(m))
         * sizeof(int);
}

}  // namespace

__global__ void __launch_bounds__(kThreads, 1)
pcg_chunk_kernel(int n, int m, int cached, int cstride,
                 const long long* __restrict__ edge_i,
                 const long long* __restrict__ edge_j,
                 const bool* __restrict__ edge_mask,
                 const int* __restrict__ inc_ptr,
                 const int* __restrict__ inc, Mat6 J, Mat6 W, Mat6 Minv,
                 float* __restrict__ x, float* __restrict__ r,
                 float* __restrict__ p, float* __restrict__ rz_io,
                 long long* __restrict__ used_io, float prior,
                 float damping, float tol, int iters) {
  extern __shared__ float4 smem[];
  float2* red = reinterpret_cast<float2*>(smem);   // two sets of kWarps
  float* sp = reinterpret_cast<float*>(red + 2 * kWarps);   // (n, 6)
  float* sq = sp + 6 * n;                          // q, (6, m)
  int* sptr = reinterpret_cast<int*>(sq + 6 * m);  // (n + 1)
  int* sinc = sptr + n + 1;                        // (2m)
  int* sei = sinc + 2 * m;                         // edge_i, -1 if masked
  int* sej = sei + m;
  float* sm = reinterpret_cast<float*>(sej + m);   // Minv, (36, n | 1)
  float* cj = sm + 36 * (n | 1);                   // (36, cstride)
  float* cw = cj + 36 * cstride;
  const int tid = threadIdx.x;
  const int v = tid;                               // this thread's node
  const bool node = v < n;

  // the node's state (its loads in flight through the copies below)
  float xv[6], rv[6], pv[6], mv[36];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    xv[a] = node ? x[6 * v + a] : 0.f;
    rv[a] = node ? r[6 * v + a] : 0.f;
    pv[a] = node ? p[6 * v + a] : 0.f;
  }
  for (int k = tid; k <= n; k += kThreads) sptr[k] = inc_ptr[k];
#pragma unroll 4
  for (int e = tid; e < m; e += kThreads) {
    sei[e] = edge_mask[e] ? static_cast<int>(edge_i[e]) : -1;
    sej[e] = static_cast<int>(edge_j[e]);
  }
  for (int k = tid; k < 2 * m; k += kThreads)
    __pipeline_memcpy_async(sinc + k, inc + k, sizeof(int));
  fill(Minv, n, sm, n | 1);
  fill(J, cached, cj, cstride);
  fill(W, cached, cw, cstride);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  // p where the edges read it, and the node's block of the preconditioner
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    if (node) sp[6 * v + a] = pv[a];
#pragma unroll
    for (int b = 0; b < 6; ++b)
      mv[6 * a + b] = node ? sm[(6 * a + b) * (n | 1) + v] : 0.f;
  }

  float part = 0.f;
#pragma unroll
  for (int a = 0; a < 6; ++a) part += rv[a] * rv[a];
  float rr = block_sum2(part, 0.f, red).x;         // syncs sp too
  float rz = *rz_io;
  int used = 0;
  for (int it = 0; it < iters && rr > tol; ++it) {
    ++used;
    // edge phase: q_e = J_j^T W_e J_j (p_j - p_i)
    for (int e = tid; e < m; e += kThreads) {
      const int i = sei[e];
      if (i < 0) continue;
      const int j = sej[e];
      float d[6], q[6];
#pragma unroll
      for (int b = 0; b < 6; ++b) d[b] = sp[6 * j + b] - sp[6 * i + b];
      if (e < cached) {
        const float* je = cj + e;
        const float* we = cw + e;
        edge_q([&](int a, int b) { return je[(6 * a + b) * cstride]; },
               [&](int a, int b) { return we[(6 * a + b) * cstride]; }, d,
               q);
      } else {
        const float* je = J.p + e * J.s0;
        const float* we = W.p + e * W.s0;
        edge_q([&](int a, int b) { return __ldg(je + a * J.s1 + b * J.s2); },
               [&](int a, int b) { return __ldg(we + a * W.s1 + b * W.s2); },
               d, q);
      }
#pragma unroll
      for (int b = 0; b < 6; ++b) sq[b * m + e] = q[b];
    }
    __syncthreads();
    // node phase: H·p and p·Hp
    float hv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    part = 0.f;
    if (node) {
      int k = sptr[v];
      const int end = sptr[v + 1];
      // four entries' loads in flight at once, added in list order
      for (; k + 4 <= end; k += 4) {
        int c[4];
        float q[4][6];
#pragma unroll
        for (int t = 0; t < 4; ++t) c[t] = sinc[k + t];
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int a = 0; a < 6; ++a) q[t][a] = sq[a * m + (c[t] >> 1)];
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int a = 0; a < 6; ++a)
            hv[a] = (c[t] & 1) ? hv[a] + q[t][a] : hv[a] - q[t][a];
      }
      for (; k < end; ++k) {
        const int c = sinc[k];
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          const float q = sq[a * m + (c >> 1)];
          hv[a] = (c & 1) ? hv[a] + q : hv[a] - q;
        }
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        if (v == 0) hv[a] += prior * pv[a];
        hv[a] += damping * pv[a];
        part += pv[a] * hv[a];
      }
    }
    const float alpha = rz / clamp_tiny(block_sum2(part, 0.f, red).x);
    // x += alpha p, r -= alpha Hp, z = Minv r; r·z and r·r
    float zv[6], prz = 0.f, prr = 0.f;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      xv[a] += alpha * pv[a];
      rv[a] -= alpha * hv[a];
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      float z = 0.f;
#pragma unroll
      for (int b = 0; b < 6; ++b) z += mv[6 * a + b] * rv[b];
      zv[a] = z;
      prz += rv[a] * z;
      prr += rv[a] * rv[a];
    }
    const float2 s = block_sum2(prz, prr, red + kWarps);
    const float beta = s.x / clamp_tiny(rz);
    rz = s.x;
    rr = s.y;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      pv[a] = zv[a] + beta * pv[a];
      if (node) sp[6 * v + a] = pv[a];
    }
    __syncthreads();
  }
  if (node) {
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      x[6 * v + a] = xv[a];
      r[6 * v + a] = rv[a];
      p[6 * v + a] = pv[a];
    }
  }
  if (tid == 0) {
    *rz_io = rz;
    *used_io += used;
  }
}

// ``cached`` edge slots' matrices copied at an odd ``cstride`` (0 and 0
// for none) in ``bytes`` of shared memory, as kernels/pcg.py's smem_plan
// gives them.
extern "C" int pcg_chunk_launch(
    int n, int m, int cached, int cstride, size_t bytes, const void* edge_i,
    const void* edge_j, const void* edge_mask, const void* inc_ptr,
    const void* inc, const void* J, int j0, int j1, int j2, const void* W,
    int w0, int w1, int w2, const void* Minv, int m0, int m1, int m2,
    void* x, void* r, void* p, void* rz, void* used, float prior,
    float damping, float tol, int iters, void* stream) {
  if (n > kThreads || cached < 0 || cached > m || cstride < cached
      || (cstride != 0 && cstride % 2 == 0) || bytes > kSmemLimit
      || bytes != fixed_bytes(n, m)
                  + 72 * sizeof(float) * static_cast<size_t>(cstride))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pcg_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pcg_chunk_kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      n, m, cached, cstride,
      static_cast<const long long*>(edge_i),
      static_cast<const long long*>(edge_j),
      static_cast<const bool*>(edge_mask), static_cast<const int*>(inc_ptr),
      static_cast<const int*>(inc),
      Mat6{static_cast<const float*>(J), j0, j1, j2},
      Mat6{static_cast<const float*>(W), w0, w1, w2},
      Mat6{static_cast<const float*>(Minv), m0, m1, m2},
      static_cast<float*>(x), static_cast<float*>(r), static_cast<float*>(p),
      static_cast<float*>(rz), static_cast<long long*>(used), prior, damping,
      tol, iters);
  return static_cast<int>(cudaGetLastError());
}
