// Row gathers for Hopper (sm_90a): the kernels of the gather probes.
//
// Replaces the TPU kernels of benchmarks/_pallas_gather_probe.py (call, with
// bodies k_take, k_taa, k_adv, k_onehot, k_scalar),
// benchmarks/_gather_probe.py (pallas_take, body gk) and
// benchmarks/_dyngather_probe.py (make with body k_eq; run_sub, body k_sub;
// run_oh, body k_onehot). Those bodies were lowerings of three functions
// that the TPU studied for their cost inside one VMEM-resident block:
//
//   gather_rows     out[i, j] = table[idx[i, j], j], idx one index per row
//                   (broadcast along j) or one per element;
//   gather_row_sum  out[i] = sum_j table[idx[i], j], summed left to right;
//   onehot_gather   what the one-hot matrix product computes: table[idx[i]]
//                   for an index inside the table, a zero row outside it,
//                   each value rounded to bfloat16 (nearest even) first when
//                   asked (the product's one nonzero term 1 * bf16(t),
//                   accumulated in float32, is exactly bf16(t)).
//
// An index outside [0, rows) gives NaN in gather_rows and gather_row_sum.
// What bounds them on this card is bytes: the indices, the table rows they
// touch and the output, each moved once, at 3.35 TB/s; there is no
// arithmetic to speak of, and at the probes' sizes (under 10 MB) a launch
// lasts a few microseconds. gather_rows moves 16 bytes a thread where the
// shape and the pointers allow it: a few threads walk one row in float4s
// (four threads a 16-column row, so a warp writes 512 contiguous bytes),
// with 32-bit offsets and no division per element, the grid capped at a
// few waves. onehot_gather keeps one thread per output element and the row
// sum one thread per output row; neighbouring threads sit on neighbouring
// columns of one row, so a warp's table reads fall in one or two 64-byte
// rows and its writes coalesce.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
// gather_rows: at most this many blocks (about four waves of 8 blocks on
// each of 132 SMs); each thread then walks several rows
constexpr long long kMaxRowBlocks = 4224;

// gather_rows: each thread walks whole units of one row (a float4 in the
// vector path, a float in the scalar path): 2^lane_shift threads cover a
// row, kThreads >> lane_shift rows a block, the grid strides over rows.
// Offsets are 32-bit (the wrapper refuses m * cols >= 2^31) but for the
// table's, and no thread divides by cols. Row mode (kPerElement false)
// reads one index a row; per-element mode reads the row's indices as int4
// (vector path) and the table values one by one (the table is L2-resident).
// The vector path needs cols % 4 == 0 and 16-byte aligned table, idx (per
// element) and out; the launcher picks it from the shape and the pointers.
template <bool kVec, bool kPerElement>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ table, int rows, int cols,
                   const int32_t* __restrict__ idx, int m, int lane_shift,
                   float* __restrict__ out) {
  const int lanes = 1 << lane_shift;
  const int lane = threadIdx.x & (lanes - 1);
  const int rows_per_block = kThreads >> lane_shift;
  const int units = kVec ? cols >> 2 : cols;
  const int stride = gridDim.x * rows_per_block;
  for (int i = blockIdx.x * rows_per_block + (threadIdx.x >> lane_shift);
       i < m; i += stride) {
    const int e0 = i * cols;
    int r = 0;
    if (!kPerElement) r = __ldg(idx + i);
    const bool row_ok = r >= 0 && r < rows;
    const float* src = table + static_cast<size_t>(row_ok ? r : 0) * cols;
    for (int u = lane; u < units; u += lanes) {
      if (kVec) {
        float4 v;
        if (kPerElement) {
          const int4 r4 = __ldg(reinterpret_cast<const int4*>(idx + e0) + u);
          const int j = 4 * u;
          v.x = (r4.x >= 0 && r4.x < rows)
                    ? __ldg(table + static_cast<size_t>(r4.x) * cols + j)
                    : NAN;
          v.y = (r4.y >= 0 && r4.y < rows)
                    ? __ldg(table + static_cast<size_t>(r4.y) * cols + j + 1)
                    : NAN;
          v.z = (r4.z >= 0 && r4.z < rows)
                    ? __ldg(table + static_cast<size_t>(r4.z) * cols + j + 2)
                    : NAN;
          v.w = (r4.w >= 0 && r4.w < rows)
                    ? __ldg(table + static_cast<size_t>(r4.w) * cols + j + 3)
                    : NAN;
        } else {
          v = row_ok ? __ldg(reinterpret_cast<const float4*>(src) + u)
                     : make_float4(NAN, NAN, NAN, NAN);
        }
        reinterpret_cast<float4*>(out + e0)[u] = v;
      } else if (kPerElement) {
        const int re = __ldg(idx + e0 + u);
        out[e0 + u] = (re >= 0 && re < rows)
                          ? __ldg(table + static_cast<size_t>(re) * cols + u)
                          : NAN;
      } else {
        out[e0 + u] = row_ok ? __ldg(src + u) : NAN;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gather_row_sum_kernel(const float* __restrict__ table, int rows, int cols,
                      const int32_t* __restrict__ idx, int m,
                      float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  const int r = __ldg(idx + i);
  if (r < 0 || r >= rows) {
    out[i] = NAN;
    return;
  }
  const float* row = table + static_cast<long long>(r) * cols;
  float acc = __ldg(row);
  for (int j = 1; j < cols; ++j) acc = __fadd_rn(acc, __ldg(row + j));
  out[i] = acc;
}

__global__ void __launch_bounds__(kThreads)
onehot_gather_kernel(const float* __restrict__ table, int rows, int cols,
                     const int32_t* __restrict__ idx, int bf16,
                     long long total, float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (e >= total) return;
  const long long i = e / cols;
  const int j = static_cast<int>(e - i * cols);
  const int r = __ldg(idx + i);
  float v = (r >= 0 && r < rows)
                ? __ldg(table + static_cast<long long>(r) * cols + j)
                : 0.f;
  if (bf16) v = __bfloat162float(__float2bfloat16_rn(v));
  out[e] = v;
}

int blocks_for(long long total) {
  return static_cast<int>((total + kThreads - 1) / kThreads);
}

bool bad_shape(int rows, int cols, long long total) {
  return rows < 1 || cols < 1 || total < 1 ||
         (total + kThreads - 1) / kThreads > 0x7fffffffLL;
}

}  // namespace

// Each launch runs on ``stream`` and returns the cudaError_t of the launch
// (0 = success). table (rows, cols) float32, contiguous; idx int32.

// idx (m,) with per_element = 0, or (m, cols) with per_element = 1;
// out (m, cols).
extern "C" int gather_rows_launch(const void* table, int rows, int cols,
                                  const void* idx, int per_element, int m,
                                  void* out, void* stream) {
  const long long total = static_cast<long long>(m) * cols;
  if (bad_shape(rows, cols, total) || total >= 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t addr = reinterpret_cast<uintptr_t>(table) |
                         reinterpret_cast<uintptr_t>(out) |
                         (per_element ? reinterpret_cast<uintptr_t>(idx) : 0);
  const bool vec = cols % 4 == 0 && addr % 16 == 0;
  const int units = vec ? cols / 4 : cols;
  int lane_shift = 0;  // 2^lane_shift threads a row: units rounded up to
  while (lane_shift < 5 && (1 << lane_shift) < units) ++lane_shift;  // <= 32
  const int rows_per_block = kThreads >> lane_shift;
  const int blocks = static_cast<int>(
      std::min<long long>((m + rows_per_block - 1) / rows_per_block,
                          kMaxRowBlocks));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  float* o = static_cast<float*>(out);
  if (vec && per_element) {
    gather_rows_kernel<true, true><<<blocks, kThreads, 0, s>>>(
        t, rows, cols, ix, m, lane_shift, o);
  } else if (vec) {
    gather_rows_kernel<true, false><<<blocks, kThreads, 0, s>>>(
        t, rows, cols, ix, m, lane_shift, o);
  } else if (per_element) {
    gather_rows_kernel<false, true><<<blocks, kThreads, 0, s>>>(
        t, rows, cols, ix, m, lane_shift, o);
  } else {
    gather_rows_kernel<false, false><<<blocks, kThreads, 0, s>>>(
        t, rows, cols, ix, m, lane_shift, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// idx (m,); out (m,).
extern "C" int gather_row_sum_launch(const void* table, int rows, int cols,
                                     const void* idx, int m, void* out,
                                     void* stream) {
  if (bad_shape(rows, cols, m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gather_row_sum_kernel<<<blocks_for(m), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), rows, cols,
      static_cast<const int32_t*>(idx), m, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// idx (m,); out (m, cols).
extern "C" int onehot_gather_launch(const void* table, int rows, int cols,
                                    const void* idx, int bf16, int m,
                                    void* out, void* stream) {
  const long long total = static_cast<long long>(m) * cols;
  if (bad_shape(rows, cols, total)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  onehot_gather_kernel<<<blocks_for(total), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), rows, cols,
      static_cast<const int32_t*>(idx), bf16, total,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
