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
// One thread per output element (per output row for the row sum): each
// reads its index and its table value and writes once. What bounds them on
// this card is bytes: the indices, the table rows they touch and the output,
// each moved once, at 3.35 TB/s; there is no arithmetic to speak of. The
// design keeps neighbouring threads on neighbouring columns of one row, so a
// warp's table reads fall in one or two 64-byte rows and its writes coalesce.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ table, int rows, int cols,
                   const int32_t* __restrict__ idx, int per_element,
                   long long total, float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (e >= total) return;
  const long long i = e / cols;
  const int j = static_cast<int>(e - i * cols);
  const int r = __ldg(idx + (per_element ? e : i));
  out[e] = (r >= 0 && r < rows)
               ? __ldg(table + static_cast<long long>(r) * cols + j)
               : NAN;
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
  if (bad_shape(rows, cols, total)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gather_rows_kernel<<<blocks_for(total), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), rows, cols,
      static_cast<const int32_t*>(idx), per_element, total,
      static_cast<float*>(out));
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
