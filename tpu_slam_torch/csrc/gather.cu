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
//   gather_row_sum  out[i] = sum_j table[idx[i], j], in the order below;
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
// lasts a few microseconds, most of it the launch itself. All three run on
// one row walker (walk_rows): a few threads take one row and move 16 bytes
// each where the shape and the pointers allow it (four threads a 16-column
// row, so a warp reads 8 whole rows and writes 512 contiguous bytes), with
// 32-bit offsets and no division per element, the grid capped at a few
// waves. Each function is its own __global__ (the walker and an epilogue),
// so that a profile names it.
//
// The one-hot product on the tensor cores would do `rows` multiply-adds for
// every value it writes (2,048 at row 8, 4,096 at row 4) and read the whole
// table, for the bytes that a gather moves with none: on this card the
// product's operations, not the bytes, would bound it. A gather is exact
// for every table, inf and NaN included (the product turns a column holding
// one into NaN, 0 * inf).
//
// gather_row_sum's order (gather_row_sum_plain computes the same): the
// row's columns fall into units of 4 (the last one short when cols % 4 !=
// 0), units = ceil(cols / 4), and lanes = the least power of two >= units,
// at most 32. Lane l sums, left to right from -0.0 (x + -0.0 == x for every
// x), the columns of units l, l + lanes, l + 2 lanes, ... in that order;
// the lanes then combine pairwise by a butterfly, offset 1, 2, 4, ...:
// at 16 columns ((p0 + p1) + (p2 + p3)). IEEE addition commutes bit for
// bit, so every lane of the row ends with the same value; lane 0 writes it.
// The order depends on cols only: the scalar path (odd width, misaligned
// table) walks the same units of 4 with scalar loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

// threads a block (-D GATHER_THREADS: compare_kernels.py --sweep times
// other sizes)
#ifndef GATHER_THREADS
#define GATHER_THREADS 256
#endif
constexpr int kThreads = GATHER_THREADS;
// at most this many blocks (about four waves of 2,048 threads on each of
// 132 SMs); each thread then walks several rows
constexpr long long kMaxRowBlocks = 4224LL * 256 / kThreads;

// The row walker. 2^lane_shift consecutive threads of a warp (lanes) take
// one output row, kThreads >> lane_shift rows a block, and the grid
// strides over rows. Lane l walks the row's units l, l + lanes, ...: a
// float4 on the vector path, Epi::kScalarUnit floats on the scalar path.
// With Epi::kWholeWarp every thread of a warp makes the same trips (a row
// past m is dead: nothing loaded, nothing written), so that the epilogue
// can shuffle with the whole warp's mask: a shuffle whose mask names only
// the row's lanes makes each group of a warp wait for the others in turn
// (row 5 took 2.43 us that way on the H100, 1.84 with the whole warp's
// mask).
// Offsets are 32-bit (the launchers refuse m * cols >= 2^31) but for the
// table's. Row mode reads one index a row; per-element mode
// (Epi::kPerElement, gather_rows only) reads the row's indices as int4
// (vector path) and the table values one by one (the table is L2-resident).
// The vector path needs cols % 4 == 0 and a 16-byte aligned table (and
// idx and out where the epilogue reads or writes them as vectors); the
// launchers pick it from the shape and the pointers.
//
// The epilogue Epi takes what the walker loads: begin() before a row,
// put4(e0, u, v) for a float4 at unit u of the row starting at element e0,
// put(e, x) for one value at element e, end(i, lane, lanes, live) after
// the row (live false only for a dead row of a kWholeWarp walk).
// Epi::outside() is the value of an index outside the table.
template <bool kVec, class Epi>
__device__ __forceinline__ void walk_rows(const float* __restrict__ table,
                                          int rows, int cols,
                                          const int32_t* __restrict__ idx,
                                          int m, int lane_shift, Epi& epi) {
  constexpr int kW = Epi::kScalarUnit;
  const int lanes = 1 << lane_shift;
  const int lane = threadIdx.x & (lanes - 1);
  const int rows_per_block = kThreads >> lane_shift;
  const int units = kVec ? cols >> 2 : (cols + kW - 1) / kW;
  const int stride = gridDim.x * rows_per_block;
  // with kWholeWarp the warp walks on while its first row, i - group, is
  // below m
  const int group = Epi::kWholeWarp ? (threadIdx.x & 31) >> lane_shift : 0;
  const float no = Epi::outside();
  for (int i = blockIdx.x * rows_per_block + (threadIdx.x >> lane_shift);
       i - group < m; i += stride) {
    const bool live = i < m;
    const int e0 = i * cols;
    int r = 0;
    if (!Epi::kPerElement && live) r = __ldg(idx + i);
    const bool row_ok = r >= 0 && r < rows;
    const float* src = table + static_cast<size_t>(row_ok ? r : 0) * cols;
    epi.begin();
    for (int u = lane; live && u < units; u += lanes) {
      if (kVec) {
        float4 v;
        if (Epi::kPerElement) {
          const int4 r4 = __ldg(reinterpret_cast<const int4*>(idx + e0) + u);
          const int j = 4 * u;
          v.x = (r4.x >= 0 && r4.x < rows)
                    ? __ldg(table + static_cast<size_t>(r4.x) * cols + j)
                    : no;
          v.y = (r4.y >= 0 && r4.y < rows)
                    ? __ldg(table + static_cast<size_t>(r4.y) * cols + j + 1)
                    : no;
          v.z = (r4.z >= 0 && r4.z < rows)
                    ? __ldg(table + static_cast<size_t>(r4.z) * cols + j + 2)
                    : no;
          v.w = (r4.w >= 0 && r4.w < rows)
                    ? __ldg(table + static_cast<size_t>(r4.w) * cols + j + 3)
                    : no;
        } else {
          v = row_ok ? __ldg(reinterpret_cast<const float4*>(src) + u)
                     : make_float4(no, no, no, no);
        }
        epi.put4(e0, u, v);
      } else if (Epi::kPerElement) {
        const int re = __ldg(idx + e0 + u);
        epi.put(e0 + u, (re >= 0 && re < rows)
                            ? __ldg(table + static_cast<size_t>(re) * cols + u)
                            : no);
      } else {
#pragma unroll
        for (int k = 0; k < kW; ++k) {
          const int j = u * kW + k;
          if (kW == 1 || j < cols) epi.put(e0 + j, row_ok ? __ldg(src + j)
                                                          : no);
        }
      }
    }
    epi.end(i, lane, lanes, live);
  }
}

// gather_rows: the values as they are, NaN outside the table.
template <bool kPerElementIdx>
struct CopyRows {
  static constexpr bool kPerElement = kPerElementIdx;
  static constexpr int kScalarUnit = 1;
  static constexpr bool kWholeWarp = false;
  float* out;
  static __device__ float outside() { return NAN; }
  __device__ void begin() {}
  __device__ void put4(int e0, int u, float4 v) {
    reinterpret_cast<float4*>(out + e0)[u] = v;
  }
  __device__ void put(int e, float x) { out[e] = x; }
  __device__ void end(int, int, int, bool) {}
};

// onehot_gather: a zero row outside the table; each value rounded to
// bfloat16 (nearest even) in registers when kBf16.
template <bool kBf16>
struct OneHotRows {
  static constexpr bool kPerElement = false;
  static constexpr int kScalarUnit = 1;
  static constexpr bool kWholeWarp = false;
  float* out;
  static __device__ float outside() { return 0.f; }
  static __device__ float rounded(float x) {
    return kBf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
  }
  __device__ void begin() {}
  __device__ void put4(int e0, int u, float4 v) {
    reinterpret_cast<float4*>(out + e0)[u] =
        make_float4(rounded(v.x), rounded(v.y), rounded(v.z),
                    rounded(v.w));
  }
  __device__ void put(int e, float x) { out[e] = rounded(x); }
  __device__ void end(int, int, int, bool) {}
};

// gather_row_sum: each lane's values summed left to right, then the lanes'
// sums by a butterfly (the order of the header note); NaN outside the
// table (every value of such a row is NaN).
struct RowSum {
  static constexpr bool kPerElement = false;
  static constexpr int kScalarUnit = 4;
  static constexpr bool kWholeWarp = true;
  float* out;
  float acc;
  static __device__ float outside() { return NAN; }
  __device__ void begin() { acc = -0.f; }
  __device__ void put4(int, int, float4 v) {
    acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, v.x), v.y), v.z),
                    v.w);
  }
  __device__ void put(int, float x) { acc = __fadd_rn(acc, x); }
  __device__ void end(int i, int lane, int lanes, bool live) {
    // the whole warp is here (kWholeWarp); an offset below lanes stays in
    // the row's lanes
    for (int off = 1; off < lanes; off <<= 1) {
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    }
    if (live && lane == 0) out[i] = acc;
  }
};

template <bool kVec, bool kPerElement>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ table, int rows, int cols,
                   const int32_t* __restrict__ idx, int m, int lane_shift,
                   float* __restrict__ out) {
  CopyRows<kPerElement> epi{out};
  walk_rows<kVec>(table, rows, cols, idx, m, lane_shift, epi);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_row_sum_kernel(const float* __restrict__ table, int rows, int cols,
                      const int32_t* __restrict__ idx, int m, int lane_shift,
                      float* __restrict__ out) {
  RowSum epi{out, 0.f};
  walk_rows<kVec>(table, rows, cols, idx, m, lane_shift, epi);
}

template <bool kVec, bool kBf16>
__global__ void __launch_bounds__(kThreads)
onehot_gather_kernel(const float* __restrict__ table, int rows, int cols,
                     const int32_t* __restrict__ idx, int m, int lane_shift,
                     float* __restrict__ out) {
  OneHotRows<kBf16> epi{out};
  walk_rows<kVec>(table, rows, cols, idx, m, lane_shift, epi);
}

// How a launch walks its rows: the vector path where cols % 4 == 0 and
// every address in `addr` (or-ed) is 16-byte aligned; 2^lane_shift threads
// a row, the row's units rounded up to a power of two, at most 32; the
// blocks that cover m rows, at most kMaxRowBlocks.
struct Plan {
  bool vec;
  int lane_shift;
  int blocks;
};

Plan plan(int cols, int m, uintptr_t addr, int scalar_unit) {
  Plan p;
  p.vec = cols % 4 == 0 && addr % 16 == 0;
  const int units = p.vec ? cols / 4 : (cols + scalar_unit - 1) / scalar_unit;
  p.lane_shift = 0;
  while (p.lane_shift < 5 && (1 << p.lane_shift) < units) ++p.lane_shift;
  const int rows_per_block = kThreads >> p.lane_shift;
  p.blocks = static_cast<int>(std::min<long long>(
      (static_cast<long long>(m) + rows_per_block - 1) / rows_per_block,
      kMaxRowBlocks));
  return p;
}

bool bad_shape(int rows, int cols, int m) {
  return rows < 1 || cols < 1 || m < 1 ||
         static_cast<long long>(m) * cols >= 0x7fffffffLL;
}

uintptr_t address(const void* p) { return reinterpret_cast<uintptr_t>(p); }

}  // namespace

// Each launch runs on ``stream`` and returns the cudaError_t of the launch
// (0 = success). table (rows, cols) float32, contiguous; idx int32.

// idx (m,) with per_element = 0, or (m, cols) with per_element = 1;
// out (m, cols).
extern "C" int gather_rows_launch(const void* table, int rows, int cols,
                                  const void* idx, int per_element, int m,
                                  void* out, void* stream) {
  if (bad_shape(rows, cols, m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = plan(cols, m,
                      address(table) | address(out) |
                          (per_element ? address(idx) : 0),
                      1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  float* o = static_cast<float*>(out);
  if (p.vec && per_element) {
    gather_rows_kernel<true, true><<<p.blocks, kThreads, 0, s>>>(
        t, rows, cols, ix, m, p.lane_shift, o);
  } else if (p.vec) {
    gather_rows_kernel<true, false><<<p.blocks, kThreads, 0, s>>>(
        t, rows, cols, ix, m, p.lane_shift, o);
  } else if (per_element) {
    gather_rows_kernel<false, true><<<p.blocks, kThreads, 0, s>>>(
        t, rows, cols, ix, m, p.lane_shift, o);
  } else {
    gather_rows_kernel<false, false><<<p.blocks, kThreads, 0, s>>>(
        t, rows, cols, ix, m, p.lane_shift, o);
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
  // units of 4 columns on both paths: the order is the same on both
  const Plan p = plan(cols, m, address(table), 4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  float* o = static_cast<float*>(out);
  if (p.vec) {
    gather_row_sum_kernel<true><<<p.blocks, kThreads, 0, s>>>(
        t, rows, cols, ix, m, p.lane_shift, o);
  } else {
    gather_row_sum_kernel<false><<<p.blocks, kThreads, 0, s>>>(
        t, rows, cols, ix, m, p.lane_shift, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// idx (m,); out (m, cols).
extern "C" int onehot_gather_launch(const void* table, int rows, int cols,
                                    const void* idx, int bf16, int m,
                                    void* out, void* stream) {
  if (bad_shape(rows, cols, m)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = plan(cols, m, address(table) | address(out), 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  float* o = static_cast<float*>(out);
  if (p.vec && bf16) {
    onehot_gather_kernel<true, true><<<p.blocks, kThreads, 0, s>>>(
        t, rows, cols, ix, m, p.lane_shift, o);
  } else if (p.vec) {
    onehot_gather_kernel<true, false><<<p.blocks, kThreads, 0, s>>>(
        t, rows, cols, ix, m, p.lane_shift, o);
  } else if (bf16) {
    onehot_gather_kernel<false, true><<<p.blocks, kThreads, 0, s>>>(
        t, rows, cols, ix, m, p.lane_shift, o);
  } else {
    onehot_gather_kernel<false, false><<<p.blocks, kThreads, 0, s>>>(
        t, rows, cols, ix, m, p.lane_shift, o);
  }
  return static_cast<int>(cudaGetLastError());
}
