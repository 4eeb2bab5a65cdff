// Stage marks of the span recorder (utils/tracing.py).
//
// One single-thread kernel a stage, named by its tag type, so that a
// profiler's trace shows which stage of a dense step starts after it
// (``span_mark<stage_prep>``, ...). Each writes ``%globaltimer`` (ns) and
// its stage id into its slot of a static (MARK_SLOTS, 2) int64 buffer. The
// ids are the order of ``tracing.STAGES``.

#include <cuda_runtime.h>

struct stage_prep { static constexpr long long id = 0; };
struct stage_map { static constexpr long long id = 1; };
struct stage_field { static constexpr long long id = 2; };
struct stage_raster { static constexpr long long id = 3; };
struct stage_solve { static constexpr long long id = 4; };
struct stage_end { static constexpr long long id = 5; };

template <class Stage>
__global__ void span_mark(long long* slots, int slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  slots[2 * slot] = static_cast<long long>(t);
  slots[2 * slot + 1] = Stage::id;
}

template <class Stage>
static int launch(long long* slots, int slot, cudaStream_t stream) {
  span_mark<Stage><<<1, 1, 0, stream>>>(slots, slot);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int span_mark_launch(int stage, void* slots, int slot,
                                void* stream) {
  long long* p = static_cast<long long*>(slots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: return launch<stage_prep>(p, slot, s);
    case 1: return launch<stage_map>(p, slot, s);
    case 2: return launch<stage_field>(p, slot, s);
    case 3: return launch<stage_raster>(p, slot, s);
    case 4: return launch<stage_solve>(p, slot, s);
    case 5: return launch<stage_end>(p, slot, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
