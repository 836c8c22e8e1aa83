// Floors of event_compact's one-launch design, timed beside the port's
// kernel by experiments/torch_event_compact_variants.py (its results are
// not a compaction and are not compared). Its C entry point is the port's;
// it ignores the inputs and launches, over the grid the port's kernel
// takes at the firework's shape (128 CTAs of 128 threads at n = 65,536):
//   HANABI_PROBE=1  an empty kernel, an ordinary launch;
//   HANABI_PROBE=2  an empty kernel, a cooperative launch;
//   HANABI_PROBE=3  a cooperative launch whose kernel runs one grid.sync();
//   HANABI_PROBE=4  as 3, with one load of a mask word and a scratch write
//                   before the barrier and one scratch read after it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 512;

__global__ void probe_kernel(const uint8_t* mask, int* scratch, int* num_events) {
#if HANABI_PROBE >= 3
#if HANABI_PROBE >= 4
  const unsigned m = __ldg(reinterpret_cast<const unsigned*>(mask) + blockIdx.x * kThreads + threadIdx.x);
  const int c = __syncthreads_count(m != 0);
  if (threadIdx.x == 0) scratch[blockIdx.x] = c;
#endif
  cg::this_grid().sync();
#if HANABI_PROBE >= 4
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    int all = 0;
    for (int k = 0; k < (int)gridDim.x; ++k) all += scratch[k];
    *num_events = all;
  }
#endif
#endif
}

}  // namespace

extern "C" int hanabi_event_compact(const void* mask, const void*, const void*, void*, void*, void*,
                                    void* num_events, void* scratch, long long n, int, void* stream) {
  const int grid = (int)((n + kChunk - 1) / kChunk);
  cudaStream_t s = (cudaStream_t)stream;
#if HANABI_PROBE == 1
  probe_kernel<<<grid, kThreads, 0, s>>>((const uint8_t*)mask, (int*)scratch, (int*)num_events);
#else
  void* args[] = {(void*)&mask, (void*)&scratch, (void*)&num_events};
  cudaLaunchCooperativeKernel((const void*)probe_kernel, dim3(grid), dim3(kThreads), args, 0, s);
#endif
  return (int)cudaGetLastError();
}
