// The first version of the port's event_compact (three launches: block
// counts, a single-block scan, a block-scan scatter), kept to be timed
// beside the port's kernel by experiments/torch_event_compact_variants.py.
// Its C entry point is the port's; the scratch holds one int a 1024 lanes.
//
// event_compact: the stable partition that compacts one event channel.
//
// Replaces the XLA region at bevy_hanabi_tpu/runtime/events.py:124-159
// (`build_event_buffer`): one stable multi-operand `lax.sort` on the
// inactive flag that carries the lane id, the count and every 32-bit word
// of the payload. The JAX package has no Pallas kernel for it.
//
// Input: mask [n] bool, count [n] int64 (uint32 values), payload [n, W]
// int32 words (the f32 payload bit patterns). Output: slot [n] and count [n]
// int64, payload [n, W] int32, num_events int32. Active lanes (mask and
// count > 0) come first in lane order, inactive lanes follow in lane order,
// and count is zeroed past num_events: the buffer equals the JAX package's
// bit for bit.
//
// Bound on the H100: nothing at the firework's shape. n = 65,536 rockets
// with W = 3 moves ~2 MB; the three launches and their dependency dominate
// (a few microseconds each). The sort it replaces is 4+ radix passes over
// all operands.
//
// Design, simple and correct first:
//   1. count_kernel: active lanes per block of 1024 (__syncthreads_count);
//   2. scan_kernel: one block turns the block counts into exclusive offsets
//      in place and writes the total (num_events);
//   3. scatter_kernel: a block-wide scan of the active flags gives each
//      lane its rank; active lane -> rank, inactive lane -> num_events +
//      (inactive lanes before it). Each lane writes slot, count and its W
//      words. A single pass with decoupled look-back is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool lane_active(const uint8_t* mask, const long long* count,
                                            long long i, long long n) {
  return i < n && mask[i] != 0 && count[i] > 0;
}

// Inclusive scan of one int per thread over a block of kThreads threads.
// Every thread of the block must call it.
__device__ int block_inclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int r = x + (warp > 0 ? warp_sums[warp - 1] : 0);
  __syncthreads();  // warp_sums is reused by the next call
  return r;
}

__global__ void count_kernel(const uint8_t* __restrict__ mask, const long long* __restrict__ count,
                             int* __restrict__ block_counts, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int c = __syncthreads_count(lane_active(mask, count, i, n));
  if (threadIdx.x == 0) block_counts[blockIdx.x] = c;
}

__global__ void scan_kernel(int* __restrict__ block_counts, int nb, int* __restrict__ num_events) {
  __shared__ int warp_sums[32];
  __shared__ int chunk_total;
  int carry = 0;
  for (int base = 0; base < nb; base += kThreads) {
    const int b = base + threadIdx.x;
    const int v = b < nb ? block_counts[b] : 0;
    const int incl = block_inclusive_scan(v, warp_sums);
    if (b < nb) block_counts[b] = carry + incl - v;
    if (threadIdx.x == kThreads - 1) chunk_total = incl;
    __syncthreads();
    carry += chunk_total;
    __syncthreads();
  }
  if (threadIdx.x == 0) *num_events = carry;
}

__global__ void scatter_kernel(const uint8_t* __restrict__ mask, const long long* __restrict__ count,
                               const int32_t* __restrict__ payload,
                               const int* __restrict__ block_offsets,
                               const int* __restrict__ num_events,
                               long long* __restrict__ out_slot, long long* __restrict__ out_count,
                               int32_t* __restrict__ out_payload, long long n, int W) {
  __shared__ int warp_sums[32];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool active = lane_active(mask, count, i, n);
  const int incl = block_inclusive_scan(active ? 1 : 0, warp_sums);
  if (i >= n) return;
  // active lanes strictly before lane i
  const long long before = (long long)block_offsets[blockIdx.x] + incl - (active ? 1 : 0);
  const long long dst = active ? before : (long long)*num_events + (i - before);
  out_slot[dst] = i;
  out_count[dst] = active ? count[i] : 0;
  const int32_t* src = payload + i * W;
  int32_t* d = out_payload + dst * W;
  for (int w = 0; w < W; ++w) d[w] = src[w];
}

}  // namespace

extern "C" int hanabi_event_compact(const void* mask, const void* count, const void* payload,
                                    void* out_slot, void* out_count, void* out_payload,
                                    void* num_events, void* scratch, long long n, int W,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    const int nb = (int)((n + kThreads - 1) / kThreads);
    count_kernel<<<nb, kThreads, 0, s>>>((const uint8_t*)mask, (const long long*)count,
                                         (int*)scratch, n);
    scan_kernel<<<1, kThreads, 0, s>>>((int*)scratch, nb, (int*)num_events);
    scatter_kernel<<<nb, kThreads, 0, s>>>(
        (const uint8_t*)mask, (const long long*)count, (const int32_t*)payload,
        (const int*)scratch, (const int*)num_events, (long long*)out_slot,
        (long long*)out_count, (int32_t*)out_payload, n, W);
  } else {
    cudaMemsetAsync(num_events, 0, sizeof(int), s);
  }
  return (int)cudaGetLastError();
}
