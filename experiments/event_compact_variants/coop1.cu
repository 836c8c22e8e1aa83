// The first one-launch event_compact: the cooperative kernel with one
// grid.sync(), whose scatter copies each lane's W payload words straight
// from global memory (a load, then its store, W times a lane). Kept to be
// timed beside the port's kernel by experiments/torch_event_compact_variants.py.
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
// with W = 3 moves ~2 MB (0.0006 ms at 3.35 TB/s); the launch and the
// dependency between counting and scattering dominate. The first version
// ran three dependent launches (block counts, a single-block scan, a
// block-scan scatter): three launch floors, 0.0090 ms.
//
// Design: one persistent cooperative launch with one grid-wide barrier.
// The difficulty is that an inactive lane's destination, num_events +
// (inactive lanes before it), needs the grand total, which a single pass
// with decoupled look-back does not give a CTA. So:
//   1. the grid is sized so that every CTA is resident
//      (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, capped) and
//      launched with cudaLaunchCooperativeKernel; CTA b owns a contiguous
//      run of 512-lane chunks (one at n = 65,536: 128 CTAs; more at larger
//      n, in a loop), a thread 4 lanes, read with one 4-byte mask load and
//      two 16-byte count loads;
//   2. each CTA counts the active lanes of its run and writes the total to
//      its scratch word; cooperative_groups' grid.sync();
//   3. each CTA sums the scratch words before its own (its first active
//      destination) and all of them (num_events), then walks its chunks
//      again (from L2): a block scan of the lanes' active flags gives each
//      lane its destination, and it writes slot, count and its W words.
// Every scratch word is written before the barrier in the same call, so no
// memset runs; n = 0 is one CTA that writes num_events = 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 4;                    // lanes a thread
constexpr int kChunk = kThreads * kLanes;    // lanes a CTA scans at once
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocksPerSM = 4;           // caps the grid, and the scratch words each CTA sums
constexpr unsigned kFull = 0xffffffffu;

// The active flags and counts of lanes i0 .. i0 + 3 (i0 a multiple of 4);
// returns how many are active. `wide`: mask is 4-byte and count 16-byte
// aligned, so a full group loads with one 4-byte and two 16-byte loads.
__device__ __forceinline__ int load_lanes(const uint8_t* __restrict__ mask,
                                          const long long* __restrict__ count, long long i0,
                                          long long n, bool wide, bool act[kLanes],
                                          long long cnt[kLanes]) {
  if (wide && i0 + kLanes <= n) {
    const unsigned m = __ldg(reinterpret_cast<const unsigned*>(mask + i0));
    const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(count + i0));
    const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(count + i0 + 2));
    cnt[0] = a.x;
    cnt[1] = a.y;
    cnt[2] = b.x;
    cnt[3] = b.y;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) act[j] = ((m >> (8 * j)) & 0xffu) != 0 && cnt[j] > 0;
  } else {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const long long i = i0 + j;
      const bool in = i < n;
      cnt[j] = in ? __ldg(count + i) : 0;
      act[j] = in && __ldg(mask + i) != 0 && cnt[j] > 0;
    }
  }
  int a = 0;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) a += act[j] ? 1 : 0;
  return a;
}

// Exclusive scan of one int a thread over the CTA, and the CTA's total.
// Every thread of the CTA must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = warp_sums[w];
    before += w < warp ? s : 0;
    all += s;
  }
  __syncthreads();  // warp_sums is reused by the next call
  *total = all;
  return before + x - v;
}

// Sum of one long long a thread over the CTA, in every thread.
__device__ __forceinline__ long long block_sum(long long v, long long* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  long long all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) all += warp_sums[w];
  __syncthreads();
  return all;
}

__global__ void __launch_bounds__(kThreads)
    event_compact_kernel(const uint8_t* __restrict__ mask, const long long* __restrict__ count,
                         const int32_t* __restrict__ payload, long long* __restrict__ out_slot,
                         long long* __restrict__ out_count, int32_t* __restrict__ out_payload,
                         int* __restrict__ num_events, int* __restrict__ block_totals, long long n,
                         int W, long long n_chunks, long long chunks_per_block, int wide) {
  __shared__ int warp_ints[kWarps];
  __shared__ long long warp_sums[kWarps];
  const long long c0 = (long long)blockIdx.x * chunks_per_block;
  const long long c1 = min(c0 + chunks_per_block, n_chunks);
  const long long lane0 = (long long)threadIdx.x * kLanes;
  bool act[kLanes];
  long long cnt[kLanes];

  // 1. the active lanes of this CTA's chunks
  long long mine = 0;
  for (long long c = c0; c < c1; ++c)
    mine += load_lanes(mask, count, c * kChunk + lane0, n, wide != 0, act, cnt);
  const long long block_total = block_sum(mine, warp_sums);
  if (threadIdx.x == 0) block_totals[blockIdx.x] = (int)block_total;
  cg::this_grid().sync();

  // 2. active lanes before this CTA's first lane, and in all
  long long before = 0, all = 0;
  for (int k = threadIdx.x; k < (int)gridDim.x; k += kThreads) {
    const long long v = block_totals[k];
    all += v;
    before += k < (int)blockIdx.x ? v : 0;
  }
  before = block_sum(before, warp_sums);
  all = block_sum(all, warp_sums);
  if (blockIdx.x == 0 && threadIdx.x == 0) *num_events = (int)all;

  // 3. scatter: an active lane goes to (active lanes before it), an inactive
  // one to num_events + (inactive lanes before it)
  for (long long c = c0; c < c1; ++c) {
    const long long i0 = c * kChunk + lane0;
    const int a = load_lanes(mask, count, i0, n, wide != 0, act, cnt);
    int chunk_total;
    long long k = before + block_exclusive_scan(a, warp_ints, &chunk_total);
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const long long i = i0 + j;
      if (i >= n) break;
      const long long dst = act[j] ? k : all + (i - k);
      out_slot[dst] = i;
      out_count[dst] = act[j] ? cnt[j] : 0;
      const int32_t* src = payload + i * W;
      int32_t* d = out_payload + dst * W;
      for (int w = 0; w < W; ++w) d[w] = __ldg(src + w);
      k += act[j] ? 1 : 0;
    }
    before += chunk_total;
  }
}

struct Grid {
  int sms = 0;
  int per_sm = 0;
};

// SMs and resident CTAs an SM, once a device.
const Grid& device_grid(int dev) {
  static Grid grids[64];
  Grid& g = grids[dev & 63];
  if (g.sms == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, event_compact_kernel, kThreads, 0);
    g.per_sm = std::min(per_sm, kMaxBlocksPerSM);
    g.sms = sms;
  }
  return g;
}

}  // namespace

// The lanes a CTA scans at once: the wrapper's scratch holds one int for
// each chunk of this many lanes (at least one).
extern "C" int hanabi_event_compact_chunk() { return kChunk; }

extern "C" int hanabi_event_compact(const void* mask, const void* count, const void* payload,
                                    void* out_slot, void* out_count, void* out_payload,
                                    void* num_events, void* scratch, long long n, int W,
                                    void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const Grid& g = device_grid(dev);
  if (g.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long n_chunks = std::max(1LL, (n + kChunk - 1) / kChunk);
  const long long max_grid = (long long)g.sms * g.per_sm;
  long long per = (n_chunks + max_grid - 1) / max_grid;
  int grid = (int)((n_chunks + per - 1) / per);  // <= n_chunks: one scratch int each
  int wide = ((uintptr_t)mask % 4 == 0) && ((uintptr_t)count % 16 == 0);
  void* args[] = {(void*)&mask,     (void*)&count,      (void*)&payload, (void*)&out_slot,
                  (void*)&out_count, (void*)&out_payload, (void*)&num_events, (void*)&scratch,
                  (void*)&n,        (void*)&W,          (void*)&n_chunks, (void*)&per,
                  (void*)&wide};
  err = cudaLaunchCooperativeKernel((const void*)event_compact_kernel, dim3(grid), dim3(kThreads),
                                    args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
