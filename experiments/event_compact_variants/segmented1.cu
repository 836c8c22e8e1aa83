// The segmented event_compact before its redesign: one CTA a segment, which
// walks the segment's 512-lane chunks twice, one after the other (counting,
// then scanning and writing). Kept as the yardstick of the port's
// cooperative kernel: chip_smoke.py builds it beside the library, holds it
// bit-exact on phase 24c's rows and times it there as `first_ms`; also
// listed in experiments/torch_event_compact_variants.py. Its C entry point
// hanabi_event_compact_segmented takes no scratch:
// (mask, count, payload, out_slot, out_count, out_payload, num_events, I, n, W, stream).
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
// with W = 3 moves ~2 MB (0.0006 ms at 3.35 TB/s); the launch, the chain
// of dependent memory latencies and the barrier dominate. The first
// version ran three dependent launches (block counts, a single-block scan,
// a block-scan scatter): three launch floors, 0.0090 ms. This design's
// floor, a cooperative launch of the same grid whose kernel loads a word,
// crosses one grid.sync() and reads a scratch word, is 0.0047 ms on an
// H100 (experiments/torch_event_compact_variants.py, probe4).
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
//      its scratch word, and meanwhile stages its first chunk's payload
//      (512 x W contiguous words) in shared memory with coalesced 16-byte
//      loads; cooperative_groups' grid.sync() (no -rdc=true needed);
//   3. each CTA sums the scratch words before its own (its first active
//      destination) and all of them (num_events), then walks its chunks
//      (a later chunk reloads its lanes and stages its payload): a block
//      scan of the active flags orders the chunk's lanes, active first, in
//      shared memory, and the chunk's outputs, two contiguous runs of rows
//      (its active lanes at `before`, its inactive ones at num_events +
//      inactive lanes before it), are written with coalesced stores.
// The first one-launch version wrote each lane's slot, count and W words
// at its own destination, 4- and 8-byte stores that touch a sector each:
// 0.0077 ms at the firework's shape, and 2x the three-launch version's
// time at 1.5M-4M lanes. Payloads wider than 20 words (40 KB a chunk) are
// read from global memory in the write loop instead of staged.
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
constexpr int kMaxBlocksPerSM = 16;          // caps the grid, and the scratch words each CTA sums
constexpr int kMaxStagedW = 20;              // payload words a lane staged: 40 KB a chunk
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

// Sums of two long longs a thread over the CTA, in every thread.
__device__ __forceinline__ longlong2 block_sum2(long long a, long long b, longlong2* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = make_longlong2(a, b);
  __syncthreads();
  longlong2 all = make_longlong2(0, 0);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    all.x += warp_sums[w].x;
    all.y += warp_sums[w].y;
  }
  __syncthreads();
  return all;
}

// dst[k] = src[k] for k < count over the CTA, kBatch loads a thread issued
// before their stores, so their latencies overlap.
template <typename T, int kBatch>
__device__ __forceinline__ void copy_batched(const T* __restrict__ src, T* dst, int count) {
  for (int base = threadIdx.x; base < count; base += kBatch * kThreads) {
    T v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = base + u * kThreads;
      if (k < count) v[u] = __ldg(src + k);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = base + u * kThreads;
      if (k < count) dst[k] = v[u];
    }
  }
}

// Stage chunk c's payload words (its lanes' W words, contiguous) in shared
// memory: 16-byte loads where `payload` is 16-byte aligned (a chunk's
// 512 * W words start 16-byte aligned then).
__device__ __forceinline__ void stage_payload(const int32_t* __restrict__ payload, long long c,
                                              long long n, int W, bool vec, int32_t* stage) {
  const long long first = c * kChunk;
  const int words = (int)min((long long)kChunk, n - first) * W;
  const int32_t* src = payload + first * W;
  int done = 0;
  if (vec) {
    copy_batched<int4, 4>(reinterpret_cast<const int4*>(src), reinterpret_cast<int4*>(stage),
                          words >> 2);
    done = words & ~3;
  }
  copy_batched<int32_t, 8>(src + done, stage + done, words - done);
}

__global__ void __launch_bounds__(kThreads)
    event_compact_kernel(const uint8_t* __restrict__ mask, const long long* __restrict__ count,
                         const int32_t* __restrict__ payload, long long* __restrict__ out_slot,
                         long long* __restrict__ out_count, int32_t* __restrict__ out_payload,
                         int* __restrict__ num_events, int* __restrict__ block_totals, long long n,
                         int W, long long n_chunks, long long chunks_per_block, int wide,
                         int staged) {
  extern __shared__ int4 stage4[];  // a chunk's payload words where `staged`
  int32_t* stage = reinterpret_cast<int32_t*>(stage4);
  __shared__ short order[kChunk];   // the lane each row of the chunk's output takes
  __shared__ long long counts[kChunk];  // and its count (0 for an inactive lane)
  __shared__ int warp_ints[kWarps];
  __shared__ longlong2 warp_sums[kWarps];
  const long long c0 = (long long)blockIdx.x * chunks_per_block;
  const long long c1 = min(c0 + chunks_per_block, n_chunks);
  const long long lane0 = (long long)threadIdx.x * kLanes;
  const bool vec = (reinterpret_cast<uintptr_t>(payload) & 15) == 0;
  bool act[kLanes];  // the lanes of the chunk being scattered (first: c0)
  long long cnt[kLanes];
  bool act_k[kLanes];
  long long cnt_k[kLanes];

  // 1. the active lanes of this CTA's chunks; chunk c0's lanes stay in
  // registers and its payload is staged while the counts are summed
  long long mine = 0;
  if (c0 < c1) {
    mine = load_lanes(mask, count, c0 * kChunk + lane0, n, wide != 0, act, cnt);
    if (staged) stage_payload(payload, c0, n, W, vec, stage);
  }
  for (long long c = c0 + 1; c < c1; ++c)
    mine += load_lanes(mask, count, c * kChunk + lane0, n, wide != 0, act_k, cnt_k);
  const longlong2 block_total = block_sum2(mine, 0, warp_sums);
  if (threadIdx.x == 0) block_totals[blockIdx.x] = (int)block_total.x;
  cg::this_grid().sync();

  // 2. active lanes before this CTA's first lane, and in all
  long long before = 0, all = 0;
#pragma unroll 8
  for (int k = threadIdx.x; k < (int)gridDim.x; k += kThreads) {
    const long long v = block_totals[k];
    all += v;
    before += k < (int)blockIdx.x ? v : 0;
  }
  const longlong2 sums = block_sum2(before, all, warp_sums);
  before = sums.x;
  all = sums.y;
  if (blockIdx.x == 0 && threadIdx.x == 0) *num_events = (int)all;

  // 3. scatter: an active lane goes to (active lanes before it), an inactive
  // one to num_events + (inactive lanes before it)
  for (long long c = c0; c < c1; ++c) {
    const long long first = c * kChunk;
    const int L = (int)min((long long)kChunk, n - first);  // the chunk's lanes
    if (c != c0) {
      __syncthreads();  // every thread is done with the last chunk's stage and order
      load_lanes(mask, count, first + lane0, n, wide != 0, act, cnt);
      if (staged) stage_payload(payload, c, n, W, vec, stage);
    }
    int mine_a = 0;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) mine_a += act[j] ? 1 : 0;
    int a;  // the chunk's active lanes; the scan's barriers also publish the stage
    int r = block_exclusive_scan(mine_a, warp_ints, &a);
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int l = threadIdx.x * kLanes + j;
      if (l < L) {
        const int q = act[j] ? r : a + (l - r);
        order[q] = (short)l;
        counts[q] = act[j] ? cnt[j] : 0;
        r += act[j] ? 1 : 0;
      }
    }
    __syncthreads();
    // row q < a goes to before + q; row q >= a, the chunk's (q - a)-th
    // inactive lane, to all + (first - before) + (q - a)
    const long long shift_i = all + (first - before) - a;
    for (int q = threadIdx.x; q < L; q += kThreads) {
      const int l = order[q];
      const long long row = (q < a ? before : shift_i) + q;
      out_slot[row] = first + l;
      out_count[row] = counts[q];
    }
    for (int x = threadIdx.x; x < L * W; x += kThreads) {
      const int q = x / W;
      const int l = order[q];
      const int w = x - q * W;
      out_payload[(q < a ? before : shift_i) * W + x] =
          staged ? stage[l * W + w] : __ldg(payload + (first + l) * W + w);
    }
    before += a;
  }
}

// event_compact_segmented: I independent compactions of N lanes each, one
// launch. An instanced group (InstancedEffect) steps I instances as one
// flat [I*N] pass; the JAX package vmaps its step over the instance axis
// (runtime/instanced.py:53-59, 111-121), so an emitting asset's event build
// (events.py:124-159) becomes I stable sorts, one for each row of [I, N].
// Segment s's output rows are s*N .. s*N + N - 1: its active lanes in lane
// order, then its inactive lanes in lane order, slot the lane's index in
// its segment, count zeroed past num_events[s]. A segment's total is its
// own, so no grid barrier is needed: one CTA a segment walks the
// segment's 512-lane chunks twice, first counting its active lanes (its
// num_events, where its inactive rows start), then ordering each chunk
// by the block scan above and writing it as the one-array kernel does.
// Bound: the same bytes as I launches of the one-array kernel. A segment
// is serial in its CTA (a chunk's latency chain twice), so the design
// fills the card where I is near the SM count or above (the instanced
// groups' 64-4096 instances of 1024-4096 lanes) and is slow for a few
// segments of 65,536 lanes.
__global__ void __launch_bounds__(kThreads)
    event_compact_segmented_kernel(const uint8_t* __restrict__ mask,
                                   const long long* __restrict__ count,
                                   const int32_t* __restrict__ payload,
                                   long long* __restrict__ out_slot,
                                   long long* __restrict__ out_count,
                                   int32_t* __restrict__ out_payload, int* __restrict__ num_events,
                                   long long n, int W, int wide, int staged) {
  extern __shared__ int4 stage4[];
  int32_t* stage = reinterpret_cast<int32_t*>(stage4);
  __shared__ short order[kChunk];
  __shared__ long long counts[kChunk];
  __shared__ int warp_ints[kWarps];
  __shared__ longlong2 warp_sums[kWarps];
  const long long base = (long long)blockIdx.x * n;  // the segment's first lane
  mask += base;
  count += base;
  payload += base * W;
  out_slot += base;
  out_count += base;
  out_payload += base * W;
  // mask 4-byte and count 16-byte aligned at the segment's start
  const bool wide_s = wide != 0 && base % 4 == 0;
  const bool vec = (reinterpret_cast<uintptr_t>(payload) & 15) == 0;
  const long long n_chunks = (n + kChunk - 1) / kChunk;
  const long long lane0 = (long long)threadIdx.x * kLanes;
  bool act[kLanes];  // the lanes of the chunk loaded last
  long long cnt[kLanes];

  // 1. the segment's active lanes
  long long mine = 0;
  for (long long c = 0; c < n_chunks; ++c)
    mine += load_lanes(mask, count, c * kChunk + lane0, n, wide_s, act, cnt);
  const long long all = block_sum2(mine, 0, warp_sums).x;
  if (threadIdx.x == 0) num_events[blockIdx.x] = (int)all;

  // 2. each chunk: an active lane to (active lanes before it), an inactive
  // one to all + (inactive lanes before it)
  long long before = 0;
  for (long long c = 0; c < n_chunks; ++c) {
    const long long first = c * kChunk;
    const int L = (int)min((long long)kChunk, n - first);
    if (c > 0) __syncthreads();  // every thread is done with the last chunk's stage and order
    if (n_chunks > 1) load_lanes(mask, count, first + lane0, n, wide_s, act, cnt);
    if (staged) stage_payload(payload, c, n, W, vec, stage);
    int mine_a = 0;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) mine_a += act[j] ? 1 : 0;
    int a;  // the chunk's active lanes; the scan's barriers also publish the stage
    int r = block_exclusive_scan(mine_a, warp_ints, &a);
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int l = threadIdx.x * kLanes + j;
      if (l < L) {
        const int q = act[j] ? r : a + (l - r);
        order[q] = (short)l;
        counts[q] = act[j] ? cnt[j] : 0;
        r += act[j] ? 1 : 0;
      }
    }
    __syncthreads();
    const long long shift_i = all + (first - before) - a;
    for (int q = threadIdx.x; q < L; q += kThreads) {
      const long long row = (q < a ? before : shift_i) + q;
      out_slot[row] = first + order[q];
      out_count[row] = counts[q];
    }
    for (int x = threadIdx.x; x < L * W; x += kThreads) {
      const int q = x / W;
      const int l = order[q];
      const int w = x - q * W;
      out_payload[(q < a ? before : shift_i) * W + x] =
          staged ? stage[l * W + w] : __ldg(payload + (first + l) * W + w);
    }
    before += a;
  }
}

struct Grid {
  int sms = 0;
  int per_sm = 0;
};

// SMs and resident CTAs an SM for a payload of W staged words (W = 0: none
// staged), once a device and W.
const Grid& device_grid(int dev, int W) {
  static Grid grids[64][kMaxStagedW + 1];
  Grid& g = grids[dev & 63][W];
  if (g.sms == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, event_compact_kernel, kThreads,
                                                  (size_t)kChunk * W * sizeof(int32_t));
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
  int staged = W > 0 && W <= kMaxStagedW;
  const size_t smem = staged ? (size_t)kChunk * W * sizeof(int32_t) : 0;
  const Grid& g = device_grid(dev, staged ? W : 0);
  if (g.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long n_chunks = std::max(1LL, (n + kChunk - 1) / kChunk);
  const long long max_grid = (long long)g.sms * g.per_sm;
  long long per = (n_chunks + max_grid - 1) / max_grid;
  int grid = (int)((n_chunks + per - 1) / per);  // <= n_chunks: one scratch int each
  int wide = ((uintptr_t)mask % 4 == 0) && ((uintptr_t)count % 16 == 0);
  void* args[] = {(void*)&mask,     (void*)&count,      (void*)&payload, (void*)&out_slot,
                  (void*)&out_count, (void*)&out_payload, (void*)&num_events, (void*)&scratch,
                  (void*)&n,        (void*)&W,          (void*)&n_chunks, (void*)&per,
                  (void*)&wide,     (void*)&staged};
  err = cudaLaunchCooperativeKernel((const void*)event_compact_kernel, dim3(grid), dim3(kThreads),
                                    args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}


// I segments of n lanes: mask [I*n], count [I*n], payload [I*n, W] in,
// slot, count [I*n], payload [I*n, W] and num_events [I] out; one CTA a
// segment, one launch.
extern "C" int hanabi_event_compact_segmented(const void* mask, const void* count,
                                              const void* payload, void* out_slot,
                                              void* out_count, void* out_payload,
                                              void* num_events, int I, long long n, int W,
                                              void* stream) {
  if (I <= 0) return (int)cudaGetLastError();
  const int staged = W > 0 && W <= kMaxStagedW;
  const size_t smem = staged ? (size_t)kChunk * W * sizeof(int32_t) : 0;
  const int wide = ((uintptr_t)mask % 4 == 0) && ((uintptr_t)count % 16 == 0);
  event_compact_segmented_kernel<<<I, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (const long long*)count, (const int32_t*)payload,
      (long long*)out_slot, (long long*)out_count, (int32_t*)out_payload, (int*)num_events, n, W,
      wide, staged);
  return (int)cudaGetLastError();
}
