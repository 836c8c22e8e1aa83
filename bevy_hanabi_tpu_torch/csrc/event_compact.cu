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
constexpr int kMaxCluster = 8;               // the portable cluster size: a segment's chunks
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
// its segment, count zeroed past num_events[s].
//
// Bound: the bytes, each input read once and each output written once,
// 89 B a lane at W = 8: 0.0279 ms at 256 x 4096 and 0.0070 ms at
// 4 x 65,536 on 3.35 TB/s; at the instanced firework's 64 x 1024 (5.8 MB,
// 0.0017 ms) the launch and the chain of dependent latencies.
//
// Design: every CTA orders one 512-lane chunk at a time as the one-array
// kernel does, and the I x ceil(N / 512) chunks are spread over the whole
// card. What a chunk needs from the others is its segment's active lanes
// before it and in all; two kernels get them:
//   * N <= kMaxCluster chunks (the instanced groups' 1024-4096 lanes): one
//     CTA a chunk and one thread block cluster a segment, a plain launch of
//     I x ceil(N / 512) CTAs. Each CTA loads, stages and orders its chunk,
//     crosses the cluster barrier, and reads its segment's chunk counts
//     from the other CTAs' shared memory (distributed shared memory): no
//     grid barrier, no residency bound, no scratch.
//   * longer segments: the cooperative kernel below, whose resident grid
//     walks contiguous runs of chunks that may cross segment boundaries,
//     with one grid barrier.
// Times on an H100 80GB HBM3 at 700 W (experiments/
// torch_event_compact_variants.py), against the cooperative kernel for
// every N and the first version (one CTA a segment walking its chunks
// twice, experiments/event_compact_variants/segmented1.cu):
// 64 x 1024 x 8: 0.0064 ms, 0.0080, 0.0110; 256 x 4096 x 8: 0.0432, 0.0488,
// 0.0630; 4096 x 1024 x 8: 0.139, 0.178, 0.145; 3000 x 700 x 8: 0.085,
// 0.101, 0.079 (the second chunk of a segment holds 188 lanes: twice the
// CTAs of the first version for 1.4 chunks of work); 4 x 65,536 x 8
// (cooperative): 0.0132 against 0.597; 1 x 4M x 3: 0.110 against 26.4.
// The cluster barrier costs far less than the cooperative launch and its
// grid barrier (0.0047-0.0051 ms against a plain launch's 0.0020, probe4
// and probe1 of the one-array kernel).
//
// The cluster kernel: chunk k of segment s is CTA s * cps + k, the
// cluster's block rank k. The scan and the order are built before the
// cluster barrier; after it, lane t of each warp reads chunk t's count.
// A CTA's shared memory must outlive the cluster's reads of it, so each
// CTA arrives on a second cluster barrier once its reads are done and
// waits on it only before it exits.
__global__ void __launch_bounds__(kThreads)
    event_compact_cluster_kernel(const uint8_t* __restrict__ mask,
                                 const long long* __restrict__ count,
                                 const int32_t* __restrict__ payload,
                                 long long* __restrict__ out_slot,
                                 long long* __restrict__ out_count,
                                 int32_t* __restrict__ out_payload, int* __restrict__ num_events,
                                 long long n, int W, int cps, int wide, int staged) {
  extern __shared__ int4 stage4[];
  int32_t* stage = reinterpret_cast<int32_t*>(stage4);
  __shared__ short order[kChunk];
  __shared__ long long counts[kChunk];
  __shared__ int warp_ints[kWarps];
  __shared__ int chunk_active;  // read by the segment's other CTAs
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.block_rank();  // the chunk in its segment
  const long long s = blockIdx.x / cps;
  const long long base = s * n;
  const int32_t* pay = payload + base * W;
  const long long first = (long long)k * kChunk;
  const int L = (int)min((long long)kChunk, n - first);
  bool act[kLanes];
  long long cnt[kLanes];
  load_lanes(mask + base, count + base, first + (long long)threadIdx.x * kLanes, n,
             wide != 0 && base % 4 == 0, act, cnt);
  if (staged) stage_payload(pay, k, n, W, (reinterpret_cast<uintptr_t>(pay) & 15) == 0, stage);
  int mine_a = 0;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) mine_a += act[j] ? 1 : 0;
  int a;
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
  if (threadIdx.x == 0) chunk_active = a;
  cluster.sync();  // also publishes this CTA's stage, order and counts

  // active lanes of the segment before this chunk and in all: lane t of
  // each warp reads chunk t's count
  const int lane = threadIdx.x & 31;
  const int v = lane < cps ? *cluster.map_shared_rank(&chunk_active, lane) : 0;
  int before = lane < k ? v : 0, all = v;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    before += __shfl_xor_sync(kFull, before, o);
    all += __shfl_xor_sync(kFull, all, o);
  }
  // no more reads of another CTA's shared memory: the peers may exit once
  // every CTA of the cluster has arrived here
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (k == 0 && threadIdx.x == 0) num_events[s] = all;

  const long long shift_i = (long long)all + (first - before) - a;
  long long* slot_s = out_slot + base;
  long long* count_s = out_count + base;
  for (int q = threadIdx.x; q < L; q += kThreads) {
    const long long row = (q < a ? (long long)before : shift_i) + q;
    slot_s[row] = first + order[q];
    count_s[row] = counts[q];
  }
  int32_t* words_s = out_payload + base * W;
  for (int x = threadIdx.x; x < L * W; x += kThreads) {
    const int q = x / W;
    const int l = order[q];
    const int w = x - q * W;
    words_s[(q < a ? (long long)before : shift_i) * W + x] =
        staged ? stage[l * W + w] : __ldg(pay + (first + l) * W + w);
  }
  // this CTA's shared memory stays until the cluster's reads of it are done
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The cooperative kernel, for segments of more than kMaxCluster chunks:
// the one-array kernel's design over the chunks of every segment. The
// I x ceil(N / 512) chunks are numbered segment by segment; the grid is
// sized so that every CTA is resident and launched cooperatively, and CTA
// b owns a contiguous run of chunks, which may cross segment boundaries
// or be one of many runs of one segment (I = 1, N = 4M: 512 CTAs of 16
// chunks, the kernel's 121 registers leaving 4 CTAs an SM; 4 x 65,536: 512
// CTAs of one chunk, where the first version gave each segment one CTA
// while the other SMs idled).
//   1. Each CTA counts the active lanes of its chunks (chunk c0's lanes
//      stay in registers and its payload is staged meanwhile), block-summed
//      once for each segment the run touches. A segment that lies inside
//      the run gets its num_events there; the run's first and last
//      segments, which other CTAs may share, get the CTA's (head, tail)
//      counts in its scratch pair. Every pair is written before the one
//      grid.sync(), so no memset runs.
//   2. The CTAs that share a segment are contiguous, and for each of them
//      the segment is its first or its last: a CTA before b counts in its
//      tail, b and the CTAs after it in their heads. So the run's first
//      segment's lanes before the run and its total are sums over the CTAs
//      that hold its chunks, and the last segment's total a sum over the
//      CTAs after b that hold its chunks: at most one pair a CTA sharing
//      the segment (512 at I = 1, N = 4M), not a word a chunk. The CTA
//      that holds a segment's first chunk writes its num_events.
//   3. Each chunk is ordered by the block scan, active lanes first, and
//      written as two contiguous runs of rows with coalesced stores: its
//      active lanes at `before`, its inactive lanes at num_events[s] +
//      (inactive lanes before them), as the one-array kernel does.
// Both kernels keep the wide loads where a segment's start is 4-lane
// aligned, and read payloads wider than 20 words from global memory in the
// write loop instead of staging them. N = 0 is one empty chunk a segment
// (the cluster kernel), which writes num_events = 0.
__global__ void __launch_bounds__(kThreads)
    event_compact_segmented_kernel(const uint8_t* __restrict__ mask,
                                   const long long* __restrict__ count,
                                   const int32_t* __restrict__ payload,
                                   long long* __restrict__ out_slot,
                                   long long* __restrict__ out_count,
                                   int32_t* __restrict__ out_payload, int* __restrict__ num_events,
                                   int2* __restrict__ ends, long long n, int W, long long cps,
                                   long long n_chunks, long long chunks_per_block, int wide,
                                   int staged) {
  extern __shared__ int4 stage4[];
  int32_t* stage = reinterpret_cast<int32_t*>(stage4);
  __shared__ short order[kChunk];
  __shared__ long long counts[kChunk];
  __shared__ int warp_ints[kWarps];
  __shared__ longlong2 warp_sums[kWarps];
  const long long b = blockIdx.x;
  const long long c0 = b * chunks_per_block;
  const long long c1 = min(c0 + chunks_per_block, n_chunks);  // c0 < c1: the grid has no idle CTA
  const long long s0 = c0 / cps, s1 = (c1 - 1) / cps;  // the run's first and last segments
  const long long k0 = c0 - s0 * cps;                  // c0's chunk in s0
  const long long lane0 = (long long)threadIdx.x * kLanes;
  bool act[kLanes];  // the lanes of the chunk being written (first: c0)
  long long cnt[kLanes];
  bool act_k[kLanes];
  long long cnt_k[kLanes];

  // 1. the active lanes of each segment of the run; chunk c0's lanes stay
  // in registers and its payload is staged while the counts are summed
  {
    const long long base = s0 * n;
    const bool wide_s = wide != 0 && base % 4 == 0;  // mask 4-, count 16-byte aligned there
    const int32_t* pay = payload + base * W;
    const bool vec = (reinterpret_cast<uintptr_t>(pay) & 15) == 0;
    load_lanes(mask + base, count + base, k0 * kChunk + lane0, n, wide_s, act, cnt);
    if (staged) stage_payload(pay, k0, n, W, vec, stage);
  }
  long long mine = 0;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) mine += act[j] ? 1 : 0;
  int head = 0;  // active lanes of the run in s0 (block-uniform)
  long long s = s0, k = k0;
  for (long long c = c0 + 1; c < c1; ++c) {
    if (++k == cps) {  // segment s ends with chunk c - 1
      const int t = (int)block_sum2(mine, 0, warp_sums).x;
      if (s == s0)
        head = t;
      else if (threadIdx.x == 0)
        num_events[s] = t;  // a segment inside the run
      mine = 0;
      k = 0;
      ++s;
    }
    const long long base = s * n;
    mine += load_lanes(mask + base, count + base, k * kChunk + lane0, n,
                       wide != 0 && base % 4 == 0, act_k, cnt_k);
  }
  const int tail = (int)block_sum2(mine, 0, warp_sums).x;  // active lanes of the run in s1
  if (s0 == s1) head = tail;
  if (threadIdx.x == 0) ends[b] = make_int2(head, tail);
  cg::this_grid().sync();

  // 2. s0's active lanes before this run and in all, over the CTAs that
  // hold its chunks; s1's total where it is not s0
  const long long b_first = (s0 * cps) / chunks_per_block;
  long long before = 0, all = 0;
  for (long long q = b_first + threadIdx.x; q <= ((s0 + 1) * cps - 1) / chunks_per_block;
       q += kThreads) {
    const int2 e = ends[q];
    const long long v = q < b ? e.y : e.x;
    before += q < b ? v : 0;
    all += v;
  }
  const longlong2 sums = block_sum2(before, all, warp_sums);
  before = sums.x;
  all = sums.y;
  long long all_last = 0;
  if (s1 != s0) {
    long long later = 0;
    for (long long q = b + 1 + threadIdx.x; q <= ((s1 + 1) * cps - 1) / chunks_per_block;
         q += kThreads)
      later += ends[q].x;
    all_last = tail + block_sum2(later, 0, warp_sums).x;
  }
  if (threadIdx.x == 0) {
    if (b_first == b) num_events[s0] = (int)all;
    if (s1 != s0) num_events[s1] = (int)all_last;
  }

  // 3. each chunk: an active lane to (active lanes before it in its
  // segment), an inactive one to all + (inactive lanes before it)
  s = s0;
  k = k0;
  for (long long c = c0; c < c1; ++c) {
    if (c != c0 && ++k == cps) {
      k = 0;
      ++s;
      before = 0;
      all = s == s1 ? all_last : num_events[s];
    }
    const long long base = s * n;
    const int32_t* pay = payload + base * W;
    const long long first = k * kChunk;
    const int L = (int)min((long long)kChunk, n - first);
    if (c != c0) {
      __syncthreads();  // every thread is done with the last chunk's stage and order
      load_lanes(mask + base, count + base, first + lane0, n, wide != 0 && base % 4 == 0, act,
                 cnt);
      if (staged)
        stage_payload(pay, k, n, W, (reinterpret_cast<uintptr_t>(pay) & 15) == 0, stage);
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
    const long long shift_i = all + (first - before) - a;
    long long* slot_s = out_slot + base;
    long long* count_s = out_count + base;
    for (int q = threadIdx.x; q < L; q += kThreads) {
      const long long row = (q < a ? before : shift_i) + q;
      slot_s[row] = first + order[q];
      count_s[row] = counts[q];
    }
    int32_t* words_s = out_payload + base * W;
    for (int x = threadIdx.x; x < L * W; x += kThreads) {
      const int q = x / W;
      const int l = order[q];
      const int w = x - q * W;
      words_s[(q < a ? before : shift_i) * W + x] =
          staged ? stage[l * W + w] : __ldg(pay + (first + l) * W + w);
    }
    before += a;
  }
}

struct Grid {
  int sms = 0;
  int per_sm = 0;
};

// SMs and resident CTAs an SM of the one-array (segmented = 0) or the
// segmented kernel for a payload of W staged words (W = 0: none staged),
// once a device, kernel and W.
const Grid& device_grid(int dev, int W, int segmented) {
  static Grid grids[2][64][kMaxStagedW + 1];
  Grid& g = grids[segmented][dev & 63][W];
  if (g.sms == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segmented ? (const void*)event_compact_segmented_kernel
                           : (const void*)event_compact_kernel,
        kThreads, (size_t)kChunk * W * sizeof(int32_t));
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
  const Grid& g = device_grid(dev, staged ? W : 0, 0);
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
// slot, count [I*n], payload [I*n, W] and num_events [I] out; `scratch`
// holds an int2 for each of the I * ceil(n / 512) chunks (at least one),
// of which the grid uses one a CTA. One cooperative launch.
extern "C" int hanabi_event_compact_segmented(const void* mask, const void* count,
                                              const void* payload, void* out_slot,
                                              void* out_count, void* out_payload,
                                              void* num_events, void* scratch, int I, long long n,
                                              int W, void* stream) {
  if (I <= 0) return (int)cudaGetLastError();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int staged = W > 0 && W <= kMaxStagedW;
  const size_t smem = staged ? (size_t)kChunk * W * sizeof(int32_t) : 0;
  long long cps = std::max(1LL, (n + kChunk - 1) / kChunk);  // chunks a segment
  int wide = ((uintptr_t)mask % 4 == 0) && ((uintptr_t)count % 16 == 0);
  if (cps <= kMaxCluster) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(I * cps));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cps;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, event_compact_cluster_kernel, (const uint8_t*)mask,
                             (const long long*)count, (const int32_t*)payload,
                             (long long*)out_slot, (long long*)out_count, (int32_t*)out_payload,
                             (int*)num_events, n, W, (int)cps, wide, staged);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  const Grid& g = device_grid(dev, staged ? W : 0, 1);
  if (g.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long n_chunks = (long long)I * cps;
  const long long max_grid = (long long)g.sms * g.per_sm;
  long long per = (n_chunks + max_grid - 1) / max_grid;
  int grid = (int)((n_chunks + per - 1) / per);  // <= n_chunks: one scratch pair each
  void* args[] = {(void*)&mask,      (void*)&count,     (void*)&payload,    (void*)&out_slot,
                  (void*)&out_count, (void*)&out_payload, (void*)&num_events, (void*)&scratch,
                  (void*)&n,         (void*)&W,         (void*)&cps,        (void*)&n_chunks,
                  (void*)&per,       (void*)&wide,      (void*)&staged};
  err = cudaLaunchCooperativeKernel((const void*)event_compact_segmented_kernel, dim3(grid),
                                    dim3(kThreads), args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
