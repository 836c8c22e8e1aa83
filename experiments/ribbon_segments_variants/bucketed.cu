// A variant of the port's ribbon_segments kernel (bevy_hanabi_tpu_torch/csrc/
// ribbon.cu), timed beside it by experiments/torch_ribbon_segments_variants.py.
// Its C entry point is the port's; its results equal the plain version bit
// for bit. The design: a CTA takes a tile of 1024 sorted rows (~4 ribbons of
// the ribbon frame), reads perm2 and the sorted key in order (4 rows a
// thread, 16-byte vectors) and writes the valid flags; it orders the tile's
// rows by perm2 in 256 buckets of equal width over the tile's perm2 range
// (a counting sort in shared memory: at the ribbon frame's shapes one
// generation of the tile's ribbons a bucket), and resolves each row's chain
// perm2 -> perm1 -> rows once, in that order, so that a warp instruction
// gathers the same-age rows of neighbouring ribbons, whose sectors it
// shares; the positions go to shared memory by row, where each row finds
// its predecessor's (or the halo row's); every output column passes through
// shared memory by row and leaves as 16-byte evict-first stores.
//   HANABI_PERSISTENT=1  the grid is the CTAs the card holds at once, each
//                        looping over tiles b, b + G, ... (one round of
//                        tiles started together), not one CTA a tile.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef HANABI_PERSISTENT
#define HANABI_PERSISTENT 0
#endif

namespace {

constexpr uint32_t kDead = 0xFFFFFFFFu;
constexpr uint32_t kSign = 0x80000000u;

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ uint32_t key_rid(int64_t key) {
  return (uint32_t)((uint64_t)key >> 32) ^ kSign;
}

constexpr int kSegThreads = 256;
constexpr int kRows = 4;                    // rows a thread, in row order
constexpr int kTile = kSegThreads * kRows;  // sorted rows a CTA
constexpr int kBuckets = 256;               // of the counting sort: one a thread
static_assert(kBuckets == kSegThreads, "the bucket scan takes one bucket a thread");

__device__ __forceinline__ Vec3 gather3(const float* __restrict__ a, int64_t row) {
  return Vec3{__ldg(a + 3 * row), __ldg(a + 3 * row + 1), __ldg(a + 3 * row + 2)};
}

// The exclusive prefix sum of v over the CTA's threads (two barriers).
__device__ __forceinline__ int exclusive_sum(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kSegThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kSegThreads / 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kSegThreads / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  return x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
}

// The tile's `floats` floats staged in `stage` to `out`, then a barrier
// before the next column takes the stage.
__device__ __forceinline__ void write_out(const float4* stage, float* __restrict__ out,
                                          int floats, bool whole) {
  if (whole) {
    for (int i = threadIdx.x; i < floats / 4; i += kSegThreads)
      __stcs(reinterpret_cast<float4*>(out) + i, stage[i]);
  } else {
    const float* f = reinterpret_cast<const float*>(stage);
    for (int i = threadIdx.x; i < floats; i += kSegThreads) out[i] = f[i];
  }
  __syncthreads();
}

// A vec3 column of the thread's rows (slot t + 256 m holds row row[m]) to
// the stage by row, then out.
__device__ __forceinline__ void write_out3(const Vec3 (&v)[kRows], const int (&row)[kRows],
                                           int rows, float4* stage, float* __restrict__ out,
                                           bool whole) {
  float* f = reinterpret_cast<float*>(stage);
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    if ((int)threadIdx.x + kSegThreads * m < rows) {
      f[3 * row[m]] = v[m].x;
      f[3 * row[m] + 1] = v[m].y;
      f[3 * row[m] + 2] = v[m].z;
    }
  }
  __syncthreads();
  write_out(stage, out, 3 * rows, whole);
}

__global__ void __launch_bounds__(kSegThreads, 3) ribbon_segments_kernel(
    const float* __restrict__ position, const float* __restrict__ axis_y,
    const float4* __restrict__ color, const float* __restrict__ cutoff,
    const int64_t* __restrict__ perm1, const int64_t* __restrict__ perm2,
    const int64_t* __restrict__ key, Vec3 cam, float* __restrict__ center,
    float* __restrict__ axis_x, float* __restrict__ side_out, uint8_t* __restrict__ valid,
    float4* __restrict__ color_out, float* __restrict__ cutoff_out, int64_t n) {
  __shared__ uint32_t j_s[kTile];         // perm2 of the tile's rows
  __shared__ uint16_t order_s[kTile];     // the tile's rows in bucket order
  __shared__ int bucket_s[kBuckets];      // bucket sizes, then first slots
  __shared__ int warp_s[kSegThreads / 32];
  __shared__ uint32_t range_s[2][kSegThreads / 32];  // each warp's least and greatest perm2
  __shared__ float p_s[3 * (kTile + 1)];  // row i's position at i + 1, the halo's at 0
  __shared__ float4 stage[kTile];         // one output column of the tile, by row
  float* stage_f = reinterpret_cast<float*>(stage);

  const int t = threadIdx.x;
  const long long* perm1_ll = reinterpret_cast<const long long*>(perm1);
  const long long* perm2_ll = reinterpret_cast<const long long*>(perm2);
  const long long* key_ll = reinterpret_cast<const long long*>(key);
#if HANABI_PERSISTENT
  // Tiles b, b + G, b + 2G, ... for the G resident CTAs.
  for (int64_t tile = (int64_t)blockIdx.x * kTile; tile < n; tile += (int64_t)gridDim.x * kTile) {
#else
  {
    const int64_t tile = (int64_t)blockIdx.x * kTile;
#endif
    const int rows = (int)(n - tile < kTile ? n - tile : kTile);
    const bool whole = rows == kTile;
    const int64_t r0 = tile + kRows * t;
    bucket_s[t] = 0;

    // 1. The streamed rows in order: perm2 and the key, 32 bytes each a thread;
    // the valid flags. Past row n - 1 (the last tile only) a thread repeats
    // row n - 1 and writes nothing of it.
    int64_t j[kRows], k[kRows];
    if (whole) {
#pragma unroll
      for (int h = 0; h < kRows; h += 2) {
        const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(perm2_ll + r0 + h));
        const longlong2 b = __ldcs(reinterpret_cast<const longlong2*>(key_ll + r0 + h));
        j[h] = a.x;
        j[h + 1] = a.y;
        k[h] = b.x;
        k[h + 1] = b.y;
      }
    } else {
#pragma unroll
      for (int h = 0; h < kRows; ++h) {
        const int64_t r = r0 + h < n ? r0 + h : n - 1;
        j[h] = __ldcs(perm2_ll + r);
        k[h] = __ldcs(key_ll + r);
      }
    }
    uint32_t rid_q = key_rid(__ldcs(key_ll + (r0 == 0 ? n - 1 : (r0 < n ? r0 : n) - 1)));
    uint32_t ok_bytes = 0;  // byte h: row r0 + h's valid flag
#pragma unroll
    for (int h = 0; h < kRows; ++h) {
      const uint32_t rid = key_rid(k[h]);
      const bool ok = r0 + h > 0 && rid != kDead && rid_q != kDead && rid == rid_q;
      ok_bytes |= (uint32_t)ok << (8 * h);
      rid_q = rid;
    }
    if (whole) {
      __stcs(reinterpret_cast<unsigned int*>(valid + r0), ok_bytes);
    } else {
#pragma unroll
      for (int h = 0; h < kRows; ++h)
        if (r0 + h < n) valid[r0 + h] = (uint8_t)(ok_bytes >> (8 * h));
    }
    // the tile's perm2 range (rows past n - 1 repeat row n - 1's)
    uint32_t lo = 0xFFFFFFFFu, hi = 0;
#pragma unroll
    for (int h = 0; h < kRows; ++h) {
      lo = min(lo, (uint32_t)j[h]);
      hi = max(hi, (uint32_t)j[h]);
    }
    lo = __reduce_min_sync(0xFFFFFFFFu, lo);
    hi = __reduce_max_sync(0xFFFFFFFFu, hi);
    if ((t & 31) == 0) {
      range_s[0][t >> 5] = lo;
      range_s[1][t >> 5] = hi;
    }
    __syncthreads();

    // 2. The counting sort of the tile's rows into 256 buckets of equal width
    // over the tile's perm2 range.
#pragma unroll
    for (int w = 0; w < kSegThreads / 32; ++w) {
      lo = min(lo, range_s[0][w]);
      hi = max(hi, range_s[1][w]);
    }
    const float scale = (float)kBuckets / ((float)(hi - lo) + 1.0f);
    int bucket[kRows] = {}, rank[kRows] = {};
#pragma unroll
    for (int h = 0; h < kRows; ++h) {
      if (r0 + h < n) {
        j_s[kRows * t + h] = (uint32_t)j[h];
        bucket[h] = min(kBuckets - 1, (int)((float)((uint32_t)j[h] - lo) * scale));
        rank[h] = atomicAdd(&bucket_s[bucket[h]], 1);
      }
    }
    __syncthreads();
    const int first = exclusive_sum(bucket_s[t], warp_s);
    bucket_s[t] = first;
    __syncthreads();
#pragma unroll
    for (int h = 0; h < kRows; ++h)
      if (r0 + h < n) order_s[bucket_s[bucket[h]] + rank[h]] = (uint16_t)(kRows * t + h);
    __syncthreads();

    // 3. One chain a row, in bucket order: slot t + 256 m of the tile's sorted
    // rows (slots past the tile's rows repeat its last and write nothing).
    int row[kRows];
    int64_t s[kRows];
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int slot = t + kSegThreads * m;
      row[m] = order_s[slot < rows ? slot : rows - 1];
    }
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const uint32_t jm = j_s[row[m]];
      s[m] = perm1 ? __ldg(perm1_ll + jm) : (int64_t)jm;
    }
    Vec3 p[kRows], ay[kRows];
    float4 col[kRows];
    float cut[kRows];
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      p[m] = gather3(position, s[m]);
      ay[m] = gather3(axis_y, s[m]);
      col[m] = __ldg(color + s[m]);
      cut[m] = cutoff ? __ldg(cutoff + s[m]) : 0.0f;
    }
    if (t == 0) {  // the halo: the row before the tile
      const int64_t jh = __ldcs(perm2_ll + (tile == 0 ? n - 1 : tile - 1));
      const Vec3 ph = gather3(position, perm1 ? __ldg(perm1_ll + jh) : jh);
      p_s[0] = ph.x;
      p_s[1] = ph.y;
      p_s[2] = ph.z;
    }
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      if (t + kSegThreads * m < rows) {
        p_s[3 * row[m] + 3] = p[m].x;
        p_s[3 * row[m] + 4] = p[m].y;
        p_s[3 * row[m] + 5] = p[m].z;
      }
    }
    __syncthreads();

    // 4. Each row's segment, from its predecessor's position.
    Vec3 c[kRows], d[kRows], side[kRows];
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const Vec3 q{p_s[3 * row[m]], p_s[3 * row[m] + 1], p_s[3 * row[m] + 2]};
      const Vec3 pp = p[m], a = ay[m];
      const float width = sqrtf(a.x * a.x + a.y * a.y + a.z * a.z);
      d[m] = Vec3{pp.x - q.x, pp.y - q.y, pp.z - q.z};
      c[m] = Vec3{0.5f * (pp.x + q.x), 0.5f * (pp.y + q.y), 0.5f * (pp.z + q.z)};
      const Vec3 v{c[m].x - cam.x, c[m].y - cam.y, c[m].z - cam.z};
      const Vec3 dd = d[m];
      const Vec3 sd{v.y * dd.z - v.z * dd.y, v.z * dd.x - v.x * dd.z, v.x * dd.y - v.y * dd.x};
      const float norm = sqrtf(sd.x * sd.x + sd.y * sd.y + sd.z * sd.z);
      const float den = norm > 1e-8f ? norm : 1.0f;
      side[m] = Vec3{sd.x / den * width, sd.y / den * width, sd.z / den * width};
    }

    // 5. The output columns, each through the stage by row.
    write_out3(c, row, rows, stage, center + 3 * tile, whole);
    write_out3(d, row, rows, stage, axis_x + 3 * tile, whole);
    write_out3(side, row, rows, stage, side_out + 3 * tile, whole);
#pragma unroll
    for (int m = 0; m < kRows; ++m)
      if (t + kSegThreads * m < rows) stage[row[m]] = col[m];
    __syncthreads();
    write_out(stage, reinterpret_cast<float*>(color_out + tile), 4 * rows, whole);
    if (cutoff) {
#pragma unroll
      for (int m = 0; m < kRows; ++m)
        if (t + kSegThreads * m < rows) stage_f[row[m]] = cut[m];
      __syncthreads();
      write_out(stage, cutoff_out + tile, rows, whole);
    }
  }
}

// The ribbon_segments CTAs the current device holds at once, once a device.
int resident_segment_ctas() {
  static int resident[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int& r = resident[dev & 63];
  if (r == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ribbon_segments_kernel, kSegThreads, 0);
    r = sms * (per_sm > 0 ? per_sm : 1);
  }
  return r;
}

}  // namespace

// position, axis_y f32 [n, 3], color f32 [n, 4], cutoff f32
// [n] or NULL, perm1 int64 [n] or NULL, perm2 int64 [n], key int64 [n] (the
// sorted stage-2 keys), camera f32 [3] on the host -> center, axis_x, side
// f32 [n, 3], valid bool [n], color_out f32 [n, 4], cutoff_out f32 [n]
// (where cutoff is given). color, perm2, key and every output 16-byte
// aligned (16-byte loads and stores).
extern "C" int hanabi_ribbon_segments(const void* position, const void* axis_y, const void* color,
                                      const void* cutoff, const void* perm1, const void* perm2,
                                      const void* key, const float* camera, void* center,
                                      void* axis_x, void* side, void* valid, void* color_out,
                                      void* cutoff_out, long long n, void* stream) {
  if (n > 0) {
    if (cutoff && !cutoff_out) return (int)cudaErrorInvalidValue;
    if (n > 0xFFFFFFFFll) return (int)cudaErrorInvalidValue;  // perm2 values held as uint32
    const Vec3 cam{camera[0], camera[1], camera[2]};
    const int64_t tiles = (n + kTile - 1) / kTile;
    const int resident = HANABI_PERSISTENT ? resident_segment_ctas() : 0;
    ribbon_segments_kernel<<<(unsigned int)(resident && resident < tiles ? resident : tiles),
                             kSegThreads, 0,
                             (cudaStream_t)stream>>>(
        (const float*)position, (const float*)axis_y, (const float4*)color, (const float*)cutoff,
        (const int64_t*)perm1, (const int64_t*)perm2, (const int64_t*)key, cam, (float*)center,
        (float*)axis_x, (float*)side, (uint8_t*)valid, (float4*)color_out, (float*)cutoff_out, n);
  }
  return (int)cudaGetLastError();
}
