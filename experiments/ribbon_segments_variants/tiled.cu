// Variants of the port's ribbon_segments kernel (bevy_hanabi_tpu_torch/csrc/
// ribbon.cu: a warp a tile of 128 rows, one gather chain a row, staged
// 16-byte stores, evict-first hints on the streamed rows), timed beside it
// by experiments/torch_ribbon_segments_variants.py. Its C entry point is the
// port's; its results equal the plain version bit for bit.
//   HANABI_GATHER16=1    a 12-byte position or axis_y row is read as the
//                        16-byte vector that holds its first float, and the
//                        next one where the row runs into it: one or two
//                        vector loads in place of three scalar ones (the
//                        tables must be 16-byte aligned; the last row's
//                        vector may end up to 4 bytes past the table, inside
//                        its 16-byte aligned block);
//   HANABI_EVICT_LAST=1  every gathered load (perm1, position, axis_y,
//                        colour, cutoff) carries an L2 evict-last policy;
//   HANABI_PREFETCH=N    every gathered load asks L2 to fetch the N bytes
//                        (64, 128 or 256) around it (.L2::NB), not only
//                        its 32-byte sector: the neighbouring ribbons' rows;
//   HANABI_MIN_BLOCKS=K  __launch_bounds__(128, K): at most 65536 / (128 K)
//                        registers a thread, K CTAs an SM;
//   HANABI_WINDOW=W      a probe, not a segment build: every source row s
//                        becomes (s ^ (s >> 16 << 4)) % W (W a power of two,
//                        65 536 at most), so the gathers read tables of W
//                        rows that stay in L2 and cost their requests but
//                        no device-memory traffic; the fold keeps the lanes
//                        of a warp instruction on distinct sectors where the
//                        ribbon frame's rows (a lane's 4 rows ~16 384 source
//                        rows from the next lane's) were.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef HANABI_GATHER16
#define HANABI_GATHER16 0
#endif
#ifndef HANABI_EVICT_LAST
#define HANABI_EVICT_LAST 0
#endif
#ifndef HANABI_PREFETCH
#define HANABI_PREFETCH 0
#endif
#ifndef HANABI_MIN_BLOCKS
#define HANABI_MIN_BLOCKS 1
#endif
#ifndef HANABI_WINDOW
#define HANABI_WINDOW 0
#endif

namespace {

constexpr uint32_t kDead = 0xFFFFFFFFu;
constexpr uint32_t kSign = 0x80000000u;

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ void store3(float* __restrict__ a, int64_t row, Vec3 v) {
  a[3 * row] = v.x;
  a[3 * row + 1] = v.y;
  a[3 * row + 2] = v.z;
}

__device__ __forceinline__ uint32_t key_rid(int64_t key) {
  return (uint32_t)((uint64_t)key >> 32) ^ kSign;
}

constexpr int kSegThreads = 128;
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kRows = 4;
constexpr int kTileRows = 32 * kRows;
constexpr int kStage = kTileRows + kTileRows / 8;

#define HANABI_STR2(x) #x
#define HANABI_STR(x) HANABI_STR2(x)
#if HANABI_PREFETCH
#define HANABI_PF ".L2::" HANABI_STR(HANABI_PREFETCH) "B"
#else
#define HANABI_PF ""
#endif

#if HANABI_EVICT_LAST
struct Gather {
  uint64_t policy;
  __device__ Gather() {
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  }
  __device__ __forceinline__ float f(const float* a) const {
    float v;
    asm("ld.global.nc.L2::cache_hint" HANABI_PF ".f32 %0, [%1], %2;"
        : "=f"(v) : "l"(a), "l"(policy));
    return v;
  }
  __device__ __forceinline__ float4 f4(const float4* a) const {
    float4 v;
    asm("ld.global.nc.L2::cache_hint" HANABI_PF ".v4.f32 {%0, %1, %2, %3}, [%4], %5;"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(a), "l"(policy));
    return v;
  }
  __device__ __forceinline__ long long i64(const long long* a) const {
    long long v;
    asm("ld.global.nc.L2::cache_hint" HANABI_PF ".s64 %0, [%1], %2;"
        : "=l"(v) : "l"(a), "l"(policy));
    return v;
  }
};
#elif HANABI_PREFETCH
struct Gather {
  __device__ __forceinline__ float f(const float* a) const {
    float v;
    asm("ld.global.nc" HANABI_PF ".f32 %0, [%1];" : "=f"(v) : "l"(a));
    return v;
  }
  __device__ __forceinline__ float4 f4(const float4* a) const {
    float4 v;
    asm("ld.global.nc" HANABI_PF ".v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(a));
    return v;
  }
  __device__ __forceinline__ long long i64(const long long* a) const {
    long long v;
    asm("ld.global.nc" HANABI_PF ".s64 %0, [%1];" : "=l"(v) : "l"(a));
    return v;
  }
};
#else
struct Gather {
  __device__ __forceinline__ float f(const float* a) const { return __ldg(a); }
  __device__ __forceinline__ float4 f4(const float4* a) const { return __ldg(a); }
  __device__ __forceinline__ long long i64(const long long* a) const { return __ldg(a); }
};
#endif

__device__ __forceinline__ Vec3 gather3(const Gather& g, const float* __restrict__ a,
                                        int64_t row) {
#if HANABI_GATHER16
  const int64_t f = 3 * row;
  const int m = (int)(f & 3);
  const float4* a4 = reinterpret_cast<const float4*>(a) + (f >> 2);
  const float4 lo = g.f4(a4);
  float4 hi = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (m >= 2) hi = g.f4(a4 + 1);
  if (m == 0) return Vec3{lo.x, lo.y, lo.z};
  if (m == 1) return Vec3{lo.y, lo.z, lo.w};
  if (m == 2) return Vec3{lo.z, lo.w, hi.x};
  return Vec3{lo.w, hi.x, hi.y};
#else
  return Vec3{g.f(a + 3 * row), g.f(a + 3 * row + 1), g.f(a + 3 * row + 2)};
#endif
}

__device__ __forceinline__ Vec3 shfl_up3(Vec3 v) {
  return Vec3{__shfl_up_sync(0xFFFFFFFFu, v.x, 1), __shfl_up_sync(0xFFFFFFFFu, v.y, 1),
              __shfl_up_sync(0xFFFFFFFFu, v.z, 1)};
}

__device__ __forceinline__ void store_tile3(float4* stage, const Vec3 (&v)[kRows],
                                            float* __restrict__ out, int lane) {
  stage[3 * lane] = make_float4(v[0].x, v[0].y, v[0].z, v[1].x);
  stage[3 * lane + 1] = make_float4(v[1].y, v[1].z, v[2].x, v[2].y);
  stage[3 * lane + 2] = make_float4(v[2].z, v[3].x, v[3].y, v[3].z);
  __syncwarp();
  float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int m = 0; m < 3; ++m) __stcs(o + 32 * m + lane, stage[32 * m + lane]);
  __syncwarp();
}

__global__ void __launch_bounds__(kSegThreads, HANABI_MIN_BLOCKS)
ribbon_segments_kernel(
    const float* __restrict__ position, const float* __restrict__ axis_y,
    const float4* __restrict__ color, const float* __restrict__ cutoff,
    const int64_t* __restrict__ perm1, const int64_t* __restrict__ perm2,
    const int64_t* __restrict__ key, Vec3 cam, float* __restrict__ center,
    float* __restrict__ axis_x, float* __restrict__ side_out, uint8_t* __restrict__ valid,
    float4* __restrict__ color_out, float* __restrict__ cutoff_out, int64_t n) {
  __shared__ float4 stage_all[kSegWarps][kStage];
  const int lane = threadIdx.x & 31;
  const int64_t tile = ((int64_t)blockIdx.x * kSegWarps + (threadIdx.x >> 5)) * kTileRows;
  if (tile >= n) return;
  const Gather g{};
  float4* stage = stage_all[threadIdx.x >> 5];
  const int64_t r0 = tile + lane * kRows;
  const bool whole = tile + kTileRows <= n;
  const long long* perm1_ll = reinterpret_cast<const long long*>(perm1);
  const long long* perm2_ll = reinterpret_cast<const long long*>(perm2);
  const long long* key_ll = reinterpret_cast<const long long*>(key);

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
  const int64_t halo = tile == 0 ? n - 1 : tile - 1;
  const int64_t j_halo = __ldcs(perm2_ll + halo);
  const int64_t k_halo = __ldcs(key_ll + halo);

  int64_t s[kRows];
#pragma unroll
  for (int h = 0; h < kRows; ++h) s[h] = perm1 ? g.i64(perm1_ll + j[h]) : j[h];
  int64_t s_halo = perm1 ? g.i64(perm1_ll + j_halo) : j_halo;
#if HANABI_WINDOW
#pragma unroll
  for (int h = 0; h < kRows; ++h) s[h] = (s[h] ^ ((s[h] >> 16) << 4)) & (HANABI_WINDOW - 1);
  s_halo = (s_halo ^ ((s_halo >> 16) << 4)) & (HANABI_WINDOW - 1);
#endif
  Vec3 p[kRows], ay[kRows];
  float4 col[kRows];
  float cut[kRows];
#pragma unroll
  for (int h = 0; h < kRows; ++h) {
    p[h] = gather3(g, position, s[h]);
    ay[h] = gather3(g, axis_y, s[h]);
    col[h] = g.f4(color + s[h]);
    cut[h] = cutoff ? g.f(cutoff + s[h]) : 0.0f;
  }
  const Vec3 p_halo = gather3(g, position, s_halo);

  Vec3 q = shfl_up3(p[kRows - 1]);
  uint32_t rid_q = __shfl_up_sync(0xFFFFFFFFu, key_rid(k[kRows - 1]), 1);
  if (lane == 0) {
    q = p_halo;
    rid_q = key_rid(k_halo);
  }
  Vec3 c[kRows], d[kRows], side[kRows];
  uint32_t ok_bytes = 0;
#pragma unroll
  for (int h = 0; h < kRows; ++h) {
    if (h > 0) {
      q = p[h - 1];
      rid_q = key_rid(k[h - 1]);
    }
    const Vec3 pp = p[h], a = ay[h];
    const float width = sqrtf(a.x * a.x + a.y * a.y + a.z * a.z);
    d[h] = Vec3{pp.x - q.x, pp.y - q.y, pp.z - q.z};
    c[h] = Vec3{0.5f * (pp.x + q.x), 0.5f * (pp.y + q.y), 0.5f * (pp.z + q.z)};
    const Vec3 v{c[h].x - cam.x, c[h].y - cam.y, c[h].z - cam.z};
    const Vec3 dd = d[h];
    const Vec3 sd{v.y * dd.z - v.z * dd.y, v.z * dd.x - v.x * dd.z, v.x * dd.y - v.y * dd.x};
    const float norm = sqrtf(sd.x * sd.x + sd.y * sd.y + sd.z * sd.z);
    const float den = norm > 1e-8f ? norm : 1.0f;
    side[h] = Vec3{sd.x / den * width, sd.y / den * width, sd.z / den * width};
    const uint32_t rid = key_rid(k[h]);
    const bool ok = r0 + h > 0 && rid != kDead && rid_q != kDead && rid == rid_q;
    ok_bytes |= (uint32_t)ok << (8 * h);
  }

  if (whole) {
    store_tile3(stage, c, center + 3 * tile, lane);
    store_tile3(stage, d, axis_x + 3 * tile, lane);
    store_tile3(stage, side, side_out + 3 * tile, lane);
#pragma unroll
    for (int h = 0; h < kRows; ++h) stage[kRows * lane + h + (lane >> 1)] = col[h];
    __syncwarp();
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int row = 32 * m + lane;
      __stcs(color_out + tile + row, stage[row + (row >> 3)]);
    }
    __stcs(reinterpret_cast<unsigned int*>(valid + r0), ok_bytes);
    if (cutoff)
      __stcs(reinterpret_cast<float4*>(cutoff_out + r0),
             make_float4(cut[0], cut[1], cut[2], cut[3]));
  } else {
#pragma unroll
    for (int h = 0; h < kRows; ++h) {
      const int64_t r = r0 + h;
      if (r >= n) break;
      store3(center, r, c[h]);
      store3(axis_x, r, d[h]);
      store3(side_out, r, side[h]);
      valid[r] = (uint8_t)(ok_bytes >> (8 * h));
      color_out[r] = col[h];
      if (cutoff) cutoff_out[r] = cut[h];
    }
  }
}

}  // namespace

extern "C" int hanabi_ribbon_segments(const void* position, const void* axis_y, const void* color,
                                      const void* cutoff, const void* perm1, const void* perm2,
                                      const void* key, const float* camera, void* center,
                                      void* axis_x, void* side, void* valid, void* color_out,
                                      void* cutoff_out, long long n, void* stream) {
  if (n > 0) {
    if (cutoff && !cutoff_out) return (int)cudaErrorInvalidValue;
    const Vec3 cam{camera[0], camera[1], camera[2]};
    const int64_t cta_rows = kSegWarps * kTileRows;
    const unsigned int grid = (unsigned int)((n + cta_rows - 1) / cta_rows);
    ribbon_segments_kernel<<<grid, kSegThreads, 0, (cudaStream_t)stream>>>(
        (const float*)position, (const float*)axis_y, (const float4*)color, (const float*)cutoff,
        (const int64_t*)perm1, (const int64_t*)perm2, (const int64_t*)key, cam, (float*)center,
        (float*)axis_x, (float*)side, (uint8_t*)valid, (float4*)color_out, (float*)cutoff_out, n);
  }
  return (int)cudaGetLastError();
}
