// ribbon_keys: the sort keys of the ribbon segment order; ribbon_segments:
// every segment quad from the sorted rows, with its appearance gathered into
// segment order.
//
// Both replace XLA regions of bevy_hanabi_tpu/render/ribbon.py (the JAX
// package has no Pallas kernel for them): ribbon_keys the key build of
// ribbon.py:47-50, 69 that feeds `lax.sort(num_keys=3)`, ribbon_segments the
// adjacency and quad build of ribbon.py:61-121 after it.
//
// The order is (ribbon id, -age, counter), dead lanes last. torch.sort takes
// one key, so it is two stable sorts, least significant first:
//   stage 1: int32 key where(alive, counter, 0xFFFFFFFF) ^ 0x80000000 -> perm1;
//   stage 2: int64 key (rid << 32 | ordered(-age)) ^ (1 << 63), read through
//            perm1 (NULL: the identity, for a layout without a counter) -> perm2.
// Flipping the top bit makes a signed sort order each key as its unsigned
// form; the dead sentinel rid 0xFFFFFFFF then never overflows the int64.
// ordered() reproduces lax.sort's f32 order on the CPU, which is not IEEE's
// total order: -0.0, +0.0 and the subnormals compare equal (as zero), and
// every NaN equals every other NaN and sorts after +inf. The transform works
// on the bits alone (-age is a sign flip), so no flush-to-zero mode of the
// card can change it.
//
// ribbon_segments: sorted row i has the source s = perm1[perm2[i]] and the
// predecessor row i - 1 (row n - 1 for i = 0: the roll of ribbon.py:82). From
// the two positions and row s's axis_y it writes the segment's centre,
// axis_x = p - p_prev, the camera-facing side
// normalize(cross(centre - camera, axis_x)) * |axis_y| (the normalize divides
// by 1 where the norm is <= 1e-8), its valid flag (rows i - 1 and i alive in
// one ribbon, i > 0; alive and the ribbon read from the sorted key) and row
// s's colour, mask cutoff and, for a textured ribbon with a flipbook, sprite
// index (int32, one more 4-byte column read through the same chain). The op
// order is the plain version's, and the library is built with -fmad=false,
// so the two agree bit for bit.
//
// Bound on the H100: device-memory bandwidth. ribbon_keys moves 13 B a lane
// in stage 1 (alive, counter, key) and 29 B in stage 2 (perm1, alive, rid,
// age, key); ribbon_segments ~117 B a row (perm1 and perm2, the sorted key,
// 24 B of geometry, 37 B of segment out, 16 B of colour read and written,
// +8 B with a cutoff, +8 B with a sprite column): ~123 MB, ~0.037 ms at 1M
// rows and 3.35 TB/s.
//
// The reads through the permutations are scattered: a ribbon's particles are
// far apart in the pool (ribbon_bench_effect puts counter c in ribbon
// c % 4096, so consecutive rows of a ribbon sit ~4096 lanes apart), and each
// gather touches a 32-byte sector for 4-16 useful bytes. The rows sharing
// those sectors belong to the neighbouring ribbons, which other CTAs read at
// about the same time: that reuse can only come through L2. So the design:
//  - a warp takes a tile of 128 sorted rows, 4 consecutive rows a lane, and
//    resolves each row's chain perm2 -> perm1 -> rows once; a row's
//    predecessor is the lane's previous row, the last row of lane - 1 (a
//    shuffle) or, for lane 0, the halo row before the tile, which every lane
//    of the warp reads at one address;
//  - every gather of a lane's four rows is issued before any is used;
//  - perm2 and the sorted key are read as 16-byte vectors, colour rows as one
//    16-byte load each;
//  - the streamed rows (perm2, the key, every output) carry evict-first
//    hints: what L2 should keep are the gathered tables (perm1, position,
//    axis_y, colour: ~48 MB at 1M rows) for the neighbouring ribbons' reads;
//  - centre, axis_x, side and colour pass through the warp's staging buffer
//    in shared memory and leave as 16-byte stores, each warp instruction
//    writing 512 contiguous bytes (whole sectors); valid (4 bytes a lane)
//    and the cutoff and sprite (16 each) are contiguous a lane already. The
//    tile that holds row n - 1 writes row by row.
// At the ribbon frame's shapes the in-order work (perm1 None, perm2 the
// identity) takes ~0.040 ms and the frame ~0.057-0.060: the scattered
// gathers cost the rest, in L2 requests and in device-memory accesses to
// scattered sectors (experiments/torch_ribbon_segments_variants.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kDead = 0xFFFFFFFFu;
constexpr uint32_t kSign = 0x80000000u;
constexpr uint32_t kOrderedInf = 0xFF800000u;  // ordered(+inf): a dead lane's age key

// -age as bits that order as unsigned integers like lax.sort orders floats.
__device__ __forceinline__ uint32_t ordered_neg_age(float age) {
  uint32_t b = __float_as_uint(age) ^ kSign;
  if ((b & 0x7FFFFFFFu) > 0x7F800000u) b = 0x7FC00000u;  // every NaN: one quiet NaN
  if ((b & 0x7F800000u) == 0u) b = 0u;                    // zeros and subnormals: +0.0
  return (b & kSign) ? ~b : (b | kSign);
}

__global__ void counter_key_kernel(const uint8_t* __restrict__ alive,
                                   const int64_t* __restrict__ counter,
                                   int32_t* __restrict__ key, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t c = alive[i] ? (uint32_t)counter[i] : kDead;
  key[i] = (int32_t)(c ^ kSign);
}

__global__ void order_key_kernel(const uint8_t* __restrict__ alive,
                                 const int64_t* __restrict__ ribbon_id,
                                 const float* __restrict__ age, const int64_t* __restrict__ perm,
                                 int64_t* __restrict__ key, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t j = perm ? perm[i] : i;
  uint32_t rid = kDead, q = kOrderedInf;
  if (alive[j]) {
    rid = (uint32_t)ribbon_id[j];
    q = ordered_neg_age(age[j]);
  }
  key[i] = (int64_t)(((uint64_t)(rid ^ kSign) << 32) | q);
}

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ void store3(float* __restrict__ a, int64_t row, Vec3 v) {
  a[3 * row] = v.x;
  a[3 * row + 1] = v.y;
  a[3 * row + 2] = v.z;
}

// The ribbon id of a sorted stage-2 key.
__device__ __forceinline__ uint32_t key_rid(int64_t key) {
  return (uint32_t)((uint64_t)key >> 32) ^ kSign;
}

constexpr int kSegThreads = 128;
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kRows = 4;               // consecutive sorted rows a lane
constexpr int kTileRows = 32 * kRows;  // rows a warp
// A warp's staging buffer in float4s: a tile's colour rows, with one float4
// of padding after every 8 so that the lanes' stores into it are free of
// bank conflicts (row q at q + q / 8). The vec3 columns use the first 96.
constexpr int kStage = kTileRows + kTileRows / 8;

__device__ __forceinline__ Vec3 gather3(const float* __restrict__ a, int64_t row) {
  return Vec3{__ldg(a + 3 * row), __ldg(a + 3 * row + 1), __ldg(a + 3 * row + 2)};
}

__device__ __forceinline__ Vec3 shfl_up3(Vec3 v) {
  return Vec3{__shfl_up_sync(0xFFFFFFFFu, v.x, 1), __shfl_up_sync(0xFFFFFFFFu, v.y, 1),
              __shfl_up_sync(0xFFFFFFFFu, v.z, 1)};
}

// A lane's 4 rows of a vec3 column (48 bytes) through the warp's buffer
// (lane stride 12 words: no bank conflict in a quarter warp) to the tile's
// 512 * 3 contiguous bytes at `out`.
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

// kSprite: the sprite column is gathered (a template constant, so the
// kernel without it keeps its registers and its loads).
template <bool kSprite>
__global__ void __launch_bounds__(kSegThreads) ribbon_segments_kernel(
    const float* __restrict__ position, const float* __restrict__ axis_y,
    const float4* __restrict__ color, const float* __restrict__ cutoff,
    const int64_t* __restrict__ perm1, const int64_t* __restrict__ perm2,
    const int64_t* __restrict__ key, Vec3 cam, float* __restrict__ center,
    float* __restrict__ axis_x, float* __restrict__ side_out, uint8_t* __restrict__ valid,
    float4* __restrict__ color_out, float* __restrict__ cutoff_out,
    const int32_t* __restrict__ sprite, int32_t* __restrict__ sprite_out, int64_t n) {
  __shared__ float4 stage_all[kSegWarps][kStage];
  const int lane = threadIdx.x & 31;
  const int64_t tile = ((int64_t)blockIdx.x * kSegWarps + (threadIdx.x >> 5)) * kTileRows;
  if (tile >= n) return;  // the whole warp, so every shuffle below has its 32 lanes
  float4* stage = stage_all[threadIdx.x >> 5];
  const int64_t r0 = tile + lane * kRows;
  const bool whole = tile + kTileRows <= n;
  const long long* perm1_ll = reinterpret_cast<const long long*>(perm1);
  const long long* perm2_ll = reinterpret_cast<const long long*>(perm2);
  const long long* key_ll = reinterpret_cast<const long long*>(key);

  // The streamed rows: perm2 and the sorted key, 32 bytes of each a lane.
  // Past row n - 1 (the last tile only) a lane repeats row n - 1 and writes
  // nothing of it.
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
  // the halo: the row before the tile, one address for the whole warp
  const int64_t halo = tile == 0 ? n - 1 : tile - 1;
  const int64_t j_halo = __ldcs(perm2_ll + halo);
  const int64_t k_halo = __ldcs(key_ll + halo);

  // One chain a row, every gather issued before any is used.
  int64_t s[kRows];
#pragma unroll
  for (int h = 0; h < kRows; ++h) s[h] = perm1 ? __ldg(perm1_ll + j[h]) : j[h];
  const int64_t s_halo = perm1 ? __ldg(perm1_ll + j_halo) : j_halo;
  Vec3 p[kRows], ay[kRows];
  float4 col[kRows];
  float cut[kRows];
  int32_t spr[kRows];
#pragma unroll
  for (int h = 0; h < kRows; ++h) {
    p[h] = gather3(position, s[h]);
    ay[h] = gather3(axis_y, s[h]);
    col[h] = __ldg(color + s[h]);
    cut[h] = cutoff ? __ldg(cutoff + s[h]) : 0.0f;
    if (kSprite) spr[h] = __ldg(sprite + s[h]);
  }
  const Vec3 p_halo = gather3(position, s_halo);

  // row r0's predecessor: lane - 1's last row, or the halo for lane 0
  Vec3 q = shfl_up3(p[kRows - 1]);
  uint32_t rid_q = __shfl_up_sync(0xFFFFFFFFu, key_rid(k[kRows - 1]), 1);
  if (lane == 0) {
    q = p_halo;
    rid_q = key_rid(k_halo);
  }
  Vec3 c[kRows], d[kRows], side[kRows];
  uint32_t ok_bytes = 0;  // byte h: row r0 + h's valid flag
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
    if (kSprite)
      __stcs(reinterpret_cast<int4*>(sprite_out + r0), make_int4(spr[0], spr[1], spr[2], spr[3]));
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
      if (kSprite) sprite_out[r] = spr[h];
    }
  }
}

unsigned int blocks(int64_t n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

}  // namespace

// Stage 1 when `counter` is given: alive bool [n], counter int64 [n] (uint32
// values) -> key int32 [n]. Stage 2 otherwise: alive, ribbon_id int64 [n]
// (uint32 values), age f32 [n], perm int64 [n] or NULL -> key int64 [n].
extern "C" int hanabi_ribbon_keys(const void* alive, const void* counter, const void* ribbon_id,
                                  const void* age, const void* perm, void* key, long long n,
                                  void* stream) {
  if (n > 0) {
    if (!counter && (!ribbon_id || !age)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (counter)
      counter_key_kernel<<<blocks(n), kThreads, 0, s>>>(
          (const uint8_t*)alive, (const int64_t*)counter, (int32_t*)key, n);
    else
      order_key_kernel<<<blocks(n), kThreads, 0, s>>>(
          (const uint8_t*)alive, (const int64_t*)ribbon_id, (const float*)age,
          (const int64_t*)perm, (int64_t*)key, n);
  }
  return (int)cudaGetLastError();
}

// position, axis_y f32 [n, 3], color f32 [n, 4], cutoff f32 [n] or NULL,
// sprite int32 [n] or NULL, perm1 int64 [n] or NULL, perm2 int64 [n], key
// int64 [n] (the sorted stage-2 keys), camera f32 [3] on the host -> center,
// axis_x, side f32 [n, 3], valid bool [n], color_out f32 [n, 4], cutoff_out
// f32 [n] (where cutoff is given), sprite_out int32 [n] (where sprite is
// given). color, perm2, key and every output 16-byte aligned (16-byte loads
// and stores).
extern "C" int hanabi_ribbon_segments_sprite(const void* position, const void* axis_y,
                                             const void* color, const void* cutoff,
                                             const void* sprite, const void* perm1,
                                             const void* perm2, const void* key,
                                             const float* camera, void* center, void* axis_x,
                                             void* side, void* valid, void* color_out,
                                             void* cutoff_out, void* sprite_out, long long n,
                                             void* stream) {
  if (n > 0) {
    if ((cutoff && !cutoff_out) || (sprite && !sprite_out)) return (int)cudaErrorInvalidValue;
    const Vec3 cam{camera[0], camera[1], camera[2]};
    const int64_t cta_rows = kSegWarps * kTileRows;
    const unsigned int grid = (unsigned int)((n + cta_rows - 1) / cta_rows);
    auto kernel = sprite ? ribbon_segments_kernel<true> : ribbon_segments_kernel<false>;
    kernel<<<grid, kSegThreads, 0, (cudaStream_t)stream>>>(
        (const float*)position, (const float*)axis_y, (const float4*)color, (const float*)cutoff,
        (const int64_t*)perm1, (const int64_t*)perm2, (const int64_t*)key, cam, (float*)center,
        (float*)axis_x, (float*)side, (uint8_t*)valid, (float4*)color_out, (float*)cutoff_out,
        (const int32_t*)sprite, (int32_t*)sprite_out, n);
  }
  return (int)cudaGetLastError();
}

// The same without a sprite column: the entry point of the kernel's earlier
// versions (experiments/ribbon_segments_variants/), whose callers it keeps.
extern "C" int hanabi_ribbon_segments(const void* position, const void* axis_y, const void* color,
                                      const void* cutoff, const void* perm1, const void* perm2,
                                      const void* key, const float* camera, void* center,
                                      void* axis_x, void* side, void* valid, void* color_out,
                                      void* cutoff_out, long long n, void* stream) {
  return hanabi_ribbon_segments_sprite(position, axis_y, color, cutoff, nullptr, perm1, perm2,
                                       key, camera, center, axis_x, side, valid, color_out,
                                       cutoff_out, nullptr, n, stream);
}
