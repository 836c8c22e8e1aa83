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
// ribbon_segments: one thread per sorted row i reads its source
// s = perm1[perm2[i]] and its predecessor's (row i - 1, row n - 1 for i = 0:
// the roll of ribbon.py:82), the two positions and row i's axis_y, and writes
// the segment's centre, axis_x = p - p_prev, the camera-facing side
// normalize(cross(centre - camera, axis_x)) * |axis_y| (the normalize divides
// by 1 where the norm is <= 1e-8), its valid flag (rows i - 1 and i alive in
// one ribbon, i > 0; alive and the ribbon read from the sorted key) and row
// s's colour and mask cutoff. The op order is the plain version's, and the
// library is built with -fmad=false, so the two agree bit for bit.
//
// Bound on the H100: device-memory bandwidth. ribbon_keys moves 13 B a lane
// in stage 1 (alive, counter, key) and 29 B in stage 2 (perm1, alive, rid,
// age, key); ribbon_segments ~117 B a row (perm1 and perm2, the sorted key,
// 24 B of geometry, 37 B of segment out, 16 B of colour read and written,
// +8 B with a cutoff): ~123 MB, ~0.037 ms at 1M rows and 3.35 TB/s. The
// reads through the permutations are scattered (a ribbon's particles are far
// apart in the pool), so each touches a 32-byte sector for 4-16 useful
// bytes; a first, simple design: one thread a row, no staging.

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

__device__ __forceinline__ Vec3 load3(const float* __restrict__ a, int64_t row) {
  return Vec3{a[3 * row], a[3 * row + 1], a[3 * row + 2]};
}

__device__ __forceinline__ void store3(float* __restrict__ a, int64_t row, Vec3 v) {
  a[3 * row] = v.x;
  a[3 * row + 1] = v.y;
  a[3 * row + 2] = v.z;
}

// The ribbon id of a sorted stage-2 key.
__device__ __forceinline__ uint32_t key_rid(int64_t key) {
  return (uint32_t)((uint64_t)key >> 32) ^ kSign;
}

__global__ void __launch_bounds__(kThreads) ribbon_segments_kernel(
    const float* __restrict__ position, const float* __restrict__ axis_y,
    const float* __restrict__ color, const float* __restrict__ cutoff,
    const int64_t* __restrict__ perm1, const int64_t* __restrict__ perm2,
    const int64_t* __restrict__ key, Vec3 cam, float* __restrict__ center,
    float* __restrict__ axis_x, float* __restrict__ side_out, uint8_t* __restrict__ valid,
    float* __restrict__ color_out, float* __restrict__ cutoff_out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t ip = i == 0 ? n - 1 : i - 1;
  const int64_t s = perm1 ? perm1[perm2[i]] : perm2[i];
  const int64_t sp = perm1 ? perm1[perm2[ip]] : perm2[ip];
  const Vec3 p = load3(position, s);
  const Vec3 q = load3(position, sp);
  const Vec3 ay = load3(axis_y, s);
  const float col[4] = {color[4 * s], color[4 * s + 1], color[4 * s + 2], color[4 * s + 3]};

  const float width = sqrtf(ay.x * ay.x + ay.y * ay.y + ay.z * ay.z);
  const Vec3 d{p.x - q.x, p.y - q.y, p.z - q.z};
  const Vec3 c{0.5f * (p.x + q.x), 0.5f * (p.y + q.y), 0.5f * (p.z + q.z)};
  const Vec3 v{c.x - cam.x, c.y - cam.y, c.z - cam.z};
  Vec3 side{v.y * d.z - v.z * d.y, v.z * d.x - v.x * d.z, v.x * d.y - v.y * d.x};
  const float norm = sqrtf(side.x * side.x + side.y * side.y + side.z * side.z);
  const float den = norm > 1e-8f ? norm : 1.0f;
  side = Vec3{side.x / den * width, side.y / den * width, side.z / den * width};

  bool ok = false;
  if (i > 0) {
    const uint32_t rid = key_rid(key[i]), rid_prev = key_rid(key[ip]);
    ok = rid != kDead && rid_prev != kDead && rid == rid_prev;
  }
  store3(center, i, c);
  store3(axis_x, i, d);
  store3(side_out, i, side);
  valid[i] = ok;
  for (int k = 0; k < 4; ++k) color_out[4 * i + k] = col[k];
  if (cutoff) cutoff_out[i] = cutoff[s];
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

// position, axis_y f32 [n, 3], color f32 [n, 4], cutoff f32
// [n] or NULL, perm1 int64 [n] or NULL, perm2 int64 [n], key int64 [n] (the
// sorted stage-2 keys), camera f32 [3] on the host -> center, axis_x, side
// f32 [n, 3], valid bool [n], color_out f32 [n, 4], cutoff_out f32 [n]
// (where cutoff is given)
extern "C" int hanabi_ribbon_segments(const void* position, const void* axis_y, const void* color,
                                      const void* cutoff, const void* perm1, const void* perm2,
                                      const void* key, const float* camera, void* center,
                                      void* axis_x, void* side, void* valid, void* color_out,
                                      void* cutoff_out, long long n, void* stream) {
  if (n > 0) {
    if (cutoff && !cutoff_out) return (int)cudaErrorInvalidValue;
    const Vec3 cam{camera[0], camera[1], camera[2]};
    ribbon_segments_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)position, (const float*)axis_y, (const float*)color, (const float*)cutoff,
        (const int64_t*)perm1, (const int64_t*)perm2, (const int64_t*)key, cam, (float*)center,
        (float*)axis_x, (float*)side, (uint8_t*)valid, (float*)color_out, (float*)cutoff_out, n);
  }
  return (int)cudaGetLastError();
}
