// The first version of the port's ribbon_segments kernel, kept to be timed
// beside the port's (bevy_hanabi_tpu_torch/csrc/ribbon.cu) by
// experiments/torch_ribbon_segments_variants.py and chip_smoke.py phase 13:
// one thread per sorted row, which resolves its own chain
// s = perm1[perm2[i]] and its predecessor's, reads every row with scalar
// loads and writes 14 scalar stores, no staging and no cache hints. Its C
// entry point is the port's; the results equal the plain version bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kDead = 0xFFFFFFFFu;
constexpr uint32_t kSign = 0x80000000u;

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
