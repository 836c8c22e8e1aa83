// Floors of ribbon_segments at a call's shapes, timed beside the port's
// kernel by experiments/torch_ribbon_segments_variants.py and chip_smoke.py
// phase 13. Its C entry point is the port's:
//   HANABI_PROBE=1  a streaming copy of the bytes the call must move: every
//                   input column read once and every output column written
//                   once, all in order, 16 bytes a load or store and 512
//                   contiguous bytes a warp instruction (a ragged end of
//                   n % 4 rows is left out). Its results are not segments
//                   and are not compared;
//   HANABI_PROBE=2  first.cu's kernel with only its stores made evict-first
//                   (__stcs); its results are the segments.
// The floor without the scatter is first.cu (or the port) called with
// perm1 = NULL and perm2 = arange(n), which the scripts time as well.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

#if HANABI_PROBE == 1

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Thread t copies the t-th 16 bytes of every column that has them (each
// warp instruction 512 contiguous bytes); the two rows of perm1, perm2 and
// the key in those bytes give two valid flags.
__global__ void __launch_bounds__(kThreads) copy_kernel(
    const float4* __restrict__ position, const float4* __restrict__ axis_y,
    const float4* __restrict__ color, const float4* __restrict__ cutoff,
    const longlong2* __restrict__ perm1, const longlong2* __restrict__ perm2,
    const longlong2* __restrict__ key, float4* __restrict__ center, float4* __restrict__ axis_x,
    float4* __restrict__ side, unsigned short* __restrict__ valid, float4* __restrict__ color_out,
    float4* __restrict__ cutoff_out, int64_t quads) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 4 * quads) return;
  color_out[t] = __ldg(color + t);
  if (t < 3 * quads) {
    const float4 p = __ldg(position + t), a = __ldg(axis_y + t);
    center[t] = p;
    axis_x[t] = a;
    side[t] = add4(p, a);
  }
  if (t < 2 * quads) {
    const longlong2 a = __ldg(perm2 + t), b = __ldg(key + t);
    long long x = a.x ^ a.y ^ b.x ^ b.y;
    if (perm1) {
      const longlong2 c = __ldg(perm1 + t);
      x ^= c.x ^ c.y;
    }
    valid[t] = (unsigned short)((x ^ (x >> 32)) & 0x0101);
  }
  if (cutoff && t < quads) cutoff_out[t] = __ldg(cutoff + t);
}

#else

constexpr uint32_t kDead = 0xFFFFFFFFu;
constexpr uint32_t kSign = 0x80000000u;

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ Vec3 load3(const float* __restrict__ a, int64_t row) {
  return Vec3{a[3 * row], a[3 * row + 1], a[3 * row + 2]};
}

__device__ __forceinline__ void store3_cs(float* __restrict__ a, int64_t row, Vec3 v) {
  __stcs(a + 3 * row, v.x);
  __stcs(a + 3 * row + 1, v.y);
  __stcs(a + 3 * row + 2, v.z);
}

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
  store3_cs(center, i, c);
  store3_cs(axis_x, i, d);
  store3_cs(side_out, i, side);
  __stcs(reinterpret_cast<unsigned char*>(valid + i), (unsigned char)ok);
  for (int k = 0; k < 4; ++k) __stcs(color_out + 4 * i + k, col[k]);
  if (cutoff) __stcs(cutoff_out + i, cutoff[s]);
}

#endif

}  // namespace

extern "C" int hanabi_ribbon_segments(const void* position, const void* axis_y, const void* color,
                                      const void* cutoff, const void* perm1, const void* perm2,
                                      const void* key, const float* camera, void* center,
                                      void* axis_x, void* side, void* valid, void* color_out,
                                      void* cutoff_out, long long n, void* stream) {
  if (n > 0) {
    if (cutoff && !cutoff_out) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#if HANABI_PROBE == 1
    const int64_t quads = n / 4;
    if (quads > 0)
      copy_kernel<<<(unsigned int)((4 * quads + kThreads - 1) / kThreads), kThreads, 0, s>>>(
          (const float4*)position, (const float4*)axis_y, (const float4*)color,
          (const float4*)cutoff, (const longlong2*)perm1, (const longlong2*)perm2,
          (const longlong2*)key, (float4*)center, (float4*)axis_x, (float4*)side,
          (unsigned short*)valid, (float4*)color_out, (float4*)cutoff_out, quads);
#else
    const Vec3 cam{camera[0], camera[1], camera[2]};
    ribbon_segments_kernel<<<(unsigned int)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        (const float*)position, (const float*)axis_y, (const float*)color, (const float*)cutoff,
        (const int64_t*)perm1, (const int64_t*)perm2, (const int64_t*)key, cam, (float*)center,
        (float*)axis_x, (float*)side, (uint8_t*)valid, (float*)color_out, (float*)cutoff_out, n);
#endif
  }
  return (int)cudaGetLastError();
}
