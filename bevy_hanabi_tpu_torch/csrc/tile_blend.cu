// tile_blend: the per-tile bounded BLEND loop of the tile rasterizer.
//
// Replaces bevy_hanabi_tpu/render/raster.py:620-911 (`blend_one` / `body`,
// the alpha_mode == "blend" branch, no texture, depth, triangles,
// roundness or antialiasing). The JAX package leaves it to XLA on the TPU,
// which streams the whole [nt, T, T, 4] framebuffer through device memory
// once per group of `blend_unroll` entries; it has no Pallas kernel.
//
// Input: window [nt, M, 10] f32 rows (cx, cy, h1x, h1y, h2x, h2y, r, g, b,
// a), the tile's entries back to front, and has [nt, M] bool. Output: fb
// [nt, T, T, 4] f32.
//
// Bound on the H100: the framebuffer traffic the XLA loop pays is gone —
// each pixel's RGBA lives in registers for the whole loop and is written
// once (16 B per pixel, 4 MB at 512x512), and each tile's 2.5 KB of window
// rows is read once into shared memory. What is left is arithmetic: M * T*T
// per tile = 16.8M entry-pixel tests at the headline, each ~20 flops and
// two IEEE divisions, so the kernel is compute- and latency-bound (tens of
// microseconds), not bandwidth-bound.
//
// Design: one CTA per tile, T*T threads, one pixel each. The loop runs
// m = 0..M-1 back to front in the JAX package's order. The guards are kept:
// the det clamp that is not sign-preserving (raster.py:629-630), the
// |u|,|v| <= 1 test, and coverage-zero lanes leave the pixel untouched,
// which is exactly what the JAX package's zero-coverage `where`
// (raster.py:822-828) computes, so a NaN row never reaches a pixel it does
// not cover. Built with -fmad=false, the blend matches the plain PyTorch
// version's rounding op for op.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRow = 10;

__global__ void tile_blend_kernel(const float* __restrict__ window,
                                  const uint8_t* __restrict__ has,
                                  float4* __restrict__ fb,
                                  int M, int T, int ntx, float4 background) {
  extern __shared__ float smem[];
  float* rows = smem;                                   // [M, 10]
  uint8_t* hs = reinterpret_cast<uint8_t*>(smem + M * kRow);  // [M]
  const int tile = blockIdx.x;
  const float* src = window + (int64_t)tile * M * kRow;
  for (int k = threadIdx.x; k < M * kRow; k += blockDim.x) rows[k] = src[k];
  for (int k = threadIdx.x; k < M; k += blockDim.x) hs[k] = has[(int64_t)tile * M + k];
  __syncthreads();

  const int i = threadIdx.x / T;  // pixel row inside the tile
  const int j = threadIdx.x - i * T;
  const float px = (float)((tile % ntx) * T + j) + 0.5f;
  const float py = (float)((tile / ntx) * T + i) + 0.5f;
  float4 d = background;
  for (int m = 0; m < M; ++m) {
    if (!hs[m]) continue;
    const float* r = rows + m * kRow;
    const float dx = px - r[0];
    const float dy = py - r[1];
    const float a1x = r[2], a1y = r[3], a2x = r[4], a2y = r[5];
    float det = a1x * a2y - a1y * a2x;
    det = fabsf(det) < 1e-9f ? 1e-9f : det;
    const float u = (a2y * dx - a2x * dy) / det;
    const float v = (-a1y * dx + a1x * dy) / det;
    if (!(fabsf(u) <= 1.0f && fabsf(v) <= 1.0f)) continue;
    const float a = r[9];  // alpha * coverage, coverage == 1 here
    const float ia = 1.0f - a;
    d.x = r[6] * a + d.x * ia;
    d.y = r[7] * a + d.y * ia;
    d.z = r[8] * a + d.z * ia;
    d.w = a + d.w * ia;
  }
  fb[(int64_t)tile * blockDim.x + threadIdx.x] = d;
}

}  // namespace

extern "C" int hanabi_tile_blend(const void* window, const void* has, void* fb, int nt, int M,
                                 int T, int ntx, const float* background, void* stream) {
  float4 bg = make_float4(background[0], background[1], background[2], background[3]);
  if (nt > 0) {
    size_t smem = (size_t)M * kRow * sizeof(float) + (size_t)M;
    tile_blend_kernel<<<nt, T * T, smem, (cudaStream_t)stream>>>(
        (const float*)window, (const uint8_t*)has, (float4*)fb, M, T, ntx, bg);
  }
  return (int)cudaGetLastError();
}
