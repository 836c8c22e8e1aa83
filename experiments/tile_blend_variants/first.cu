// Variant of bevy_hanabi_tpu_torch/csrc/tile_blend.cu kept for comparison: the
// first version (one thread per pixel, every entry through the full test).
// Built by experiments/torch_tile_blend_variants.py; the port does not use it.
//
// tile_blend: the per-tile bounded blend loop of the tile rasterizer, for
// every equation of the port: BLEND, ADD, OPAQUE, MASK and the painter's
// per-entry SCENE equation, with an optional per-pixel depth test.
//
// Replaces bevy_hanabi_tpu/render/raster.py:620-911 (`blend_one` / `body`:
// the blend / add / opaque / mask / scene branches, raster.py:832-895, and
// the depth test and depth writes, raster.py:675-682, 854-855, 894-895,
// 909; no texture, triangles, roundness or antialiasing). The JAX package
// leaves it to XLA on the TPU, which streams the whole [nt, T, T, 4]
// framebuffer (and the [nt, T, T] depth plane) through device memory once
// per group of `blend_unroll` entries; it has no Pallas kernel.
//
// Input: window [nt, M, W] f32 rows (cx, cy, h1x, h1y, h2x, h2y, r, g, b,
// a, then depth, cutoff, mode where W = 13), the tile's entries in blend
// order; W is 13 for a variant that reads a column past alpha (a depth test,
// MASK, SCENE) and 10 otherwise (plain BLEND, ADD, OPAQUE); has [nt, M]
// bool; optionally the seeded framebuffer fb_in [nt, T, T, 4] (else the
// background colour) and the scene depth depth_in [nt, T, T] (else +inf).
// Output: fb [nt, T, T, 4] and, when the pass writes depth, the final depth
// plane depth_out [nt, T, T].
//
// Bound on the H100: the framebuffer and depth traffic the XLA loop pays is
// gone. Each pixel's RGBA and depth live in registers for the whole loop and
// are written once (20 B per pixel, 5 MB at 512x512), and each tile's
// M * 4W B of window rows is read once into shared memory. What is left is
// arithmetic: M * T*T entry-pixel tests per tile, each ~20 flops and two
// IEEE divisions, so the kernel is compute- and latency-bound (tens of
// microseconds), not bandwidth-bound.
//
// Design: one CTA per tile, T*T threads, one pixel each. The loop runs
// m = 0..M-1 in the JAX package's entry order (back to front on the ordered
// path; the fast paths' order for ADD). The equation and the two depth
// flags are template parameters, so each variant reads only the columns it
// uses, from rows of its own width (RowWidth):
// * kDepth: the test frag_d <= dbuf (LessEqual). dbuf starts as the scene
//   depth; with kWrite it is the running plane, which opaque and mask
//   writes (and the painter's opaque and mask entries) move forward
//   mid-loop, so later transparent entries test against it, as JAX's
//   `dbuf` carry. Without kWrite it stays the scene depth.
// * SCENE follows JAX's form, not a per-mode switch: the transparent branch
//   is the three-term sum rgb_s*cs + rgb_d*cd + rgb_s*rgb_d*cm and the
//   alpha the sum of three selected terms, with zeros in the unused terms,
//   so it rounds op for op as JAX's (with -fmad=false, as the library is
//   built).
// Uncovered lanes (outside the quad, a depth-failed fragment, a padding
// entry) leave the pixel untouched. JAX folds them in with coverage 0
// (raster.py:822-828), which leaves a pixel untouched exactly while it is
// finite and its alpha is at most 1: that is the limit of the skip. ADD's
// `min(a + a_d, 1)` also runs on uncovered lanes in JAX, so the standalone
// ADD variant clamps the starting alpha once before the loop, which gives
// JAX's result for any alpha; the painter's ADD entries assume alpha <= 1.
// A NaN row never reaches a pixel it does not cover. The det clamp that is
// not sign-preserving (raster.py:629-630) and the |u|,|v| <= 1 test are
// kept.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kColDepth = 10;
constexpr int kColCutoff = 11;
constexpr int kColMode = 12;

enum Eq { kBlend = 0, kAdd = 1, kOpaque = 2, kMask = 3, kScene = 4 };

// floats per window row: 13 where the variant reads depth, cutoff or mode
template <int kEq, bool kDepth>
struct RowWidth {
  static constexpr int value = (kDepth || kEq == kMask || kEq == kScene) ? 13 : 10;
};

template <int kEq, bool kDepth, bool kWrite>
__global__ void tile_blend_kernel(const float* __restrict__ window,
                                  const uint8_t* __restrict__ has,
                                  const float4* __restrict__ fb_in,
                                  const float* __restrict__ depth_in,
                                  float4* __restrict__ fb,
                                  float* __restrict__ depth_out,
                                  int M, int T, int ntx, float4 background) {
  constexpr int kRow = RowWidth<kEq, kDepth>::value;
  extern __shared__ float smem[];
  float* rows = smem;                                          // [M, kRow]
  uint8_t* hs = reinterpret_cast<uint8_t*>(smem + M * kRow);  // [M]
  const int tile = blockIdx.x;
  const float* src = window + (int64_t)tile * M * kRow;
  for (int k = threadIdx.x; k < M * kRow; k += blockDim.x) rows[k] = src[k];
  for (int k = threadIdx.x; k < M; k += blockDim.x) hs[k] = has[(int64_t)tile * M + k];
  __syncthreads();

  const int64_t pix = (int64_t)tile * blockDim.x + threadIdx.x;
  const int i = threadIdx.x / T;  // pixel row inside the tile
  const int j = threadIdx.x - i * T;
  const float px = (float)((tile % ntx) * T + j) + 0.5f;
  const float py = (float)((tile / ntx) * T + i) + 0.5f;
  float4 d = fb_in ? fb_in[pix] : background;
  float dbuf = INFINITY;
  if (kDepth && depth_in) dbuf = depth_in[pix];
  if (kEq == kAdd && M > 0) d.w = d.w > 1.0f ? 1.0f : d.w;
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
    float frag_d = 0.0f;
    if (kDepth) {
      frag_d = r[kColDepth];
      if (!(frag_d <= dbuf)) continue;
    }
    const float a = r[9];  // alpha * coverage, coverage == 1 here
    if (kEq == kAdd) {
      d.x = r[6] * a + d.x;
      d.y = r[7] * a + d.y;
      d.z = r[8] * a + d.z;
      const float s = a + d.w;
      d.w = s > 1.0f ? 1.0f : s;  // min(s, 1) that keeps a NaN, as jnp.minimum
    } else if (kEq == kBlend) {
      const float ia = 1.0f - a;
      d.x = r[6] * a + d.x * ia;
      d.y = r[7] * a + d.y * ia;
      d.z = r[8] * a + d.z * ia;
      d.w = a + d.w * ia;
    } else if (kEq == kOpaque || kEq == kMask) {
      if (kEq == kMask && !(a >= r[kColCutoff])) continue;
      d = make_float4(r[6], r[7], r[8], 1.0f);
      if (kWrite) dbuf = frag_d;
    } else {  // kScene
      const float mode = r[kColMode];
      const bool is_o = mode == 4.0f, is_k = mode == 5.0f;
      if (is_o || is_k) {
        if (is_o || a >= r[kColCutoff]) {
          d = make_float4(r[6], r[7], r[8], 1.0f);
          dbuf = frag_d;
        }
        continue;
      }
      const bool b_ = mode == 0.0f, p_ = mode == 1.0f, a_ = mode == 2.0f, m_ = mode == 3.0f;
      const float one_m_a = 1.0f - a;
      const float cs = ((b_ || a_) ? a : 0.0f) + (p_ ? 1.0f : 0.0f);
      const float cd = ((b_ || p_ || m_) ? one_m_a : 0.0f) + (a_ ? 1.0f : 0.0f);
      const float cm = m_ ? a : 0.0f;
      const float sa = a + d.w;
      const float al = ((b_ || p_) ? a + d.w * one_m_a : 0.0f) +
                       (a_ ? (sa > 1.0f ? 1.0f : sa) : 0.0f) + (m_ ? d.w : 0.0f);
      d.x = r[6] * cs + d.x * cd + r[6] * d.x * cm;
      d.y = r[7] * cs + d.y * cd + r[7] * d.y * cm;
      d.z = r[8] * cs + d.z * cd + r[8] * d.z * cm;
      d.w = al;
    }
  }
  fb[pix] = d;
  if (kWrite) depth_out[pix] = dbuf;
}

template <int kEq, bool kDepth, bool kWrite>
void launch(int nt, int M, int T, cudaStream_t stream, const void* window,
            const void* has, const void* fb_in, const void* depth_in, void* fb,
            void* depth_out, int ntx, float4 bg) {
  const size_t smem = (size_t)M * RowWidth<kEq, kDepth>::value * sizeof(float) + (size_t)M;
  tile_blend_kernel<kEq, kDepth, kWrite><<<nt, T * T, smem, stream>>>(
      (const float*)window, (const uint8_t*)has, (const float4*)fb_in,
      (const float*)depth_in, (float4*)fb, (float*)depth_out, M, T, ntx, bg);
}

}  // namespace

// eq: 0 blend, 1 add, 2 opaque, 3 mask, 4 scene. depth_test / write_depth as
// the wrapper validates them: write_depth needs depth_test and an opaque,
// mask or scene equation; scene needs both. The window's rows are
// RowWidth<eq, depth_test>::value floats wide. fb_in and depth_in may be NULL.
// Returns cudaErrorInvalidValue for a combination the wrapper never passes.
extern "C" int hanabi_tile_blend(const void* window, const void* has, const void* fb_in,
                                 const void* depth_in, void* fb, void* depth_out, int nt,
                                 int M, int T, int ntx, const float* background, int eq,
                                 int depth_test, int write_depth, void* stream) {
  float4 bg = make_float4(background[0], background[1], background[2], background[3]);
  if (nt <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int key = eq * 4 + (depth_test ? 2 : 0) + (write_depth ? 1 : 0);
#define HANABI_TB(E, D, W) \
  launch<E, D, W>(nt, M, T, s, window, has, fb_in, depth_in, fb, depth_out, ntx, bg)
  switch (key) {
    case kBlend * 4 + 0: HANABI_TB(kBlend, false, false); break;
    case kBlend * 4 + 2: HANABI_TB(kBlend, true, false); break;
    case kAdd * 4 + 0: HANABI_TB(kAdd, false, false); break;
    case kAdd * 4 + 2: HANABI_TB(kAdd, true, false); break;
    case kOpaque * 4 + 0: HANABI_TB(kOpaque, false, false); break;
    case kOpaque * 4 + 2: HANABI_TB(kOpaque, true, false); break;
    case kOpaque * 4 + 3: HANABI_TB(kOpaque, true, true); break;
    case kMask * 4 + 0: HANABI_TB(kMask, false, false); break;
    case kMask * 4 + 2: HANABI_TB(kMask, true, false); break;
    case kMask * 4 + 3: HANABI_TB(kMask, true, true); break;
    case kScene * 4 + 3: HANABI_TB(kScene, true, true); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef HANABI_TB
  return (int)cudaGetLastError();
}
