// Variant of bevy_hanabi_tpu_torch/csrc/tile_blend.cu kept for comparison: the
// first redesign (per-entry det, a pre-test before the two divisions, ballot
// culling per 8x4 warp block).
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
// Bound on the H100: each pixel's RGBA and depth live in registers for the
// whole loop and are written once (20 B per pixel, 5 MB at 512x512), and
// each tile's M * 4W B of window rows is read once into shared memory. What
// the reference does besides is arithmetic: M * T*T entry-pixel tests per
// tile, each ~17 flops and two IEEE divisions. The particles are small (the
// headline's quads span ~2 px), so nearly every (entry, pixel) pair is
// plainly uncovered; the design spends its issue slots on deciding that
// cheaply and exactly, and keeps the full test for the pairs that pass.
//
// Design: one CTA per tile; each warp owns an 8x4 block of the tile's pixels
// (row-major pixels where T is not a multiple of 8), one pixel a thread.
// 1. Load: the tile's rows into shared memory with 16-byte loads (M * W * 4
//    contiguous bytes); then per entry, once: the clamped det (the same float
//    ops as the reference), the pre-test threshold fl(|det| * (1 + 2^-22)),
//    and whether the entry may be culled (it has a real entry, finite quad
//    columns and det, and a det that was not clamped).
// 2. Warp culling: for each run of 32 entries, lane k tests entry m0 + k
//    against the warp's pixel block (below) and __ballot_sync gives the
//    entries that may cover a pixel of the block; the warp walks the set bits
//    in ascending m, so the blend order is the reference's.
// 3. Per pixel: num_u = a2y*dx - a2x*dy and num_v = -a1y*dx + a1x*dy exactly
//    as the reference; the pair is skipped when |num_u| or |num_v| exceeds
//    fl(|det| * (1 + 2^-22)); only the pairs left run the two divisions and
//    the reference's |u|, |v| <= 1 test.
//
// Why each skip is exact (skipped pairs are uncovered under the reference's
// test, so no pixel changes):
// * Pre-test. fl is monotone and rounds to nearest, so fl(|det|(1 + 2^-22))
//   >= |det|(1 + 2^-22)(1 - 2^-24) > |det|(1 + 2^-24). |num| above it makes
//   |num / det| > 1 + 2^-24, the rounding midpoint above 1, so the rounded
//   quotient exceeds 1. NaN or an overflowed threshold makes the comparison
//   false: those pairs fall through to the full test.
// * Warp block. Let X(px, py) = N / det with N the exact affine numerator
//   a2y (px - cx) - a2x (py - cy), and S = (|a2y||px - cx| + |a2x||py - cy|)
//   / |det|. The reference's float u (dx, dy, two products, one difference,
//   one quotient: five roundings of relative error u = 2^-24) satisfies
//   |u_f - X| <= gamma_3 S (1 + u) + u |X|, plus at most 2^-149 / 1e-9 from
//   subnormal products (|det| >= 1e-9 where it is not clamped). Hence
//   |X| > 1 + 8u (S + 1) gives |u_f| > 1, with more than 6u to spare for the
//   subnormal term. X is affine in the pixel, so over the block its extremes
//   are at the corners, and S <= Smax from the block's largest |px - cx|,
//   |py - cy|. The lane evaluates the corner numerators in double and culls
//   when all exceed |det| (1 + m) or all lie below -|det| (1 + m), with
//   m = 2^-20 (Smax + 1): twice the margin needed, which also covers the
//   double's own rounding (2^-53 relative).
//   The same for v. A reference computation that overflows yields an inf or
//   NaN u, which is uncovered too. Entries with a clamped det, non-finite
//   columns or no real entry are never culled by the bound.
// The per-pixel loop then matches the reference as before: uncovered lanes
// (outside the quad, a depth-failed fragment, a padding entry) leave the
// pixel untouched. JAX folds them in with coverage 0 (raster.py:822-828),
// which leaves a pixel untouched exactly while it is finite and its alpha is
// at most 1: that is the limit of the skip. ADD's `min(a + a_d, 1)` also
// runs on uncovered lanes in JAX, so the standalone ADD variant clamps the
// starting alpha once before the loop, which gives JAX's result for any
// alpha; the painter's ADD entries assume alpha <= 1. A NaN row never
// reaches a pixel it does not cover. The det clamp that is not
// sign-preserving (raster.py:629-630) and the |u|,|v| <= 1 test are kept.
//
// Variants: the equation and the two depth flags are template parameters,
// so each variant reads only the columns it uses, from rows of its own width
// (RowWidth):
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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kColDepth = 10;
constexpr int kColCutoff = 11;
constexpr int kColMode = 12;
constexpr int kBlockW = 8, kBlockH = 4;  // a warp's pixel block

// entry flags (shared memory): no real entry; the full test only; cullable
constexpr uint8_t kSkip = 0, kExact = 1, kCullable = 2;

enum Eq { kBlend = 0, kAdd = 1, kOpaque = 2, kMask = 3, kScene = 4 };

// floats per window row: 13 where the variant reads depth, cutoff or mode
template <int kEq, bool kDepth>
struct RowWidth {
  static constexpr int value = (kDepth || kEq == kMask || kEq == kScene) ? 13 : 10;
};

// True when the entry's quad provably covers no pixel centre in
// [x0, x1] x [y0, y1] under the reference's float test (the header's proof).
__device__ __forceinline__ bool block_culled(const float* r, float det, float x0, float x1,
                                             float y0, float y1) {
  const double cx = r[0], cy = r[1];
  const double a1x = r[2], a1y = r[3], a2x = r[4], a2y = r[5];
  const double ad = fabs((double)det);
  const double dx0 = (double)x0 - cx, dx1 = (double)x1 - cx;
  const double dy0 = (double)y0 - cy, dy1 = (double)y1 - cy;
  const double mx = fmax(fabs(dx0), fabs(dx1)), my = fmax(fabs(dy0), fabs(dy1));
  constexpr double kRel = 0x1p-20;  // twice 8u, u = 2^-24
  // u: N = a2y dx - a2x dy, separable, so its range over the block is the
  // sum of the two terms' ranges (the corners)
  const double bu = ad * (1.0 + kRel) + kRel * (fabs(a2y) * mx + fabs(a2x) * my);
  const double ux0 = a2y * dx0, ux1 = a2y * dx1, uy0 = -a2x * dy0, uy1 = -a2x * dy1;
  const double u_lo = fmin(ux0, ux1) + fmin(uy0, uy1), u_hi = fmax(ux0, ux1) + fmax(uy0, uy1);
  if (u_lo > bu || u_hi < -bu) return true;
  // v: N = -a1y dx + a1x dy
  const double bv = ad * (1.0 + kRel) + kRel * (fabs(a1y) * mx + fabs(a1x) * my);
  const double vx0 = -a1y * dx0, vx1 = -a1y * dx1, vy0 = a1x * dy0, vy1 = a1x * dy1;
  const double v_lo = fmin(vx0, vx1) + fmin(vy0, vy1), v_hi = fmax(vx0, vx1) + fmax(vy0, vy1);
  return v_lo > bv || v_hi < -bv;
}

// One entry into one pixel: the reference's coverage test (after the exact
// pre-test), depth test and equation. Returns without touching the pixel
// where the entry does not cover it.
template <int kEq, bool kDepth, bool kWrite>
__device__ __forceinline__ void blend_entry(const float* __restrict__ r, float det, float thr,
                                            float px, float py, float4& d, float& dbuf) {
  const float dx = px - r[0];
  const float dy = py - r[1];
  const float a1x = r[2], a1y = r[3], a2x = r[4], a2y = r[5];
  const float nu = a2y * dx - a2x * dy;
  const float nv = -a1y * dx + a1x * dy;
  if (fabsf(nu) > thr || fabsf(nv) > thr) return;  // |u| or |v| > 1, exactly
  const float u = nu / det;
  const float v = nv / det;
  if (!(fabsf(u) <= 1.0f && fabsf(v) <= 1.0f)) return;
  float frag_d = 0.0f;
  if (kDepth) {
    frag_d = r[kColDepth];
    if (!(frag_d <= dbuf)) return;
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
    if (kEq == kMask && !(a >= r[kColCutoff])) return;
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
      return;
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

template <int kEq, bool kDepth, bool kWrite>
__global__ void tile_blend_kernel(const float* __restrict__ window,
                                  const uint8_t* __restrict__ has,
                                  const float4* __restrict__ fb_in,
                                  const float* __restrict__ depth_in,
                                  float4* __restrict__ fb,
                                  float* __restrict__ depth_out,
                                  int M, int T, int ntx, int vec, float4 background) {
  constexpr int kRow = RowWidth<kEq, kDepth>::value;
  extern __shared__ __align__(16) float smem[];
  const int row_floats = (M * kRow + 3) & ~3;
  float* rows = smem;                        // [M, kRow]
  float* s_det = smem + row_floats;          // [M] clamped det
  float* s_thr = s_det + M;                  // [M] pre-test threshold
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(s_thr + M);  // [M]
  const int tile = blockIdx.x;
  const int t = threadIdx.x;

  // ---- 1. the tile's rows and the per-entry terms ----
  const float* src = window + (int64_t)tile * M * kRow;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(rows);
    for (int k = t; k < M * kRow / 4; k += blockDim.x) d4[k] = s4[k];
  } else {
    for (int k = t; k < M * kRow; k += blockDim.x) rows[k] = src[k];
  }
  __syncthreads();
  for (int m = t; m < M; m += blockDim.x) {
    const float* r = rows + m * kRow;
    float det = r[2] * r[5] - r[3] * r[4];
    const bool clamped = fabsf(det) < 1e-9f;
    det = clamped ? 1e-9f : det;
    s_det[m] = det;
    s_thr[m] = fabsf(det) * (1.0f + 0x1p-22f);  // fl(|det| * (1 + 2^-22))
    bool finite = isfinite(det);
    for (int c = 0; c < 6; ++c) finite = finite && isfinite(r[c]);
    s_flag[m] = !has[(int64_t)tile * M + m] ? kSkip : (finite && !clamped ? kCullable : kExact);
  }
  __syncthreads();

  // ---- this thread's pixel and its warp's block ----
  const int lane = t & 31, warp = t >> 5;
  const bool live = t < T * T;
  int pi, pj;  // row and column inside the tile
  if (T % kBlockW == 0) {
    const int per_row = T / kBlockW;
    pi = (warp / per_row) * kBlockH + lane / kBlockW;
    pj = (warp % per_row) * kBlockW + lane % kBlockW;
  } else {
    const int lin = live ? t : T * T - 1;  // a padding lane repeats the last pixel
    pi = lin / T;
    pj = lin - pi * T;
  }
  const int64_t pix = (int64_t)tile * T * T + pi * T + pj;
  const float px = (float)((tile % ntx) * T + pj) + 0.5f;
  const float py = (float)((tile / ntx) * T + pi) + 0.5f;
  float x0 = px, x1 = px, y0 = py, y1 = py;
  for (int o = 16; o > 0; o >>= 1) {
    x0 = fminf(x0, __shfl_xor_sync(0xffffffffu, x0, o));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, o));
    y0 = fminf(y0, __shfl_xor_sync(0xffffffffu, y0, o));
    y1 = fmaxf(y1, __shfl_xor_sync(0xffffffffu, y1, o));
  }

  float4 d = (fb_in && live) ? fb_in[pix] : background;
  float dbuf = INFINITY;
  if (kDepth && depth_in && live) dbuf = depth_in[pix];
  if (kEq == kAdd && M > 0) d.w = d.w > 1.0f ? 1.0f : d.w;

  // ---- 2-3. runs of 32 entries: cull against the block, blend the rest ----
  for (int m0 = 0; m0 < M; m0 += 32) {
    const int m = m0 + lane;
    bool keep = false;
    if (m < M) {
      const uint8_t f = s_flag[m];
      keep = f == kExact ||
             (f == kCullable && !block_culled(rows + m * kRow, s_det[m], x0, x1, y0, y1));
    }
    unsigned int mask = __ballot_sync(0xffffffffu, keep);
    while (mask) {
      const int e = m0 + __ffs(mask) - 1;
      mask &= mask - 1;
      blend_entry<kEq, kDepth, kWrite>(rows + e * kRow, s_det[e], s_thr[e], px, py, d,
                                             dbuf);
    }
  }
  if (live) {
    fb[pix] = d;
    if (kWrite) depth_out[pix] = dbuf;
  }
}

template <int kEq, bool kDepth, bool kWrite>
void launch(int nt, int M, int T, cudaStream_t stream, const void* window,
            const void* has, const void* fb_in, const void* depth_in, void* fb,
            void* depth_out, int ntx, float4 bg) {
  constexpr int kRow = RowWidth<kEq, kDepth>::value;
  const size_t row_floats = ((size_t)M * kRow + 3) & ~(size_t)3;
  const size_t smem = row_floats * sizeof(float) + 2 * (size_t)M * sizeof(float) + (size_t)M;
  const int vec = ((uintptr_t)window & 15u) == 0 && (M * kRow) % 4 == 0;
  const int threads = (T * T + 31) / 32 * 32;
  tile_blend_kernel<kEq, kDepth, kWrite><<<nt, threads, smem, stream>>>(
      (const float*)window, (const uint8_t*)has, (const float4*)fb_in,
      (const float*)depth_in, (float4*)fb, (float*)depth_out, M, T, ntx, vec, bg);
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
  if (T <= 0 || T * T > 1024) return (int)cudaErrorInvalidValue;
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
