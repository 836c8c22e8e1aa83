// Variant of bevy_hanabi_tpu_torch/csrc/tile_blend.cu kept for comparison: the
// first version of the appearance variants (kAppear), every covered pair
// shaded on the lane that covers it, the quad bound culling triangles, fmodf
// wrap addressing. Built by experiments/torch_tile_blend_variants.py and
// chip_smoke.py (first_ms of the appearance rows); the port does not use it.
//
// tile_blend: the per-tile bounded blend loop of the tile rasterizer, for
// every equation of the port: BLEND, PREMULTIPLY, ADD, MULTIPLY, OPAQUE,
// MASK and the painter's per-entry SCENE equation, with an optional
// per-pixel depth test, and the per-fragment appearance of textured, round
// and mesh particles.
//
// Replaces bevy_hanabi_tpu/render/raster.py:616-911 (`blend_one` / `body`:
// the six equations and the scene branch, raster.py:832-895; the depth test
// and depth writes, raster.py:675-682, 854-855, 894-895, 909; the triangle
// inside test, the squircle, barycentric UVs / normals / vertex colours,
// the Lambert shade, the flipbook cell and the texture layers,
// raster.py:121-146, 616-618, 635-642, 683-776; no antialiasing). The JAX package
// leaves it to XLA on the TPU, which streams the whole [nt, T, T, 4]
// framebuffer (and the [nt, T, T] depth plane) through device memory once
// per group of `blend_unroll` entries; it has no Pallas kernel.
//
// Input: window [nt, M, W] f32 rows (cx, cy, h1x, h1y, h2x, h2y, r, g, b,
// a, then depth, cutoff, mode where W = 13), the tile's entries in blend
// order; W is 13 for a variant that reads a column past alpha (a depth test,
// MASK, SCENE) and 10 otherwise (plain BLEND, PREMULTIPLY, ADD, MULTIPLY,
// OPAQUE), plus the draw's appearance columns (below); has [nt, M] bool;
// the texture layers [th, tw, 4] f32; optionally the seeded framebuffer fb_in [nt, T, T, 4] (else the
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
// cheaply and exactly. A covered pixel of a textured entry adds four
// texel loads a layer (from L1/L2: a 32x32 texture is 16 KB) and ~30 flops;
// a lit one ~25 flops and a square root.
//
// Design: one CTA per tile, one pixel a thread; where T is a multiple of 8
// each warp owns an 8x4 block of the tile's pixels, else the pixels are
// row-major. A warp's block is the bounding box of its pixel centres.
// 1. Load: every global load is issued before the first barrier: the
//    thread's framebuffer and depth pixels into registers, the tile's rows
//    (M * W * 4 contiguous bytes, 16-byte loads) and has flags into shared
//    memory. Then per entry, once: the clamped det (the same float ops as
//    the reference) and the entry's test: none (no real entry), the
//    reference's divisions (a det that is not finite), the comparisons
//    below (a finite det), and whether the bound may cull it (also finite
//    quad columns and a det that was not clamped).
// 2. Warp culling: for each run of 32 entries, lane k tests entry m0 + k
//    against the warp's pixel block (below) and __ballot_sync gives the
//    entries that may cover a pixel of the block; the warp walks the set bits
//    in ascending m, so the blend order is the reference's.
// 3. Per pixel: num_u = a2y*dx - a2x*dy and num_v = -a1y*dx + a1x*dy exactly
//    as the reference, then |num_u| <= |det| and |num_v| <= |det| in place of
//    the reference's two divisions and |u|, |v| <= 1 test.
//
// Why this is the reference's coverage, pair for pair:
// * No division. For a finite det, |det| >= 1e-9 (the clamp), so |det| is a
//   normal float. Let x = |num| and d = |det|; the reference's |u| is
//   fl(x / d), rounded to nearest. If x <= d then x / d <= 1 and, fl being
//   monotone with 1 representable, fl(x / d) <= 1. If x > d then, both
//   being floats, x >= d + ulp(d) with ulp(d) / d > 2^-24, so x / d lies
//   above 1 + 2^-24, the rounding midpoint above 1, and fl(x / d) > 1. A NaN
//   num fails both comparisons as the reference's NaN u fails its test, and
//   an infinite num fails them as the reference's infinite u does. Only a
//   det that is not finite (inf / inf is NaN where inf <= inf holds) keeps
//   the divisions.
// * Warp block. Let N(px, py) = a2y (px - cx) - a2x (py - cy), the exact
//   affine numerator, and S = |a2y||px - cx| + |a2x||py - cy|. The
//   reference's float num_u (each of its two terms through three roundings
//   of relative error 2^-24: the difference dx or dy, the product, the final
//   difference) satisfies |num_u - N| <= gamma_3 S, plus at most 2^-149 from
//   subnormal products. Hence |N| > |det| +
//   2^-22 S gives |num_u| > |det|: uncovered; the subnormal term is far
//   below the margin, as |det| >= 1e-9 where it is not clamped. N is affine
//   in the pixel, so over the block its extremes are at the corners, and
//   S <= Smax from the block's largest |px - cx|, |py - cy|. The lane
//   evaluates the corner numerators in double and culls when all exceed
//   |det| (1 + m) + m Smax or all lie below its negative, m = 2^-20: four
//   times the margin needed, which also covers the double's own rounding
//   (2^-53 relative). The same for v. Entries with a clamped or non-finite
//   det, non-finite columns or no real entry are never culled by the bound.
// The per-pixel loop then matches the reference as before: uncovered lanes
// (outside the quad, a depth-failed fragment, a padding entry) leave the
// pixel untouched. JAX folds them in with coverage 0 (raster.py:822-828),
// which leaves a pixel untouched exactly while it is finite and its alpha is
// at most 1: that is the limit of the skip. ADD's `min(a + a_d, 1)` also
// runs on uncovered lanes in JAX, so the standalone ADD variant clamps the
// starting alpha once before the loop, which gives JAX's result for any
// alpha; the painter's ADD entries assume alpha <= 1. A NaN row never
// reaches a pixel it does not cover. The det clamp that is not
// sign-preserving (raster.py:629-630) is kept.
//
// Appearance (the kAppear variants, for a draw with any appearance column
// or texture layer). The row holds, after its 10 or 13 floats, the draw's
// appearance columns in JAX's order (roundness, tri, sprite, uv (6), nrm
// (9), vcol (12)), each present or absent for the whole call; a per-call
// descriptor (Appearance) gives each column's offset, or -1, the flipbook
// grid, the Lambert parameters and up to kMaxLayers texture layers (pointer,
// size, mapping). Every field is uniform across the grid, so each of its
// branches is uniform across a warp. Per covered pixel, in JAX's op order:
// * Triangle test. A triangle entry keeps the reference's divisions,
//   u = num_u / det and v = num_v / det, and its test u >= -0.5, v >= -0.5,
//   fl(u) + fl(v) <= 0 in float (fl(u) + fl(v) is not (num_u + num_v) /
//   det). The warp-block cull stays valid for it: a pixel the triangle
//   covers has |fl(u)|, |fl(v)| <= 0.5 <= 1 (u >= -0.5 and v >= -0.5 with
//   u + v <= 0 bound each by 0.5 above), so the quad bound, which culls only
//   pairs with |fl(u)| > 1 or |fl(v)| > 1 at every pixel of the block,
//   never culls it. A quad entry takes the division-free test, then the two
//   divisions for its UVs.
// * Squircle: |1 - 2u'|^n + |1 - 2v'|^n <= 1 (u' = u/2 + 1/2, n = 2 /
//   max(roundness, 1e-6); powf, which may differ from XLA's pow in the last
//   ulp, so a pixel on the squircle's edge may flip), skipped for triangles
//   and for roundness <= 0.
// * Barycentric attributes at (s, t) = (u + 1/2, v + 1/2): A + s (B - A) +
//   t (C - A), for vertex colours (which modulate the colour), normals
//   (normalised by max(|n|, 1e-9), then the shade clip(n.l, band, 1) as
//   max then min, keeping a NaN) and a triangle's UVs (where the entry's
//   first UV is finite; NaN-padded entries keep the quad's u', v').
// * The flipbook cell: u'' = (u' + mod(sprite, cols)) / cols, v'' = (v' +
//   floor_div(sprite, cols)) / rows, with jnp.mod's and jnp.floor_divide's
//   float semantics (a floored remainder: C's fmodf with the sign fixed), the
//   divisions by the grid as XLA compiles them: products with the f32
//   reciprocals.
// * Texture layers: bilinear filtering with wrap addressing in software in
//   f32 (no texture objects: their filter weights are 8-bit fixed point),
//   JAX's `_bilinear_wrap` op for op: uu = u * tw - 0.5, the floor, the
//   fractions, four taps at floored-mod indices, two lerps; then modulate,
//   modulate_rgb or modulate_opacity_from_r.
//
// Variants: the equation, the two depth flags and kAppear are template
// parameters, so each variant reads only the columns it uses; without
// appearance, from rows of its own width (RowWidth):
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
constexpr int kBlockW = 8, kBlockH = 4;  // a warp's 32 lanes as 8 x 4 pixels
constexpr int kMaxLayers = 4;            // texture layers of one call

// an entry's test (shared memory): no real entry; the reference's
// divisions; the comparisons; the comparisons after the warp-block bound
constexpr uint8_t kSkip = 0, kDivide = 1, kCompare = 2, kCullable = 3;

enum Eq { kBlend = 0, kAdd = 1, kOpaque = 2, kMask = 3, kScene = 4, kPremultiply = 5,
          kMultiply = 6 };

// the texture mappings of a layer (ImageSampleMapping)
enum Mapping { kModulate = 0, kModulateRgb = 1, kOpacityFromR = 2 };

// A call's appearance: where each column sits in the row (-1: absent), the
// flipbook grid, the Lambert parameters and the texture layers ([th, tw, 4]
// f32 each, row-major).
struct Appearance {
  int row;  // floats per window row
  int o_round, o_tri, o_sprite, o_uv, o_nrm, o_vcol;
  int grid_c, grid_r;
  int lit;
  float lx, ly, lz, band;
  int layers;
  const float4* tex[kMaxLayers];
  int tw[kMaxLayers], th[kMaxLayers], map[kMaxLayers];
};

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
  constexpr double kRel = 0x1p-20;  // four times gamma_3 ~ 3 * 2^-24
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

// jnp.maximum / jnp.minimum against a constant: a NaN stays NaN
__device__ __forceinline__ float at_least(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float at_most(float x, float hi) { return x > hi ? hi : x; }

// The equation of a covered fragment of source colour s (alpha * coverage,
// coverage == 1 here) onto the pixel d: raster.py:832-895.
template <int kEq, bool kWrite>
__device__ __forceinline__ void equation(float4 s, const float* __restrict__ r, float frag_d,
                                         float4& d, float& dbuf) {
  const float a = s.w;
  if (kEq == kAdd) {
    d.x = s.x * a + d.x;
    d.y = s.y * a + d.y;
    d.z = s.z * a + d.z;
    const float sa = a + d.w;
    d.w = sa > 1.0f ? 1.0f : sa;  // min(s, 1) that keeps a NaN, as jnp.minimum
  } else if (kEq == kBlend) {
    const float ia = 1.0f - a;
    d.x = s.x * a + d.x * ia;
    d.y = s.y * a + d.y * ia;
    d.z = s.z * a + d.z * ia;
    d.w = a + d.w * ia;
  } else if (kEq == kPremultiply) {  // rgb_s * coverage + rgb_d * (1 - a)
    const float ia = 1.0f - a;
    d.x = s.x + d.x * ia;
    d.y = s.y + d.y * ia;
    d.z = s.z + d.z * ia;
    d.w = a + d.w * ia;
  } else if (kEq == kMultiply) {  // rgb_s * rgb_d * a + rgb_d * (1 - a); alpha kept
    const float ia = 1.0f - a;
    d.x = s.x * d.x * a + d.x * ia;
    d.y = s.y * d.y * a + d.y * ia;
    d.z = s.z * d.z * a + d.z * ia;
  } else if (kEq == kOpaque || kEq == kMask) {
    if (kEq == kMask && !(a >= r[kColCutoff])) return;
    d = make_float4(s.x, s.y, s.z, 1.0f);
    if (kWrite) dbuf = frag_d;
  } else {  // kScene
    const float mode = r[kColMode];
    const bool is_o = mode == 4.0f, is_k = mode == 5.0f;
    if (is_o || is_k) {
      if (is_o || a >= r[kColCutoff]) {
        d = make_float4(s.x, s.y, s.z, 1.0f);
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
    d.x = s.x * cs + d.x * cd + s.x * d.x * cm;
    d.y = s.y * cs + d.y * cd + s.y * d.y * cm;
    d.z = s.z * cs + d.z * cd + s.z * d.z * cm;
    d.w = al;
  }
}

// jnp.mod of floats: the remainder with the sign of the divisor
__device__ __forceinline__ float floor_mod(float x, float y) {
  float m = fmodf(x, y);
  if (m != 0.0f && ((m < 0.0f) != (y < 0.0f))) m += y;
  return m;
}

// jnp.floor_divide of floats (jax's _float_divmod): (x - fmod(x, y)) / y,
// less one where the remainder's sign differs from y's, rounded
__device__ __forceinline__ float floor_div(float x, float y) {
  const float m = fmodf(x, y);
  float q = (x - m) / y;
  if (m != 0.0f && ((m < 0.0f) != (y < 0.0f))) q -= 1.0f;
  return roundf(q);
}

// A + s (B - A) + t (C - A) (raster.py:706-716)
__device__ __forceinline__ float bary(float va, float vb, float vc, float s, float t) {
  return va + s * (vb - va) + t * (vc - va);
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float f) {
  return make_float4(a.x + (b.x - a.x) * f, a.y + (b.y - a.y) * f, a.z + (b.z - a.z) * f,
                     a.w + (b.w - a.w) * f);
}

// _bilinear_wrap (raster.py:121-146) on a [th, tw, 4] texture
__device__ __forceinline__ float4 sample(const float4* __restrict__ tex, int tw, int th, float u,
                                         float v) {
  const float twf = (float)tw, thf = (float)th;
  const float uu = u * twf - 0.5f, vv = v * thf - 0.5f;
  const float u0 = floorf(uu), v0 = floorf(vv);
  const float fu = uu - u0, fv = vv - v0;
  // in [0, tw) and [0, th); a NaN converts to 0, as XLA's saturating cast
  const int u0i = (int)floor_mod(u0, twf), v0i = (int)floor_mod(v0, thf);
  const int u1i = (int)floor_mod(u0 + 1.0f, twf), v1i = (int)floor_mod(v0 + 1.0f, thf);
  const float4 t00 = __ldg(tex + v0i * tw + u0i), t01 = __ldg(tex + v0i * tw + u1i);
  const float4 t10 = __ldg(tex + v1i * tw + u0i), t11 = __ldg(tex + v1i * tw + u1i);
  return lerp4(lerp4(t00, t01, fu), lerp4(t10, t11, fu), fv);
}

// One entry into one pixel: the reference's coverage test (the comparisons,
// or the divisions where `divide`; with kAppear a triangle entry's own test),
// depth test, with kAppear the call's appearance (the header: the squircle,
// then the source colour by vertex colours, Lambert and texture layers), and
// the equation. Returns without touching the pixel where the entry does not
// cover it. Without kAppear it reads only the row's first 10 or 13 floats.
template <int kEq, bool kDepth, bool kWrite, bool kAppear>
__device__ __forceinline__ void blend_entry(const float* __restrict__ r, float det, bool divide,
                                            float px, float py, float4& d, float& dbuf,
                                            const Appearance& ap) {
  const float dx = px - r[0];
  const float dy = py - r[1];
  const float a1x = r[2], a1y = r[3], a2x = r[4], a2y = r[5];
  const float nu = a2y * dx - a2x * dy;
  const float nv = -a1y * dx + a1x * dy;
  bool is_tri = false;
  if constexpr (kAppear) is_tri = ap.o_tri >= 0 && r[ap.o_tri] > 0.5f;
  float u = 0.0f, v = 0.0f;
  if (is_tri) {
    u = nu / det;
    v = nv / det;
    if (!(u >= -0.5f && v >= -0.5f && u + v <= 0.0f)) return;
  } else if (divide) {
    u = nu / det;
    v = nv / det;
    if (!(fabsf(u) <= 1.0f && fabsf(v) <= 1.0f)) return;
  } else {
    const float ad = fabsf(det);
    if (!(fabsf(nu) <= ad && fabsf(nv) <= ad)) return;  // |u|, |v| <= 1, exactly
    if constexpr (kAppear) {
      u = nu / det;
      v = nv / det;
    }
  }
  float frag_d = 0.0f;
  if (kDepth) {
    frag_d = r[kColDepth];
    if (!(frag_d <= dbuf)) return;
  }
  float4 s = make_float4(r[6], r[7], r[8], r[9]);
  if constexpr (kAppear) {
    const float u01 = u * 0.5f + 0.5f, v01 = v * 0.5f + 0.5f;
    if (ap.o_round >= 0 && !is_tri) {  // raster.py:690-700
      const float rnd = r[ap.o_round];
      if (!(rnd <= 0.0f)) {
        const float nexp = 2.0f / at_least(rnd, 1e-6f);
        const float sq =
            powf(fabsf(1.0f - 2.0f * u01), nexp) + powf(fabsf(1.0f - 2.0f * v01), nexp);
        if (!(sq <= 1.0f)) return;
      }
    }
    const float bs = u + 0.5f, bt = v + 0.5f;
    if (ap.o_vcol >= 0) {  // raster.py:719-722
      const float* c = r + ap.o_vcol;
      s.x = s.x * bary(c[0], c[4], c[8], bs, bt);
      s.y = s.y * bary(c[1], c[5], c[9], bs, bt);
      s.z = s.z * bary(c[2], c[6], c[10], bs, bt);
      s.w = s.w * bary(c[3], c[7], c[11], bs, bt);
    }
    if (ap.lit) {  // raster.py:723-740
      const float* nr = r + ap.o_nrm;
      float n0 = bary(nr[0], nr[3], nr[6], bs, bt);
      float n1 = bary(nr[1], nr[4], nr[7], bs, bt);
      float n2 = bary(nr[2], nr[5], nr[8], bs, bt);
      const float len = at_least(sqrtf(n0 * n0 + n1 * n1 + n2 * n2), 1e-9f);
      n0 = n0 / len;
      n1 = n1 / len;
      n2 = n2 / len;
      const float ndotl = n0 * ap.lx + n1 * ap.ly + n2 * ap.lz;
      const float shade = at_most(at_least(ndotl, ap.band), 1.0f);
      s.x = s.x * shade;
      s.y = s.y * shade;
      s.z = s.z * shade;
    }
    if (ap.layers) {  // raster.py:741-776
      float tu = u01, tv = v01;
      if (is_tri && ap.o_uv >= 0 && isfinite(r[ap.o_uv])) {
        const float* w = r + ap.o_uv;
        tu = bary(w[0], w[2], w[4], bs, bt);
        tv = bary(w[1], w[3], w[5], bs, bt);
      }
      if (ap.grid_c != 1 || ap.grid_r != 1) {
        const float sprite = (float)(int)r[ap.o_sprite];  // the row's f32, astype(int32)
        const float gc = (float)ap.grid_c;
        // XLA compiles JAX's division by the grid constant into a product with
        // its f32 reciprocal
        tu = (tu + floor_mod(sprite, gc)) * (1.0f / gc);
        tv = (tv + floor_div(sprite, gc)) * (1.0f / (float)ap.grid_r);
      }
      for (int l = 0; l < ap.layers; ++l) {
        const float4 t = sample(ap.tex[l], ap.tw[l], ap.th[l], tu, tv);
        if (ap.map[l] == kModulate) {
          s = make_float4(s.x * t.x, s.y * t.y, s.z * t.z, s.w * t.w);
        } else if (ap.map[l] == kModulateRgb) {
          s = make_float4(s.x * t.x, s.y * t.y, s.z * t.z, s.w);
        } else {
          s.w = s.w * t.x;
        }
      }
    }
  }
  equation<kEq, kWrite>(s, r, frag_d, d, dbuf);
}

template <int kEq, bool kDepth, bool kWrite, bool kAppear>
__global__ void tile_blend_kernel(const float* __restrict__ window,
                                  const uint8_t* __restrict__ has,
                                  const float4* __restrict__ fb_in,
                                  const float* __restrict__ depth_in,
                                  float4* __restrict__ fb,
                                  float* __restrict__ depth_out,
                                  int M, int T, int ntx, int vec, float4 background,
                                  Appearance ap) {
  const int kRow = kAppear ? ap.row : RowWidth<kEq, kDepth>::value;
  extern __shared__ __align__(16) float smem[];
  const int row_floats = (M * kRow + 3) & ~3;
  float* rows = smem;                                           // [M, kRow]
  float* s_det = smem + row_floats;                             // [M] clamped det
  uint8_t* s_test = reinterpret_cast<uint8_t*>(s_det + M);      // [M] has, then the test
  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;

  // ---- this thread's pixel ----
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
  // every global load of the CTA is in flight before the first barrier
  float4 d = (fb_in && live) ? fb_in[pix] : background;
  float dbuf = (kDepth && depth_in && live) ? depth_in[pix] : INFINITY;
  if (kEq == kAdd && M > 0) d.w = d.w > 1.0f ? 1.0f : d.w;

  // ---- 1. the tile's rows and the per-entry terms ----
  const float* src = window + (int64_t)tile * M * kRow;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(rows);
    for (int k = t; k < M * kRow / 4; k += blockDim.x) d4[k] = s4[k];
  } else {
    for (int k = t; k < M * kRow; k += blockDim.x) rows[k] = src[k];
  }
  for (int m = t; m < M; m += blockDim.x) s_test[m] = has[(int64_t)tile * M + m];
  __syncthreads();
  for (int m = t; m < M; m += blockDim.x) {
    const float* r = rows + m * kRow;
    float det = r[2] * r[5] - r[3] * r[4];
    const bool clamped = fabsf(det) < 1e-9f;
    det = clamped ? 1e-9f : det;
    s_det[m] = det;
    bool finite = true;
    for (int c = 0; c < 6; ++c) finite = finite && isfinite(r[c]);
    s_test[m] = !s_test[m] ? kSkip
                : !isfinite(det) ? kDivide
                : (finite && !clamped) ? kCullable
                : kCompare;
  }
  __syncthreads();

  // the pixel-centre bounds of the warp's block
  float x0 = px, x1 = px, y0 = py, y1 = py;
  for (int o = 16; o > 0; o >>= 1) {
    x0 = fminf(x0, __shfl_xor_sync(0xffffffffu, x0, o));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, o));
    y0 = fminf(y0, __shfl_xor_sync(0xffffffffu, y0, o));
    y1 = fmaxf(y1, __shfl_xor_sync(0xffffffffu, y1, o));
  }

  // ---- 2-3. runs of 32 entries: cull against the block, blend the rest ----
  for (int m0 = 0; m0 < M; m0 += 32) {
    const int m = m0 + lane;
    bool keep = false;
    if (m < M) {
      const uint8_t test = s_test[m];
      keep = test == kDivide || test == kCompare ||
             (test == kCullable && !block_culled(rows + m * kRow, s_det[m], x0, x1, y0, y1));
    }
    unsigned int mask = __ballot_sync(0xffffffffu, keep);
    while (mask) {
      const int e = m0 + __ffs(mask) - 1;
      mask &= mask - 1;
      blend_entry<kEq, kDepth, kWrite, kAppear>(rows + e * kRow, s_det[e], s_test[e] == kDivide,
                                                px, py, d, dbuf, ap);
    }
  }
  if (live) {
    fb[pix] = d;
    if (kWrite) depth_out[pix] = dbuf;
  }
}

template <int kEq, bool kDepth, bool kWrite, bool kAppear>
void launch(int nt, int M, int T, cudaStream_t stream, const void* window,
            const void* has, const void* fb_in, const void* depth_in, void* fb,
            void* depth_out, int ntx, float4 bg, const Appearance& ap) {
  const int row = kAppear ? ap.row : RowWidth<kEq, kDepth>::value;
  const size_t row_floats = ((size_t)M * row + 3) & ~(size_t)3;
  const size_t smem = row_floats * sizeof(float) + (size_t)M * sizeof(float) + (size_t)M;
  const int vec = ((uintptr_t)window & 15u) == 0 && (M * row) % 4 == 0;
  const int threads = (T * T + 31) / 32 * 32;
  tile_blend_kernel<kEq, kDepth, kWrite, kAppear><<<nt, threads, smem, stream>>>(
      (const float*)window, (const uint8_t*)has, (const float4*)fb_in,
      (const float*)depth_in, (float4*)fb, (float*)depth_out, M, T, ntx, vec, bg, ap);
}

}  // namespace

// eq: 0 blend, 1 add, 2 opaque, 3 mask, 4 scene, 5 premultiply, 6 multiply.
// depth_test / write_depth as the wrapper validates them: write_depth needs
// depth_test and an opaque, mask or scene equation; scene needs both. fb_in
// and depth_in may be NULL. ap_i NULL: no appearance, the window's rows
// RowWidth<eq, depth_test>::value floats wide (row is then not read).
// Otherwise rows of `row` floats and the descriptor: ap_i = [o_round, o_tri,
// o_sprite, o_uv, o_nrm, o_vcol (-1 where absent), grid_c, grid_r, lit,
// layers, then tw, th, mapping of each layer], ap_f = [lx, ly, lz, band],
// textures = the layers' [th, tw, 4] f32 tensors (16-byte aligned). Returns
// cudaErrorInvalidValue for a combination the wrapper never passes.
extern "C" int hanabi_tile_blend_appearance(const void* window, const void* has,
                                            const void* fb_in, const void* depth_in, void* fb,
                                            void* depth_out, int nt, int M, int T, int ntx,
                                            const float* background, int eq, int depth_test,
                                            int write_depth, int row, const int* ap_i,
                                            const float* ap_f, const void* const* textures,
                                            void* stream) {
  float4 bg = make_float4(background[0], background[1], background[2], background[3]);
  if (nt <= 0) return (int)cudaGetLastError();
  if (T <= 0 || T * T > 1024) return (int)cudaErrorInvalidValue;
  Appearance ap = {};
  if (ap_i) {
    ap.row = row;
    int* offsets[6] = {&ap.o_round, &ap.o_tri, &ap.o_sprite, &ap.o_uv, &ap.o_nrm, &ap.o_vcol};
    const int widths[6] = {1, 1, 1, 6, 9, 12};
    for (int c = 0; c < 6; ++c) {
      *offsets[c] = ap_i[c];
      if (ap_i[c] < -1 || (ap_i[c] >= 0 && ap_i[c] + widths[c] > row))
        return (int)cudaErrorInvalidValue;
    }
    ap.grid_c = ap_i[6];
    ap.grid_r = ap_i[7];
    ap.lit = ap_i[8];
    ap.layers = ap_i[9];
    if (ap.layers < 0 || ap.layers > kMaxLayers || (ap.lit && ap.o_nrm < 0) || ap.grid_c < 1 ||
        ap.grid_r < 1 || ((ap.grid_c != 1 || ap.grid_r != 1) && ap.layers && ap.o_sprite < 0))
      return (int)cudaErrorInvalidValue;
    ap.lx = ap_f[0];
    ap.ly = ap_f[1];
    ap.lz = ap_f[2];
    ap.band = ap_f[3];
    for (int l = 0; l < ap.layers; ++l) {
      ap.tw[l] = ap_i[10 + 3 * l];
      ap.th[l] = ap_i[11 + 3 * l];
      ap.map[l] = ap_i[12 + 3 * l];
      ap.tex[l] = (const float4*)textures[l];
      if (!ap.tex[l] || ((uintptr_t)ap.tex[l] & 15u) || ap.tw[l] < 1 || ap.th[l] < 1 ||
          ap.map[l] < kModulate || ap.map[l] > kOpacityFromR)
        return (int)cudaErrorInvalidValue;
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int key = eq * 4 + (depth_test ? 2 : 0) + (write_depth ? 1 : 0);
#define HANABI_TB(E, D, W, A) \
  launch<E, D, W, A>(nt, M, T, s, window, has, fb_in, depth_in, fb, depth_out, ntx, bg, ap)
  if (!ap_i) {
    switch (key) {
      case kBlend * 4 + 0: HANABI_TB(kBlend, false, false, false); break;
      case kBlend * 4 + 2: HANABI_TB(kBlend, true, false, false); break;
      case kAdd * 4 + 0: HANABI_TB(kAdd, false, false, false); break;
      case kAdd * 4 + 2: HANABI_TB(kAdd, true, false, false); break;
      case kOpaque * 4 + 0: HANABI_TB(kOpaque, false, false, false); break;
      case kOpaque * 4 + 2: HANABI_TB(kOpaque, true, false, false); break;
      case kOpaque * 4 + 3: HANABI_TB(kOpaque, true, true, false); break;
      case kMask * 4 + 0: HANABI_TB(kMask, false, false, false); break;
      case kMask * 4 + 2: HANABI_TB(kMask, true, false, false); break;
      case kMask * 4 + 3: HANABI_TB(kMask, true, true, false); break;
      case kScene * 4 + 3: HANABI_TB(kScene, true, true, false); break;
      case kPremultiply * 4 + 0: HANABI_TB(kPremultiply, false, false, false); break;
      case kPremultiply * 4 + 2: HANABI_TB(kPremultiply, true, false, false); break;
      case kMultiply * 4 + 0: HANABI_TB(kMultiply, false, false, false); break;
      case kMultiply * 4 + 2: HANABI_TB(kMultiply, true, false, false); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (key) {
      case kBlend * 4 + 0: HANABI_TB(kBlend, false, false, true); break;
      case kBlend * 4 + 2: HANABI_TB(kBlend, true, false, true); break;
      case kAdd * 4 + 0: HANABI_TB(kAdd, false, false, true); break;
      case kAdd * 4 + 2: HANABI_TB(kAdd, true, false, true); break;
      case kOpaque * 4 + 0: HANABI_TB(kOpaque, false, false, true); break;
      case kOpaque * 4 + 2: HANABI_TB(kOpaque, true, false, true); break;
      case kOpaque * 4 + 3: HANABI_TB(kOpaque, true, true, true); break;
      case kMask * 4 + 0: HANABI_TB(kMask, false, false, true); break;
      case kMask * 4 + 2: HANABI_TB(kMask, true, false, true); break;
      case kMask * 4 + 3: HANABI_TB(kMask, true, true, true); break;
      case kScene * 4 + 3: HANABI_TB(kScene, true, true, true); break;
      case kPremultiply * 4 + 0: HANABI_TB(kPremultiply, false, false, true); break;
      case kPremultiply * 4 + 2: HANABI_TB(kPremultiply, true, false, true); break;
      case kMultiply * 4 + 0: HANABI_TB(kMultiply, false, false, true); break;
      case kMultiply * 4 + 2: HANABI_TB(kMultiply, true, false, true); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef HANABI_TB
  return (int)cudaGetLastError();
}

// The same without appearance (the entry experiments/torch_tile_blend_variants.py links).
extern "C" int hanabi_tile_blend(const void* window, const void* has, const void* fb_in,
                                 const void* depth_in, void* fb, void* depth_out, int nt,
                                 int M, int T, int ntx, const float* background, int eq,
                                 int depth_test, int write_depth, void* stream) {
  return hanabi_tile_blend_appearance(window, has, fb_in, depth_in, fb, depth_out, nt, M, T, ntx,
                                      background, eq, depth_test, write_depth, 0, nullptr,
                                      nullptr, nullptr, stream);
}
