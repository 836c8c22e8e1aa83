// tile_blend: the per-tile bounded blend loop of the tile rasterizer, for
// every equation of the port: BLEND, PREMULTIPLY, ADD, MULTIPLY, OPAQUE,
// MASK and the painter's per-entry SCENE equation, with an optional
// per-pixel depth test, the per-fragment appearance of textured, round and
// mesh particles, the painter's per-entry texture atlas and Lambert setups,
// and analytic antialiasing.
//
// Replaces bevy_hanabi_tpu/render/raster.py:616-911 (`blend_one` / `body`:
// the six equations and the scene branch, raster.py:832-895; the depth test
// and depth writes, raster.py:675-682, 854-855, 894-895, 909; the triangle
// inside test, the squircle, barycentric UVs / normals / vertex colours,
// the Lambert shade, the flipbook cell and the texture layers,
// raster.py:121-146, 616-618, 635-642, 683-776; the painter's atlas and
// per-entry light, raster.py:724-733, 777-813; antialiased coverage,
// raster.py:644-671, 834-839). The JAX package
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
// alpha; in SCENE an ADD entry is never culled, and every lane it does not
// write (uncovered, behind the depth plane, discarded by the squircle)
// clamps its alpha to 1 in the entry's place in the sequence, as JAX's
// uncovered lanes do (alpha above 1 comes from a source alpha above 1:
// HDR colours, vertex colours extrapolated on quads). A NaN row never
// reaches a pixel it does not cover. The det clamp that is not
// sign-preserving (raster.py:629-630) is kept.
//
// Appearance (the appearance kernel, for a draw with any appearance column
// or texture layer). The row holds, after its 10 or 13 floats, the draw's
// appearance columns in JAX's order (roundness, tri, sprite, uv (6), nrm
// (9), vcol (12)), each present or absent for the whole call; a per-call
// descriptor (Appearance) gives each column's offset, or -1, the flipbook
// grid, the Lambert parameters and up to kMaxLayers texture layers (pointer,
// size, mapping). Every field is uniform across the grid, so each of its
// branches is uniform across a warp; the layer loop is unrolled, so each
// layer's fields are read from the parameter bank at constant offsets and
// the descriptor never goes to local memory. What a covered pair costs is
// instructions (~8 covered pairs a pixel on the mesh frame: divisions,
// Lambert's square root and divisions, per layer the wrap and four texel
// loads), so the design cuts the instructions a pair and the idle lanes:
// 1. Per entry, once per CTA (the per-entry pass): besides the det and the
//    test, the triangle flag, the differences B - A and C - A of every
//    barycentric attribute (UVs, normals, vertex colours), written over B
//    and C in the tile's shared rows, and the flipbook cell of the sprite.
//    bary() computes A + s (B - A) + t (C - A) per pair as JAX does, so the
//    difference computed once rounds as the one computed per pair.
// 2. Warp culling as for quads, with a triangle-tight bound for triangle
//    entries (below): a triangle covers u >= -1/2, v >= -1/2, u + v <= 0,
//    an eighth of the quad bound's |u|, |v| <= 1.
// 3. Coverage, per lane, for each surviving entry: the quad test as for
//    quads; a triangle's half-planes decided without dividing where that is
//    exact (below), the two divisions and the reference's test only where it
//    is not. With a depth test that writes no depth the test joins coverage
//    (it is then pure); with depth writes it waits for the blend.
// 4. Compaction: the warp's covered (entry, pixel) pairs go, by
//    __ballot_sync and a prefix __popc, into a per-warp buffer of kPairs
//    pairs in shared memory (entry, lane; the entry's coverage mask once).
//    A pair's source colour is a pure function of (entry, pixel), so when
//    the buffer would overflow, and after the last run, the warp shades the
//    buffered pairs 32 at a time with every lane busy (the divisions for u,
//    v, the squircle, vertex colours, Lambert, the UVs, the texture layers),
//    each lane the pixel of another through __shfl_sync, writes each
//    pair's colour (or a squircle discard) to shared memory, and then each
//    lane blends its own pixel's pairs in ascending entry order: the depth
//    test against the running plane where depth is written, then the
//    equation. Blend order and every float op of a pair are the reference's.
//    Only a draw with the squircle takes this path: there each covered pair
//    pays two powf, and compacting them measured faster than shading them
//    on the covering lane; for every other draw the buffer's shared-memory
//    round trips and its registers cost more than the idle lanes they save
//    (PERF.md, Findings), so each covered pair is shaded on its own lane inside
//    the entry loop.
// 5. Wrap addressing (_bilinear_wrap's jnp.mod of floor(u tw - 1/2) by tw)
//    without fmodf where it is exact (below).
//
// Why the new tests are the reference's, pair for pair (finite det, so
// D = |det| >= 1e-9 is normal; sg = sign(det); x_u = sg num_u and x_v =
// sg num_v, exact negations, so fl(u) = fl(x_u / D) and fl(v) = fl(x_v / D)):
// * u >= -1/2 exactly when x_u >= -D/2 (D/2 is exact). If x_u >= -D/2 then
//   x_u / D >= -1/2 and fl is monotone. If x_u < -D/2, both floats, then
//   |x_u| >= D/2 + ulp(D/2), ulp(D/2) / (D/2) > 2^-24, so x_u / D lies
//   below -1/2 (1 + 2^-24), the rounding midpoint below -1/2, and fl(u) <
//   -1/2. A NaN x_u fails as the reference's NaN u; an infinite one passes
//   or fails as the reference's infinite u. The same for v.
// * fl(u) + fl(v) <= 0: the float sum of two floats is positive exactly when
//   their exact sum is (subnormals are kept). fl(u) + fl(v) >= (x_u + x_v) /
//   D - 2^-24 (|x_u| + |x_v|) / D - 2^-149 (the divisions' roundings, an
//   absolute 2^-150 each where subnormal). The lane's float sum fl(x_u +
//   x_v) is within 2^-24 |x_u + x_v| of the exact one, so fl(x_u + x_v) >
//   2^-20 (|x_u| + |x_v|) + 2^-60 D (each side rounded once more) proves
//   fl(u) + fl(v) > 0: uncovered, with no division. Any other lane,
//   including a NaN or infinite x, takes the divisions and the reference's
//   test verbatim; covered lanes need u and v for the shading anyway.
// * Triangle warp block. With the header's notation, sg N_u = sg (a2y (px -
//   cx) - a2x (py - cy)) and sg N_v are affine in the pixel, and so is sg
//   (N_u + N_v) = sg ((a2y - a1y)(px - cx) + (a1x - a2x)(py - cy)); their
//   extremes over the block are at its corners, evaluated in double. The
//   float numerators are within gamma_3 S of them (S <= S_u resp. S_v as
//   above). So, m = 2^-20 (four times the needed margin, covering the
//   double's own rounding and the subnormal terms, as |det| >= 1e-9):
//   max sg N_u < -(D/2 (1 + m) + m S_u) gives fl(u) < -1/2 at every pixel,
//   min sg N_u > D/2 (1 + m) + m S_u gives fl(u) > 1/2, which with fl(v) >=
//   -1/2 makes fl(u) + fl(v) > 0, the same for v, and min sg (N_u + N_v) >
//   m (D + S_u + S_v) gives x_u + x_v > 2^-24 (|x_u| + |x_v|) + 2^-148 D
//   hence fl(u) + fl(v) > 0 at every pixel. Any of the five culls the
//   block. As for quads, only entries with a finite det that was not
//   clamped and finite quad columns are culled; quad entries keep the quad
//   bound.
// * Wrap. u0 = floor(u tw - 1/2) is an integer-valued float or NaN/inf, and
//   jnp.mod(u0, tw) is C's fmodf with the sign fixed, exact. For tw <= 2^22
//   and u0 in [-tw, 2 tw), |u0| < 2^23: u0 + tw, u0 - tw and u0 + 1 are
//   exact, so the index is u0 + tw, u0 - tw or u0 by two compares (fmodf(-tw,
//   tw) is -0, index 0 all the same), and jnp.mod(u0 + 1, tw) is that index
//   plus one, wrapped at tw. Everything else, NaN included (which converts
//   to index 0), takes fmodf as before. The flipbook cell is once per entry,
//   a sprite in [0, cols) its own column in row 0 without fmodf.
// Per covered pixel, in JAX's op order:
// * Triangle test: u = num_u / det and v = num_v / det, u >= -0.5, v >=
//   -0.5, fl(u) + fl(v) <= 0 in float (fl(u) + fl(v) is not (num_u + num_v) /
//   det). A quad entry: the division-free test, then the two divisions for
//   its UVs.
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
// Variants: the equation and the two depth flags are template parameters of
// both kernels, so each variant reads only the columns it uses; the quad
// kernel from rows of its own width (RowWidth):
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
//
// The painter's atlas (the appearance kernel's SCENE variants, the only
// ones a painter draw takes, an Appearance with atlas_layers; the other
// variants compile without the code below): the row carries, after the sprite, the entry's texture
// state (grid cols, grid rows, then per layer: atlas layer, true width,
// true height, map code) and, after the normals, its Lambert setup (lx, ly,
// lz, band) where the merge had several. The per-entry pass computes the
// cell as JAX does with a traced grid, mod(sprite, cols) and floor(sprite /
// cols) (true divisions: the grid is a per-entry float), and the UVs divide
// by the grid per pair. Each layer samples layer `tid` of the one [L, H, W,
// 4] atlas at texel tid*H*W + v*W + u, at the entry's true size, so the
// zero padding is never read; its map code gives neutral factors (0: the
// layer is absent and is not sampled, as JAX's factors are exactly 1).
// The wrap takes the compare path only for an integer-valued size in [1,
// 2^22] (then exact, as for per-call textures); indices are clamped into
// the atlas as JAX's gather clamps them. The per-call texture layers and
// their descriptor are not used by an atlas draw.
//
// Antialiasing (kAA, RasterConfig.antialias): a pair's coverage is JAX's,
// op for op: quads clip((1 - |u|) eu + 1/2) clip((1 - |v|) ev + 1/2) with
// eu = |h1|, ev = |h2|; triangles the product of clip(d + 1/2) over the
// three half-planes, d1 = (u + 1/2) |det| / max(ev, 1e-9), d2 = (v + 1/2)
// |det| / max(eu, 1e-9), d3 = -(u + v) |det| / max(|h2 - h1|, 1e-9). A lane
// covers where coverage > 0 (the fringe included); the source alpha is
// scaled by it, and PREMULTIPLY's RGB too (SCENE's premultiply term cs is
// the coverage); MASK's and SCENE's cutoffs test the unscaled alpha; opaque
// and mask writes (colour, alpha 1 and depth) take every covered lane. The
// lane computes u, v by division and the coverage in full (no
// division-free test). The warp-block bounds widen to the fringe, with the
// header's notation, D = |det|, e the edge lengths in double and m = 2^-20:
// * Quad: coverage is 0 where fl(fl(1 - |u|) eu) <= -1/2, which holds once
//   |x_u| >= (D + D / (2 eu) (1 + 2^-20)) (1 + 2^-23) (the divisions' and
//   products' roundings, and the float eu within 2^-22 of the double's).
//   So the block is culled where N_u lies beyond +-((D + D / (2 eu)) (1 + 2
//   m) + m S_u) at every corner, or N_v beyond the same with ev.
// * Triangle: a half-plane's factor is 0 where fl(d) <= -1/2, which holds
//   once fl(u + 1/2) <= -(1/2)(1 + 2^-20) max(ev, 1e-9) / D (three
//   roundings of 2^-24), so where sg N_u < -((D + max(ev, 1e-9)) / 2 (1 +
//   2 m) + m S_u) at every corner; the same for v with eu; and sg (N_u +
//   N_v) > max(e12, 1e-9) / 2 (1 + 2 m) + m (D + S_u + S_v) at every
//   corner for the third (the sum's and the divisions' roundings, as in the
//   triangle bound above). The quad-extent culls (u > 1/2, v > 1/2) do not
//   hold under the fringe and are dropped.
// Only entries that are cullable as before and whose three edge lengths in
// float lie in [2^-40, 2^60] (their squares neither underflow nor
// overflow, so the float lengths are within 2^-22 of the double's) are
// culled. A NaN coverage (JAX's on a non-finite row) is not > 0: such a
// lane leaves its pixel untouched, where JAX's PREMULTIPLY term rgb_s *
// coverage would write NaN; no binned entry has a non-finite quad. The
// compacted-pair path is not instantiated with kAA.

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
// the appearance kernel's test byte: the kind above, and a triangle entry's bit
constexpr uint8_t kKindBits = 3, kTri = 4;

// a warp's buffer of covered (entry, pixel) pairs in the appearance kernel:
// at least a run's 32, a multiple of 4 (the rows after it stay 16-byte
// aligned); 32 and 128 measured no faster (PERF.md, Findings)
constexpr int kPairs = 64;
static_assert(kPairs >= 32 && kPairs % 4 == 0);

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
  // the painter's atlas: the tex column's offset and layers an entry (0:
  // none), the per-entry light's offset (-1: the static one above), and the
  // [L, H, W, 4] atlas
  int o_tex, atlas_layers, o_light;
  const float4* atlas;
  int atlas_l, atlas_h, atlas_w;
};

// floats per window row: 13 where the variant reads depth, cutoff or mode
template <int kEq, bool kDepth>
struct RowWidth {
  static constexpr int value = (kDepth || kEq == kMask || kEq == kScene) ? 13 : 10;
};

constexpr double kRel = 0x1p-20;  // four times gamma_3 ~ 3 * 2^-24

// True when |N_u| exceeds fu + m S_u and |N_v| exceeds fv + m S_v at every
// pixel centre in [x0, x1] x [y0, y1] (the header's quad bound: fu = fv =
// D (1 + m); under antialiasing, the fringe's).
__device__ __forceinline__ bool quad_block_culled(const float* r, double fu, double fv,
                                                  float x0, float x1, float y0, float y1) {
  const double cx = r[0], cy = r[1];
  const double a1x = r[2], a1y = r[3], a2x = r[4], a2y = r[5];
  const double dx0 = (double)x0 - cx, dx1 = (double)x1 - cx;
  const double dy0 = (double)y0 - cy, dy1 = (double)y1 - cy;
  const double mx = fmax(fabs(dx0), fabs(dx1)), my = fmax(fabs(dy0), fabs(dy1));
  // u: N = a2y dx - a2x dy, separable, so its range over the block is the
  // sum of the two terms' ranges (the corners)
  const double bu = fu + kRel * (fabs(a2y) * mx + fabs(a2x) * my);
  const double ux0 = a2y * dx0, ux1 = a2y * dx1, uy0 = -a2x * dy0, uy1 = -a2x * dy1;
  const double u_lo = fmin(ux0, ux1) + fmin(uy0, uy1), u_hi = fmax(ux0, ux1) + fmax(uy0, uy1);
  if (u_lo > bu || u_hi < -bu) return true;
  // v: N = -a1y dx + a1x dy
  const double bv = fv + kRel * (fabs(a1y) * mx + fabs(a1x) * my);
  const double vx0 = -a1y * dx0, vx1 = -a1y * dx1, vy0 = a1x * dy0, vy1 = a1x * dy1;
  const double v_lo = fmin(vx0, vx1) + fmin(vy0, vy1), v_hi = fmax(vx0, vx1) + fmax(vy0, vy1);
  return v_lo > bv || v_hi < -bv;
}

// the edge lengths |h1|, |h2| and |h2 - h1| in double
__device__ __forceinline__ void edges(const float* r, double& eu, double& ev, double& e12) {
  const double a1x = r[2], a1y = r[3], a2x = r[4], a2y = r[5];
  eu = sqrt(a1x * a1x + a1y * a1y);
  ev = sqrt(a2x * a2x + a2y * a2y);
  e12 = sqrt((a2x - a1x) * (a2x - a1x) + (a2y - a1y) * (a2y - a1y));
}

// True when the entry's quad provably covers no pixel centre in
// [x0, x1] x [y0, y1] under the reference's float test (the header's proof);
// with kAA, no pixel centre with coverage > 0 (the header's fringe bound).
template <bool kAA = false>
__device__ __forceinline__ bool block_culled(const float* r, float det, float x0, float x1,
                                             float y0, float y1) {
  const double ad = fabs((double)det);
  if (!kAA) return quad_block_culled(r, ad * (1.0 + kRel), ad * (1.0 + kRel), x0, x1, y0, y1);
  double eu, ev, e12;
  edges(r, eu, ev, e12);
  constexpr double k = 1.0 + 2.0 * kRel;
  return quad_block_culled(r, (ad + 0.5 * ad / eu) * k, (ad + 0.5 * ad / ev) * k, x0, x1, y0, y1);
}

// jnp.maximum / jnp.minimum against a constant: a NaN stays NaN
__device__ __forceinline__ float at_least(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float at_most(float x, float hi) { return x > hi ? hi : x; }
// jnp.clip(x, 0, 1)
__device__ __forceinline__ float clip01(float x) { return at_most(at_least(x, 0.0f), 1.0f); }

// The equation of a covered fragment of source colour s (its alpha before
// coverage) onto the pixel d: raster.py:832-895. `cov` is the pair's
// coverage with kAA (1 without: the alpha is then s.w itself).
template <int kEq, bool kWrite, bool kAA = false>
__device__ __forceinline__ void equation(float4 s, float cov, const float* __restrict__ r,
                                         float frag_d, float4& d, float& dbuf) {
  const float a = kAA ? s.w * cov : s.w;
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
    if (kAA) {
      d.x = s.x * cov + d.x * ia;
      d.y = s.y * cov + d.y * ia;
      d.z = s.z * cov + d.z * ia;
    } else {
      d.x = s.x + d.x * ia;
      d.y = s.y + d.y * ia;
      d.z = s.z + d.z * ia;
    }
    d.w = a + d.w * ia;
  } else if (kEq == kMultiply) {  // rgb_s * rgb_d * a + rgb_d * (1 - a); alpha kept
    const float ia = 1.0f - a;
    d.x = s.x * d.x * a + d.x * ia;
    d.y = s.y * d.y * a + d.y * ia;
    d.z = s.z * d.z * a + d.z * ia;
  } else if (kEq == kOpaque || kEq == kMask) {
    if (kEq == kMask && !(s.w >= r[kColCutoff])) return;  // the alpha before coverage
    d = make_float4(s.x, s.y, s.z, 1.0f);
    if (kWrite) dbuf = frag_d;
  } else {  // kScene
    const float mode = r[kColMode];
    const bool is_o = mode == 4.0f, is_k = mode == 5.0f;
    if (is_o || is_k) {
      if (is_o || s.w >= r[kColCutoff]) {
        d = make_float4(s.x, s.y, s.z, 1.0f);
        dbuf = frag_d;
      }
      return;
    }
    const bool b_ = mode == 0.0f, p_ = mode == 1.0f, a_ = mode == 2.0f, m_ = mode == 3.0f;
    const float one_m_a = 1.0f - a;
    const float cs = ((b_ || a_) ? a : 0.0f) + (p_ ? (kAA ? cov : 1.0f) : 0.0f);
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

// JAX's antialiased coverage of a pair (the header's formulas), u = num_u /
// det and v = num_v / det as the reference divides
__device__ __forceinline__ float aa_coverage(const float* __restrict__ r, float det, bool tri,
                                             float nu, float nv, float& u, float& v) {
  u = nu / det;
  v = nv / det;
  const float a1x = r[2], a1y = r[3], a2x = r[4], a2y = r[5];
  const float eu = sqrtf(a1x * a1x + a1y * a1y), ev = sqrtf(a2x * a2x + a2y * a2y);
  if (!tri) return clip01((1.0f - fabsf(u)) * eu + 0.5f) * clip01((1.0f - fabsf(v)) * ev + 0.5f);
  const float ad = fabsf(det);
  const float ex = a2x - a1x, ey = a2y - a1y;
  const float e12 = sqrtf(ex * ex + ey * ey);
  const float d1 = (u + 0.5f) * ad / at_least(ev, 1e-9f);
  const float d2 = (v + 0.5f) * ad / at_least(eu, 1e-9f);
  const float d3 = -(u + v) * ad / at_least(e12, 1e-9f);
  return clip01(d1 + 0.5f) * clip01(d2 + 0.5f) * clip01(d3 + 0.5f);
}

// SCENE's ADD entry on a lane it does not write: JAX's min(0 + a_d, 1)
template <int kEq>
__device__ __forceinline__ void unwritten(const float* __restrict__ r, float4& d) {
  if (kEq == kScene && r[kColMode] == 2.0f) d.w = d.w > 1.0f ? 1.0f : d.w;
}

// whether a real entry may not be culled: SCENE's ADD entries, which touch
// every lane (unwritten)
template <int kEq>
__device__ __forceinline__ bool unculled(const float* __restrict__ r) {
  return kEq == kScene && r[kColMode] == 2.0f;
}

// One entry into one pixel: the reference's coverage test (the comparisons,
// or the divisions where `divide`; with kAA the coverage), depth test and
// equation. Returns without touching the pixel where the entry does not
// cover it. Reads only the row's first 10 or 13 floats.
template <int kEq, bool kDepth, bool kWrite, bool kAA>
__device__ __forceinline__ void blend_entry(const float* __restrict__ r, float det, bool divide,
                                            float px, float py, float4& d, float& dbuf) {
  const float dx = px - r[0];
  const float dy = py - r[1];
  const float a1x = r[2], a1y = r[3], a2x = r[4], a2y = r[5];
  const float nu = a2y * dx - a2x * dy;
  const float nv = -a1y * dx + a1x * dy;
  float cov = 1.0f;
  if (kAA) {
    float u, v;
    cov = aa_coverage(r, det, false, nu, nv, u, v);
    if (!(cov > 0.0f)) return unwritten<kEq>(r, d);
  } else if (divide) {
    const float u = nu / det;
    const float v = nv / det;
    if (!(fabsf(u) <= 1.0f && fabsf(v) <= 1.0f)) return unwritten<kEq>(r, d);
  } else {
    const float ad = fabsf(det);
    // |u|, |v| <= 1, exactly
    if (!(fabsf(nu) <= ad && fabsf(nv) <= ad)) return unwritten<kEq>(r, d);
  }
  float frag_d = 0.0f;
  if (kDepth) {
    frag_d = r[kColDepth];
    if (!(frag_d <= dbuf)) return unwritten<kEq>(r, d);
  }
  equation<kEq, kWrite, kAA>(make_float4(r[6], r[7], r[8], r[9]), cov, r, frag_d, d, dbuf);
}

// the thread's pixel inside the tile: a warp's 8x4 block where T is a
// multiple of 8, else row-major (a padding lane repeats the last pixel)
__device__ __forceinline__ void pixel_of(int t, int T, int& pi, int& pj) {
  const int lane = t & 31, warp = t >> 5;
  if (T % kBlockW == 0) {
    const int per_row = T / kBlockW;
    pi = (warp / per_row) * kBlockH + lane / kBlockW;
    pj = (warp % per_row) * kBlockW + lane % kBlockW;
  } else {
    const int lin = t < T * T ? t : T * T - 1;
    pi = lin / T;
    pj = lin - pi * T;
  }
}

// the pixel-centre bounds of the warp's block
__device__ __forceinline__ void warp_block(float px, float py, float& x0, float& x1, float& y0,
                                           float& y1) {
  x0 = x1 = px;
  y0 = y1 = py;
  for (int o = 16; o > 0; o >>= 1) {
    x0 = fminf(x0, __shfl_xor_sync(0xffffffffu, x0, o));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, o));
    y0 = fminf(y0, __shfl_xor_sync(0xffffffffu, y0, o));
    y1 = fmaxf(y1, __shfl_xor_sync(0xffffffffu, y1, o));
  }
}

// Whether the fringe bounds may cull the entry: its three edge lengths in
// float (as the lane computes them) in [2^-40, 2^60] (the header's kAA)
__device__ __forceinline__ bool aa_cullable(const float* r) {
  const float a1x = r[2], a1y = r[3], a2x = r[4], a2y = r[5];
  const float ex = a2x - a1x, ey = a2y - a1y;
  const float e[3] = {sqrtf(a1x * a1x + a1y * a1y), sqrtf(a2x * a2x + a2y * a2y),
                      sqrtf(ex * ex + ey * ey)};
  bool ok = true;
  for (int k = 0; k < 3; ++k) ok = ok && e[k] >= 0x1p-40f && e[k] <= 0x1p60f;
  return ok;
}

// the clamped det and the entry's test (the header's step 1)
template <bool kAA = false>
__device__ __forceinline__ uint8_t entry_test(const float* r, bool has, float& det) {
  det = r[2] * r[5] - r[3] * r[4];
  const bool clamped = fabsf(det) < 1e-9f;
  det = clamped ? 1e-9f : det;
  bool finite = true;
  for (int c = 0; c < 6; ++c) finite = finite && isfinite(r[c]);
  if (kAA) finite = finite && aa_cullable(r);
  return !has ? kSkip : !isfinite(det) ? kDivide : (finite && !clamped) ? kCullable : kCompare;
}

template <int kEq, bool kDepth, bool kWrite, bool kAA>
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
  float* rows = smem;                                           // [M, kRow]
  float* s_det = smem + row_floats;                             // [M] clamped det
  uint8_t* s_test = reinterpret_cast<uint8_t*>(s_det + M);      // [M] has, then the test
  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;

  // ---- this thread's pixel ----
  const bool live = t < T * T;
  int pi, pj;
  pixel_of(t, T, pi, pj);
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
  for (int m = t; m < M; m += blockDim.x)
    s_test[m] = entry_test<kAA>(rows + m * kRow, s_test[m], s_det[m]);
  __syncthreads();

  float x0, x1, y0, y1;
  warp_block(px, py, x0, x1, y0, y1);

  // ---- 2-3. runs of 32 entries: cull against the block, blend the rest ----
  for (int m0 = 0; m0 < M; m0 += 32) {
    const int m = m0 + lane;
    bool keep = false;
    if (m < M) {
      const uint8_t test = s_test[m];
      keep = test == kDivide || test == kCompare ||
             (test == kCullable && (unculled<kEq>(rows + m * kRow) ||
                                    !block_culled<kAA>(rows + m * kRow, s_det[m], x0, x1, y0, y1)));
    }
    unsigned int mask = __ballot_sync(0xffffffffu, keep);
    while (mask) {
      const int e = m0 + __ffs(mask) - 1;
      mask &= mask - 1;
      blend_entry<kEq, kDepth, kWrite, kAA>(rows + e * kRow, s_det[e], s_test[e] == kDivide, px,
                                            py, d, dbuf);
    }
  }
  if (live) {
    fb[pix] = d;
    if (kWrite) depth_out[pix] = dbuf;
  }
}

// ---------------------------------------------------------------------------
// the appearance kernel
// ---------------------------------------------------------------------------

// True when the triangle entry provably covers no pixel centre in [x0, x1] x
// [y0, y1] under the reference's float test (the header's triangle bound);
// with kAA, no pixel centre with coverage > 0 (the header's fringe bound:
// the three widened half-planes).
template <bool kAA = false>
__device__ __forceinline__ bool tri_block_culled(const float* r, float det, float x0, float x1,
                                                 float y0, float y1) {
  const double sg = det < 0.0f ? -1.0 : 1.0;
  const double cx = r[0], cy = r[1];
  const double a1x = r[2], a1y = r[3], a2x = r[4], a2y = r[5];
  const double ad = fabs((double)det);
  const double dx0 = (double)x0 - cx, dx1 = (double)x1 - cx;
  const double dy0 = (double)y0 - cy, dy1 = (double)y1 - cy;
  const double mx = fmax(fabs(dx0), fabs(dx1)), my = fmax(fabs(dy0), fabs(dy1));
  const double su = kRel * (fabs(a2y) * mx + fabs(a2x) * my);
  const double sv = kRel * (fabs(a1y) * mx + fabs(a1x) * my);
  const double h = 0.5 * ad * (1.0 + kRel);
  // the range over the block of p (px - cx) + q (py - cy): its corners
  auto lo = [&](double p, double q) { return fmin(p * dx0, p * dx1) + fmin(q * dy0, q * dy1); };
  auto hi = [&](double p, double q) { return fmax(p * dx0, p * dx1) + fmax(q * dy0, q * dy1); };
  const double pu = sg * a2y, qu = -sg * a2x;  // sg N_u
  const double pv = -sg * a1y, qv = sg * a1x;  // sg N_v
  if (kAA) {
    double eu, ev, e12;
    edges(r, eu, ev, e12);
    constexpr double k = 1.0 + 2.0 * kRel, eps = (double)1e-9f;
    if (hi(pu, qu) < -(0.5 * (ad + fmax(ev, eps)) * k + su)) return true;  // d1 <= -1/2
    if (hi(pv, qv) < -(0.5 * (ad + fmax(eu, eps)) * k + sv)) return true;  // d2 <= -1/2
    return lo(pu + pv, qu + qv) > 0.5 * fmax(e12, eps) * k + kRel * ad + su + sv;  // d3
  }
  if (hi(pu, qu) < -(h + su) || lo(pu, qu) > h + su) return true;  // u < -1/2 or u > 1/2
  if (hi(pv, qv) < -(h + sv) || lo(pv, qv) > h + sv) return true;  // v < -1/2 or v > 1/2
  return lo(pu + pv, qu + qv) > kRel * ad + su + sv;                // u + v > 0
}

// num_u and num_v of the entry at the pixel, as the reference rounds them
__device__ __forceinline__ void numerators(const float* __restrict__ r, float px, float py,
                                           float& nu, float& nv) {
  const float dx = px - r[0];
  const float dy = py - r[1];
  const float a1x = r[2], a1y = r[3], a2x = r[4], a2y = r[5];
  nu = a2y * dx - a2x * dy;
  nv = -a1y * dx + a1x * dy;
}

// Whether the entry covers the pixel (the header's step 3): no division for
// a quad's test, nor for a triangle lane that the half-planes settle; where
// it covers, u = num_u / det and v = num_v / det as the reference divides.
__device__ __forceinline__ bool covers(const float* __restrict__ r, float det, uint8_t test,
                                       float px, float py, float& u, float& v) {
  float nu, nv;
  numerators(r, px, py, nu, nv);
  const uint8_t kind = test & kKindBits;
  if (test & kTri) {
    if (kind != kDivide) {
      const float ad = fabsf(det);
      const float xu = det < 0.0f ? -nu : nu, xv = det < 0.0f ? -nv : nv;
      const float h = -0.5f * ad;
      if (!(xu >= h && xv >= h)) return false;  // u >= -1/2, v >= -1/2, exactly
      if (xu + xv > 0x1p-20f * (fabsf(xu) + fabsf(xv)) + 0x1p-60f * ad) return false;
    }
    u = nu / det;
    v = nv / det;
    return u >= -0.5f && v >= -0.5f && u + v <= 0.0f;
  }
  if (kind != kDivide) {
    const float ad = fabsf(det);
    if (!(fabsf(nu) <= ad && fabsf(nv) <= ad)) return false;  // |u|, |v| <= 1, exactly
    u = nu / det;
    v = nv / det;
    return true;
  }
  u = nu / det;
  v = nv / det;
  return fabsf(u) <= 1.0f && fabsf(v) <= 1.0f;
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

// A + s (B - A) + t (C - A) (raster.py:706-716), B - A and C - A computed
// once per entry (the per-entry pass writes them over B and C)
__device__ __forceinline__ float bary(float va, float dba, float dca, float s, float t) {
  return va + s * dba + t * dca;
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float f) {
  return make_float4(a.x + (b.x - a.x) * f, a.y + (b.y - a.y) * f, a.z + (b.z - a.z) * f,
                     a.w + (b.w - a.w) * f);
}

// jnp.mod(x, n) and jnp.mod(x + 1, n) of an integer-valued float x as
// indices in [0, n) (the header's wrap); a NaN converts to 0, as XLA's
// saturating cast
__device__ __forceinline__ void wrap(float x, float n, int ni, int& i0, int& i1) {
  if (x >= -n && x < 2.0f * n && n <= 0x1p22f) {
    i0 = (int)(x < 0.0f ? x + n : (x >= n ? x - n : x));
    i1 = i0 + 1 == ni ? 0 : i0 + 1;
  } else {
    i0 = (int)floor_mod(x, n);
    i1 = (int)floor_mod(x + 1.0f, n);
  }
}

// _bilinear_wrap (raster.py:121-146) on a [th, tw, 4] texture
__device__ __forceinline__ float4 sample(const float4* __restrict__ tex, int tw, int th, float u,
                                         float v) {
  const float twf = (float)tw, thf = (float)th;
  const float uu = u * twf - 0.5f, vv = v * thf - 0.5f;
  const float u0 = floorf(uu), v0 = floorf(vv);
  const float fu = uu - u0, fv = vv - v0;
  int u0i, u1i, v0i, v1i;
  wrap(u0, twf, tw, u0i, u1i);
  wrap(v0, thf, th, v0i, v1i);
  const float4 t00 = __ldg(tex + v0i * tw + u0i), t01 = __ldg(tex + v0i * tw + u1i);
  const float4 t10 = __ldg(tex + v1i * tw + u0i), t11 = __ldg(tex + v1i * tw + u1i);
  return lerp4(lerp4(t00, t01, fu), lerp4(t10, t11, fu), fv);
}

// wrap() for the painter's per-entry float size n: the compare path only
// for an integer-valued n in [1, 2^22] (then exact), else the floored
// remainder (NaN and a zero size to index 0)
__device__ __forceinline__ void wrap_entry(float x, float n, int& i0, int& i1) {
  if (n >= 1.0f && n <= 0x1p22f && n == floorf(n) && x >= -n && x < 2.0f * n) {
    i0 = (int)(x < 0.0f ? x + n : (x >= n ? x - n : x));
    i1 = i0 + 1 == (int)n ? 0 : i0 + 1;
  } else {
    i0 = (int)floor_mod(x, n);
    i1 = (int)floor_mod(x + 1.0f, n);
  }
}

// _bilinear_wrap (raster.py:121-146) on the atlas layer at `tex` ([h, w, 4]
// of the atlas's extent) at the entry's true size tw x th (floats)
__device__ __forceinline__ float4 sample_atlas(const float4* __restrict__ tex, int h, int w,
                                               float twf, float thf, float u, float v) {
  const float uu = u * twf - 0.5f, vv = v * thf - 0.5f;
  const float u0 = floorf(uu), v0 = floorf(vv);
  const float fu = uu - u0, fv = vv - v0;
  int u0i, u1i, v0i, v1i;
  wrap_entry(u0, twf, u0i, u1i);
  wrap_entry(v0, thf, v0i, v1i);
  u0i = min(max(u0i, 0), w - 1);
  u1i = min(max(u1i, 0), w - 1);
  v0i = min(max(v0i, 0), h - 1);
  v1i = min(max(v1i, 0), h - 1);
  const float4 t00 = __ldg(tex + v0i * w + u0i), t01 = __ldg(tex + v0i * w + u1i);
  const float4 t10 = __ldg(tex + v1i * w + u0i), t11 = __ldg(tex + v1i * w + u1i);
  return lerp4(lerp4(t00, t01, fu), lerp4(t10, t11, fu), fv);
}

// The source colour of a covered pair at (u, v) (the header's per-pixel list
// after the test); false where the squircle discards it. `cell`: the entry's
// flipbook cell (column, row). kPainter: the SCENE variants, which also read
// the painter's per-entry Lambert setups and atlas layers; the other
// variants compile without them.
template <bool kPainter>
__device__ __forceinline__ bool shade(const float* __restrict__ r, bool is_tri,
                                      const float* __restrict__ cell, float u, float v,
                                      const Appearance& ap, float4& s) {
  s = make_float4(r[6], r[7], r[8], r[9]);
  const float u01 = u * 0.5f + 0.5f, v01 = v * 0.5f + 0.5f;
  if (ap.o_round >= 0 && !is_tri) {  // raster.py:690-700
    const float rnd = r[ap.o_round];
    if (!(rnd <= 0.0f)) {
      const float nexp = 2.0f / at_least(rnd, 1e-6f);
      const float sq =
          powf(fabsf(1.0f - 2.0f * u01), nexp) + powf(fabsf(1.0f - 2.0f * v01), nexp);
      if (!(sq <= 1.0f)) return false;
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
  if (ap.lit) {  // raster.py:723-740; per entry where the painter merged setups
    const float* lt = r + ap.o_light;
    const bool per_entry = kPainter && ap.o_light >= 0;
    const float lx = per_entry ? lt[0] : ap.lx, ly = per_entry ? lt[1] : ap.ly;
    const float lz = per_entry ? lt[2] : ap.lz, band = per_entry ? lt[3] : ap.band;
    const float* nr = r + ap.o_nrm;
    float n0 = bary(nr[0], nr[3], nr[6], bs, bt);
    float n1 = bary(nr[1], nr[4], nr[7], bs, bt);
    float n2 = bary(nr[2], nr[5], nr[8], bs, bt);
    const float len = at_least(sqrtf(n0 * n0 + n1 * n1 + n2 * n2), 1e-9f);
    n0 = n0 / len;
    n1 = n1 / len;
    n2 = n2 / len;
    const float ndotl = n0 * lx + n1 * ly + n2 * lz;
    const float shade = at_most(at_least(ndotl, band), 1.0f);
    s.x = s.x * shade;
    s.y = s.y * shade;
    s.z = s.z * shade;
  }
  if (kPainter && ap.atlas_layers) {  // raster.py:777-813: the painter's atlas, per entry
    float tu = u01, tv = v01;
    if (is_tri && ap.o_uv >= 0 && isfinite(r[ap.o_uv])) {
      const float* w = r + ap.o_uv;
      tu = bary(w[0], w[2], w[4], bs, bt);
      tv = bary(w[1], w[3], w[5], bs, bt);
    }
    const float* pt = r + ap.o_tex;
    tu = (tu + cell[0]) / pt[0];  // the grid is a per-entry float: true divisions
    tv = (tv + cell[1]) / pt[1];
#pragma unroll
    for (int l = 0; l < kMaxLayers; ++l) {
      if (l < ap.atlas_layers) {
        const float* e = pt + 2 + 4 * l;
        const float mm = e[3];
        if (mm == 1.0f || mm == 2.0f || mm == 3.0f) {  // else factors of exactly 1
          const int tid = min(max((int)e[0], 0), ap.atlas_l - 1);
          const float4 t = sample_atlas(ap.atlas + (int64_t)tid * ap.atlas_h * ap.atlas_w,
                                        ap.atlas_h, ap.atlas_w, e[1], e[2], tu, tv);
          if (mm == 1.0f) {
            s = make_float4(s.x * t.x, s.y * t.y, s.z * t.z, s.w * t.w);
          } else if (mm == 2.0f) {
            s = make_float4(s.x * t.x, s.y * t.y, s.z * t.z, s.w);
          } else {
            s.w = s.w * t.x;
          }
        }
      }
    }
  } else if (ap.layers) {  // raster.py:741-776
    float tu = u01, tv = v01;
    if (is_tri && ap.o_uv >= 0 && isfinite(r[ap.o_uv])) {
      const float* w = r + ap.o_uv;
      tu = bary(w[0], w[2], w[4], bs, bt);
      tv = bary(w[1], w[3], w[5], bs, bt);
    }
    if (ap.grid_c != 1 || ap.grid_r != 1) {
      // XLA compiles JAX's division by the grid constant into a product with
      // its f32 reciprocal
      tu = (tu + cell[0]) * (1.0f / (float)ap.grid_c);
      tv = (tv + cell[1]) * (1.0f / (float)ap.grid_r);
    }
#pragma unroll
    for (int l = 0; l < kMaxLayers; ++l) {  // constant indices: the descriptor stays in its bank
      if (l < ap.layers) {
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
  return true;
}

// Whether entry m may cover a pixel of the warp's block: a real entry not
// culled by its bound (the triangle bound for a triangle entry)
template <int kEq, bool kAA = false>
__device__ __forceinline__ bool appear_keep(const float* rows, int kRow, const float* s_det,
                                            const uint8_t* s_test, int M, int m, float x0,
                                            float x1, float y0, float y1) {
  if (m >= M) return false;
  const uint8_t test = s_test[m], kind = test & kKindBits;
  if (kind != kCullable) return kind != kSkip;
  const float* r = rows + m * kRow;
  return unculled<kEq>(r) || !((test & kTri) ? tri_block_culled<kAA>(r, s_det[m], x0, x1, y0, y1)
                                             : block_culled<kAA>(r, s_det[m], x0, x1, y0, y1));
}

// B - A and C - A of an attribute of nc floats a vertex, over B and C
__device__ __forceinline__ void vertex_differences(float* c, int nc) {
  for (int k = 0; k < nc; ++k) {
    c[nc + k] = c[nc + k] - c[k];
    c[2 * nc + k] = c[2 * nc + k] - c[k];
  }
}

// shared memory of the appearance kernel: the warps' pair buffers where it
// compacts, then the rows and the per-entry terms
__host__ __device__ constexpr size_t appear_pair_bytes(int warps, bool compact) {
  return compact ? (size_t)warps * kPairs * (sizeof(float4) + 3 * sizeof(int)) : 0;
}

// kCompact: shade compacted pairs (the header's step 4), for a draw with the
// squircle, whose powf pairs pay for it, on tiles of at most 256 pixels; else
// each covered pair is shaded on its own lane inside the entry loop, in at
// most 64 registers a thread (4 CTAs of 256 threads an SM, and a 32x32
// tile's 1024 threads fit; a few registers spill, which measured faster than
// 3 CTAs an SM without spills).
template <int kEq, bool kDepth, bool kWrite, bool kCompact, bool kAA>
__global__ void __launch_bounds__(kCompact ? 256 : 1024, 1)
tile_blend_appear_kernel(const float* __restrict__ window, const uint8_t* __restrict__ has,
                         const float4* __restrict__ fb_in, const float* __restrict__ depth_in,
                         float4* __restrict__ fb, float* __restrict__ depth_out, int M, int T,
                         int ntx, int vec, float4 background,
                         const __grid_constant__ Appearance ap) {
  const int kRow = ap.row;
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  float4* s_col = reinterpret_cast<float4*>(smem);  // [warps, kPairs] colours
  int* s_key = reinterpret_cast<int*>(s_col + (kCompact ? warps * kPairs : 0));  // entry, lane
  unsigned* s_cov = reinterpret_cast<unsigned*>(s_key + (kCompact ? warps * kPairs : 0));
  int* s_ent = reinterpret_cast<int*>(s_cov + (kCompact ? warps * kPairs : 0));
  float* rows = reinterpret_cast<float*>(s_ent + (kCompact ? warps * kPairs : 0));  // [M, kRow]
  const int row_floats = (M * kRow + 3) & ~3;
  float* s_det = rows + row_floats;                                // [M] clamped det
  float* s_cell = s_det + M;                                       // [M, 2] flipbook cell
  uint8_t* s_test = reinterpret_cast<uint8_t*>(s_cell + 2 * M);    // [M] has, then the test
  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;

  // ---- this thread's pixel ----
  const bool live = t < T * T;
  int pi, pj;
  pixel_of(t, T, pi, pj);
  const int64_t pix = (int64_t)tile * T * T + pi * T + pj;
  const float px = (float)((tile % ntx) * T + pj) + 0.5f;
  const float py = (float)((tile / ntx) * T + pi) + 0.5f;
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
  const bool flipbook = (ap.grid_c != 1 || ap.grid_r != 1) && ap.layers;
  for (int m = t; m < M; m += blockDim.x) {
    float* r = rows + m * kRow;
    const bool tri = ap.o_tri >= 0 && r[ap.o_tri] > 0.5f;
    s_test[m] = entry_test<kAA>(r, s_test[m], s_det[m]) | (tri ? kTri : 0);
    if (ap.o_uv >= 0) vertex_differences(r + ap.o_uv, 2);
    if (ap.o_nrm >= 0) vertex_differences(r + ap.o_nrm, 3);
    if (ap.o_vcol >= 0) vertex_differences(r + ap.o_vcol, 4);
    if (flipbook) {
      const float sprite = (float)(int)r[ap.o_sprite];  // the row's f32, astype(int32)
      const float gc = (float)ap.grid_c;
      const bool first_row = sprite >= 0.0f && sprite < gc;  // fmod-free: (sprite, 0)
      s_cell[2 * m] = first_row ? sprite : floor_mod(sprite, gc);
      s_cell[2 * m + 1] = first_row ? 0.0f : floor_div(sprite, gc);
    } else if (kEq == kScene && ap.atlas_layers) {  // the entry's grid: jnp.mod, floor(s / cols)
      const float sprite = (float)(int)r[ap.o_sprite];
      const float gc = r[ap.o_tex];
      s_cell[2 * m] = floor_mod(sprite, gc);
      s_cell[2 * m + 1] = floorf(sprite / gc);
    }
  }
  __syncthreads();

  float x0, x1, y0, y1;
  warp_block(px, py, x0, x1, y0, y1);

  // ---- 2-4. runs of 32 entries: cull, cover; shade and blend ----
  if constexpr (!kCompact) {
    for (int m0 = 0; m0 < M; m0 += 32) {
      unsigned int mask = __ballot_sync(
          0xffffffffu, appear_keep<kEq, kAA>(rows, kRow, s_det, s_test, M, m0 + lane, x0, x1, y0,
                                             y1));
      while (mask) {
        const int e = m0 + __ffs(mask) - 1;
        mask &= mask - 1;
        const float* r = rows + e * kRow;
        float u, v, c = 1.0f;
        bool cov;
        if (kAA) {
          float nu, nv;
          numerators(r, px, py, nu, nv);
          c = aa_coverage(r, s_det[e], s_test[e] & kTri, nu, nv, u, v);
          cov = live && c > 0.0f;
        } else {
          cov = live && covers(r, s_det[e], s_test[e], px, py, u, v);
        }
        if (kDepth && !kWrite) cov = cov && r[kColDepth] <= dbuf;
        float4 s;
        bool wrote = false;
        if (cov && shade<kEq == kScene>(r, s_test[e] & kTri, s_cell + 2 * e, u, v, ap, s)) {
          const float frag_d = kWrite ? r[kColDepth] : 0.0f;
          if (!kWrite || frag_d <= dbuf) {
            equation<kEq, kWrite, kAA>(s, c, r, frag_d, d, dbuf);
            wrote = true;
          }
        }
        if (!wrote) unwritten<kEq>(r, d);
      }
    }
  } else {
    static_assert(!kAA, "the compacted-pair path has no antialiased variant");
    // the warp's pair buffer: pairs (entry << 5 | lane, then -1 where the
    // squircle discards it) and their colours; per buffered entry its
    // coverage mask and index
    float4* w_col = s_col + warp * kPairs;
    int* w_key = s_key + warp * kPairs;
    unsigned* w_cov = s_cov + warp * kPairs;
    int* w_ent = s_ent + warp * kPairs;
    int n_pairs = 0, n_ent = 0, m0 = 0;
    unsigned int mask = 0;
    for (;;) {
      while (!mask && m0 < M) {
        mask = __ballot_sync(0xffffffffu, appear_keep<kEq>(rows, kRow, s_det, s_test, M, m0 + lane,
                                                           x0, x1, y0, y1));
        m0 += 32;
      }
      const bool end = !mask;  // uniform: no entry left
      bool cov = false;
      int e = 0;
      if (!end) {
        e = m0 - 32 + __ffs(mask) - 1;
        mask &= mask - 1;
        const float* r = rows + e * kRow;
        float u, v;
        cov = live && covers(r, s_det[e], s_test[e], px, py, u, v);
        if (kDepth && !kWrite) cov = cov && r[kColDepth] <= dbuf;  // the scene depth: pure
      }
      const unsigned cm = __ballot_sync(0xffffffffu, cov);
      if (!end && !cm && !unculled<kEq>(rows + e * kRow)) continue;
      if (end || n_pairs + __popc(cm) > kPairs || n_ent == kPairs) {
        // shade the buffered pairs 32 at a time, each lane the pixel of
        // another, then blend each lane's own in ascending entry order
        __syncwarp();
        for (int p0 = 0; p0 < n_pairs; p0 += 32) {
          const int p = p0 + lane;
          const int key = w_key[p < n_pairs ? p : p0];
          const float qx = __shfl_sync(0xffffffffu, px, key & 31);
          const float qy = __shfl_sync(0xffffffffu, py, key & 31);
          if (p < n_pairs) {
            const int k = key >> 5;
            const float* r = rows + k * kRow;
            float nu, nv;
            numerators(r, qx, qy, nu, nv);
            float4 s;
            const bool kept = shade<kEq == kScene>(r, s_test[k] & kTri, s_cell + 2 * k,
                                                   nu / s_det[k], nv / s_det[k], ap, s);
            w_col[p] = s;
            if (!kept) w_key[p] = -1;
          }
        }
        __syncwarp();
        int base = 0;
        for (int j = 0; j < n_ent; ++j) {
          const unsigned c = w_cov[j];
          const float* r = rows + w_ent[j] * kRow;
          bool wrote = false;
          if (c >> lane & 1u) {
            const int p = base + __popc(c & below);
            if (ap.o_round < 0 || w_key[p] >= 0) {  // only the squircle discards
              const float frag_d = kWrite ? r[kColDepth] : 0.0f;
              if (!kWrite || frag_d <= dbuf) {
                equation<kEq, kWrite>(w_col[p], 1.0f, r, frag_d, d, dbuf);
                wrote = true;
              }
            }
          }
          if (!wrote) unwritten<kEq>(r, d);
          base += __popc(c);
        }
        __syncwarp();
        n_pairs = n_ent = 0;
        if (end) break;
      }
      if (cov) w_key[n_pairs + __popc(cm & below)] = (e << 5) | lane;
      if (lane == 0) {
        w_cov[n_ent] = cm;
        w_ent[n_ent] = e;
      }
      n_pairs += __popc(cm);
      ++n_ent;
    }
  }
  if (live) {
    fb[pix] = d;
    if (kWrite) depth_out[pix] = dbuf;
  }
}

template <int kEq, bool kDepth, bool kWrite, bool kAppear, bool kAA>
int launch(int nt, int M, int T, cudaStream_t stream, const void* window, const void* has,
           const void* fb_in, const void* depth_in, void* fb, void* depth_out, int ntx,
           float4 bg, const Appearance& ap) {
  const int row = kAppear ? ap.row : RowWidth<kEq, kDepth>::value;
  const size_t row_floats = ((size_t)M * row + 3) & ~(size_t)3;
  const int vec = ((uintptr_t)window & 15u) == 0 && (M * row) % 4 == 0;
  const int threads = (T * T + 31) / 32 * 32;
  if constexpr (!kAppear) {
    const size_t smem = row_floats * sizeof(float) + (size_t)M * sizeof(float) + (size_t)M;
    tile_blend_kernel<kEq, kDepth, kWrite, kAA><<<nt, threads, smem, stream>>>(
        (const float*)window, (const uint8_t*)has, (const float4*)fb_in,
        (const float*)depth_in, (float4*)fb, (float*)depth_out, M, T, ntx, vec, bg);
  } else {
    const bool compact = !kAA && ap.o_round >= 0 && threads <= 256;
    const size_t smem = appear_pair_bytes(threads / 32, compact) +
                        (row_floats + 3 * (size_t)M) * sizeof(float) + (size_t)M;
    auto kernel = compact ? tile_blend_appear_kernel<kEq, kDepth, kWrite, !kAA, kAA>
                          : tile_blend_appear_kernel<kEq, kDepth, kWrite, false, kAA>;
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<nt, threads, smem, stream>>>((const float*)window, (const uint8_t*)has,
                                         (const float4*)fb_in, (const float*)depth_in,
                                         (float4*)fb, (float*)depth_out, M, T, ntx, vec, bg, ap);
  }
  return 0;
}

}  // namespace

// eq: 0 blend, 1 add, 2 opaque, 3 mask, 4 scene, 5 premultiply, 6 multiply,
// plus 8 for the antialiased variant (every variant, with or without
// appearance).
// depth_test / write_depth as the wrapper validates them: write_depth needs
// depth_test and an opaque, mask or scene equation; scene needs both. fb_in
// and depth_in may be NULL. ap_i NULL: no appearance, the window's rows
// RowWidth<eq, depth_test>::value floats wide (row is then not read).
// Otherwise rows of `row` floats and the descriptor: ap_i = [o_round, o_tri,
// o_sprite, o_uv, o_nrm, o_vcol (-1 where absent), grid_c, grid_r, lit,
// layers, then tw, th, mapping of each of kMaxLayers layers, then o_tex,
// atlas_layers, o_light (-1 / 0 / -1 where absent), then the atlas's L, H,
// W], ap_f = [lx, ly, lz, band], textures = the layers' [th, tw, 4] f32
// tensors, then at [kMaxLayers] the [L, H, W, 4] atlas (all 16-byte
// aligned). Returns cudaErrorInvalidValue for a combination the wrapper
// never passes.
extern "C" int hanabi_tile_blend_appearance(const void* window, const void* has,
                                            const void* fb_in, const void* depth_in, void* fb,
                                            void* depth_out, int nt, int M, int T, int ntx,
                                            const float* background, int eq, int depth_test,
                                            int write_depth, int row, const int* ap_i,
                                            const float* ap_f, const void* const* textures,
                                            void* stream) {
  float4 bg = make_float4(background[0], background[1], background[2], background[3]);
  const bool aa = eq >= 8;
  eq = aa ? eq - 8 : eq;
  if (nt <= 0) return (int)cudaGetLastError();
  if (T <= 0 || T * T > 1024) return (int)cudaErrorInvalidValue;
  Appearance ap = {};
  ap.o_tex = ap.o_light = -1;
  if (ap_i) {
    ap.row = row;
    int* offsets[8] = {&ap.o_round, &ap.o_tri, &ap.o_sprite, &ap.o_uv, &ap.o_nrm, &ap.o_vcol,
                       &ap.o_tex, &ap.o_light};
    const int at[8] = {0, 1, 2, 3, 4, 5, 10 + 3 * kMaxLayers, 12 + 3 * kMaxLayers};
    ap.atlas_layers = ap_i[11 + 3 * kMaxLayers];
    const int widths[8] = {1, 1, 1, 6, 9, 12, 2 + 4 * ap.atlas_layers, 4};
    for (int c = 0; c < 8; ++c) {
      *offsets[c] = ap_i[at[c]];
      if (ap_i[at[c]] < -1 || (ap_i[at[c]] >= 0 && ap_i[at[c]] + widths[c] > row))
        return (int)cudaErrorInvalidValue;
    }
    ap.grid_c = ap_i[6];
    ap.grid_r = ap_i[7];
    ap.lit = ap_i[8];
    ap.layers = ap_i[9];
    if (ap.layers < 0 || ap.layers > kMaxLayers || (ap.lit && ap.o_nrm < 0) || ap.grid_c < 1 ||
        ap.grid_r < 1 || ((ap.grid_c != 1 || ap.grid_r != 1) && ap.layers && ap.o_sprite < 0) ||
        (ap.o_light >= 0 && (!ap.lit || eq != kScene)))
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
    if (ap.atlas_layers) {
      ap.atlas = (const float4*)textures[kMaxLayers];
      ap.atlas_l = ap_i[13 + 3 * kMaxLayers];
      ap.atlas_h = ap_i[14 + 3 * kMaxLayers];
      ap.atlas_w = ap_i[15 + 3 * kMaxLayers];
      if (eq != kScene || ap.atlas_layers < 0 || ap.atlas_layers > kMaxLayers || ap.layers ||
          ap.o_tex < 0 ||
          ap.o_sprite < 0 || !ap.atlas || ((uintptr_t)ap.atlas & 15u) || ap.atlas_l < 1 ||
          ap.atlas_h < 1 || ap.atlas_w < 1)
        return (int)cudaErrorInvalidValue;
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int key = eq * 4 + (depth_test ? 2 : 0) + (write_depth ? 1 : 0);
  int code = 0;
#define HANABI_TB(E, D, W, A, AA)                                                            \
  code = launch<E, D, W, A, AA>(nt, M, T, s, window, has, fb_in, depth_in, fb, depth_out, ntx, bg, \
                                ap)
#define HANABI_TB_ALL(A, AA)                                                              \
  switch (key) {                                                                          \
    case kBlend * 4 + 0: HANABI_TB(kBlend, false, false, A, AA); break;                   \
    case kBlend * 4 + 2: HANABI_TB(kBlend, true, false, A, AA); break;                    \
    case kAdd * 4 + 0: HANABI_TB(kAdd, false, false, A, AA); break;                       \
    case kAdd * 4 + 2: HANABI_TB(kAdd, true, false, A, AA); break;                        \
    case kOpaque * 4 + 0: HANABI_TB(kOpaque, false, false, A, AA); break;                 \
    case kOpaque * 4 + 2: HANABI_TB(kOpaque, true, false, A, AA); break;                  \
    case kOpaque * 4 + 3: HANABI_TB(kOpaque, true, true, A, AA); break;                   \
    case kMask * 4 + 0: HANABI_TB(kMask, false, false, A, AA); break;                     \
    case kMask * 4 + 2: HANABI_TB(kMask, true, false, A, AA); break;                      \
    case kMask * 4 + 3: HANABI_TB(kMask, true, true, A, AA); break;                       \
    case kScene * 4 + 3: HANABI_TB(kScene, true, true, A, AA); break;                     \
    case kPremultiply * 4 + 0: HANABI_TB(kPremultiply, false, false, A, AA); break;       \
    case kPremultiply * 4 + 2: HANABI_TB(kPremultiply, true, false, A, AA); break;        \
    case kMultiply * 4 + 0: HANABI_TB(kMultiply, false, false, A, AA); break;             \
    case kMultiply * 4 + 2: HANABI_TB(kMultiply, true, false, A, AA); break;              \
    default: return (int)cudaErrorInvalidValue;                                           \
  }
  if (!ap_i && !aa) {
    HANABI_TB_ALL(false, false)
  } else if (!ap_i) {
    HANABI_TB_ALL(false, true)
  } else if (!aa) {
    HANABI_TB_ALL(true, false)
  } else {
    HANABI_TB_ALL(true, true)
  }
#undef HANABI_TB_ALL
#undef HANABI_TB
  return code ? code : (int)cudaGetLastError();
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
