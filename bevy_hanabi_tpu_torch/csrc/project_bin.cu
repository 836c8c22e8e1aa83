// project_bin: project each particle's quad, test it against the screen,
// bin it into S tile entries, pack its blend row and reduce the depth range
// of the binned entries; bin_keys: the 32-bit sort key of every entry from
// its tile, its depth and that range.
//
// project_bin replaces bevy_hanabi_tpu/render/raster.py:241-333 (steps 1-2
// for the three binnings of RasterConfig.tile_slots, with `_project` at
// raster.py:148-176) and the row stack of raster.py:516-586. The binnings:
//   tile_slots=1: S = 1, the tile holding the centre (clamped on screen);
//   tile_slots=2: S = 2, the screen-clamped bbox-corner tile and the
//     neighbour of the larger spill past its right or bottom edge
//     (raster.py:297-326);
//   tile_slots=0: S = span^2, every tile of the span x span square from the
//     bbox corner that the bbox touches and the screen holds (a larger quad
//     is cropped, raster.py:327-330).
// Each particle writes its S (tile, depth) entries slot-major, entry
// s * n + p, as JAX concatenates its slots (raster.py:331-333): each slot's
// stores stay coalesced, and the entry order (the `first` policy, the
// stable sort's ties, the entry index in the keys) is JAX's. A slot that
// bins nothing holds tile nt and depth -inf. S is a template parameter (1,
// 2, span^2 for span 1-4; a larger span loops at run time). The bbox floors
// are clamped in float before the conversion to int (tx0 to [-span, ntx],
// tx1 to [-1, ntx]): that leaves every test of JAX's unchanged, gives JAX's
// saturating conversion wherever a test reads it, and keeps tx0 + dx from
// overflowing. bin_keys replaces the key build of
// raster.py:361-423 (`quant_depth` and the packed uint32 keys of the ordered
// path and the three fast variants). The JAX package leaves both regions to
// XLA on the TPU; it has no Pallas kernel for them.
//
// The row is [cx, cy, h1x, h1y, h2x, h2y, r, g, b, a] (10 floats): the
// projected quad and the colour. A pass whose blend variant reads more (a
// depth test, MASK, the painter's SCENE) asks for 13-float rows, which append
// the view distance the depth test reads (raster.py:578-580) and the two
// painter columns (the mask cutoff and the blend-mode id, raster.py:549-555),
// copied from the optional `extra` [N, 2] input (zeros without it). A draw
// with appearance columns (the kAppear variants: a round, flipbook, textured
// or mesh draw, or the painter's merge of them) appends, after those 10 or
// 13, each column it has in JAX's order (raster.py:530-577): roundness, tri,
// the flipbook frame (int32, as f32), the painter's per-entry texture state
// (2 + 4 per atlas layer), the UV (6) and normal (9) triplets, the painter's
// per-entry Lambert setup (4) and the vertex-colour triplet (12), copied
// from their inputs; which are present is a property of the draw, so the
// same for every particle of a call. A triangle entry (tri > 0.5) spans |u|,
// |v| <= 0.5 around its anchor: its screen radii are halved before the
// screen test and the binning, in every binning (raster.py:259-263).
//
// Bound on the H100: per particle project_bin reads 3 vec3 + 1 bool + 1 vec4
// (+ 2 f32) = 53-61 B and writes S tile ids and depths and one 10- or
// 13-float row = 40 + 8 S to 52 + 8 S B, ~100-120 MB a frame at 1M
// particles and S = 1 (8 (S - 1) MB more at larger S): device-memory
// bandwidth, ~30-35 us at 3.35 TB/s for S = 1. A thread per particle reading its
// stride-3 inputs and writing its 40- or 52-byte row with scalar stores
// spreads every warp access over 1.3-1.7 KB. So each block owns a contiguous
// slice of kBlock particles: it loads the slice's position, axes, colour,
// alive flags and extra columns into shared memory with 16-byte loads (all
// in flight before the first is used), projects in registers, assembles the
// slice's rows in shared memory and writes them out as one contiguous run
// (kBlock * 40 or 52 bytes) with 16-byte stores. The ragged last block, and
// any input that is not 16-byte aligned, takes scalar loads and stores.
//
// The depth range: each block reduces the min and max of its binned depths
// (a particle's depth where one of its slots bins a tile: a valid quad that
// the span crops off every tile stays out of it, as in JAX's quant_depth)
// with warp reductions and folds them into `range` [2] with one atomic each.
// A binned depth is > 1e-4 (never NaN), so its IEEE bits order as unsigned
// and as signed integers. The entry point first sets both words to
// 0xffffffff (one memset): the unsigned atomicMin of slot 0 and the signed
// atomicMax of slot 1 (0xffffffff is -1 there) both start below / above every
// binned depth, and a slot left at 0xffffffff reads as a NaN float: "nothing
// binned", which bin_keys reads as JAX's +inf / -inf (raster.py:363-366).
//
// bin_keys: 12 B per entry (tile, depth in; key out), one thread per four
// entries with 16-byte loads and stores. The key is JAX's uint32 key, stored
// XOR 0x80000000 as an int32 so that a signed sort orders it as JAX's
// unsigned sort: `torch.sort` then sorts 32-bit keys (4 radix passes, not
// the 8 of an int64 key that the sentinel tile's bit 31 forced before).
//
// The kAppear variants stage the wider rows in dynamic shared memory, kBlock
// rows of up to 13 + 53 floats (the painter's widest row, four atlas layers
// and every column, is 65: 66.6 KB beside the 15.6 KB of static staging, so
// two CTAs an SM; the mesh frame's 17- and 26-float rows take 17-27 KB),
// and read the appearance inputs with scalar loads (a warp's loads of one
// input still cover one contiguous run); they bin a span^2 square by the
// run-time loop. The variants without appearance are unchanged.
//
// Numerics: the op order is the JAX package's, and the library is built
// with -fmad=false so no multiply-add is contracted; the tile floors at
// tile boundaries and the quantised depths then agree bit for bit with the
// plain PyTorch versions.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // particles per block (project_bin)
constexpr int kRowMax = 13;  // floats per row without appearance

// a draw's appearance inputs (NULL where the draw has no such column)
struct AppearanceIn {
  const float* roundness;  // [n]
  const float* tri;        // [n]
  const int32_t* sprite;   // [n]
  const float* tex;        // [n, tex_w]: the painter's (grid, then 4 a layer)
  const float* uv;         // [n, 6]
  const float* nrm;        // [n, 9]
  const float* light;      // [n, 4]: the painter's per-entry (lx, ly, lz, band)
  const float* vcol;       // [n, 12]
  int tex_w;
};

struct ProjectParams {
  float mvp[16];     // proj @ view, row-major
  float view2[4];    // row 2 of view (view-space z)
  float vp_w, vp_h;  // camera viewport, pixels
  float width, height;  // raster size, pixels
  float tile;        // tile size T, pixels
  float y_offset;    // first viewport row of the raster (a slice), pixels
  int ntx, nty, nt;
};

struct Screen {
  float x, y, dist;
};

__device__ __forceinline__ float row4(const float* m, float px, float py, float pz) {
  return m[0] * px + m[1] * py + m[2] * pz + m[3];
}

__device__ __forceinline__ Screen project(const ProjectParams& p, float px, float py, float pz) {
  float view_z = row4(p.view2, px, py, pz);
  float cx = row4(p.mvp + 0, px, py, pz);
  float cy = row4(p.mvp + 4, px, py, pz);
  float w = row4(p.mvp + 12, px, py, pz);
  float safe_w = fabsf(w) < 1e-6f ? 1e-6f : w;
  Screen s;
  s.x = (cx / safe_w * 0.5f + 0.5f) * p.vp_w;
  s.y = (1.0f - (cy / safe_w * 0.5f + 0.5f)) * p.vp_h;
  s.dist = -view_z;
  return s;
}

// Copy `count` floats (a block's slice) from global to shared memory.
__device__ __forceinline__ void load_scalar(float* dst, const float* src, int count) {
  for (int k = threadIdx.x; k < count; k += blockDim.x) dst[k] = src[k];
}

// floor(x) clamped to [lo, hi] in float, then converted (fminf / fmaxf
// drop a NaN, which only an invalid quad has)
__device__ __forceinline__ int tile_floor(float x, float lo, float hi) {
  return (int)fminf(fmaxf(floorf(x), lo), hi);
}

// One particle's S entries at entry s * n + i (the binnings in the header);
// returns whether any slot binned a tile. kSlots: 1, 2, or 0 (span^2, the
// span kSpan, or span_rt where kSpan is 0).
template <int kSlots, int kSpan>
__device__ __forceinline__ bool bin_entries(const ProjectParams& p, float cx, float cy, float rx,
                                            float ry, bool valid, float dist, int span_rt,
                                            int32_t* __restrict__ tile_out,
                                            float* __restrict__ depth_out, int64_t i, int64_t n) {
  if constexpr (kSlots == 1) {
    int tile = p.nt;
    if (valid) {
      // clamp in float before the conversion: exact for every on-screen tile
      float tx = fminf(fmaxf(floorf(cx / p.tile), 0.0f), (float)(p.ntx - 1));
      float ty = fminf(fmaxf(floorf(cy / p.tile), 0.0f), (float)(p.nty - 1));
      tile = (int)ty * p.ntx + (int)tx;
    }
    tile_out[i] = tile;
    depth_out[i] = valid ? dist : -INFINITY;
    return valid;
  }
  const int span = kSlots == 2 ? 1 : (kSpan > 0 ? kSpan : span_rt);
  // raster.py:268-271, the division by T in f32 as JAX's
  const int tx0 = tile_floor((cx - rx) / p.tile, (float)-span, (float)p.ntx);
  const int ty0 = tile_floor((cy - ry) / p.tile, (float)-span, (float)p.nty);
  const int tx1 = tile_floor((cx + rx) / p.tile, -1.0f, (float)p.ntx);
  const int ty1 = tile_floor((cy + ry) / p.tile, -1.0f, (float)p.nty);
  if constexpr (kSlots == 2) {  // raster.py:297-326
    const int tcx = min(max(tx0, 0), p.ntx - 1);
    const int tcy = min(max(ty0, 0), p.nty - 1);
    const bool ok0 = valid && tcx <= tx1 && tcy <= ty1;
    const int tile0 = ok0 ? tcy * p.ntx + tcx : p.nt;
    const bool sx = tx1 > tcx && tcx + 1 < p.ntx;
    const bool sy = ty1 > tcy && tcy + 1 < p.nty;
    const float spill_x = (cx + rx) - (float)(tcx + 1) * p.tile;
    const float spill_y = (cy + ry) - (float)(tcy + 1) * p.tile;
    const bool use_x = sx && (!sy || spill_x >= spill_y);
    const bool ok1 = valid && (sx || sy);
    tile_out[i] = tile0;
    depth_out[i] = ok0 ? dist : -INFINITY;
    tile_out[n + i] = ok1 ? (use_x ? tile0 + 1 : tile0 + p.ntx) : p.nt;
    depth_out[n + i] = ok1 ? dist : -INFINITY;
    return ok0 || ok1;
  }
  bool any = false;  // raster.py:327-330
#pragma unroll
  for (int dy = 0; dy < span; ++dy) {
#pragma unroll
    for (int dx = 0; dx < span; ++dx) {
      const int tx = tx0 + dx, ty = ty0 + dy;
      const bool ok = valid && tx <= tx1 && ty <= ty1 && tx >= 0 && tx < p.ntx && ty >= 0 &&
                      ty < p.nty;
      const int64_t e = (int64_t)(dy * span + dx) * n + i;
      tile_out[e] = ok ? ty * p.ntx + tx : p.nt;
      depth_out[e] = ok ? dist : -INFINITY;
      any = any || ok;
    }
  }
  return any;
}

template <int kSlots, int kSpan, bool kAppear>
__global__ void __launch_bounds__(kBlock) project_bin_kernel(
    const float* __restrict__ position, const float* __restrict__ axis_x,
    const float* __restrict__ axis_y, const uint8_t* __restrict__ alive,
    const float* __restrict__ color, const float* __restrict__ extra,
    int32_t* __restrict__ tile_out, float* __restrict__ depth_out, float* __restrict__ rows,
    unsigned int* __restrict__ range, int n, int row, int base_row, int vec, int span_rt,
    ProjectParams p, AppearanceIn ap) {
  __shared__ __align__(16) float s_pos[3 * kBlock];
  __shared__ __align__(16) float s_ax[3 * kBlock];
  __shared__ __align__(16) float s_ay[3 * kBlock];
  __shared__ __align__(16) float s_col[4 * kBlock];
  __shared__ __align__(16) float s_extra[2 * kBlock];
  __shared__ __align__(16) uint8_t s_alive[kBlock];
  __shared__ __align__(16) float s_rows_fixed[kAppear ? 4 : kRowMax * kBlock];
  extern __shared__ __align__(16) float s_rows_wide[];  // [kBlock, row] (kAppear)
  float* s_rows = kAppear ? s_rows_wide : s_rows_fixed;
  __shared__ unsigned int s_min[kBlock / 32];
  __shared__ int s_max[kBlock / 32];

  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * kBlock;
  const int cnt = (int)min((int64_t)kBlock, (int64_t)n - base);
  const bool full = vec && cnt == kBlock;

  // ---- the slice's inputs into shared memory ----
  if (full) {
    // every load of the thread is issued before the first store to shared memory
    const float4* pos4 = reinterpret_cast<const float4*>(position + 3 * base);
    const float4* ax4 = reinterpret_cast<const float4*>(axis_x + 3 * base);
    const float4* ay4 = reinterpret_cast<const float4*>(axis_y + 3 * base);
    const float4* col4 = reinterpret_cast<const float4*>(color + 4 * base);
    const float4* ex4 = reinterpret_cast<const float4*>(extra + 2 * base);
    const uint4* al16 = reinterpret_cast<const uint4*>(alive + base);
    constexpr int kVec3 = 3 * kBlock / 4, kVec2 = 2 * kBlock / 4, kBytes = kBlock / 16;
    float4 vp, vx, vy, ve;
    uint4 va;
    if (t < kVec3) {
      vp = pos4[t];
      vx = ax4[t];
      vy = ay4[t];
    }
    const float4 vc = col4[t];
    if (extra && t < kVec2) ve = ex4[t];
    if (t < kBytes) va = al16[t];
    if (t < kVec3) {
      reinterpret_cast<float4*>(s_pos)[t] = vp;
      reinterpret_cast<float4*>(s_ax)[t] = vx;
      reinterpret_cast<float4*>(s_ay)[t] = vy;
    }
    reinterpret_cast<float4*>(s_col)[t] = vc;
    if (extra && t < kVec2) reinterpret_cast<float4*>(s_extra)[t] = ve;
    if (t < kBytes) reinterpret_cast<uint4*>(s_alive)[t] = va;
  } else {
    load_scalar(s_pos, position + 3 * base, 3 * cnt);
    load_scalar(s_ax, axis_x + 3 * base, 3 * cnt);
    load_scalar(s_ay, axis_y + 3 * base, 3 * cnt);
    load_scalar(s_col, color + 4 * base, 4 * cnt);
    if (extra) load_scalar(s_extra, extra + 2 * base, 2 * cnt);
    for (int k = t; k < cnt; k += blockDim.x) s_alive[k] = alive[base + k];
  }
  __syncthreads();

  // ---- project, test and bin one particle per thread ----
  unsigned int lo = 0xffffffffu;  // bits of the binned depth (min identity)
  int hi = -1;                    // the same, signed (max identity)
  if (t < cnt) {
    const float px = s_pos[3 * t], py = s_pos[3 * t + 1], pz = s_pos[3 * t + 2];
    Screen c = project(p, px, py, pz);
    Screen e1 = project(p, px + 0.5f * s_ax[3 * t], py + 0.5f * s_ax[3 * t + 1],
                        pz + 0.5f * s_ax[3 * t + 2]);
    Screen e2 = project(p, px + 0.5f * s_ay[3 * t], py + 0.5f * s_ay[3 * t + 1],
                        pz + 0.5f * s_ay[3 * t + 2]);
    float h1x = e1.x - c.x, h1y = e1.y - c.y;
    float h2x = e2.x - c.x, h2y = e2.y - c.y;
    // a slice's raster starts at viewport row y_offset: the centre moves,
    // the half-extents (differences) do not (raster.py:247-252)
    c.y = c.y - p.y_offset;
    float rx = fabsf(h1x) + fabsf(h2x);
    float ry = fabsf(h1y) + fabsf(h2y);
    if (kAppear && ap.tri) {  // raster.py:259-263: a triangle spans half the quad
      const float half = ap.tri[base + t] > 0.5f ? 0.5f : 1.0f;
      rx = rx * half;
      ry = ry * half;
    }
    bool valid = s_alive[t] != 0 && c.dist > 1e-4f;
    valid = valid && (c.x + rx > 0.0f) && (c.x - rx < p.width);
    valid = valid && (c.y + ry > 0.0f) && (c.y - ry < p.height);
    valid = valid && (rx > 1e-6f) && (ry > 1e-6f);
    if (bin_entries<kSlots, kSpan>(p, c.x, c.y, rx, ry, valid, c.dist, span_rt, tile_out,
                                   depth_out, base + t, n)) {
      lo = __float_as_uint(c.dist);
      hi = __float_as_int(c.dist);
    }
    float* r = s_rows + row * t;
    r[0] = c.x;
    r[1] = c.y;
    r[2] = h1x;
    r[3] = h1y;
    r[4] = h2x;
    r[5] = h2y;
    r[6] = s_col[4 * t];
    r[7] = s_col[4 * t + 1];
    r[8] = s_col[4 * t + 2];
    r[9] = s_col[4 * t + 3];
    if (base_row == 13) {
      r[10] = c.dist;
      r[11] = extra ? s_extra[2 * t] : 0.0f;
      r[12] = extra ? s_extra[2 * t + 1] : 0.0f;
    }
    if (kAppear) {  // the appearance columns, in JAX's order
      const int64_t i = base + t;
      int o = base_row;
      if (ap.roundness) r[o++] = ap.roundness[i];
      if (ap.tri) r[o++] = ap.tri[i];
      if (ap.sprite) r[o++] = (float)ap.sprite[i];
      if (ap.tex)
        for (int j = 0; j < ap.tex_w; ++j) r[o++] = ap.tex[(int64_t)ap.tex_w * i + j];
      if (ap.uv)
        for (int j = 0; j < 6; ++j) r[o++] = ap.uv[6 * i + j];
      if (ap.nrm)
        for (int j = 0; j < 9; ++j) r[o++] = ap.nrm[9 * i + j];
      if (ap.light)
        for (int j = 0; j < 4; ++j) r[o++] = ap.light[4 * i + j];
      if (ap.vcol)
        for (int j = 0; j < 12; ++j) r[o++] = ap.vcol[12 * i + j];
    }
  }

  // ---- the block's depth range: one atomic per slot and block ----
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((t & 31) == 0) {
    s_min[t >> 5] = lo;
    s_max[t >> 5] = hi;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < kBlock / 32; ++w) {
      lo = min(lo, s_min[w]);
      hi = max(hi, s_max[w]);
    }
    if (lo != 0xffffffffu) atomicMin(range, lo);
    if (hi != -1) atomicMax(reinterpret_cast<int*>(range + 1), hi);
  }

  // ---- the slice's rows, one contiguous run ----
  float* dst = rows + base * row;
  if (full) {
    const int n4 = kBlock * row / 4;  // row * kBlock floats, a multiple of 4
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* s4 = reinterpret_cast<const float4*>(s_rows);
    for (int k = t; k < n4; k += kBlock) d4[k] = s4[k];
  } else {
    for (int k = t; k < cnt * row; k += kBlock) dst[k] = s_rows[k];
  }
}

// Key layout: key = (tile << tile_shift) | (q << idx_bits) | (idx_bits ? i : 0),
// with q the depth quantised to q_bits (none where q_bits == 0), far first
// (scale - q) where `far_first`.
struct KeyParams {
  int tile_shift, q_bits, idx_bits, far_first;
};

__device__ __forceinline__ int32_t entry_key(int32_t tile, float d, int64_t i, float dmin,
                                             float span, const KeyParams& k) {
  uint32_t key = (uint32_t)tile << k.tile_shift;
  if (k.q_bits) {
    // raster.py:368: (clip((d - dmin) / span, 0, 1) * scale).astype(uint32)
    const float scale = (float)((1u << k.q_bits) - 1u);
    const float x = fminf(fmaxf((d - dmin) / span, 0.0f), 1.0f);
    uint32_t q = (uint32_t)(x * scale);
    if (k.far_first) q = ((1u << k.q_bits) - 1u) - q;
    key |= q << k.idx_bits;
  }
  if (k.idx_bits) key |= (uint32_t)i;
  return (int32_t)(key ^ 0x80000000u);
}

__global__ void bin_keys_kernel(const int32_t* __restrict__ tile, const float* __restrict__ depth,
                                const float* __restrict__ range, int32_t* __restrict__ key,
                                int64_t n, int vec, KeyParams k) {
  float dmin = 0.0f, span = 1.0f;
  if (k.q_bits) {
    const float r0 = range[0], r1 = range[1];
    // NaN: nothing binned, JAX's empty min and max (raster.py:363-366)
    dmin = r0 != r0 ? INFINITY : r0;
    const float dmax = r1 != r1 ? -INFINITY : r1;
    span = fmaxf(dmax - dmin, 1e-9f);  // jnp.maximum(dmax - dmin, 1e-9)
  }
  const int64_t i0 = 4 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (i0 >= n) return;
  if (vec && i0 + 4 <= n) {
    const int4 tv = *reinterpret_cast<const int4*>(tile + i0);
    const float4 dv = *reinterpret_cast<const float4*>(depth + i0);
    int4 out;
    out.x = entry_key(tv.x, dv.x, i0, dmin, span, k);
    out.y = entry_key(tv.y, dv.y, i0 + 1, dmin, span, k);
    out.z = entry_key(tv.z, dv.z, i0 + 2, dmin, span, k);
    out.w = entry_key(tv.w, dv.w, i0 + 3, dmin, span, k);
    *reinterpret_cast<int4*>(key + i0) = out;
  } else {
    for (int64_t i = i0; i < n && i < i0 + 4; ++i)
      key[i] = entry_key(tile[i], depth[i], i, dmin, span, k);
  }
}

bool aligned16(const void* p) { return p == nullptr || ((uintptr_t)p & 15u) == 0; }

}  // namespace

// params: mvp[16], view row 2 [4], vp_w, vp_h, width, height, tile, y_offset
// (26 floats)
// extra: [n, 2] f32 (cutoff, mode) or NULL; base_row: 10 or 13; row: floats
// per row, base_row plus the widths of the appearance inputs given
// (roundness [n] f32, tri [n] f32, sprite [n] int32, tex [n, tex_width]
// with tex_width 2 + 4 * (1 to 4) layers, uv [n, 6], nrm [n, 9], light
// [n, 4], vcol [n, 12] f32; each NULL where the draw has no such column);
// range: f32 [2], out: (min, max) of the binned depths, NaN where none
// tile_slots: 0 (span^2 entries a particle), 1 or 2; tile_out and depth_out
// hold S * n entries, slot-major
extern "C" int hanabi_project_bin(const void* position, const void* axis_x, const void* axis_y,
                                  const void* alive, const void* color, const void* extra,
                                  void* tile_out, void* depth_out, void* rows, void* range,
                                  int n, int row, const float* params, int ntx, int nty,
                                  int tile_slots, int tile_span, int base_row,
                                  const void* roundness, const void* tri, const void* sprite,
                                  const void* tex, const void* uv, const void* nrm,
                                  const void* light, const void* vcol, int tex_width,
                                  void* stream) {
  const AppearanceIn ap{(const float*)roundness, (const float*)tri, (const int32_t*)sprite,
                        (const float*)tex, (const float*)uv, (const float*)nrm,
                        (const float*)light, (const float*)vcol, tex ? tex_width : 0};
  const int appear_width = (roundness ? 1 : 0) + (tri ? 1 : 0) + (sprite ? 1 : 0) + ap.tex_w +
                           (uv ? 6 : 0) + (nrm ? 9 : 0) + (light ? 4 : 0) + (vcol ? 12 : 0);
  const bool appear = appear_width > 0;
  // (with no particle the inputs, appearance columns included, may be NULL)
  if ((base_row != 10 && base_row != 13) || (n > 0 && row != base_row + appear_width) ||
      (tex && (tex_width < 6 || tex_width > 18 || (tex_width - 2) % 4 != 0)) ||
      !range || tile_slots < 0 || tile_slots > 2 ||
      (tile_slots == 0 && (tile_span < 1 || tile_span > 46340)))  // span^2 fits an int
    return (int)cudaErrorInvalidValue;
  ProjectParams p;
  for (int k = 0; k < 16; ++k) p.mvp[k] = params[k];
  for (int k = 0; k < 4; ++k) p.view2[k] = params[16 + k];
  p.vp_w = params[20];
  p.vp_h = params[21];
  p.width = params[22];
  p.height = params[23];
  p.tile = params[24];
  p.y_offset = params[25];
  p.ntx = ntx;
  p.nty = nty;
  p.nt = ntx * nty;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(range, 0xff, 2 * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int vec = aligned16(position) && aligned16(axis_x) && aligned16(axis_y) &&
                    aligned16(alive) && aligned16(color) && aligned16(extra) && aligned16(rows);
    const size_t wide = appear ? (size_t)kBlock * row * sizeof(float) : 0;
#define HANABI_PB(SLOTS, SPAN, APPEAR)                                                           \
  do {                                                                                         \
    if (APPEAR) {                                                                              \
      err = cudaFuncSetAttribute(project_bin_kernel<SLOTS, SPAN, APPEAR>,                      \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wide);      \
      if (err != cudaSuccess) return (int)err;                                                 \
    }                                                                                          \
    project_bin_kernel<SLOTS, SPAN, APPEAR><<<(n + kBlock - 1) / kBlock, kBlock, wide, s>>>(   \
        (const float*)position, (const float*)axis_x, (const float*)axis_y,                    \
        (const uint8_t*)alive, (const float*)color, (const float*)extra, (int32_t*)tile_out,   \
        (float*)depth_out, (float*)rows, (unsigned int*)range, n, row, base_row, vec,          \
        tile_span, p, ap);                                                                     \
  } while (0)
    if (appear) {
      if (tile_slots == 1) HANABI_PB(1, 1, true);
      else if (tile_slots == 2) HANABI_PB(2, 1, true);
      else HANABI_PB(0, 0, true);
    } else if (tile_slots == 1) HANABI_PB(1, 1, false);
    else if (tile_slots == 2) HANABI_PB(2, 1, false);
    else if (tile_span == 1) HANABI_PB(0, 1, false);
    else if (tile_span == 2) HANABI_PB(0, 2, false);
    else if (tile_span == 3) HANABI_PB(0, 3, false);
    else if (tile_span == 4) HANABI_PB(0, 4, false);
    else HANABI_PB(0, 0, false);
#undef HANABI_PB
  }
  return (int)cudaGetLastError();
}

// tile int32 [n], depth f32 [n], range f32 [2] (NaN: nothing binned; may be
// NULL where q_bits is 0) -> key int32 [n] in the layout of KeyParams
extern "C" int hanabi_bin_keys(const void* tile, const void* depth, const void* range, void* key,
                               long long n, int tile_shift, int q_bits, int idx_bits,
                               int far_first, void* stream) {
  if (tile_shift < 0 || tile_shift > 31 || q_bits < 0 || q_bits > 22 || idx_bits < 0 ||
      idx_bits > 31 || (q_bits && !range))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    KeyParams k{tile_shift, q_bits, idx_bits, far_first};
    const int vec = aligned16(tile) && aligned16(depth) && aligned16(key);
    const int threads = 256;
    const long long blocks = ((n + 3) / 4 + threads - 1) / threads;
    bin_keys_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)tile, (const float*)depth, (const float*)range, (int32_t*)key, n, vec, k);
  }
  return (int)cudaGetLastError();
}
