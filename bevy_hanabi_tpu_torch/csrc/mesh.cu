// mesh_expand: expand N particles into the K elements (Q quads, then T
// triangles) of a per-particle mesh, one raster entry per element and
// particle, entry k * N + p (element-major: the order of the JAX package's
// concatenation).
//
// Replaces bevy_hanabi_tpu/render/mesh.py:228-363 (`expand_mesh_draw`),
// which the JAX package leaves to XLA on the TPU as a Python loop over the
// elements; it has no Pallas kernel. In eager PyTorch that loop would be
// hundreds of launches a frame; here it is one.
//
// Per entry (e = k * N + p), with the particle's axes ax, ay and
//   az = cross(ax, ay) / max(|cross(ax, ay)|, 1e-9) * |ax|:
//   position = P + map(anchor_k), axis_x = s_k * map(ex_k),
//   axis_y = s_k * map(ey_k), map(m) = (m.x ax + m.y ay) + m.z az,
//   color = the particle's, alive = the particle's, tri = (element k is a
//   triangle), uv = the element's constant UVs, vcol its constant colours,
//   and the normals: a quad's three are az / |.|; a triangle's are its
//   mesh-space vertex normals through the normalised axes, normalised.
// The tables (anchor, edges, scale s_k; UVs, normals, colours) are the
// mesh's constants, computed on the host as JAX does in numpy (mesh.py:
// 261-331) and uploaded once per mesh and device.
//
// Numerics: the op order is JAX's (its jnp.cross, which XLA compiles with
// one fused multiply-add a component, its left-to-right sums of three,
// `jnp.maximum` which keeps a NaN), and the library is built with
// -fmad=false (the cross product's fmaf is explicit), so every output
// equals the plain version's bit for bit.
//
// Bound on the H100: bytes. An entry reads its particle's 53 bytes (from
// L2 for K - 1 of the K elements: the particle's inputs are 53 MB at most
// and each of a block's elements reads the same slice) and writes
// 81 bytes (positions, axes, colour, alive, tri and six UV floats; 117 with
// nine normals), ~106 MB a frame for the 1.31M-entry textured mesh frame:
// ~0.032 ms at 3.35 TB/s. The arithmetic (~60 flops an entry, ~130 with
// normals) is far below the FP32 rate.
//
// Design: one thread per entry, a block of 256 consecutive particles of
// one element (blockIdx.y = k), so a warp reads 32 consecutive particles
// and the block writes 256 consecutive entries of every output. A thread's
// own rows (position, axes, normals: 3 or 9 floats) would leave a warp's
// store scattered over 12 or 36 B strides, so they are staged in shared
// memory and written as the block's contiguous run, a warp storing 128
// contiguous bytes at a time; the element's constant rows (UVs, colours)
// are written the same way straight from its table. The colour leaves as
// one 16-byte store a thread, the flags as one store each. The element's
// table rows are the same for every thread of the block (broadcast loads
// through the read-only cache).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGeom = 10;  // anchor (3), edge x (3), edge y (3), scale

struct V3 {
  float x, y, z;
};

// jnp.maximum(x, lo): a NaN stays NaN
__device__ __forceinline__ float at_least(float x, float lo) { return x < lo ? lo : x; }

// jnp.sum(v * v, axis=-1) over three components, left to right
__device__ __forceinline__ float dot_self(V3 v) { return (v.x * v.x + v.y * v.y) + v.z * v.z; }

__device__ __forceinline__ V3 load3(const float* __restrict__ p, int64_t i) {
  return V3{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

// (m0 * a + m1 * b) + m2 * c, per component (mesh.py:254-255)
__device__ __forceinline__ V3 map3(float m0, float m1, float m2, V3 a, V3 b, V3 c) {
  return V3{(m0 * a.x + m1 * b.x) + m2 * c.x, (m0 * a.y + m1 * b.y) + m2 * c.y,
            (m0 * a.z + m1 * b.z) + m2 * c.z};
}

__device__ __forceinline__ V3 scale3(float s, V3 v) { return V3{s * v.x, s * v.y, s * v.z}; }

__device__ __forceinline__ V3 div3(V3 v, float d) { return V3{v.x / d, v.y / d, v.z / d}; }

// The block's `cnt` rows of kW floats (thread t's in v) to out[0 .. cnt *
// kW), through shared memory, as one contiguous run. Every thread of the
// block calls it.
template <int kW>
__device__ __forceinline__ void store_rows(float* buf, const float (&v)[kW], float* __restrict__ out,
                                           int cnt) {
  __syncthreads();  // the previous run has left the buffer
  if ((int)threadIdx.x < cnt) {
#pragma unroll
    for (int j = 0; j < kW; ++j) buf[threadIdx.x * kW + j] = v[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cnt * kW; i += kThreads) out[i] = buf[i];
}

// `cnt` copies of one kW-float row to out[0 .. cnt * kW), contiguous
template <int kW>
__device__ __forceinline__ void fill_rows(const float* __restrict__ row, float* __restrict__ out,
                                          int cnt) {
  for (int i = threadIdx.x; i < cnt * kW; i += kThreads) out[i] = __ldg(row + i % kW);
}

__global__ void __launch_bounds__(kThreads) mesh_expand_kernel(
    const float* __restrict__ position, const float* __restrict__ axis_x,
    const float* __restrict__ axis_y, const float* __restrict__ color,
    const uint8_t* __restrict__ alive, const float* __restrict__ geom,
    const float* __restrict__ uv_t, const float* __restrict__ nrm_t,
    const float* __restrict__ vcol_t, float* __restrict__ pos_o, float* __restrict__ ax_o,
    float* __restrict__ ay_o, float* __restrict__ col_o, uint8_t* __restrict__ alive_o,
    float* __restrict__ tri_o, float* __restrict__ uv_o, float* __restrict__ nrm_o,
    float* __restrict__ vcol_o, int64_t n, int q) {
  __shared__ float buf[kThreads * 9];
  const int t = threadIdx.x;
  const int k = blockIdx.y;
  const int64_t p0 = (int64_t)blockIdx.x * kThreads;
  const int cnt = (int)min((int64_t)kThreads, n - p0);
  const bool live = t < cnt;
  const int64_t p = live ? p0 + t : p0;  // a thread past the end repeats a live particle
  const int64_t e0 = (int64_t)k * n + p0, e = e0 + t;
  const V3 P = load3(position, p), ax = load3(axis_x, p), ay = load3(axis_y, p);
  if (live) {
    reinterpret_cast<float4*>(col_o)[e] = reinterpret_cast<const float4*>(color)[p];
    alive_o[e] = alive[p];
    if (tri_o) tri_o[e] = k >= q ? 1.0f : 0.0f;
  }

  // the particle frame (mesh.py:248-252): jnp.cross, then normalise, scale
  // by |ax|. XLA contracts jnp.cross's a1 * b2 - a2 * b1 into one fused
  // multiply-add of the first product; fmaf is that op.
  const V3 cr = V3{fmaf(ax.y, ay.z, -(ax.z * ay.y)), fmaf(ax.z, ay.x, -(ax.x * ay.z)),
                   fmaf(ax.x, ay.y, -(ax.y * ay.x))};
  const V3 azn = div3(cr, at_least(sqrtf(dot_self(cr)), 1e-9f));
  const float sz = sqrtf(dot_self(ax));
  const V3 az = scale3(sz, azn);

  const float* g = geom + (int64_t)k * kGeom;
  const float s = __ldg(g + 9);
  const V3 anchor = map3(__ldg(g + 0), __ldg(g + 1), __ldg(g + 2), ax, ay, az);
  const V3 ex = scale3(s, map3(__ldg(g + 3), __ldg(g + 4), __ldg(g + 5), ax, ay, az));
  const V3 ey = scale3(s, map3(__ldg(g + 6), __ldg(g + 7), __ldg(g + 8), ax, ay, az));
  store_rows<3>(buf, {P.x + anchor.x, P.y + anchor.y, P.z + anchor.z}, pos_o + 3 * e0, cnt);
  store_rows<3>(buf, {ex.x, ex.y, ex.z}, ax_o + 3 * e0, cnt);
  store_rows<3>(buf, {ey.x, ey.y, ey.z}, ay_o + 3 * e0, cnt);
  if (uv_o) fill_rows<6>(uv_t + 6 * k, uv_o + 6 * e0, cnt);
  if (vcol_o) fill_rows<12>(vcol_t + 12 * k, vcol_o + 12 * e0, cnt);
  if (nrm_o) {
    float nv[9];
    if (k < q) {  // a quad: its face normal at all three corners
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        nv[3 * v] = azn.x;
        nv[3 * v + 1] = azn.y;
        nv[3 * v + 2] = azn.z;
      }
    } else {  // mesh.py:289-298: through the normalised particle axes
      const V3 axn = div3(ax, at_least(sqrtf(dot_self(ax)), 1e-9f));
      const V3 ayn = div3(ay, at_least(sqrtf(dot_self(ay)), 1e-9f));
      const float* m = nrm_t + 9 * k;
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const V3 w = map3(__ldg(m + 3 * v), __ldg(m + 3 * v + 1), __ldg(m + 3 * v + 2), axn,
                          ayn, azn);
        const V3 u = div3(w, at_least(sqrtf(dot_self(w)), 1e-9f));
        nv[3 * v] = u.x;
        nv[3 * v + 1] = u.y;
        nv[3 * v + 2] = u.z;
      }
    }
    store_rows<9>(buf, nv, nrm_o + 9 * e0, cnt);
  }
}

}  // namespace

// position, axis_x, axis_y [n, 3] f32, color [n, 4] f32 (16-byte aligned),
// alive [n] bool; geom [k, 10]; uv_t [k, 6], nrm_t [k, 9], vcol_t [k, 12]
// (NULL where not asked for); outputs [k * n, ...] as their tables (tri_o
// NULL for a mesh without triangles; uv_o, nrm_o, vcol_o NULL where their
// table is). k = q + t.
extern "C" int hanabi_mesh_expand(const void* position, const void* axis_x, const void* axis_y,
                                  const void* color, const void* alive, const void* geom,
                                  const void* uv_t, const void* nrm_t, const void* vcol_t,
                                  void* pos_o, void* ax_o, void* ay_o, void* col_o,
                                  void* alive_o, void* tri_o, void* uv_o, void* nrm_o,
                                  void* vcol_o, long long n, int q, int t, void* stream) {
  const int k = q + t;
  if (q < 0 || t < 0 || k <= 0 || k > 65535) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();  // empty outputs may hold NULL pointers
  if ((!uv_t) != (!uv_o) || (!nrm_t) != (!nrm_o) || (!vcol_t) != (!vcol_o) ||
      (t > 0) != (tri_o != nullptr) || ((uintptr_t)color & 15u) || ((uintptr_t)col_o & 15u))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)k);
  mesh_expand_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)position, (const float*)axis_x, (const float*)axis_y, (const float*)color,
      (const uint8_t*)alive, (const float*)geom, (const float*)uv_t, (const float*)nrm_t,
      (const float*)vcol_t, (float*)pos_o, (float*)ax_o, (float*)ay_o, (float*)col_o,
      (uint8_t*)alive_o, (float*)tri_o, (float*)uv_o, (float*)nrm_o, (float*)vcol_o, n, q);
  return (int)cudaGetLastError();
}
