// project_bin: project each particle's quad, test it against the screen,
// bin it into the tile holding its centre, and pack its blend row.
//
// Replaces bevy_hanabi_tpu/render/raster.py:241-292 (the tile_slots=1
// branch of steps 1-2, with `_project` at raster.py:148-176) and the row
// stack of raster.py:516-529/586. The JAX package leaves this region to XLA
// on the TPU; it has no Pallas kernel.
//
// Per particle it reads 3 vec3 + 1 bool + 1 vec4 = 53 B and writes the tile
// id, the depth and one 10-float row = 48 B: ~100 MB per frame at 1M
// particles, so it is bound by device-memory bandwidth (~30 us at 3.35
// TB/s). The design keeps everything in one pass: the three projections
// (centre and both half-axis points), the screen test and the binning all
// stay in registers, and the 4x4 matrices ride in the kernel parameters
// (constant bank), so the only device traffic is the particle streams.
//
// Numerics: the op order is the JAX package's, and the library is built
// with -fmad=false so no multiply-add is contracted; the tile floors at
// tile boundaries then agree bit for bit with the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct ProjectParams {
  float mvp[16];     // proj @ view, row-major
  float view2[4];    // row 2 of view (view-space z)
  float vp_w, vp_h;  // camera viewport, pixels
  float width, height;  // raster size, pixels
  float tile;        // tile size T, pixels
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

__global__ void project_bin_kernel(const float* __restrict__ position,
                                   const float* __restrict__ axis_x,
                                   const float* __restrict__ axis_y,
                                   const uint8_t* __restrict__ alive,
                                   const float* __restrict__ color,
                                   int32_t* __restrict__ tile_out,
                                   float* __restrict__ depth_out,
                                   float* __restrict__ rows,
                                   int n, ProjectParams p) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float px = position[3 * i], py = position[3 * i + 1], pz = position[3 * i + 2];
  Screen c = project(p, px, py, pz);
  Screen e1 = project(p, px + 0.5f * axis_x[3 * i], py + 0.5f * axis_x[3 * i + 1],
                      pz + 0.5f * axis_x[3 * i + 2]);
  Screen e2 = project(p, px + 0.5f * axis_y[3 * i], py + 0.5f * axis_y[3 * i + 1],
                      pz + 0.5f * axis_y[3 * i + 2]);
  float h1x = e1.x - c.x, h1y = e1.y - c.y;
  float h2x = e2.x - c.x, h2y = e2.y - c.y;
  float rx = fabsf(h1x) + fabsf(h2x);
  float ry = fabsf(h1y) + fabsf(h2y);
  bool valid = alive[i] != 0 && c.dist > 1e-4f;
  valid = valid && (c.x + rx > 0.0f) && (c.x - rx < p.width);
  valid = valid && (c.y + ry > 0.0f) && (c.y - ry < p.height);
  valid = valid && (rx > 1e-6f) && (ry > 1e-6f);
  int tile = p.nt;
  if (valid) {
    // clamp in float before the conversion: exact for every on-screen tile
    float tx = fminf(fmaxf(floorf(c.x / p.tile), 0.0f), (float)(p.ntx - 1));
    float ty = fminf(fmaxf(floorf(c.y / p.tile), 0.0f), (float)(p.nty - 1));
    tile = (int)ty * p.ntx + (int)tx;
  }
  tile_out[i] = tile;
  depth_out[i] = valid ? c.dist : -INFINITY;
  float* r = rows + 10 * (int64_t)i;
  r[0] = c.x;
  r[1] = c.y;
  r[2] = h1x;
  r[3] = h1y;
  r[4] = h2x;
  r[5] = h2y;
  r[6] = color[4 * i];
  r[7] = color[4 * i + 1];
  r[8] = color[4 * i + 2];
  r[9] = color[4 * i + 3];
}

}  // namespace

// params: mvp[16], view row 2 [4], vp_w, vp_h, width, height, tile (25 floats)
extern "C" int hanabi_project_bin(const void* position, const void* axis_x, const void* axis_y,
                                  const void* alive, const void* color, void* tile_out,
                                  void* depth_out, void* rows, int n, const float* params,
                                  int ntx, int nty, void* stream) {
  ProjectParams p;
  for (int k = 0; k < 16; ++k) p.mvp[k] = params[k];
  for (int k = 0; k < 4; ++k) p.view2[k] = params[16 + k];
  p.vp_w = params[20];
  p.vp_h = params[21];
  p.width = params[22];
  p.height = params[23];
  p.tile = params[24];
  p.ntx = ntx;
  p.nty = nty;
  p.nt = ntx * nty;
  if (n > 0) {
    const int threads = 256;
    project_bin_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const float*)position, (const float*)axis_x, (const float*)axis_y,
        (const uint8_t*)alive, (const float*)color, (int32_t*)tile_out, (float*)depth_out,
        (float*)rows, n, p);
  }
  return (int)cudaGetLastError();
}
