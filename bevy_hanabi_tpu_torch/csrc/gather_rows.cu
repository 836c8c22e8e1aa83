// gather_rows: out[j, :] = table[idx[j], :] for an f32 row table.
//
// Replaces the TPU kernel `pallas_gather` (experiments/pallas_gather_bench.py:64,
// and its second version experiments/pallas_gather2.py:57), a per-row DMA
// gather with scalar-prefetched indices. On the rasterizer's main path it
// is the window gather of bevy_hanabi_tpu/render/raster.py:581-588: M * nt
// = 64 * 1024 rows of F = 10 f32 (cx, cy, h1, h2, rgba) at 512x512.
//
// Bound on the H100: bytes. Each output row is 40 B written once and 40 B
// read from a random table row (idx are particle ids in depth order), so
// the kernel moves ~2 * 40 B * 65536 = 5.2 MB plus the 256 KB index array;
// at that size it is launch- and latency-bound, not bandwidth-bound.
//
// Design: one thread per output element. Consecutive threads write
// consecutive floats of `out` (coalesced stores), and the F threads of a
// row read one contiguous 40 B table row (one or two 32 B sectors). The
// TPU version needed a ring of D row DMAs in flight to hide latency; here
// the SM's many resident warps hide it, so no explicit pipelining. An
// index outside [0, n_table) writes NaN instead of reading out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_rows_kernel(const float* __restrict__ table,
                                   const int32_t* __restrict__ idx,
                                   float* __restrict__ out,
                                   int64_t total, int32_t n_table, int32_t F) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  int64_t j = e / F;
  int32_t f = (int32_t)(e - j * F);
  int32_t r = idx[j];
  out[e] = (r >= 0 && r < n_table) ? table[(int64_t)r * F + f] : __int_as_float(0x7fc00000);
}

}  // namespace

extern "C" int hanabi_gather_rows(const void* table, const void* idx, void* out,
                                  long long n_out, int n_table, int F, void* stream) {
  int64_t total = (int64_t)n_out * F;
  if (total > 0) {
    const int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    gather_rows_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)table, (const int32_t*)idx, (float*)out, total, n_table, F);
  }
  return (int)cudaGetLastError();
}
