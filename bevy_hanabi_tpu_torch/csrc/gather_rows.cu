// gather_rows and gather_window: row gathers from an f32 row table.
//
// Both replace the TPU kernel `pallas_gather` (experiments/pallas_gather_bench.py:64,
// and its second version experiments/pallas_gather2.py:57), a per-row DMA
// gather with scalar-prefetched indices.
//
// gather_rows: out[j, :] = table[idx[j], :]. On the main paths it is the
// event payload gather of a child's step (runtime/events.py): the rocket
// buffer's [65536, 3] positions at the 262,144 trail lanes' event indices.
//
// gather_window: the rasterizer's per-tile window, the XLA region of
// bevy_hanabi_tpu/render/raster.py:488-506 (the window's base, its slot
// indices and `has`) and :586 (the row gather) in one launch. Tile t takes
// base = starts[t] (the fast paths) or max(ends[t] - M, starts[t]) (the
// ordered path's nearest M, back to front); slot m is filled when
// base + m < ends[t] and then holds rows[e mod n_rows], e = pidx_sorted[base
// + m]: with S bin entries a particle (tile_slots 0 and 2), the sorted ids
// are entry indices s * n_rows + p, and JAX takes t_p = entry mod n
// (raster.py:497-500). The remainder is taken on each filled slot (one
// integer op; non-negative, as torch.remainder), so no id reads outside the
// table. Empty slots are written as 0.0 and never read from the table. At
// the headline (512x512, M = 64, 1024 tiles) 34,691 of 65,536 slots are
// filled.
//
// Bound on the H100: bytes, and at these sizes the latency of three
// dependent loads (bounds, index, row) and the launch. gather_window must
// read starts/ends, the filled slots' indices and rows, and write the whole
// window and `has`: ~4.4 MB on the headline, 0.0013 ms at 3.35 TB/s.
// gather_rows moves the indices, the rows it reads and the rows it writes.
//
// Design (the first version ran one thread per output float: each of a
// row's F threads loaded the same index and divided by F, and stored 4 B):
//   - one thread per row: it loads the row's index once and its F floats
//     (all loads issued before the first use, so they overlap), with no
//     divide per element;
//   - a CTA stages its run of rows (gather_rows: up to 256 rows;
//     gather_window: one tile's M slots) in shared memory, then writes
//     the run with coalesced 16-byte stores (the run's M * F floats are a
//     multiple of 4 for F = 10, 13 at M = 64, 128; a scalar tail or path
//     covers the rest);
//   - gather_window takes pidx_sorted as int32 (the first/depth keys) or
//     int64 (the stable sort's indices) through a template: no conversion
//     launch. It replaces the ~8 eager launches of window_index and the
//     gather with one.
// gather_rows: an index outside [0, n_table) writes NaN instead of reading
// out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kStageFloats = 12288;  // 48 KB: the static shared-memory limit
constexpr int kRowsPerBlock = 256;   // gather_rows' run for F <= 48

// Stage row r of `table` (F floats) at `dst` in shared memory, or NaN where
// r is outside [0, n_table). kF > 0 fixes F at compile time.
template <int kF>
__device__ __forceinline__ void stage_row(const float* __restrict__ table, long long r,
                                          long long n_table, int F_rt, float* dst) {
  const bool ok = r >= 0 && r < n_table;
  const float nan = __int_as_float(0x7fc00000);
  if constexpr (kF > 0) {
    const float* src = table + (ok ? r : 0) * kF;
    float v[kF];
#pragma unroll
    for (int f = 0; f < kF; ++f) v[f] = ok ? __ldg(src + f) : nan;
#pragma unroll
    for (int f = 0; f < kF; ++f) dst[f] = v[f];
  } else {
    const float* src = table + (ok ? r : 0) * F_rt;
    for (int f = 0; f < F_rt; ++f) dst[f] = ok ? __ldg(src + f) : nan;
  }
}

template <int kF>
__device__ __forceinline__ void zero_row(int F_rt, float* dst) {
  if constexpr (kF > 0) {
#pragma unroll
    for (int f = 0; f < kF; ++f) dst[f] = 0.0f;
  } else {
    for (int f = 0; f < F_rt; ++f) dst[f] = 0.0f;
  }
}

// Write `total` staged floats to `dst`: 16-byte stores where `vec4` (dst
// 16-byte aligned), then the scalar tail.
__device__ __forceinline__ void write_run(const float4* stage4, float* __restrict__ dst, int total,
                                          bool vec4) {
  int done = 0;
  if (vec4) {
    const int n4 = total >> 2;
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) dst4[i] = stage4[i];
    done = n4 << 2;
  }
  const float* stage = reinterpret_cast<const float*>(stage4);
  for (int i = done + threadIdx.x; i < total; i += blockDim.x) dst[i] = stage[i];
}

template <int kF>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const float* __restrict__ table, const int32_t* __restrict__ idx,
                       float* __restrict__ out, long long n_out, long long n_table, int F_rt,
                       int rows_per_block) {
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  const int F = kF > 0 ? kF : F_rt;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const int rows = (int)min((long long)rows_per_block, n_out - row0);
  for (int j = threadIdx.x; j < rows; j += blockDim.x)
    stage_row<kF>(table, __ldg(idx + row0 + j), n_table, F, stage + j * F);
  __syncthreads();
  // row0 * F * 4 bytes is a multiple of 16: rows_per_block * F is a multiple of 4
  write_run(stage4, out + row0 * F, rows * F, true);
}

// the row of entry `e`: e mod n_rows in [0, n_rows), as torch.remainder
template <typename Idx>
__device__ __forceinline__ long long entry_row(Idx e, long long n_rows) {
  if constexpr (sizeof(Idx) == 4) {
    const int r = e % (int)n_rows;  // the wrapper keeps n_rows below 2^31
    return r < 0 ? r + n_rows : r;
  } else {
    const long long r = e % n_rows;
    return r < 0 ? r + n_rows : r;
  }
}

template <typename Idx, int kF>
__global__ void __launch_bounds__(kThreads)
    gather_window_kernel(const float* __restrict__ rows, const Idx* __restrict__ pidx_sorted,
                         const long long* __restrict__ starts, const long long* __restrict__ ends,
                         float* __restrict__ window, uint8_t* __restrict__ has, long long n_entries,
                         long long n_rows, int M, int F_rt, int from_start, int vec4) {
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  const int F = kF > 0 ? kF : F_rt;
  const long long t = blockIdx.x;
  const long long s = starts[t], e = ends[t];
  const long long base = from_start ? s : max(e - (long long)M, s);
  const long long filled = e - base;  // slots m < filled hold an entry
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float* dst = stage + m * F;
    if (m < filled) {
      // the reference clamps the slot to the last entry (raster.py:490)
      const long long k = min(base + m, n_entries - 1);
      stage_row<kF>(rows, entry_row(__ldg(pidx_sorted + k), n_rows), n_rows, F, dst);
    } else {
      zero_row<kF>(F, dst);
    }
    has[t * M + m] = m < filled;
  }
  __syncthreads();
  write_run(stage4, window + t * M * F, M * F, vec4 != 0);
}

template <typename Idx>
cudaError_t launch_window(const void* rows, const void* pidx, const void* starts, const void* ends,
                          void* window, void* has, int nt, long long n_entries, long long n_rows,
                          int M, int F, int from_start, int vec4, cudaStream_t s) {
  const int threads = std::min(kThreads, std::max(32, (M + 31) / 32 * 32));
  const size_t smem = (size_t)M * F * sizeof(float);
#define HANABI_WINDOW(KF)                                                                         \
  gather_window_kernel<Idx, KF><<<nt, threads, smem, s>>>(                                         \
      (const float*)rows, (const Idx*)pidx, (const long long*)starts, (const long long*)ends,     \
      (float*)window, (uint8_t*)has, n_entries, n_rows, M, F, from_start, vec4)
  if (F == 10) HANABI_WINDOW(10);
  else if (F == 13) HANABI_WINDOW(13);
  else HANABI_WINDOW(0);
#undef HANABI_WINDOW
  return cudaGetLastError();
}

}  // namespace

extern "C" int hanabi_gather_rows(const void* table, const void* idx, void* out,
                                  long long n_out, int n_table, int F, void* stream) {
  if (n_out <= 0 || F <= 0) return (int)cudaGetLastError();
  // a run of rows that fits the staging buffer, its floats a multiple of 4
  const int rows_per_block = F <= kStageFloats / kRowsPerBlock ? kRowsPerBlock
                                                               : (kStageFloats / F) & ~3;
  if (rows_per_block < 4) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_out + rows_per_block - 1) / rows_per_block;
  const size_t smem = (size_t)rows_per_block * F * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
#define HANABI_GATHER(KF)                                                                          \
  gather_rows_kernel<KF><<<(unsigned)blocks, kThreads, smem, s>>>(                                 \
      (const float*)table, (const int32_t*)idx, (float*)out, n_out, n_table, F, rows_per_block)
  if (F == 1) HANABI_GATHER(1);
  else if (F == 3) HANABI_GATHER(3);
  else if (F == 10) HANABI_GATHER(10);
  else if (F == 13) HANABI_GATHER(13);
  else HANABI_GATHER(0);
#undef HANABI_GATHER
  return (int)cudaGetLastError();
}

extern "C" int hanabi_gather_window(const void* rows, const void* pidx_sorted, const void* starts,
                                    const void* ends, void* window, void* has, int nt,
                                    long long n_entries, long long n_rows, int M, int F,
                                    int from_start, int idx64, int vec4, void* stream) {
  if (nt <= 0 || M <= 0) return (int)cudaGetLastError();
  if ((long long)M * F > kStageFloats || (n_entries > 0 && (n_rows <= 0 || n_rows > 0x7fffffff)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      idx64 ? launch_window<long long>(rows, pidx_sorted, starts, ends, window, has, nt, n_entries,
                                     n_rows, M, F, from_start, vec4, s)
            : launch_window<int>(rows, pidx_sorted, starts, ends, window, has, nt, n_entries,
                                     n_rows, M, F, from_start, vec4, s);
  return (int)err;
}
