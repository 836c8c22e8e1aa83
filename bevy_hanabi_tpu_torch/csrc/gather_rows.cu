// gather_rows and gather_window: row gathers from an f32 row table.
//
// Both replace the TPU kernel `pallas_gather` (experiments/pallas_gather_bench.py:65,
// and its second version experiments/pallas_gather2.py:58), a per-row DMA
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
// window and `has`: ~4.4 MB on the headline, 0.0013 ms at 3.35 TB/s; the lit
// mesh window (26 floats a row, every slot filled) ~14.2 MB, 0.0043 ms.
// gather_rows moves the indices, the rows it reads and the rows it writes.
//
// gather_rows: one thread per row loads the row's index once and its F
// floats (all loads issued before the first use, so they overlap); a CTA
// stages its run of up to 256 rows in shared memory and writes the run with
// coalesced 16-byte stores. An index outside [0, n_table) writes NaN instead
// of reading out of bounds.
//
// gather_window, for any row width F and any M: the window [nt, M, F] is one
// run of nt * M * F floats, slot-major, so a CTA of 256 threads takes
// `chunk` consecutive slots (about 1024, 2048 or 4096 floats, across tile
// boundaries) whatever M is:
//   - it stages the slots' row ids, not their floats: one index load a slot
//     (int32 in shared memory, -1 for an empty slot), `has` written in the
//     same pass; so shared memory is 4 bytes a slot and sets no cap on M * F;
//   - then its threads sweep the run's floats: lane l of a warp takes floats
//     4l..4l+3 of the warp's 128, so a row of 68 or 104 bytes is read by
//     neighbouring lanes, and the floats go out in 16-byte stores straight
//     from registers (the run starts 16-byte aligned: `chunk` is a multiple
//     of 4; a scalar tail ends the last CTA);
//   - slot and column of a thread's floats come from one division by F a
//     thread, then additions (no divide a float);
//   - each thread issues all its loads (its batch of 1, 2 or 4 groups of 4)
//     before its first store, so they overlap: the smallest batch whose grid
//     is resident at once, else 4 (fewer CTAs, each one's staging and
//     barrier spread over more floats);
//   - F = 10, the quads' rows, is fixed at compile time (it measured faster
//     there; fixing 11, 13, 17 and 26 too did not); every other width takes
//     the runtime F;
//   - offsets are 64-bit (g0 * F, row * F).
// It takes pidx_sorted as int32 (the first/depth keys) or int64 (the stable
// sort's indices) through a template: no conversion launch. The designs
// measured beside it (experiments/torch_gather_window_variants.py) are in
// experiments/gather_window_variants/: the kernel it replaced (first.cu: one thread a
// slot, the tile's floats staged in 48 KB, so M * F <= 12288), the sweep
// with a multiply-high division and lane-contiguous 4-byte stores
// (direct.cu), and floats staged in shared memory for the stores
// (staged.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kStageFloats = 12288;  // 48 KB: the static shared-memory limit
constexpr int kRowsPerBlock = 256;   // gather_rows' run for F <= 48

// gather_window: a lane loads and stores 4 consecutive floats of its CTA's
// run (one 16-byte store); a thread's groups lie kStride floats apart, and it
// loads its batch of groups (1, 2 or 4, chosen at launch) before its first
// store.
constexpr int kStride = 4 * kThreads;
constexpr int kMaxBatch = 4;

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

// kF > 0 fixes F at compile time (F = 10, the quads' rows of every BLEND,
// ADD and OPAQUE pass)
template <typename Idx, int kBatch, int kF>
__global__ void __launch_bounds__(kThreads)
    gather_window_kernel(const float* __restrict__ rows, const Idx* __restrict__ pidx_sorted,
                         const long long* __restrict__ starts, const long long* __restrict__ ends,
                         float* __restrict__ window, uint8_t* __restrict__ has, long long n_slots,
                         long long n_entries, long long n_rows, int M, int F_rt, int chunk,
                         int from_start) {
  extern __shared__ int ids[];  // the CTA's slots' rows, -1 where a slot is empty
  const int F = kF > 0 ? kF : F_rt;
  const long long g0 = (long long)blockIdx.x * chunk;  // the CTA's first slot, t * M + m
  const int slots = (int)min((long long)chunk, n_slots - g0);
  const long long t0 = g0 / M;
  const int m0 = (int)(g0 - t0 * M);
  for (int j = threadIdx.x; j < slots; j += kThreads) {
    const unsigned u = (unsigned)m0 + (unsigned)j;  // m0 < M < 2^31, j < chunk <= 4096
    const unsigned dt = u / (unsigned)M;
    const int m = (int)(u - dt * (unsigned)M);
    const long long s = __ldg(starts + t0 + dt), e = __ldg(ends + t0 + dt);
    const long long base = from_start ? s : max(e - (long long)M, s);
    const bool filled = m < e - base;
    // the reference clamps the slot to the last entry (raster.py:490)
    ids[j] = filled ? (int)entry_row(__ldg(pidx_sorted + min(base + m, n_entries - 1)), n_rows)
                    : -1;
    has[g0 + j] = filled;
  }
  __syncthreads();
  const int n = slots * F;  // the CTA's floats: window[g0 * F, g0 * F + n)
  float* __restrict__ dst = window + g0 * F;
  for (int q0 = 0; 4 * q0 < n; q0 += kThreads * kBatch) {
    // a thread's groups lie kStride floats apart: ds slots and dc columns
    const int ds = kStride / F, dc = kStride - ds * F;
    const int f0 = 4 * (q0 + (int)threadIdx.x);
    int s = f0 / F, c = f0 - s * F;
    float v[kBatch][4];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      int sk = s, ck = c;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = f0 + kStride * k + i < n ? ids[sk] : -1;
        v[k][i] = r >= 0 ? __ldg(rows + (long long)r * F + ck) : 0.0f;
        if (++ck == F) {
          ck = 0;
          ++sk;
        }
      }
      s += ds;
      c += dc;
      if (c >= F) {
        c -= F;
        ++s;
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int f = f0 + kStride * k;
      if (f + 4 <= n) {
        *reinterpret_cast<float4*>(dst + f) = make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (f + i < n) dst[f + i] = v[k][i];
      }
    }
  }
}

// the longest run of slots a CTA takes at `batch` groups a thread: a
// multiple of 4 slots, so every CTA's run starts 16-byte aligned
int window_chunk(int F, int batch) {
  const int floats = kStride * batch;
  return F > 0 ? std::max(4, (floats / F) & ~3) : floats;
}

template <typename Idx>
cudaError_t launch_window(const void* rows, const void* pidx, const void* starts, const void* ends,
                          void* window, void* has, int nt, long long n_entries, long long n_rows,
                          int M, int F, int from_start, cudaStream_t s) {
  const long long n_slots = (long long)nt * M;
  // the smallest batch whose grid is resident at once (fewer floats a
  // thread, more CTAs to hide the loads' latency), else the largest (fewer
  // CTAs, each one's staging and barrier spread over more floats); CTAs of
  // the longest runs at that batch (an equal share of one wave each measured
  // slower): experiments/torch_gather_window_variants.py
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long resident = (long long)sms * (2048 / kThreads);
  int batch = 1;
  while (batch < kMaxBatch && (n_slots - 1) / window_chunk(F, batch) + 1 > resident) batch *= 2;
  const int chunk = window_chunk(F, batch);
  const long long blocks = (n_slots + chunk - 1) / chunk;
#define HANABI_WINDOW(KB, KF)                                                                      \
  gather_window_kernel<Idx, KB, KF><<<(unsigned)blocks, kThreads, chunk * sizeof(int), s>>>(       \
      (const float*)rows, (const Idx*)pidx, (const long long*)starts, (const long long*)ends,      \
      (float*)window, (uint8_t*)has, n_slots, n_entries, n_rows, M, F, chunk, from_start)
  // F = 10, the quads' rows, fixed at compile time
  if (batch == 1) {
    if (F == 10) HANABI_WINDOW(1, 10);
    else HANABI_WINDOW(1, 0);
  } else if (batch == 2) {
    if (F == 10) HANABI_WINDOW(2, 10);
    else HANABI_WINDOW(2, 0);
  } else {
    if (F == 10) HANABI_WINDOW(4, 10);
    else HANABI_WINDOW(4, 0);
  }
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
                                    int from_start, int idx64, void* stream) {
  if (nt <= 0 || M <= 0) return (int)cudaGetLastError();
  if (F < 0 || reinterpret_cast<uintptr_t>(window) % 16 != 0 ||
      (n_entries > 0 && (n_rows <= 0 || n_rows > 0x7fffffff)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      idx64 ? launch_window<long long>(rows, pidx_sorted, starts, ends, window, has, nt, n_entries,
                                     n_rows, M, F, from_start, s)
            : launch_window<int>(rows, pidx_sorted, starts, ends, window, has, nt, n_entries,
                                 n_rows, M, F, from_start, s);
  return (int)err;
}
