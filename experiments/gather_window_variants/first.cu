// gather_window's earlier kernel, the one the port's replaced, kept to be timed beside the port's
// kernel: chip_smoke.py builds it in phase 2 and reports its device time as
// `first_ms` on every gather_window row; experiments/torch_gather_window_variants.py
// times it beside the port's builds.
//
// One thread a slot: it loads the slot's entry id and its row's F floats
// (unrolled for F = 10 and 13, a runtime loop of 4-byte loads for every
// other width), stages the tile's M * F floats in 48 KB of shared memory,
// and the CTA (M threads, at most 256) writes the tile with 16-byte stores.
// It refuses M * F > 12288. The C entry point takes one argument more than
// the port's (`vec4`: the tile's start is 16-byte aligned).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kStageFloats = 12288;  // 48 KB: the static shared-memory limit

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
