// gather_window staged for 16-byte stores: kept to be timed beside the
// port's by experiments/torch_gather_window_variants.py.
//
// A CTA stages its slots' row ids in shared memory; its threads load the
// run's floats lane-contiguously (a thread's floats 256 apart: 4, 8 or 16 of
// them, chosen at launch as the smallest whose grid is resident at once, or
// HANABI_WINDOW_BATCH), write them to a piece of shared memory, and the CTA
// stores the piece with 16-byte stores after a barrier.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
// gather_window: the floats a thread loads before its first store (its
// batch), kThreads apart, are 4, 8 or 16, chosen at launch; a CTA's run is
// moved in pieces of kThreads * batch floats. HANABI_WINDOW_BATCH fixes the
// batch (the variants of experiments/torch_gather_window_variants.py).
constexpr int kMaxBatch = 16;

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

template <typename Idx, int kBatch>
__global__ void __launch_bounds__(kThreads)
    gather_window_kernel(const float* __restrict__ rows, const Idx* __restrict__ pidx_sorted,
                         const long long* __restrict__ starts, const long long* __restrict__ ends,
                         float* __restrict__ window, uint8_t* __restrict__ has, long long n_slots,
                         long long n_entries, long long n_rows, int M, int F, int chunk,
                         int from_start) {
  constexpr int kPiece = kThreads * kBatch;
  extern __shared__ float4 piece4[];  // a piece of the run, then the slots' rows (-1: empty)
  float* piece = reinterpret_cast<float*>(piece4);
  int* ids = reinterpret_cast<int*>(piece + kPiece);
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
  for (int p0 = 0; p0 < n; p0 += kPiece) {
    // a thread's floats lie kThreads apart: ds slots and dc columns
    const int ds = kThreads / F, dc = kThreads - ds * F;
    const int f0 = p0 + (int)threadIdx.x;
    int s = f0 / F, c = f0 - s * F;
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int r = f0 + kThreads * k < n ? ids[s] : -1;
      v[k] = r >= 0 ? __ldg(rows + (long long)r * F + c) : 0.0f;
      s += ds;
      c += dc;
      if (c >= F) {
        c -= F;
        ++s;
      }
    }
    if (p0 > 0) __syncthreads();  // the last piece is out of shared memory
#pragma unroll
    for (int k = 0; k < kBatch; ++k) piece[threadIdx.x + kThreads * k] = v[k];
    __syncthreads();
    // out in 16-byte stores: g0 * F and p0 are multiples of 4 floats
    const int len = min(kPiece, n - p0);
    float4* __restrict__ dst4 = reinterpret_cast<float4*>(dst + p0);
    for (int i = threadIdx.x; i < len >> 2; i += kThreads) dst4[i] = piece4[i];
    for (int i = (len & ~3) + threadIdx.x; i < len; i += kThreads) dst[p0 + i] = piece[i];
  }
}

// a CTA's run of slots at `batch` floats a thread: a multiple of 4 slots, so
// every CTA's run starts 16-byte aligned
int window_chunk(int F, int batch) {
  const int floats = kThreads * batch;
  return F > 0 ? std::max(4, (floats / F) & ~3) : floats;
}

template <typename Idx>
cudaError_t launch_window(const void* rows, const void* pidx, const void* starts, const void* ends,
                          void* window, void* has, int nt, long long n_entries, long long n_rows,
                          int M, int F, int from_start, cudaStream_t s) {
  const long long n_slots = (long long)nt * M;
  // the smallest batch whose grid is resident at once (fewer floats a thread,
  // more CTAs to hide the loads' latency), else the largest (fewer CTAs, each
  // one's staging and barriers spread over more floats): measured in
  // experiments/torch_gather_window_variants.py
#ifdef HANABI_WINDOW_BATCH
  const int batch = HANABI_WINDOW_BATCH;
#else
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long resident = (long long)sms * (2048 / kThreads);
  int batch = 4;
  while (batch < kMaxBatch && (n_slots - 1) / window_chunk(F, batch) + 1 > resident) batch *= 2;
#endif
  const int chunk = window_chunk(F, batch);
  const long long blocks = (n_slots + chunk - 1) / chunk;
  const size_t smem = (size_t)(kThreads * batch + chunk) * sizeof(float);
#define HANABI_WINDOW(KB)                                                                          \
  gather_window_kernel<Idx, KB><<<(unsigned)blocks, kThreads, smem, s>>>(                          \
      (const float*)rows, (const Idx*)pidx, (const long long*)starts, (const long long*)ends,      \
      (float*)window, (uint8_t*)has, n_slots, n_entries, n_rows, M, F, chunk, from_start)
#ifdef HANABI_WINDOW_BATCH
  HANABI_WINDOW(HANABI_WINDOW_BATCH);
#else
  if (batch == 4) HANABI_WINDOW(4);
  else if (batch == 8) HANABI_WINDOW(8);
  else HANABI_WINDOW(16);
#endif
#undef HANABI_WINDOW
  return cudaGetLastError();
}

}  // namespace

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
