// gather_window with direct stores: the CTA sweep of the port's kernel, each
// thread storing the floats it loaded straight from registers. Kept to be
// timed beside the port's by experiments/torch_gather_window_variants.py,
// which builds it with the flags below.
//
// A CTA stages its slots' row ids in shared memory, then each lane loads
// HANABI_WINDOW_VEC consecutive floats of the run (4: one 16-byte store; 1:
// lane-contiguous 4-byte stores), a thread's groups 256 * VEC floats apart,
// and stores them from registers. The groups a thread loads before its first
// store (its batch) are 1, 2 or 4, chosen at launch (the smallest whose grid
// is resident at once), or HANABI_WINDOW_BATCH. Slot and column come from
// one division by F a thread (a multiply-high by the host's reciprocal),
// then additions (the port divides by the hardware's sequence, which
// measured no slower).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
// gather_window: the consecutive floats a lane loads and stores together (4:
// one 16-byte store; 1: lane-contiguous 4-byte stores). The groups a thread
// loads before its first store (its batch) are 1, 2 or 4, chosen at launch;
// HANABI_WINDOW_BATCH fixes them. Other values build the variants of
// experiments/torch_gather_window_variants.py.
#ifndef HANABI_WINDOW_VEC
#define HANABI_WINDOW_VEC 4
#endif
constexpr int kVec = HANABI_WINDOW_VEC;
constexpr int kStride = kVec * kThreads;  // floats between a thread's groups
constexpr int kMaxBatch = 4;              // a CTA's run is at most kStride * 4 floats

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

// u / d for a 32-bit u, by the host's magic = ceil(2^64 / d) for d >= 2:
// exact, as u * (magic * d - 2^64) < 2^64
__device__ __forceinline__ unsigned div_u32(unsigned u, unsigned d, unsigned long long magic) {
  return d == 1 ? u : (unsigned)__umul64hi(u, magic);
}

template <typename Idx, int kBatch>
__global__ void __launch_bounds__(kThreads)
    gather_window_kernel(const float* __restrict__ rows, const Idx* __restrict__ pidx_sorted,
                         const long long* __restrict__ starts, const long long* __restrict__ ends,
                         float* __restrict__ window, uint8_t* __restrict__ has, long long n_slots,
                         long long n_entries, long long n_rows, int M, int F, int chunk,
                         int from_start, unsigned long long magic_m,
                         unsigned long long magic_f) {
  extern __shared__ int ids[];  // the CTA's slots' rows, -1 where a slot is empty
  const long long g0 = (long long)blockIdx.x * chunk;  // the CTA's first slot, t * M + m
  const int slots = (int)min((long long)chunk, n_slots - g0);
  const long long t0 = g0 / M;
  const int m0 = (int)(g0 - t0 * M);
  for (int j = threadIdx.x; j < slots; j += kThreads) {
    const unsigned u = (unsigned)m0 + (unsigned)j;  // m0 < M < 2^31, j < chunk <= 4096
    const unsigned dt = div_u32(u, M, magic_m);
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
  for (int q0 = 0; kVec * q0 < n; q0 += kThreads * kBatch) {
    // a thread's groups lie kStride floats apart: ds slots and dc columns
    const int ds = kStride / F, dc = kStride - ds * F;
    const int f0 = kVec * (q0 + (int)threadIdx.x);
    int s = (int)div_u32(f0, F, magic_f), c = f0 - s * F;
    float v[kBatch][kVec];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      int sk = s, ck = c;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
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
      if constexpr (kVec == 4) {
        if (f + 4 <= n) {
          *reinterpret_cast<float4*>(dst + f) = make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
          continue;
        }
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        if (f + i < n) dst[f + i] = v[k][i];
    }
  }
}

unsigned long long div_magic(unsigned d) { return d < 2 ? 0 : ~0ull / d + 1; }

// a CTA's run of slots at `batch` groups a thread: a multiple of 4 slots, so
// every CTA's run starts 16-byte aligned
int window_chunk(int F, int batch) {
  const int floats = kStride * batch;
  return F > 0 ? std::max(4, (floats / F) & ~3) : floats;
}

template <typename Idx>
cudaError_t launch_window(const void* rows, const void* pidx, const void* starts, const void* ends,
                          void* window, void* has, int nt, long long n_entries, long long n_rows,
                          int M, int F, int from_start, cudaStream_t s) {
  const long long n_slots = (long long)nt * M;
  // the smallest batch whose grid is resident at once (fewer floats a thread,
  // more CTAs to hide the loads' latency), else the largest (fewer CTAs, each
  // one's staging and barrier spread over more floats): measured in
  // experiments/torch_gather_window_variants.py
#ifdef HANABI_WINDOW_BATCH
  const int batch = HANABI_WINDOW_BATCH;
#else
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long resident = (long long)sms * (2048 / kThreads);
  int batch = 1;
  while (batch < kMaxBatch && (n_slots - 1) / window_chunk(F, batch) + 1 > resident) batch *= 2;
#endif
  const int chunk = window_chunk(F, batch);
  const long long blocks = (n_slots + chunk - 1) / chunk;
#define HANABI_WINDOW(KB)                                                                          \
  gather_window_kernel<Idx, KB><<<(unsigned)blocks, kThreads, chunk * sizeof(int), s>>>(            \
      (const float*)rows, (const Idx*)pidx, (const long long*)starts, (const long long*)ends,      \
      (float*)window, (uint8_t*)has, n_slots, n_entries, n_rows, M, F, chunk, from_start,          \
      div_magic(M), div_magic(F))
#ifdef HANABI_WINDOW_BATCH
  HANABI_WINDOW(HANABI_WINDOW_BATCH);
#else
  if (batch == 1) HANABI_WINDOW(1);
  else if (batch == 2) HANABI_WINDOW(2);
  else HANABI_WINDOW(4);
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
