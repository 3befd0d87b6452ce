// RMSNorm forward for Hopper (sm_90a).
//
// Replaces: pgica_tpu/ops/layernorm.py:119 `_rms_fwd_kernel` (Pallas, TPU).
//   rstd = rsqrt(mean(x^2) + eps) over the last axis in f32, y = x * rstd * g
//   written in x's dtype (f32 or bf16), rstd written in f32 for the backward
//   pass, g f32.
//
// What bounds it on the H100: memory. Each element is read once and written
// once for three flops, far below the ~295 flops per byte at which the card
// stops being memory-bound, so the floor is
// (2 * rows * H * sizeof(x) + 4 * H + 4 * rows) bytes / 3.35 TB/s: 10.0 us at
// the Llama training shape (2048, 4096) in bf16. At decode (4-32 rows) one
// launch, one round trip to memory and one barrier are what the kernel meets.
//
// Design: a row's 16-byte slots (8 bf16 or 4 f32 values) spread over a block
// of THREADS threads, NS slots a thread, the matching slice of g in
// registers; the sum of squares is a warp butterfly, then the warps' sums
// through shared memory added by every thread in warp order (one barrier a
// row). y is written from registers with 16-byte stores, so x is read from
// memory once. Three instances of that layout:
// * stream (1,024 rows or more: Llama's 2048-row blocks): persistent blocks,
//   two a SM, each walking the rows b, b + G, ... with g loaded once. Rows
//   arrive through a ring of four whole rows in shared memory that one
//   thread fills with bulk copies (row_stream.cuh), so a block keeps three
//   rows of loads in flight through each row's reduction and stores, and a
//   thread holds only its four slots of the row it works on. x's lines go
//   into L2 marked evict-first and y is stored streaming (st.global.cs): both
//   are touched once here, and at (2048, 4096) the hints took 12.1-12.3 us to
//   11.4-11.8 (bf16) on an H100 SXM.
// * rows (fewer rows: decode's 4-32): one block of 256 threads a row, every
//   load of the row and of g issued before the first sum; the time is one
//   launch, one round trip to memory and one barrier.
// * loop: rows wider than 8 slots a thread (H > 16,384 in bf16, 8,192 in
//   f32), one block a row that reads it twice.
// H must be a multiple of 8 and x, y and g 16-byte aligned (the wrapper
// checks), so a slot never straddles the row's end.
#include <algorithm>
#include <initializer_list>

#include "row_stream.cuh"

namespace {

using pgica::block_sum2;
using pgica::load16;
using pgica::load_weight;
using pgica::pack16;
using pgica::unpack16;

enum Route : int { kRows = 0, kStream = 1, kLoop = 2 };
struct Plan {
  int route;
  int threads;        // a row's threads (every route's block is one row wide)
  int stages;         // stream: rows in the ring (at most kStreamStages)
};

// The stream's layout, from sweeps on an H100 SXM at (2048, 4096) bf16 and f32: four slots a thread, four
// rows in the ring, two blocks a SM. Below kStreamMinRows rows (four a block of that grid) the rows instance
// was as fast or faster (1,024 rows: 7.1 against 8.3 us in bf16).
constexpr int kStreamSlots = 4;
constexpr int kStreamStages = 4;
constexpr int kStreamBlocksPerSm = 2;
constexpr int kRingBytes = 64 * 1024;
constexpr int kStreamMinRows = 1024;
constexpr int kRowsThreads = 256;
constexpr int kLoopThreads = 256;

template <typename T, int THREADS, int NS>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_fwd_rows(const T* __restrict__ x, const float* __restrict__ g, T* __restrict__ y,
                     float* __restrict__ rstd_out, int hidden, float eps) {
  constexpr int kN = 16 / static_cast<int>(sizeof(T));
  __shared__ float red_s[2][THREADS / 32];
  const int slots = hidden / kN;
  const size_t base = static_cast<size_t>(blockIdx.x) * hidden;
  uint4 raw[NS];
  float w[NS][kN];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    raw[i] = load16(x + base + static_cast<size_t>(c) * kN, c < slots);
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    load_weight<kN>(g, c * kN, c < slots, w[i]);
  }
  float v[NS][kN];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    unpack16(raw[i], v[i], x);  // slots past the row load as zeros
#pragma unroll
    for (int e = 0; e < kN; ++e) ss += v[i][e] * v[i][e];
  }
  const float rstd = rsqrtf(block_sum2<THREADS / 32>(ss, red_s, 0) / static_cast<float>(hidden) + eps);
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    if (c >= slots) break;
    float out[kN];
#pragma unroll
    for (int e = 0; e < kN; ++e) out[e] = v[i][e] * rstd * w[i][e];
    *reinterpret_cast<uint4*>(y + base + static_cast<size_t>(c) * kN) = pack16(out, y);
  }
  if (threadIdx.x == 0) rstd_out[blockIdx.x] = rstd;
}

template <typename T, int THREADS, int NS>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_fwd_stream(const T* __restrict__ x, const float* __restrict__ g, T* __restrict__ y,
                       float* __restrict__ rstd_out, int rows, int hidden, float eps, int stages) {
  constexpr int kN = 16 / static_cast<int>(sizeof(T));
  constexpr int kWarps = THREADS / 32;
  extern __shared__ __align__(128) unsigned char ring[];  // stages x one row of x
  __shared__ uint64_t bar[kStreamStages];
  __shared__ float red_s[2][kWarps];
  const int n = pgica::strided_rows(rows);
  const int grid = static_cast<int>(gridDim.x);
  const unsigned row_bytes = static_cast<unsigned>(hidden) * sizeof(T);
  const int slots = hidden / kN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) pgica::mbar_init(&bar[s], 1);
    pgica::mbar_init_fence();
  }
  __syncthreads();
  const uint64_t policy = pgica::evict_first_policy();
  auto fill = [&](int i) {  // the block's row i into stage i % stages
    const int s = i % stages;
    pgica::mbar_expect_bytes(&bar[s], row_bytes);
    pgica::bulk_copy(ring + static_cast<size_t>(s) * row_bytes,
                     x + (static_cast<size_t>(blockIdx.x) + static_cast<size_t>(i) * grid) * hidden, row_bytes,
                     &bar[s], policy);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < min(stages, n); ++i) fill(i);

  float w[NS][kN];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int c = threadIdx.x + j * THREADS;
    load_weight<kN>(g, c * kN, c < slots, w[j]);
  }
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int s = i % stages;
    pgica::mbar_wait(&bar[s], static_cast<unsigned>(i / stages) & 1u);
    const T* src = reinterpret_cast<const T*>(ring + static_cast<size_t>(s) * row_bytes);
    float v[NS][kN];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int c = threadIdx.x + j * THREADS;
      const uint4 raw = c < slots ? *reinterpret_cast<const uint4*>(src + c * kN) : make_uint4(0u, 0u, 0u, 0u);
      unpack16(raw, v[j], x);
#pragma unroll
      for (int e = 0; e < kN; ++e) ss += v[j][e] * v[j][e];
    }
    const float total = block_sum2<kWarps>(ss, red_s, i);  // every thread has read stage s
    if (threadIdx.x == 0 && i + stages < n) fill(i + stages);
    const float rstd = rsqrtf(total / static_cast<float>(hidden) + eps);
    const int row = static_cast<int>(blockIdx.x) + i * grid;
    T* dst = y + static_cast<size_t>(row) * hidden;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int c = threadIdx.x + j * THREADS;
      if (c >= slots) break;
      float out[kN];
#pragma unroll
      for (int e = 0; e < kN; ++e) out[e] = v[j][e] * rstd * w[j][e];
      __stcs(reinterpret_cast<uint4*>(dst + c * kN), pack16(out, y));  // streamed: evict first
    }
    if (threadIdx.x == 0) rstd_out[row] = rstd;
  }
}

template <typename T>
__global__ void __launch_bounds__(kLoopThreads)
    rmsnorm_fwd_loop(const T* __restrict__ x, const float* __restrict__ g, T* __restrict__ y,
                     float* __restrict__ rstd_out, int hidden, float eps) {
  constexpr int kN = 16 / static_cast<int>(sizeof(T));
  __shared__ float red_s[2][kLoopThreads / 32];
  const int slots = hidden / kN;
  const size_t base = static_cast<size_t>(blockIdx.x) * hidden;
  float ss = 0.f;
  for (int c = threadIdx.x; c < slots; c += kLoopThreads) {
    float v[kN];
    unpack16(load16(x + base + static_cast<size_t>(c) * kN, true), v, x);
#pragma unroll
    for (int e = 0; e < kN; ++e) ss += v[e] * v[e];
  }
  const float rstd = rsqrtf(block_sum2<kLoopThreads / 32>(ss, red_s, 0) / static_cast<float>(hidden) + eps);
  for (int c = threadIdx.x; c < slots; c += kLoopThreads) {
    float v[kN], w[kN], out[kN];
    unpack16(load16(x + base + static_cast<size_t>(c) * kN, true), v, x);
    load_weight<kN>(g, c * kN, true, w);
#pragma unroll
    for (int e = 0; e < kN; ++e) out[e] = v[e] * rstd * w[e];
    *reinterpret_cast<uint4*>(y + base + static_cast<size_t>(c) * kN) = pack16(out, y);
  }
  if (threadIdx.x == 0) rstd_out[blockIdx.x] = rstd;
}

// The instance for (rows, H, element size): the stream from kStreamMinRows rows on where a row's slots
// fit four a thread of at most 512 and the ring holds two rows or more; the rows instance (256 threads,
// up to eight slots a thread) otherwise; the loop beyond.
Plan plan_for(int rows, int hidden, int esize) {
  const int row_bytes = hidden * esize;
  const int slots = row_bytes / 16;
  if (slots > kRowsThreads * 8) return {kLoop, kLoopThreads, 0};
  int threads = 128;
  while (threads < 512 && slots > kStreamSlots * threads) threads *= 2;
  const int stages = std::min(kStreamStages, kRingBytes / row_bytes);
  if (rows < kStreamMinRows || slots > kStreamSlots * threads || stages < 2) return {kRows, kRowsThreads, 0};
  return {kStream, threads, stages};
}

// Slots a thread for `slots` over `threads`, rounded up to the instances' 1, 2, 4, 8 (0: none).
int slots_per_thread(int slots, int threads) {
  const int need = (slots + threads - 1) / threads;
  for (int ns : {1, 2, 4, 8})
    if (need <= ns) return ns;
  return 0;
}

template <typename T, int NS>
int launch_rows(const T* x, const float* g, T* y, float* rstd, int rows, int hidden, float eps,
                cudaStream_t stream) {
  rmsnorm_fwd_rows<T, kRowsThreads, NS><<<rows, kRowsThreads, 0, stream>>>(x, g, y, rstd, hidden, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int THREADS, int NS>
int launch_stream(const Plan& p, const T* x, const float* g, T* y, float* rstd, int rows, int hidden, float eps,
                  cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int grid = std::min(rows, kStreamBlocksPerSm * sms);
  const size_t smem = static_cast<size_t>(p.stages) * hidden * sizeof(T);
  // the ring: with the kernel's static shared memory, past the 48 KB a block gets unasked
  const cudaError_t err = cudaFuncSetAttribute(rmsnorm_fwd_stream<T, THREADS, NS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_fwd_stream<T, THREADS, NS><<<grid, THREADS, smem, stream>>>(x, g, y, rstd, rows, hidden, eps, p.stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int THREADS>
int launch_stream_threads(const Plan& p, const T* x, const float* g, T* y, float* rstd, int rows, int hidden,
                          float eps, cudaStream_t stream) {
  constexpr int kN = 16 / static_cast<int>(sizeof(T));
  switch (slots_per_thread(hidden / kN, THREADS)) {
    case 1: return launch_stream<T, THREADS, 1>(p, x, g, y, rstd, rows, hidden, eps, stream);
    case 2: return launch_stream<T, THREADS, 2>(p, x, g, y, rstd, rows, hidden, eps, stream);
    case 4: return launch_stream<T, THREADS, 4>(p, x, g, y, rstd, rows, hidden, eps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int run(const Plan& p, const void* x, const void* g, void* y, void* rstd, int rows, int hidden, float eps,
        cudaStream_t stream) {
  constexpr int kN = 16 / static_cast<int>(sizeof(T));
  const auto* xp = static_cast<const T*>(x);
  const auto* gp = static_cast<const float*>(g);
  auto* yp = static_cast<T*>(y);
  auto* rp = static_cast<float*>(rstd);
  if (p.route == kLoop) {
    rmsnorm_fwd_loop<T><<<rows, kLoopThreads, 0, stream>>>(xp, gp, yp, rp, hidden, eps);
    return static_cast<int>(cudaGetLastError());
  }
  if (p.route == kRows) {
    switch (slots_per_thread(hidden / kN, kRowsThreads)) {
      case 1: return launch_rows<T, 1>(xp, gp, yp, rp, rows, hidden, eps, stream);
      case 2: return launch_rows<T, 2>(xp, gp, yp, rp, rows, hidden, eps, stream);
      case 4: return launch_rows<T, 4>(xp, gp, yp, rp, rows, hidden, eps, stream);
      case 8: return launch_rows<T, 8>(xp, gp, yp, rp, rows, hidden, eps, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (p.threads) {
    case 128: return launch_stream_threads<T, 128>(p, xp, gp, yp, rp, rows, hidden, eps, stream);
    case 256: return launch_stream_threads<T, 256>(p, xp, gp, yp, rp, rows, hidden, eps, stream);
    case 512: return launch_stream_threads<T, 512>(p, xp, gp, yp, rp, rows, hidden, eps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run_dtype(const Plan& p, const void* x, const void* g, void* y, void* rstd, int rows, int hidden, float eps,
              int dtype, cudaStream_t stream) {
  if (dtype == pgica::kFloat32) return run<float>(p, x, g, y, rstd, rows, hidden, eps, stream);
  if (dtype == pgica::kBFloat16) return run<__nv_bfloat16>(p, x, g, y, rstd, rows, hidden, eps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, y: (rows, hidden) contiguous in `dtype`, hidden % 8 == 0, 16-byte
// aligned; g: (hidden,) f32, 16-byte aligned; rstd: (rows,) f32.
// Returns a cudaError_t code (0 = launched).
extern "C" int pgica_rmsnorm_fwd(const void* x, const void* g, void* y, void* rstd, int rows,
                                 int hidden, float eps, int dtype, void* stream) {
  if (rows <= 0 || hidden <= 0 || hidden % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int esize = dtype == pgica::kFloat32 ? 4 : 2;
  return run_dtype(plan_for(rows, hidden, esize), x, g, y, rstd, rows, hidden, eps, dtype,
                   static_cast<cudaStream_t>(stream));
}
