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
// the Llama training shape (2048, 4096) in bf16. At decode (8 rows) launch
// latency, not bandwidth, is what the kernel meets.
//
// Design. The Llama row is 4,096 wide, so a whole 256-thread block takes
// one row: thread t holds the 16-byte vectors t, t + 256, ... of the row (8
// bf16 or 4 f32 values each; two of them at H = 4096 in bf16) and the
// matching slice of g in registers, all loads issued before the first use.
// Sum of squares: a warp shuffle butterfly, then the eight warps' partials
// through shared memory, added in a fixed order by every thread (one barrier,
// no broadcast step). y is written from the same registers with 16-byte
// stores: x is read from memory exactly once. Rows wider than 8 vectors per
// thread (H > 16,384 in bf16, 8,192 in f32) take a loop that reads the row
// twice. H must be a multiple of 8 and x and g 16-byte aligned (the wrapper
// checks), so a vector never straddles the row's end.
#include "common.cuh"

namespace {

using pgica::load16;
using pgica::load_weight;
using pgica::pack16;
using pgica::unpack16;
using pgica::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The block's sum of v, the same in every thread (kWarps floats of scratch).
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += scratch[w];
  return s;
}

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_fwd_registers(const T* __restrict__ x, const float* __restrict__ g, T* __restrict__ y,
                          float* __restrict__ rstd_out, int hidden, float eps) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  __shared__ float part_s[kWarps];
  const int nvec = hidden / kVec;
  const size_t base = static_cast<size_t>(blockIdx.x) * hidden;
  uint4 raw[NV];
  float w[NV][kVec];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = threadIdx.x + i * kThreads;
    raw[i] = load16(x + base + static_cast<size_t>(v) * kVec, v < nvec);
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = threadIdx.x + i * kThreads;
    load_weight<kVec>(g, v * kVec, v < nvec, w[i]);
  }
  float xv[NV][kVec];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    unpack16(raw[i], xv[i], x);  // vectors past the row load as zeros
#pragma unroll
    for (int e = 0; e < kVec; ++e) ss += xv[i][e] * xv[i][e];
  }
  const float rstd = rsqrtf(block_sum(ss, part_s) / static_cast<float>(hidden) + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = threadIdx.x + i * kThreads;
    if (v >= nvec) break;
    float out[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) out[e] = xv[i][e] * rstd * w[i][e];
    *reinterpret_cast<uint4*>(y + base + static_cast<size_t>(v) * kVec) = pack16(out, y);
  }
  if (threadIdx.x == 0) rstd_out[blockIdx.x] = rstd;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_fwd_loop(const T* __restrict__ x, const float* __restrict__ g, T* __restrict__ y,
                     float* __restrict__ rstd_out, int hidden, float eps) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  __shared__ float part_s[kWarps];
  const int nvec = hidden / kVec;
  const size_t base = static_cast<size_t>(blockIdx.x) * hidden;
  float ss = 0.f;
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    float xv[kVec];
    unpack16(load16(x + base + static_cast<size_t>(v) * kVec, true), xv, x);
#pragma unroll
    for (int e = 0; e < kVec; ++e) ss += xv[e] * xv[e];
  }
  const float rstd = rsqrtf(block_sum(ss, part_s) / static_cast<float>(hidden) + eps);
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    float xv[kVec], w[kVec], out[kVec];
    unpack16(load16(x + base + static_cast<size_t>(v) * kVec, true), xv, x);
    load_weight<kVec>(g, v * kVec, true, w);
#pragma unroll
    for (int e = 0; e < kVec; ++e) out[e] = xv[e] * rstd * w[e];
    *reinterpret_cast<uint4*>(y + base + static_cast<size_t>(v) * kVec) = pack16(out, y);
  }
  if (threadIdx.x == 0) rstd_out[blockIdx.x] = rstd;
}

template <typename T>
int launch(const void* x, const void* g, void* y, void* rstd, int rows, int hidden, float eps,
           cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int per_thread = (hidden / kVec + kThreads - 1) / kThreads;
  const auto* xp = static_cast<const T*>(x);
  const auto* gp = static_cast<const float*>(g);
  auto* yp = static_cast<T*>(y);
  auto* rp = static_cast<float*>(rstd);
#define PGICA_RMS_FWD_CASE(N)                                                                   \
  if (per_thread <= N) {                                                                        \
    rmsnorm_fwd_registers<T, N><<<rows, kThreads, 0, stream>>>(xp, gp, yp, rp, hidden, eps);   \
    return static_cast<int>(cudaGetLastError());                                               \
  }
  PGICA_RMS_FWD_CASE(1)
  PGICA_RMS_FWD_CASE(2)
  PGICA_RMS_FWD_CASE(4)
  PGICA_RMS_FWD_CASE(8)
#undef PGICA_RMS_FWD_CASE
  rmsnorm_fwd_loop<T><<<rows, kThreads, 0, stream>>>(xp, gp, yp, rp, hidden, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (rows, hidden) contiguous in `dtype`, hidden % 8 == 0, 16-byte
// aligned; g: (hidden,) f32, 16-byte aligned; rstd: (rows,) f32.
// Returns a cudaError_t code (0 = launched).
extern "C" int pgica_rmsnorm_fwd(const void* x, const void* g, void* y, void* rstd, int rows,
                                 int hidden, float eps, int dtype, void* stream) {
  if (rows <= 0 || hidden <= 0 || hidden % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == pgica::kFloat32) return launch<float>(x, g, y, rstd, rows, hidden, eps, s);
  if (dtype == pgica::kBFloat16) return launch<__nv_bfloat16>(x, g, y, rstd, rows, hidden, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
