// LayerNorm forward for Hopper (sm_90a).
//
// Replaces: pgica_tpu/ops/layernorm.py:75 `_fwd_kernel` (Pallas, TPU).
//   y = (x - mu) * rstd * gamma + beta over the last axis, statistics in f32,
//   y written in x's dtype (f32 or bf16), mu and rstd written in f32 for the
//   backward pass, gamma and beta f32.
//
// What bounds it on the H100: memory. Each element is read once and written
// once for about eight flops, far below the ~295 flops per byte at which the
// card stops being memory-bound, so the floor is
// (2 * rows * H * sizeof(x) + 8 * H + 8 * rows) bytes / 3.35 TB/s.
// At the serving shapes the rows are few (32 per decode step), so launch
// latency, not bandwidth, is what the kernel meets in practice.
//
// Design: one warp per row, four rows per 128-thread block, no shared memory
// and no block-wide synchronisation. For H <= 1024 the row stays in registers:
// lane l holds elements l, l+32, l+64, ... (VPL values), so each warp-wide
// load touches consecutive addresses. The mean and then the variance
// (mean((x-mu)^2), the reference's two-pass order, ops/layernorm.py:63-69) are
// f32 butterfly reductions with warp shuffles, and y is written from the same
// registers: x is read from memory exactly once. gamma and beta are loaded
// into registers beside x, so a row whose inputs come cold from HBM waits on
// one round trip, not two. Wider rows take a loop that
// reads the row three times (mean, variance, output), which L1/L2 serve.
#include "common.cuh"

namespace {

using pgica::from_float;
using pgica::to_float;
using pgica::warp_sum;

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;

template <typename T, int VPL>
__global__ void __launch_bounds__(kThreads)
    layernorm_fwd_registers(const T* __restrict__ x, const float* __restrict__ gamma,
                            const float* __restrict__ beta, T* __restrict__ y,
                            float* __restrict__ mu_out, float* __restrict__ rstd_out, int rows,
                            int hidden, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform: the whole warp leaves together
  const T* xr = x + static_cast<size_t>(row) * hidden;

  float v[VPL], g[VPL], bt[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    const bool in = c < hidden;
    v[i] = in ? to_float(xr[c]) : 0.f;
    g[i] = in ? gamma[c] : 0.f;
    bt[i] = in ? beta[c] : 0.f;
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) sum += v[i];
  const float mean = warp_sum(sum) / static_cast<float>(hidden);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    const float d = c < hidden ? v[i] - mean : 0.f;
    sq += d * d;
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(hidden) + eps);

  T* yr = y + static_cast<size_t>(row) * hidden;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < hidden) yr[c] = from_float<T>((v[i] - mean) * rstd * g[i] + bt[i]);
  }
  if (lane == 0) {
    mu_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    layernorm_fwd_loop(const T* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, T* __restrict__ y,
                       float* __restrict__ mu_out, float* __restrict__ rstd_out, int rows,
                       int hidden, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * hidden;

  float sum = 0.f;
  for (int c = lane; c < hidden; c += 32) sum += to_float(xr[c]);
  const float mean = warp_sum(sum) / static_cast<float>(hidden);
  float sq = 0.f;
  for (int c = lane; c < hidden; c += 32) {
    const float d = to_float(xr[c]) - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(hidden) + eps);

  T* yr = y + static_cast<size_t>(row) * hidden;
  for (int c = lane; c < hidden; c += 32)
    yr[c] = from_float<T>((to_float(xr[c]) - mean) * rstd * gamma[c] + beta[c]);
  if (lane == 0) {
    mu_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T>
void launch(const void* x, const void* gamma, const void* beta, void* y, void* mu, void* rstd,
            int rows, int hidden, float eps, cudaStream_t stream) {
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const auto* xp = static_cast<const T*>(x);
  const auto* gp = static_cast<const float*>(gamma);
  const auto* bp = static_cast<const float*>(beta);
  auto* yp = static_cast<T*>(y);
  auto* mp = static_cast<float*>(mu);
  auto* rp = static_cast<float*>(rstd);
  const int vpl = (hidden + 31) / 32;
#define PGICA_LN_CASE(N)                                                                 \
  if (vpl <= N) {                                                                        \
    layernorm_fwd_registers<T, N><<<grid, kThreads, 0, stream>>>(xp, gp, bp, yp, mp, rp, \
                                                                 rows, hidden, eps);     \
    return;                                                                              \
  }
  PGICA_LN_CASE(1)
  PGICA_LN_CASE(2)
  PGICA_LN_CASE(4)
  PGICA_LN_CASE(8)
  PGICA_LN_CASE(16)
  PGICA_LN_CASE(24)
  PGICA_LN_CASE(32)
#undef PGICA_LN_CASE
  layernorm_fwd_loop<T><<<grid, kThreads, 0, stream>>>(xp, gp, bp, yp, mp, rp, rows, hidden, eps);
}

}  // namespace

// x, y: (rows, hidden) contiguous in `dtype`; gamma, beta: (hidden,) f32;
// mu, rstd: (rows,) f32. Returns a cudaError_t code (0 = launched).
extern "C" int pgica_layernorm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                   void* mu, void* rstd, int rows, int hidden, float eps,
                                   int dtype, void* stream) {
  if (rows <= 0 || hidden <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == pgica::kFloat32) {
    launch<float>(x, gamma, beta, y, mu, rstd, rows, hidden, eps, s);
  } else if (dtype == pgica::kBFloat16) {
    launch<__nv_bfloat16>(x, gamma, beta, y, mu, rstd, rows, hidden, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
