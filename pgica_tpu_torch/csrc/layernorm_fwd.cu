// LayerNorm forward for Hopper (sm_90a).
//
// Replaces: pgica_tpu/ops/layernorm.py:75 `_fwd_kernel` (Pallas, TPU).
//   y = (x - mu) * rstd * gamma + beta over the last axis, statistics in f32
//   (the two-pass variance mean((x - mu)^2), layernorm.py:63-69), y written in
//   x's dtype (f32 or bf16), mu and rstd written in f32 for the backward
//   pass, gamma and beta f32.
//
// What bounds it on the H100: memory. Each element is read once and written
// once for about eight flops, far below the ~295 flops per byte at which the
// card stops being memory-bound, so the floor is
// (2 * rows * H * sizeof(x) + 8 * H + 8 * rows) bytes / 3.35 TB/s.
// At the serving shapes the rows are few (32 per decode step), so launch
// latency and one round trip to memory, not bandwidth, are what it meets.
//
// Design. A row is cut into 16-byte slots (8 bf16 or 4 f32 values) and
// taken by TPR threads, TPR = 32, 64, ..., 256 the fewest that leave each
// thread at most four slots: thread t holds the slots t, t + TPR, ... and
// the matching gamma and beta (float4 loads) in registers, every load of
// the row issued before the first sum, so a row waits on one round trip and
// x is read from memory exactly once. The blocks are of 128 threads (four
// rows of one warp, or two of two) or of TPR threads (one row). Mean, then
// the variance from the same registers: warp shuffle butterflies, and where
// a row spans warps, the warps' sums through shared memory, added by every
// thread in warp order (the same bits every run). y is written from the
// registers with 16-byte stores. A row whose width is not a multiple of the
// slot, or an input not 16-byte aligned, takes the instance with VEC =
// false: the same kernel with the slots moved element by element. Rows of
// more than 1,024 slots (H > 8,192 in bf16, 4,096 in f32) are refused.
#include "common.cuh"

namespace {

using pgica::aligned16;
using pgica::load_slot;
using pgica::load_weight_slot;
using pgica::row_block_threads;
using pgica::store_slot;
using pgica::unpack16;
using pgica::warp_sum;

constexpr int kSlotsPerThread = pgica::kRowSlotsPerThread;

template <typename T, bool VEC, int TPR>
__global__ void __launch_bounds__(row_block_threads(TPR))
    layernorm_fwd_rows(const T* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, T* __restrict__ y, float* __restrict__ mu_out,
                       float* __restrict__ rstd_out, int rows, int hidden, float eps) {
  constexpr int kN = 16 / static_cast<int>(sizeof(T));
  constexpr int kRowsPerBlock = row_block_threads(TPR) / TPR;
  constexpr int kWarpsPerRow = TPR / 32;
  __shared__ float red_s[2][row_block_threads(TPR) / 32];
  const int t = threadIdx.x % TPR;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / TPR;
  const bool live = row < rows;  // no early return: rows spanning warps meet at barriers
  const T* xr = x + static_cast<size_t>(live ? row : 0) * hidden;

  uint4 raw[kSlotsPerThread];
#pragma unroll
  for (int i = 0; i < kSlotsPerThread; ++i)
    raw[i] = load_slot<VEC>(xr, (t + i * TPR) * kN, live ? hidden : 0);
  float g[kSlotsPerThread][kN], b[kSlotsPerThread][kN];
#pragma unroll
  for (int i = 0; i < kSlotsPerThread; ++i) {
    load_weight_slot<VEC, kN>(gamma, (t + i * TPR) * kN, hidden, g[i]);
    load_weight_slot<VEC, kN>(beta, (t + i * TPR) * kN, hidden, b[i]);
  }
  float v[kSlotsPerThread][kN];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kSlotsPerThread; ++i) {
    unpack16(raw[i], v[i], x);  // columns past the row load as zeros
#pragma unroll
    for (int e = 0; e < kN; ++e) sum += v[i][e];
  }
  // the row's sum, the same in each of its threads
  auto row_sum = [&](float s, float* scratch) {
    s = warp_sum(s);
    if constexpr (kWarpsPerRow == 1) return s;
    if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = s;
    __syncthreads();
    const int w0 = (threadIdx.x / TPR) * kWarpsPerRow;
    s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsPerRow; ++w) s += scratch[w0 + w];
    return s;
  };
  const float inv_h = 1.f / static_cast<float>(hidden);
  const float mean = row_sum(sum, red_s[0]) * inv_h;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kSlotsPerThread; ++i) {
    const int c = (t + i * TPR) * kN;
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const float d = c + e < hidden ? v[i][e] - mean : 0.f;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(row_sum(sq, red_s[1]) * inv_h + eps);
  if (!live) return;

  T* yr = y + static_cast<size_t>(row) * hidden;
#pragma unroll
  for (int i = 0; i < kSlotsPerThread; ++i) {
    float out[kN];
#pragma unroll
    for (int e = 0; e < kN; ++e) out[e] = (v[i][e] - mean) * rstd * g[i][e] + b[i][e];
    store_slot<VEC>(yr, (t + i * TPR) * kN, hidden, out);
  }
  if (t == 0) {
    mu_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T, bool VEC>
int launch(const void* x, const void* gamma, const void* beta, void* y, void* mu, void* rstd, int rows,
           int hidden, float eps, cudaStream_t stream) {
  constexpr int kN = 16 / static_cast<int>(sizeof(T));
  const int slots = (hidden + kN - 1) / kN;
  const auto* xp = static_cast<const T*>(x);
  const auto* gp = static_cast<const float*>(gamma);
  const auto* bp = static_cast<const float*>(beta);
  auto* yp = static_cast<T*>(y);
  auto* mp = static_cast<float*>(mu);
  auto* rp = static_cast<float*>(rstd);
#define PGICA_LN_FWD_CASE(TPR)                                                                \
  if (slots <= (TPR) * kSlotsPerThread) {                                                     \
    constexpr int kRowsPerBlock = row_block_threads(TPR) / (TPR);                                 \
    layernorm_fwd_rows<T, VEC, TPR>                                                           \
        <<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, row_block_threads(TPR), 0, stream>>>(     \
            xp, gp, bp, yp, mp, rp, rows, hidden, eps);                                       \
    return static_cast<int>(cudaGetLastError());                                              \
  }
  PGICA_LN_FWD_CASE(32)
  PGICA_LN_FWD_CASE(64)
  PGICA_LN_FWD_CASE(128)
  PGICA_LN_FWD_CASE(256)
#undef PGICA_LN_FWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, y: (rows, hidden) contiguous in `dtype`; gamma, beta: (hidden,) f32;
// mu, rstd: (rows,) f32. hidden at most 1,024 16-byte slots (8,192 bf16,
// 4,096 f32). Returns a cudaError_t code (0 = launched).
extern "C" int pgica_layernorm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                   void* mu, void* rstd, int rows, int hidden, float eps,
                                   int dtype, void* stream) {
  if (rows <= 0 || hidden <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(x) && aligned16(y) && aligned16(gamma) && aligned16(beta);
  if (dtype == pgica::kFloat32)
    return vec && hidden % 4 == 0
               ? launch<float, true>(x, gamma, beta, y, mu, rstd, rows, hidden, eps, s)
               : launch<float, false>(x, gamma, beta, y, mu, rstd, rows, hidden, eps, s);
  if (dtype == pgica::kBFloat16)
    return vec && hidden % 8 == 0
               ? launch<__nv_bfloat16, true>(x, gamma, beta, y, mu, rstd, rows, hidden, eps, s)
               : launch<__nv_bfloat16, false>(x, gamma, beta, y, mu, rstd, rows, hidden, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
