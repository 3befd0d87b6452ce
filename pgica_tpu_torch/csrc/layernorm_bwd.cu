// LayerNorm backward for Hopper (sm_90a).
//
// Replaces: pgica_tpu/ops/layernorm.py:88 `_bwd_kernel` (Pallas, TPU).
//   With xhat = (x - mu) * rstd from the forward's f32 statistics and
//   dxhat = dy * gamma:
//     dx     = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
//     dgamma = sum over rows of dy * xhat,   dbeta = sum over rows of dy
//   dx in x's dtype (f32 or bf16); dgamma and dbeta in f32.
//
// What bounds it on the H100: memory. It reads x and dy and writes dx (plus
// mu, rstd, gamma and the two H-long sums) for ~15 flops per element, far
// below the ~295 flops per byte where the card stops being memory-bound.
// At the text tower's (16384, 1024) bf16 that is ~100 MB, ~30 us at
// 3.35 TB/s.
//
// Design. The TPU kernel carries the dgamma/dbeta sums across its sequential
// grid in scratch memory; Hopper blocks run in no order, so here each block
// writes its own f32 partial sums (one row of `partials` per 16 rows of x)
// and a second kernel adds the partials column by column in a fixed order.
// No atomics: the result is the same from run to run.
// * H <= 1024: one warp per row, four rows per warp, 16 rows per 128-thread
//   block. As in the forward, lane l holds elements l, l+32, ... in
//   registers, x and dy are each read once, and the two row means are warp
//   shuffles. Each warp adds its rows' dy * xhat and dy into its own slice of
//   shared memory (lane l touches only its own columns, so no two threads
//   share a slot); the block then sums its four warps in order.
// * Wider rows: one warp per row computes dx by looping over the row (which
//   L1/L2 serve on the re-reads), and a column kernel, one thread per column
//   and 16 rows per partial, forms the partial sums.
// * The reduction: a block of eight warps per 32 columns; warp w sums the
//   partials w, w+8, ... of its lane's column, and the eight sums meet in
//   shared memory in order.
#include "common.cuh"

namespace {

using pgica::from_float;
using pgica::to_float;
using pgica::warp_sum;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerPartial = kWarps * kRowsPerWarp;  // rows of x per row of `partials`
constexpr int kReduceWarps = 8;

template <typename T, int VPL>
__global__ void __launch_bounds__(kThreads)
    layernorm_bwd_registers(const T* __restrict__ x, const float* __restrict__ gamma,
                            const T* __restrict__ dy, const float* __restrict__ mu,
                            const float* __restrict__ rstd, T* __restrict__ dx,
                            float* __restrict__ part_dg, float* __restrict__ part_db, int rows,
                            int hidden) {
  __shared__ float dg_s[kWarps][VPL * 32];
  __shared__ float db_s[kWarps][VPL * 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < VPL; ++i) dg_s[warp][lane + 32 * i] = db_s[warp][lane + 32 * i] = 0.f;

  const float inv_h = 1.f / static_cast<float>(hidden);
#pragma unroll 1
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = blockIdx.x * kRowsPerPartial + rr * kWarps + warp;
    if (row >= rows) break;  // warp-uniform
    const size_t base = static_cast<size_t>(row) * hidden;
    const float m = mu[row], rs = rstd[row];
    float xh[VPL], gdy[VPL];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      const bool in = c < hidden;
      const float xv = in ? to_float(x[base + c]) : 0.f;
      const float dyv = in ? to_float(dy[base + c]) : 0.f;
      const float g = in ? gamma[c] : 0.f;
      xh[i] = in ? (xv - m) * rs : 0.f;
      dg_s[warp][c] += dyv * xh[i];
      db_s[warp][c] += dyv;
      gdy[i] = dyv * g;
      s1 += gdy[i];
      s2 += gdy[i] * xh[i];
    }
    const float m1 = warp_sum(s1) * inv_h;
    const float m2 = warp_sum(s2) * inv_h;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      if (c < hidden) dx[base + c] = from_float<T>(rs * (gdy[i] - m1 - xh[i] * m2));
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < hidden; c += kThreads) {
    float a = dg_s[0][c], b = db_s[0][c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      a += dg_s[w][c];
      b += db_s[w][c];
    }
    part_dg[static_cast<size_t>(blockIdx.x) * hidden + c] = a;
    part_db[static_cast<size_t>(blockIdx.x) * hidden + c] = b;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    layernorm_bwd_dx_loop(const T* __restrict__ x, const float* __restrict__ gamma,
                          const T* __restrict__ dy, const float* __restrict__ mu,
                          const float* __restrict__ rstd, T* __restrict__ dx, int rows, int hidden) {
  const int lane = threadIdx.x & 31;
  const float inv_h = 1.f / static_cast<float>(hidden);
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = blockIdx.x * kRowsPerPartial + rr * kWarps + (threadIdx.x >> 5);
    if (row >= rows) break;
    const size_t base = static_cast<size_t>(row) * hidden;
    const float m = mu[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < hidden; c += 32) {
      const float gdy = to_float(dy[base + c]) * gamma[c];
      s1 += gdy;
      s2 += gdy * (to_float(x[base + c]) - m) * rs;
    }
    const float m1 = warp_sum(s1) * inv_h;
    const float m2 = warp_sum(s2) * inv_h;
    for (int c = lane; c < hidden; c += 32) {
      const float xh = (to_float(x[base + c]) - m) * rs;
      dx[base + c] = from_float<T>(rs * (to_float(dy[base + c]) * gamma[c] - m1 - xh * m2));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    layernorm_bwd_partials_loop(const T* __restrict__ x, const T* __restrict__ dy,
                                const float* __restrict__ mu, const float* __restrict__ rstd,
                                float* __restrict__ part_dg, float* __restrict__ part_db, int rows,
                                int hidden) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= hidden) return;
  const int r0 = blockIdx.y * kRowsPerPartial;
  const int r1 = min(r0 + kRowsPerPartial, rows);
  float a = 0.f, b = 0.f;
  for (int r = r0; r < r1; ++r) {
    const size_t i = static_cast<size_t>(r) * hidden + c;
    const float dyv = to_float(dy[i]);
    a += dyv * ((to_float(x[i]) - mu[r]) * rstd[r]);
    b += dyv;
  }
  part_dg[static_cast<size_t>(blockIdx.y) * hidden + c] = a;
  part_db[static_cast<size_t>(blockIdx.y) * hidden + c] = b;
}

__global__ void __launch_bounds__(32 * kReduceWarps)
    layernorm_bwd_reduce(const float* __restrict__ part_dg, const float* __restrict__ part_db,
                         float* __restrict__ dgamma, float* __restrict__ dbeta, int n_parts,
                         int hidden) {
  __shared__ float dg_s[kReduceWarps][32];
  __shared__ float db_s[kReduceWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float a = 0.f, b = 0.f;
  if (c < hidden) {
    for (int p = warp; p < n_parts; p += kReduceWarps) {
      a += part_dg[static_cast<size_t>(p) * hidden + c];
      b += part_db[static_cast<size_t>(p) * hidden + c];
    }
  }
  dg_s[warp][lane] = a;
  db_s[warp][lane] = b;
  __syncthreads();
  if (warp == 0 && c < hidden) {
#pragma unroll
    for (int w = 1; w < kReduceWarps; ++w) {
      a += dg_s[w][lane];
      b += db_s[w][lane];
    }
    dgamma[c] = a;
    dbeta[c] = b;
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* dy, const void* mu, const void* rstd,
           void* dx, void* dgamma, void* dbeta, void* partials, int rows, int hidden,
           cudaStream_t stream) {
  const int n_parts = (rows + kRowsPerPartial - 1) / kRowsPerPartial;
  const auto* xp = static_cast<const T*>(x);
  const auto* gp = static_cast<const float*>(gamma);
  const auto* dyp = static_cast<const T*>(dy);
  const auto* mp = static_cast<const float*>(mu);
  const auto* rp = static_cast<const float*>(rstd);
  auto* dxp = static_cast<T*>(dx);
  auto* part_dg = static_cast<float*>(partials);
  auto* part_db = part_dg + static_cast<size_t>(n_parts) * hidden;
  const int vpl = (hidden + 31) / 32;
  bool done = false;
#define PGICA_LN_BWD_CASE(N)                                                                 \
  if (!done && vpl <= N) {                                                                   \
    layernorm_bwd_registers<T, N><<<n_parts, kThreads, 0, stream>>>(xp, gp, dyp, mp, rp, dxp, \
                                                                    part_dg, part_db, rows, \
                                                                    hidden);                \
    done = true;                                                                             \
  }
  PGICA_LN_BWD_CASE(1)
  PGICA_LN_BWD_CASE(2)
  PGICA_LN_BWD_CASE(4)
  PGICA_LN_BWD_CASE(8)
  PGICA_LN_BWD_CASE(16)
  PGICA_LN_BWD_CASE(24)
  PGICA_LN_BWD_CASE(32)
#undef PGICA_LN_BWD_CASE
  if (!done) {
    layernorm_bwd_dx_loop<T><<<n_parts, kThreads, 0, stream>>>(xp, gp, dyp, mp, rp, dxp, rows,
                                                               hidden);
    const dim3 grid((hidden + kThreads - 1) / kThreads, n_parts);
    layernorm_bwd_partials_loop<T><<<grid, kThreads, 0, stream>>>(xp, dyp, mp, rp, part_dg,
                                                                   part_db, rows, hidden);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  layernorm_bwd_reduce<<<(hidden + 31) / 32, 32 * kReduceWarps, 0, stream>>>(
      part_dg, part_db, static_cast<float*>(dgamma), static_cast<float*>(dbeta), n_parts, hidden);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dy, dx: (rows, hidden) contiguous in `dtype`; gamma, dgamma, dbeta:
// (hidden,) f32; mu, rstd: (rows,) f32 from the forward; partials: f32
// scratch of 2 * ceil(rows / 16) * hidden (16 = kRowsPerPartial, which
// ops/layernorm.py repeats). Returns a cudaError_t code (0 = launched).
extern "C" int pgica_layernorm_bwd(const void* x, const void* gamma, const void* dy, const void* mu,
                                   const void* rstd, void* dx, void* dgamma, void* dbeta,
                                   void* partials, int rows, int hidden, int dtype, void* stream) {
  if (rows <= 0 || hidden <= 0 || (rows + kRowsPerPartial - 1) / kRowsPerPartial > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == pgica::kFloat32)
    return launch<float>(x, gamma, dy, mu, rstd, dx, dgamma, dbeta, partials, rows, hidden, s);
  if (dtype == pgica::kBFloat16)
    return launch<__nv_bfloat16>(x, gamma, dy, mu, rstd, dx, dgamma, dbeta, partials, rows, hidden,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}
