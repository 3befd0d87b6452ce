// LayerNorm backward for Hopper (sm_90a).
//
// Replaces: pgica_tpu/ops/layernorm.py:88 `_bwd_kernel` (Pallas, TPU).
//   With xhat = (x - mu) * rstd from the forward's f32 statistics and
//   dxhat = dy * gamma:
//     dx     = rstd * (dxhat - m1 - xhat * m2),  m1 = mean(dxhat), m2 = mean(dxhat * xhat)
//     dgamma = sum over rows of dy * xhat,       dbeta = sum over rows of dy
//   dx in x's dtype (f32 or bf16); dgamma and dbeta in f32.
//
// What bounds it on the H100: memory. It reads x and dy and writes dx (plus
// mu, rstd, gamma and the two H-long sums) for ~15 flops per element, far
// below the ~295 flops per byte where the card stops being memory-bound.
// At the text tower's (16384, 1024) bf16 that is ~100 MB, ~30 us at
// 3.35 TB/s.
//
// Design: one cooperative launch, two phases.
// * Rows. The row layout is the forward's (csrc/layernorm_fwd.cu): 16-byte
//   slots, TPR threads per row with at most four slots each, x and dy of a
//   row in registers, so each is read from memory once. Block b takes the
//   rows [b * rows_per_part, ...) of a partition that ops/layernorm.py
//   computes from (rows, H) alone; a 128-thread block holds four rows of one
//   warp (or two of two) at once, and the next rows' loads are issued
//   before the current rows' sums, so each thread keeps two rows of loads in
//   flight. m1 and m2 are warp butterflies (and, where a row spans warps, the
//   warps' sums through double-buffered shared memory in warp order).
// * dgamma, dbeta. A thread owns the same columns in every row its block
//   takes, so its slice of the two sums is a register accumulator added in
//   row order; the block's row slots then meet in shared memory in slot
//   order, and the block writes one f32 partial row of each sum.
// * The sums. After a grid-wide barrier (cooperative_groups; the launch is
//   checked to be co-resident on any H100, 114 SMs or more, and refused
//   otherwise) each block adds chunks of 32 columns over every partial: warp
//   w sums the partials w, w + warps, ... and the warps meet in shared memory
//   in order. Every order is fixed by (rows, H): no atomics, the same bits on
//   every run and every H100.
// As in the forward, an H that is not a multiple of the slot, or an input
// not 16-byte aligned, takes the element-by-element instance (VEC = false).
#include <cooperative_groups.h>

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
constexpr int kAnyH100Sms = 114;  // the H100 PCIe; the SXM and NVL parts have 132

template <typename T, bool VEC, int TPR>
__global__ void __launch_bounds__(row_block_threads(TPR), 2)
    layernorm_bwd_fused(const T* __restrict__ x, const float* __restrict__ gamma,
                        const T* __restrict__ dy, const float* __restrict__ mu,
                        const float* __restrict__ rstd, T* __restrict__ dx, float* partials,
                        float* __restrict__ dgamma, float* __restrict__ dbeta, int rows, int hidden,
                        int rows_per_part) {
  constexpr int kN = 16 / static_cast<int>(sizeof(T));
  constexpr int kBlock = row_block_threads(TPR);
  constexpr int kRowSlots = kBlock / TPR;  // rows the block holds at once
  constexpr int kWarps = kBlock / 32;
  constexpr int kWarpsPerRow = TPR / 32;
  constexpr int kCols = TPR * kSlotsPerThread * kN;  // the widest row this instance takes
  __shared__ float red_s[2][2][kWarps];               // [iteration parity][m1, m2][warp]
  __shared__ float comb_s[kRowSlots > 1 ? (kRowSlots - 1) * 2 * kCols : 1];
  __shared__ float sum_s[kWarps][32];

  const int t = threadIdx.x % TPR;
  const int rslot = threadIdx.x / TPR;
  const int r0 = blockIdx.x * rows_per_part;
  const int r1 = min(r0 + rows_per_part, rows);
  const int iters = (r1 - r0 + kRowSlots - 1) / kRowSlots;  // block-uniform
  const float inv_h = 1.f / static_cast<float>(hidden);

  float g[kSlotsPerThread][kN], adg[kSlotsPerThread][kN], adb[kSlotsPerThread][kN];
#pragma unroll
  for (int i = 0; i < kSlotsPerThread; ++i) {
    load_weight_slot<VEC, kN>(gamma, (t + i * TPR) * kN, hidden, g[i]);
#pragma unroll
    for (int e = 0; e < kN; ++e) adg[i][e] = adb[i][e] = 0.f;
  }

  // rows at or past r1 load as zeros and write nothing
  uint4 xn[kSlotsPerThread], dn[kSlotsPerThread];
  float mn = 0.f, rn = 0.f;
  auto load_row = [&](int row) {
    const bool live = row < r1;
    const size_t base = static_cast<size_t>(live ? row : 0) * hidden;
#pragma unroll
    for (int i = 0; i < kSlotsPerThread; ++i) {
      xn[i] = load_slot<VEC>(x + base, (t + i * TPR) * kN, live ? hidden : 0);
      dn[i] = load_slot<VEC>(dy + base, (t + i * TPR) * kN, live ? hidden : 0);
    }
    mn = live ? mu[row] : 0.f;
    rn = live ? rstd[row] : 0.f;
  };
  load_row(r0 + rslot);

#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const int row = r0 + it * kRowSlots + rslot;
    const bool live = row < r1;
    uint4 xc[kSlotsPerThread], dc[kSlotsPerThread];
#pragma unroll
    for (int i = 0; i < kSlotsPerThread; ++i) {
      xc[i] = xn[i];
      dc[i] = dn[i];
    }
    const float m = mn, rs = rn;
    if (it + 1 < iters) load_row(row + kRowSlots);

    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kSlotsPerThread; ++i) {
      float xv[kN], dv[kN];
      unpack16(xc[i], xv, x);
      unpack16(dc[i], dv, dy);
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float xh = (xv[e] - m) * rs;
        const float gd = dv[e] * g[i][e];  // 0 past the row: dy and gamma load as 0
        s1 += gd;
        s2 += gd * xh;
        if (live) {
          adg[i][e] += dv[e] * xh;
          adb[i][e] += dv[e];
        }
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if constexpr (kWarpsPerRow > 1) {
      // one barrier an iteration: a buffer is written again two iterations on, after every
      // thread has passed the barrier between
      float(*buf)[kWarps] = red_s[it & 1];
      if ((threadIdx.x & 31) == 0) {
        buf[0][threadIdx.x >> 5] = s1;
        buf[1][threadIdx.x >> 5] = s2;
      }
      __syncthreads();
      const int w0 = rslot * kWarpsPerRow;
      s1 = s2 = 0.f;
#pragma unroll
      for (int w = 0; w < kWarpsPerRow; ++w) {
        s1 += buf[0][w0 + w];
        s2 += buf[1][w0 + w];
      }
    }
    if (!live) continue;
    const float m1 = s1 * inv_h, m2 = s2 * inv_h;
    T* dxr = dx + static_cast<size_t>(row) * hidden;
#pragma unroll
    for (int i = 0; i < kSlotsPerThread; ++i) {
      float xv[kN], dv[kN], out[kN];
      unpack16(xc[i], xv, x);
      unpack16(dc[i], dv, dy);
#pragma unroll
      for (int e = 0; e < kN; ++e) out[e] = rs * (dv[e] * g[i][e] - m1 - (xv[e] - m) * rs * m2);
      store_slot<VEC>(dxr, (t + i * TPR) * kN, hidden, out);
    }
  }

  // the block's partial sums: its row slots in order, then one f32 row of each into `partials`
  if constexpr (kRowSlots > 1) {
    if (rslot > 0) {
      float* dst = comb_s + (rslot - 1) * 2 * kCols;
#pragma unroll
      for (int i = 0; i < kSlotsPerThread; ++i)
#pragma unroll
        for (int e = 0; e < kN; ++e) {
          dst[(t + i * TPR) * kN + e] = adg[i][e];
          dst[kCols + (t + i * TPR) * kN + e] = adb[i][e];
        }
    }
    __syncthreads();
    if (rslot == 0) {
#pragma unroll 1
      for (int s = 0; s < kRowSlots - 1; ++s) {
        const float* src = comb_s + s * 2 * kCols;
#pragma unroll
        for (int i = 0; i < kSlotsPerThread; ++i)
#pragma unroll
          for (int e = 0; e < kN; ++e) {
            adg[i][e] += src[(t + i * TPR) * kN + e];
            adb[i][e] += src[kCols + (t + i * TPR) * kN + e];
          }
      }
    }
  }
  const int n_parts = gridDim.x;
  if (rslot == 0) {
    float* pg = partials + static_cast<size_t>(blockIdx.x) * hidden;
    float* pb = pg + static_cast<size_t>(n_parts) * hidden;
#pragma unroll
    for (int i = 0; i < kSlotsPerThread; ++i)
#pragma unroll
      for (int e = 0; e < kN; e += 4) {  // f32 slots of 4
        store_slot<VEC>(pg, (t + i * TPR) * kN + e, hidden, adg[i] + e);
        store_slot<VEC>(pb, (t + i * TPR) * kN + e, hidden, adb[i] + e);
      }
  }

  cooperative_groups::this_grid().sync();  // every partial written and visible

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = (hidden + 31) / 32;
  for (int u = blockIdx.x; u < 2 * chunks; u += n_parts) {  // block-uniform
    const bool beta_part = u >= chunks;
    const float* src = partials + (beta_part ? static_cast<size_t>(n_parts) * hidden : 0);
    const int c = (u - (beta_part ? chunks : 0)) * 32 + lane;
    float a = 0.f;
    if (c < hidden) {
#pragma unroll 8
      for (int p = warp; p < n_parts; p += kWarps) a += __ldcg(src + static_cast<size_t>(p) * hidden + c);
    }
    sum_s[warp][lane] = a;
    __syncthreads();
    if (warp == 0 && c < hidden) {
#pragma unroll
      for (int w = 1; w < kWarps; ++w) a += sum_s[w][lane];
      (beta_part ? dbeta : dgamma)[c] = a;
    }
    __syncthreads();
  }
}

template <typename T, bool VEC, int TPR>
int launch_cooperative(const void* x, const void* gamma, const void* dy, const void* mu,
                       const void* rstd, void* dx, void* partials, void* dgamma, void* dbeta,
                       int rows, int hidden, int rows_per_part, cudaStream_t stream) {
  const auto kernel = layernorm_bwd_fused<T, VEC, TPR>;
  static const int per_sm = [] {
    int n = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, layernorm_bwd_fused<T, VEC, TPR>,
                                                         row_block_threads(TPR), 0) == cudaSuccess
               ? n
               : 0;
  }();
  const int n_parts = (rows + rows_per_part - 1) / rows_per_part;
  if (per_sm * kAnyH100Sms < n_parts) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const auto* xp = static_cast<const T*>(x);
  const auto* gp = static_cast<const float*>(gamma);
  const auto* dyp = static_cast<const T*>(dy);
  const auto* mp = static_cast<const float*>(mu);
  const auto* rp = static_cast<const float*>(rstd);
  auto* dxp = static_cast<T*>(dx);
  auto* pp = static_cast<float*>(partials);
  auto* dgp = static_cast<float*>(dgamma);
  auto* dbp = static_cast<float*>(dbeta);
  void* args[] = {&xp, &gp, &dyp, &mp, &rp, &dxp, &pp, &dgp, &dbp, &rows, &hidden, &rows_per_part};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), n_parts,
                                                      row_block_threads(TPR), args, 0, stream));
}

template <typename T, bool VEC>
int launch(const void* x, const void* gamma, const void* dy, const void* mu, const void* rstd,
           void* dx, void* partials, void* dgamma, void* dbeta, int rows, int hidden,
           int rows_per_part, cudaStream_t stream) {
  constexpr int kN = 16 / static_cast<int>(sizeof(T));
  const int slots = (hidden + kN - 1) / kN;
#define PGICA_LN_BWD_CASE(TPR)                                                                       \
  if (slots <= (TPR) * kSlotsPerThread)                                                              \
    return launch_cooperative<T, VEC, TPR>(x, gamma, dy, mu, rstd, dx, partials, dgamma, dbeta, rows, \
                                           hidden, rows_per_part, stream);
  PGICA_LN_BWD_CASE(32)
  PGICA_LN_BWD_CASE(64)
  PGICA_LN_BWD_CASE(128)
  PGICA_LN_BWD_CASE(256)
#undef PGICA_LN_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, dy, dx: (rows, hidden) contiguous in `dtype`; gamma, dgamma, dbeta:
// (hidden,) f32; mu, rstd: (rows,) f32 from the forward; partials: f32
// scratch of 2 * n_parts * hidden, n_parts = ceil(rows / rows_per_part)
// (ops/layernorm.py:bwd_partition). hidden at most 1,024 16-byte slots.
// Returns a cudaError_t code (0 = launched).
extern "C" int pgica_layernorm_bwd(const void* x, const void* gamma, const void* dy, const void* mu,
                                   const void* rstd, void* dx, void* dgamma, void* dbeta,
                                   void* partials, int rows, int hidden, int rows_per_part,
                                   int dtype, void* stream) {
  if (rows <= 0 || hidden <= 0 || rows_per_part <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(x) && aligned16(dy) && aligned16(dx) && aligned16(gamma) &&
                   aligned16(partials);
  if (dtype == pgica::kFloat32)
    return vec && hidden % 4 == 0
               ? launch<float, true>(x, gamma, dy, mu, rstd, dx, partials, dgamma, dbeta, rows,
                                     hidden, rows_per_part, s)
               : launch<float, false>(x, gamma, dy, mu, rstd, dx, partials, dgamma, dbeta, rows,
                                      hidden, rows_per_part, s);
  if (dtype == pgica::kBFloat16)
    return vec && hidden % 8 == 0
               ? launch<__nv_bfloat16, true>(x, gamma, dy, mu, rstd, dx, partials, dgamma, dbeta,
                                             rows, hidden, rows_per_part, s)
               : launch<__nv_bfloat16, false>(x, gamma, dy, mu, rstd, dx, partials, dgamma, dbeta,
                                              rows, hidden, rows_per_part, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
