// RMSNorm backward for Hopper (sm_90a).
//
// Replaces: pgica_tpu/ops/layernorm.py:127 `_rms_bwd_kernel` (Pallas, TPU).
//   With xhat = x * rstd from the forward's f32 rstd:
//     dx = rstd * (dy * g - xhat * mean(dy * g * xhat))   (x's dtype)
//     dg = sum over rows of dy * xhat                     (f32)
//
// What bounds it on the H100: memory. It reads x and dy and writes dx (plus
// rstd, g and dg) for ~8 flops per element, far below the ~295 flops per byte
// where the card stops being memory-bound: 50.4 MB, 15.0 us at 3.35 TB/s at
// the Llama training shape (2048, 4096) in bf16.
//
// Design. The TPU kernel carries dg across its sequential grid in scratch
// memory; Hopper blocks run in no order, so each block writes its own f32
// partial sums (one row of `partials` per 8 rows of x) and a second kernel
// adds the partials column by column in a fixed order. No atomics: dg is the
// same bit for bit from run to run, and a row whose dy is 0 adds exactly 0.
// * Rows of up to 4 16-byte vectors per thread (H <= 8,192 in bf16, 4,096 in
//   f32): a 256-thread block takes 8 rows in turn. Thread t owns the vectors
//   t, t + 256, ... of every row, so its slice of dg is a register
//   accumulator summed over the block's rows in order; x and dy are read
//   once with 16-byte loads, the row mean is a warp shuffle butterfly plus the
//   eight warps' partials through (double-buffered) shared memory, one
//   barrier per row.
// * Wider rows: a first pass computes each of the 8 rows' means, a second
//   walks the row's vectors, each thread summing its columns over the 8 rows
//   in order while it writes dx (x and dy are read twice).
// * The reduction: a block of eight warps per 32 columns; warp w sums the
//   partials w, w + 8, ... of its lane's column and the eight sums meet in
//   shared memory in order.
#include "common.cuh"

namespace {

using pgica::load16;
using pgica::load_weight;
using pgica::pack16;
using pgica::unpack16;
using pgica::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 8;  // rows of x per row of `partials` (ops/rmsnorm.py repeats it)
constexpr int kReduceWarps = 8;

template <int N>
__device__ __forceinline__ void store_f32(float* dst, const float* v) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(dst + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

// The block's sum of v, the same in every thread. Callers alternate between
// two scratch buffers of kWarps floats, so one barrier per call suffices: a
// thread writes a buffer again only after the next call's barrier, which
// every thread reaches after reading it.
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
    rmsnorm_bwd_registers(const T* __restrict__ x, const float* __restrict__ g,
                          const T* __restrict__ dy, const float* __restrict__ rstd,
                          T* __restrict__ dx, float* __restrict__ partials, int rows, int hidden) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  __shared__ float part_s[2][kWarps];
  const int nvec = hidden / kVec;
  const float inv_h = 1.f / static_cast<float>(hidden);
  float w[NV][kVec], acc[NV][kVec];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = threadIdx.x + i * kThreads;
    load_weight<kVec>(g, v * kVec, v < nvec, w[i]);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[i][e] = 0.f;
  }
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r1 = min(r0 + kRowsPerBlock, rows);
#pragma unroll 1
  for (int row = r0; row < r1; ++row) {  // block-uniform
    const size_t base = static_cast<size_t>(row) * hidden;
    uint4 xraw[NV], draw[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = threadIdx.x + i * kThreads;
      xraw[i] = load16(x + base + static_cast<size_t>(v) * kVec, v < nvec);
      draw[i] = load16(dy + base + static_cast<size_t>(v) * kVec, v < nvec);
    }
    const float rs = rstd[row];
    float xh[NV][kVec], gdy[NV][kVec];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float xv[kVec], dv[kVec];
      unpack16(xraw[i], xv, x);  // vectors past the row load as zeros
      unpack16(draw[i], dv, dy);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        xh[i][e] = xv[e] * rs;
        gdy[i][e] = dv[e] * w[i][e];
        s += gdy[i][e] * xh[i][e];
        acc[i][e] += dv[e] * xh[i][e];
      }
    }
    const float m2 = block_sum(s, part_s[(row - r0) & 1]) * inv_h;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = threadIdx.x + i * kThreads;
      if (v >= nvec) break;
      float out[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = rs * (gdy[i][e] - xh[i][e] * m2);
      *reinterpret_cast<uint4*>(dx + base + static_cast<size_t>(v) * kVec) = pack16(out, dx);
    }
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = threadIdx.x + i * kThreads;
    if (v >= nvec) break;
    store_f32<kVec>(partials + static_cast<size_t>(blockIdx.x) * hidden + v * kVec, acc[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_loop(const T* __restrict__ x, const float* __restrict__ g, const T* __restrict__ dy,
                     const float* __restrict__ rstd, T* __restrict__ dx,
                     float* __restrict__ partials, int rows, int hidden) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  __shared__ float part_s[2][kWarps];
  __shared__ float m2_s[kRowsPerBlock];
  const int nvec = hidden / kVec;
  const float inv_h = 1.f / static_cast<float>(hidden);
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r1 = min(r0 + kRowsPerBlock, rows);
  for (int row = r0; row < r1; ++row) {  // the rows' means
    const size_t base = static_cast<size_t>(row) * hidden;
    const float rs = rstd[row];
    float s = 0.f;
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      float xv[kVec], dv[kVec], w[kVec];
      unpack16(load16(x + base + static_cast<size_t>(v) * kVec, true), xv, x);
      unpack16(load16(dy + base + static_cast<size_t>(v) * kVec, true), dv, dy);
      load_weight<kVec>(g, v * kVec, true, w);
#pragma unroll
      for (int e = 0; e < kVec; ++e) s += (dv[e] * w[e]) * (xv[e] * rs);
    }
    const float m2 = block_sum(s, part_s[(row - r0) & 1]) * inv_h;
    if (threadIdx.x == 0) m2_s[row - r0] = m2;
  }
  __syncthreads();  // m2_s
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    float w[kVec], acc[kVec];
    load_weight<kVec>(g, v * kVec, true, w);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
    for (int row = r0; row < r1; ++row) {
      const size_t at = static_cast<size_t>(row) * hidden + static_cast<size_t>(v) * kVec;
      const float rs = rstd[row], m2 = m2_s[row - r0];
      float xv[kVec], dv[kVec], out[kVec];
      unpack16(load16(x + at, true), xv, x);
      unpack16(load16(dy + at, true), dv, dy);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float xh = xv[e] * rs;
        out[e] = rs * (dv[e] * w[e] - xh * m2);
        acc[e] += dv[e] * xh;
      }
      *reinterpret_cast<uint4*>(dx + at) = pack16(out, dx);
    }
    store_f32<kVec>(partials + static_cast<size_t>(blockIdx.x) * hidden + v * kVec, acc);
  }
}

__global__ void __launch_bounds__(32 * kReduceWarps)
    rmsnorm_bwd_reduce(const float* __restrict__ partials, float* __restrict__ dg, int n_parts,
                       int hidden) {
  __shared__ float sum_s[kReduceWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float a = 0.f;
  if (c < hidden)
    for (int p = warp; p < n_parts; p += kReduceWarps) a += partials[static_cast<size_t>(p) * hidden + c];
  sum_s[warp][lane] = a;
  __syncthreads();
  if (warp == 0 && c < hidden) {
#pragma unroll
    for (int w = 1; w < kReduceWarps; ++w) a += sum_s[w][lane];
    dg[c] = a;
  }
}

template <typename T>
int launch(const void* x, const void* g, const void* dy, const void* rstd, void* dx, void* dg,
           void* partials, int rows, int hidden, cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int n_parts = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const int per_thread = (hidden / kVec + kThreads - 1) / kThreads;
  const auto* xp = static_cast<const T*>(x);
  const auto* gp = static_cast<const float*>(g);
  const auto* dyp = static_cast<const T*>(dy);
  const auto* rp = static_cast<const float*>(rstd);
  auto* dxp = static_cast<T*>(dx);
  auto* pp = static_cast<float*>(partials);
  if (per_thread <= 1)
    rmsnorm_bwd_registers<T, 1><<<n_parts, kThreads, 0, stream>>>(xp, gp, dyp, rp, dxp, pp, rows, hidden);
  else if (per_thread <= 2)
    rmsnorm_bwd_registers<T, 2><<<n_parts, kThreads, 0, stream>>>(xp, gp, dyp, rp, dxp, pp, rows, hidden);
  else if (per_thread <= 4)
    rmsnorm_bwd_registers<T, 4><<<n_parts, kThreads, 0, stream>>>(xp, gp, dyp, rp, dxp, pp, rows, hidden);
  else
    rmsnorm_bwd_loop<T><<<n_parts, kThreads, 0, stream>>>(xp, gp, dyp, rp, dxp, pp, rows, hidden);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_bwd_reduce<<<(hidden + 31) / 32, 32 * kReduceWarps, 0, stream>>>(
      pp, static_cast<float*>(dg), n_parts, hidden);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dy, dx: (rows, hidden) contiguous in `dtype`, hidden % 8 == 0, 16-byte
// aligned; g, dg: (hidden,) f32 (g 16-byte aligned); rstd: (rows,) f32 from
// the forward; partials: f32 scratch of ceil(rows / 8) * hidden (8 =
// kRowsPerBlock). Returns a cudaError_t code (0 = launched).
extern "C" int pgica_rmsnorm_bwd(const void* x, const void* g, const void* dy, const void* rstd,
                                 void* dx, void* dg, void* partials, int rows, int hidden,
                                 int dtype, void* stream) {
  if (rows <= 0 || hidden <= 0 || hidden % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == pgica::kFloat32)
    return launch<float>(x, g, dy, rstd, dx, dg, partials, rows, hidden, s);
  if (dtype == pgica::kBFloat16)
    return launch<__nv_bfloat16>(x, g, dy, rstd, dx, dg, partials, rows, hidden, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
