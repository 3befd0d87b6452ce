// Flash-attention backward for Hopper (sm_90a): the dQ and the dK/dV kernels.
//
// Replaces: pgica_tpu/ops/flash_attention.py:130 `_bwd_dq_kernel` and :81
//   `_bwd_dkv_kernel` (Pallas, TPU). Given q, k, v, the per-key bias (B, Sk)
//   f32 shared across heads, the forward's O and row logsumexp, and dO:
//     p  = exp(s - lse), s = (q / sqrt(d)) k^T + bias, masked keys p = 0
//     dv = p^T dO,  dp = dO v^T,  ds = p (dp - delta),  delta = rowsum(dO O)
//     dq = ds k / sqrt(d),  dk = ds^T q / sqrt(d)
//   with the forward's masking (csrc/flash_attn_fwd.cu): a key is masked when
//   its bias is <= NEG_INF or, under `causal`, when it lies above the
//   diagonal (rows >= cols). Every masked key has ds = 0. A row that keeps no
//   key (its lse is about NEG_INF; the forward averaged V over all Sk keys)
//   adds dO / Sk to every key's dV and nothing to dq or dk, which is what the
//   gradient of the plain JAX path (attention.py:_xla_attention) gives.
//   The two kernels stay split, as in the JAX package, so that neither
//   needs atomics. delta, which the JAX wrapper computes apart (:233), is
//   folded into the dQ kernel: it runs first and writes delta (f32) for the
//   dK/dV kernel. dq, dk and dv are written in the input dtype from f32 sums.
//
// What bounds it on the H100: memory at the stage-1 shapes. At
// (B*H, S, D) = (2048, 128, 64) bf16 the dK/dV kernel must read q, k, v and
// dO and write dk and dv, ~200 MB, ~60 us at 3.35 TB/s, against ~9 us of
// tensor-core flops for the causal half. These kernels are simple: scalar
// f32 FMAs on the CUDA cores, no tensor cores (wgmma is later work), so they
// run well above that bound; their times are in PERF.md.
//
// Design. Both kernels stage tiles in shared memory in f32 with 16-byte
// global loads issued together (common.cuh:stage_rows); K and V tile rows
// are padded to D + 4 floats, so that lane j's float4 reads of row j fall in
// distinct bank groups within each quarter warp, while the q and dO rows are
// read by all lanes at once (a broadcast). Scores use the forward's FMA order
// with q pre-scaled, so p is the forward's p.
// * dQ: one 128-thread block per (b*h, 16-row q tile; 8 rows at D = 128);
//   each warp owns four rows (two), interleaved. For one row and a 32-key
//   tile, lane j computes s and dp for key j; dq's columns are then summed
//   over the tile's keys as the forward's PV product is: ds_j is broadcast
//   by shuffle while lane l
//   accumulates columns l, l+32, ... in registers. Tiles wholly above the
//   diagonal, and keys after the batch row's last kept key, are skipped.
// * dK/dV: one 128-thread block per (b*h, 32-key tile); lane j owns key j
//   and keeps its dk and dv rows in registers (2 * D floats); the four warps
//   take interleaved q rows (from the tile's diagonal on under `causal`),
//   staged 16 rows at a time (8 at D = 128). The warps' partial sums then
//   meet in shared memory in a fixed order, so results do not vary from run
//   to run. A tile past the batch row's last kept key reads no k or v: its
//   dk is 0 and its dv only the spread of the rows that keep no key.
#include <math.h>

#include "common.cuh"

namespace {

using pgica::from_float;
using pgica::stage_rows;
using pgica::to_float;
using pgica::warp_sum;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockK = 32;  // one key per lane
// Rows of q staged at a time (dQ: per block; dK/dV: per chunk), kept small
// enough at D = 128 for the 48 KB of static shared memory.
__host__ __device__ constexpr int rows_staged(int d) { return d >= 128 ? 8 : 16; }
constexpr float kNegInf = -1.0e9f;
constexpr float kNoKeyLse = 0.5f * kNegInf;  // a row's lse at or below this: it kept no key

// sum_c a[c] * b[c], sequential in c (the forward's order), float4 reads.
template <int D>
__device__ __forceinline__ float dot_row(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + c);
    const float4 y = *reinterpret_cast<const float4*>(b + c);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

// The batch row's last key with bias > NEG_INF among [0, n), block-wide
// (-1 if none); `scratch` holds kWarps ints. All threads must call it.
__device__ __forceinline__ int last_kept_key(const float* bias_row, int n, int* scratch) {
  int last = -1;
  for (int j = threadIdx.x; j < n; j += kThreads)
    if (bias_row[j] > kNegInf) last = j;
  last = __reduce_max_sync(0xffffffffu, last);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = last;
  __syncthreads();
  last = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) last = max(last, scratch[w]);
  return last;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ bias, const T* __restrict__ o,
                      const float* __restrict__ lse, const T* __restrict__ dout,
                      T* __restrict__ dq, float* __restrict__ delta, int heads, int sq, int sk,
                      int causal, float sm_scale) {
  constexpr int kLd = D + 4;
  constexpr int kColsPerLane = (D + 31) / 32;
  constexpr int kBlockQ = rows_staged(D);
  constexpr int kRowsPerWarp = kBlockQ / kWarps;
  __shared__ __align__(16) float q_s[kBlockQ][D];
  __shared__ __align__(16) float do_s[kBlockQ][D];
  __shared__ __align__(16) float k_s[kBlockK][kLd];
  __shared__ __align__(16) float v_s[kBlockK][kLd];
  __shared__ float b_s[kBlockK];
  __shared__ int last_kept_s[kWarps];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t q_base = static_cast<size_t>(bh) * sq;
  const T* kg = k + static_cast<size_t>(bh) * sk * D;
  const T* vg = v + static_cast<size_t>(bh) * sk * D;
  const float* bias_row = bias == nullptr ? nullptr : bias + static_cast<size_t>(bh / heads) * sk;

  stage_rows<kThreads, kBlockQ, D, D>(q_s, q + q_base * D, q0, sq, sm_scale);
  stage_rows<kThreads, kBlockQ, D, D>(do_s, dout + q_base * D, q0, sq, 1.f);
  const int q_end = min(q0 + kBlockQ, sq);
  int kv_end = causal ? min(sk, q_end) : sk;  // rows >= cols: cols < q_end suffice
  if (bias_row != nullptr) kv_end = min(kv_end, last_kept_key(bias_row, sk, last_kept_s) + 1);
  __syncthreads();  // q_s, do_s

  float row_lse[kRowsPerWarp], row_delta[kRowsPerWarp];
  float acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = rr * kWarps + warp;
    const int row = q0 + r;
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) acc[rr][i] = 0.f;
    row_lse[rr] = kNegInf;
    row_delta[rr] = 0.f;
    if (row >= sq) continue;
    const T* orow = o + (q_base + row) * D;
    float part = 0.f;
    for (int c = lane; c < D; c += 32) part = fmaf(do_s[r][c], to_float(orow[c]), part);
    row_delta[rr] = warp_sum(part);
    row_lse[rr] = lse[q_base + row];
    if (lane == 0) delta[q_base + row] = row_delta[rr];
  }

  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed
    stage_rows<kThreads, kBlockK, D, kLd>(k_s, kg, k0, kv_end, 1.f);
    stage_rows<kThreads, kBlockK, D, kLd>(v_s, vg, k0, kv_end, 1.f);
    if (threadIdx.x < kBlockK)
      b_s[threadIdx.x] = bias_row != nullptr && k0 + threadIdx.x < kv_end ? bias_row[k0 + threadIdx.x] : 0.f;
    __syncthreads();

    const int col = k0 + lane;
    const bool col_kept = col < kv_end && b_s[lane] > kNegInf;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = rr * kWarps + warp;
      const int row = q0 + r;
      if (row >= sq) break;                 // warp-uniform
      if (row_lse[rr] <= kNoKeyLse) continue;  // a row without a kept key: ds = 0
      const float s = dot_row<D>(q_s[r], k_s[lane]);
      const float dp = dot_row<D>(do_s[r], v_s[lane]);
      const bool keep = col_kept && (!causal || row >= col);
      const float p = keep ? expf(s + b_s[lane] - row_lse[rr]) : 0.f;
      const float ds = p * (dp - row_delta[rr]);
#pragma unroll 8
      for (int j = 0; j < kBlockK; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int i = 0; i < kColsPerLane; ++i) {
          const int c = lane + 32 * i;
          if (D % 32 == 0 || c < D) acc[rr][i] = fmaf(dsj, k_s[j][c], acc[rr][i]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + rr * kWarps + warp;
    if (row >= sq) break;
    T* dqrow = dq + (q_base + row) * D;
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < D) dqrow[c] = from_float<T>(acc[rr][i] * sm_scale);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ bias, const float* __restrict__ lse,
                       const float* __restrict__ delta, const T* __restrict__ dout,
                       T* __restrict__ dk, T* __restrict__ dv, int heads, int sq, int sk,
                       int causal, float sm_scale) {
  constexpr int kLd = D + 4;
  constexpr int kChunk = rows_staged(D);
  // k_s and v_s hold the key tile, then the sums of the warps' dk and dv.
  __shared__ __align__(16) float k_s[kBlockK][kLd];
  __shared__ __align__(16) float v_s[kBlockK][kLd];
  __shared__ __align__(16) float q_s[kChunk][D];
  __shared__ __align__(16) float do_s[kChunk][D];
  __shared__ float lse_s[kChunk], delta_s[kChunk], b_s[kBlockK];
  __shared__ float spread_s[D];  // sum of dO / Sk over the rows that keep no key
  __shared__ int flag_s[kWarps], last_kept_s[kWarps];

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t q_base = static_cast<size_t>(bh) * sq;
  const size_t k_base = static_cast<size_t>(bh) * sk;
  const T* qg = q + q_base * D;
  const T* dog = dout + q_base * D;
  const float* lse_row = lse + q_base;
  const float* bias_row = bias == nullptr ? nullptr : bias + static_cast<size_t>(bh / heads) * sk;

  // Does any row keep no key? (block-uniform)
  int no_key = 0;
  for (int i = threadIdx.x; i < sq; i += kThreads) no_key |= lse_row[i] <= kNoKeyLse;
  no_key = __any_sync(0xffffffffu, no_key);
  if (lane == 0) flag_s[warp] = no_key;
  const int last_kept = bias_row == nullptr ? sk - 1 : last_kept_key(bias_row, sk, last_kept_s);
  __syncthreads();  // flag_s (also when last_kept_key did not run)
#pragma unroll
  for (int w = 0; w < kWarps; ++w) no_key |= flag_s[w];
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float sum = 0.f;
    if (no_key)
      for (int i = 0; i < sq; ++i)
        if (lse_row[i] <= kNoKeyLse) sum += to_float(dog[static_cast<size_t>(i) * D + c]);
    spread_s[c] = sum / static_cast<float>(sk);
  }

  float dk_acc[D], dv_acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  if (k0 <= last_kept) {  // block-uniform: the tile holds a key some row may keep
    const int kv_end = min(sk, last_kept + 1);
    stage_rows<kThreads, kBlockK, D, kLd>(k_s, k + k_base * D, k0, kv_end, 1.f);
    stage_rows<kThreads, kBlockK, D, kLd>(v_s, v + k_base * D, k0, kv_end, 1.f);
    if (threadIdx.x < kBlockK)
      b_s[threadIdx.x] = bias_row != nullptr && k0 + threadIdx.x < kv_end ? bias_row[k0 + threadIdx.x] : 0.f;
    const int col = k0 + lane;
    for (int c0 = causal ? k0 : 0; c0 < sq; c0 += kChunk) {
      __syncthreads();  // the previous chunk is consumed
      stage_rows<kThreads, kChunk, D, D>(q_s, qg, c0, sq, sm_scale);
      stage_rows<kThreads, kChunk, D, D>(do_s, dog, c0, sq, 1.f);
      if (threadIdx.x < kChunk) {
        const int row = c0 + threadIdx.x;
        lse_s[threadIdx.x] = row < sq ? lse_row[row] : kNegInf;
        delta_s[threadIdx.x] = row < sq ? delta[q_base + row] : 0.f;
      }
      __syncthreads();  // the chunk (and, the first time, the key tile)
      const bool col_kept = col < kv_end && b_s[lane] > kNegInf;
#pragma unroll
      for (int rr = 0; rr < kChunk / kWarps; ++rr) {
        const int r = rr * kWarps + warp;
        const int row = c0 + r;
        if (row >= sq) break;                // warp-uniform
        if (lse_s[r] <= kNoKeyLse) continue;  // a row without a kept key: the spread
        const float s = dot_row<D>(q_s[r], k_s[lane]);
        const float dp = dot_row<D>(do_s[r], v_s[lane]);
        const bool keep = col_kept && (!causal || row >= col);
        const float p = keep ? expf(s + b_s[lane] - lse_s[r]) : 0.f;
        const float ds = p * (dp - delta_s[r]);
#pragma unroll
        for (int c = 0; c < D; c += 4) {
          const float4 g = *reinterpret_cast<const float4*>(&do_s[r][c]);
          const float4 x = *reinterpret_cast<const float4*>(&q_s[r][c]);  // q / sqrt(d)
          dv_acc[c] = fmaf(p, g.x, dv_acc[c]);
          dv_acc[c + 1] = fmaf(p, g.y, dv_acc[c + 1]);
          dv_acc[c + 2] = fmaf(p, g.z, dv_acc[c + 2]);
          dv_acc[c + 3] = fmaf(p, g.w, dv_acc[c + 3]);
          dk_acc[c] = fmaf(ds, x.x, dk_acc[c]);
          dk_acc[c + 1] = fmaf(ds, x.y, dk_acc[c + 1]);
          dk_acc[c + 2] = fmaf(ds, x.z, dk_acc[c + 2]);
          dk_acc[c + 3] = fmaf(ds, x.w, dk_acc[c + 3]);
        }
      }
    }
  }

  // The warps' partial sums, added in a fixed order through k_s and v_s.
#pragma unroll 1
  for (int w = 0; w < kWarps; ++w) {
    __syncthreads();  // the tiles are free (w = 0) or the previous warp's adds are done
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        float4* kd = reinterpret_cast<float4*>(&k_s[lane][c]);
        float4* vd = reinterpret_cast<float4*>(&v_s[lane][c]);
        const float4 ka = w == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : *kd;
        const float4 va = w == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : *vd;
        *kd = make_float4(ka.x + dk_acc[c], ka.y + dk_acc[c + 1], ka.z + dk_acc[c + 2],
                          ka.w + dk_acc[c + 3]);
        *vd = make_float4(va.x + dv_acc[c], va.y + dv_acc[c + 1], va.z + dv_acc[c + 2],
                          va.w + dv_acc[c + 3]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
    const int j = i / D, c = i % D;
    if (k0 + j >= sk) break;  // i rises with j
    const size_t g = (k_base + k0 + j) * D + c;
    dk[g] = from_float<T>(k_s[j][c]);
    dv[g] = from_float<T>(v_s[j][c] + spread_s[c]);
  }
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* bias, const void* o,
              const void* lse, const void* dout, void* dq, void* delta, int bh, int heads, int sq,
              int sk, int head_dim, int causal, float sm_scale, cudaStream_t stream) {
  switch (head_dim) {
#define PGICA_DQ_CASE(DIM)                                                                      \
  case DIM:                                                                                     \
    flash_attn_bwd_dq<T, DIM><<<dim3(bh, (sq + rows_staged(DIM) - 1) / rows_staged(DIM)),      \
                                kThreads, 0, stream>>>(                                         \
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),           \
        static_cast<const float*>(bias), static_cast<const T*>(o),                              \
        static_cast<const float*>(lse), static_cast<const T*>(dout), static_cast<T*>(dq),       \
        static_cast<float*>(delta), heads, sq, sk, causal, sm_scale);                           \
    break;
    PGICA_DQ_CASE(16)
    PGICA_DQ_CASE(32)
    PGICA_DQ_CASE(64)
    PGICA_DQ_CASE(72)
    PGICA_DQ_CASE(128)
#undef PGICA_DQ_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* bias, const void* lse,
               const void* delta, const void* dout, void* dk, void* dv, int bh, int heads, int sq,
               int sk, int head_dim, int causal, float sm_scale, cudaStream_t stream) {
  const dim3 grid(bh, (sk + kBlockK - 1) / kBlockK);
  switch (head_dim) {
#define PGICA_DKV_CASE(DIM)                                                                     \
  case DIM:                                                                                     \
    flash_attn_bwd_dkv<T, DIM><<<grid, kThreads, 0, stream>>>(                                  \
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),           \
        static_cast<const float*>(bias), static_cast<const float*>(lse),                        \
        static_cast<const float*>(delta), static_cast<const T*>(dout), static_cast<T*>(dk),     \
        static_cast<T*>(dv), heads, sq, sk, causal, sm_scale);                                  \
    break;
    PGICA_DKV_CASE(16)
    PGICA_DKV_CASE(32)
    PGICA_DKV_CASE(64)
    PGICA_DKV_CASE(72)
    PGICA_DKV_CASE(128)
#undef PGICA_DKV_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int bh, int heads, int sq, int sk) {
  return bh <= 0 || heads <= 0 || bh % heads != 0 || sq <= 0 || sk <= 0 ||
         sq > 65535 * rows_staged(128) || sk > 65535 * kBlockK;
}

}  // namespace

// q, o, dout, dq: (bh, sq, head_dim); k, v: (bh, sk, head_dim), contiguous in
// `dtype`; bias: (bh / heads, sk) f32 or NULL; lse, delta: (bh, sq) f32.
// Writes dq and delta = rowsum(dout * o). Returns a cudaError_t code.
extern "C" int pgica_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* bias, const void* o, const void* lse,
                                       const void* dout, void* dq, void* delta, int bh, int heads,
                                       int sq, int sk, int head_dim, int causal, float sm_scale,
                                       int dtype, void* stream) {
  if (bad_shape(bh, heads, sq, sk)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == pgica::kFloat32)
    return launch_dq<float>(q, k, v, bias, o, lse, dout, dq, delta, bh, heads, sq, sk, head_dim,
                            causal, sm_scale, s);
  if (dtype == pgica::kBFloat16)
    return launch_dq<__nv_bfloat16>(q, k, v, bias, o, lse, dout, dq, delta, bh, heads, sq, sk,
                                    head_dim, causal, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As above, with delta from pgica_flash_attn_bwd_dq; writes dk and dv
// (bh, sk, head_dim) in `dtype`. Returns a cudaError_t code.
extern "C" int pgica_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* bias, const void* lse, const void* delta,
                                        const void* dout, void* dk, void* dv, int bh, int heads,
                                        int sq, int sk, int head_dim, int causal, float sm_scale,
                                        int dtype, void* stream) {
  if (bad_shape(bh, heads, sq, sk)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == pgica::kFloat32)
    return launch_dkv<float>(q, k, v, bias, lse, delta, dout, dk, dv, bh, heads, sq, sk, head_dim,
                             causal, sm_scale, s);
  if (dtype == pgica::kBFloat16)
    return launch_dkv<__nv_bfloat16>(q, k, v, bias, lse, delta, dout, dk, dv, bh, heads, sq, sk,
                                     head_dim, causal, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
