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
// What bounds it on the H100. dK/dV does 4 products of (keys x rows x D):
// 8 D flops per kept (row, key) pair, 17.2 GFLOP at the Llama shape
// (B*H, S, D) = (128, 512, 128) causal, 17 us at the bf16 tensor-core peak,
// against ~100 MB of bytes (30 us at 3.35 TB/s); dQ does 3 (S, dP and dS K),
// 6 D flops a pair, against about the same bytes: both bounds are tens of
// microseconds, so the products must run on the tensor cores.
//
// dK/dV, bf16 (flash_attn_bwd_dkv_tc), FlashAttention-2's backward on
// mma.sync m16n8k16 (mma.cuh). A 128-thread block owns 64 keys of one
// (batch*head); K and V of the tile sit in shared memory as bf16. It walks
// the q rows in tiles of 64 (from the tile's diagonal on under `causal`),
// Q, dO and the rows' lse and delta double-buffered: the next tile's
// cp.async copies fly while this one is multiplied. Rows are padded in
// shared memory to D + 8 bf16 (16 bytes apart mod 128: ldmatrix reads no
// bank twice); D = 72 is zero-filled to 80 columns, the mma depth being 16.
// Each warp owns 16 keys and, per 16 rows of the tile:
//   S^T = K Q^T and dP^T = V dO^T  (2 x D/16 mma pairs; scale on the f32 sum)
//   P^T = exp(S^T + bias - lse), 0 where the key or the causal entry is
//         masked or the row keeps no key; dS^T = P^T (dP^T - delta)
//   dV += P^T dO and dK += dS^T Q, with P^T and dS^T repacked from the
//         accumulator fragments to bf16 A fragments in registers (no trip
//         through shared memory; two parts each, below) and dO, Q read by
//         ldmatrix.trans.
// The accumulators are 16 keys x D f32 per warp: D / 2 registers a thread
// for each of dK and dV (64 at D = 128), so nothing spills. Chunks of 16
// rows wholly above the diagonal are skipped. Every key has one owner
// thread: no atomics, so dK/dV is the same from run to run.
// Precision: P and dS go into their products as two bf16 parts each, x0 =
// bf16(x) and x1 = bf16(x - x0) (x0 + x1 is x to ~2^-17), the passes x0 B
// + x1 B: six products per 16 rows where the usual tensor-core backward
// takes four. Rounding them once to bf16 holds phase 3's bf16 bound at the
// Llama shape but not at GPT-2 stage 1's (2048, 128, 128, 64) causal with
// ragged keys: there a dV element sums ~128 terms p dO that cancel, and
// over its 16.7 M elements the rounding's tail passes the bound, on the
// card and in the CPU emulation of tests/test_torch_backward.py, which
// holds the two-part scheme to the bound there and at D = 72 and 128.
// The f32 instance (flash_attn_bwd_dkv_simt) keeps the first design, which
// f32 inputs need to hold 2e-5: scalar f32 FMAs, one key per lane with its
// 2 x D accumulators in registers (they spill at D = 128; f32 runs only in
// tests and phase 4's f32 parity runs, never on a bf16 training path). The
// C entry point dispatches by dtype. Both share the prologue (dkv_prologue)
// and the semantics below.
//
// dQ, bf16 (flash_attn_bwd_dq_tc), the same machinery with the roles
// turned: a 128-thread block owns 64 q rows of one (batch*head), one warp per
// 16 rows, with Q and dO held as A fragments in registers for the whole
// walk, O passing through shared memory once for delta. It walks the key
// tiles of 64 up to the block's last causal column and the batch row's
// last kept key, K, V and the tile's bias double-buffered by cp.async (rows
// padded to D + 8 bf16, D = 72 zero-filled to 80). Per 16 keys, each warp:
//   S = Q K^T and dP = dO V^T (K and V through ldmatrix; scale on the f32 sum)
//   P = exp(S + bias - lse), 0 where the key or the causal entry is masked or
//       the row keeps no key, so such a row's dq is exactly 0; dS = P (dP -
//       delta), in place of S
//   dQ += dS K, dS repacked from the accumulator fragments to a bf16 A
//       fragment in registers and K read by ldmatrix.trans.
// The accumulator is 16 rows x D f32 per warp (D / 2 registers a thread).
// 16-key chunks wholly above a warp's rows are skipped. Each row has one
// owner: no atomics, the same dq from run to run. dS is rounded once to bf16
// in its product, unlike dK/dV's P and dS: tests/test_torch_backward.py
// emulates both and one rounding holds phase 3's bf16 bound at the Llama,
// SigLIP and GPT-2 stage-1 shapes (a dq element's error is dominated by its
// own rounding to bf16), so dQ takes 3 products where two parts would take 4.
// The f32 instance (flash_attn_bwd_dq) keeps the first design: scalar f32
// FMAs, one 128-thread block per (b*h, 16-row q tile; 8 rows at D = 128),
// each warp four rows (two), interleaved; for one row and a 32-key tile lane
// j computes s and dp for key j, and dq's columns are summed over the tile's
// keys with ds_j broadcast by shuffle. Tiles are staged in f32 with 16-byte
// global loads (common.cuh:stage_rows), K and V rows padded to D + 4 floats,
// q pre-scaled. It runs only in tests and phase 4's f32 parity runs. Both
// skip the tiles wholly above the diagonal and the keys after the batch
// row's last kept key.
//
// Both dK/dV instances: a tile past the batch row's last kept key reads no
// k or v: its dk is 0 and its dv only the spread of the rows that keep no
// key.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
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

// The dK/dV prologue, block-wide (all threads call it; it ends with a
// barrier): returns the batch row's last kept key (sk - 1 without a bias)
// and writes spread[c] = sum of dO[i][c] / Sk over the rows i that keep no
// key. `scratch` holds 2 * kWarps ints.
template <typename T, int D>
__device__ int dkv_prologue(const float* lse_row, const T* dog, const float* bias_row, int sq, int sk,
                            float* spread, int* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int no_key = 0;  // does any row keep no key? (block-uniform)
  for (int i = threadIdx.x; i < sq; i += kThreads) no_key |= lse_row[i] <= kNoKeyLse;
  no_key = __any_sync(0xffffffffu, no_key);
  if (lane == 0) scratch[warp] = no_key;
  const int last_kept = bias_row == nullptr ? sk - 1 : last_kept_key(bias_row, sk, scratch + kWarps);
  __syncthreads();  // scratch (also when last_kept_key did not run)
#pragma unroll
  for (int w = 0; w < kWarps; ++w) no_key |= scratch[w];
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float sum = 0.f;
    if (no_key)
      for (int i = 0; i < sq; ++i)
        if (lse_row[i] <= kNoKeyLse) sum += to_float(dog[static_cast<size_t>(i) * D + c]);
    spread[c] = sum / static_cast<float>(sk);
  }
  __syncthreads();  // spread
  return last_kept;
}

// f32 dK/dV: the first design, kept for f32 inputs (see the note above).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dkv_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
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
  __shared__ int scratch_s[2 * kWarps];

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
  const int last_kept = dkv_prologue<T, D>(lse_row, dog, bias_row, sq, sk, spread_s, scratch_s);

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


// bf16 dK/dV on the tensor cores (see the note above). Dynamic shared
// memory: K, V, Q[2], dO[2] tiles of 64 x (DP + 8) bf16, then f32 row
// statistics [2][lse 64 | delta 64], the key bias [64], spread [D].
constexpr int kTcKeys = 64;  // keys per block: 16 per warp
constexpr int kTcRows = 64;  // q rows per staged tile
__host__ __device__ constexpr int padded_dim(int d) { return (d + 15) / 16 * 16; }
__host__ __device__ constexpr int tc_ld(int d) { return padded_dim(d) + 8; }
__host__ __device__ constexpr int tc_smem_bytes(int d) {
  return 6 * kTcRows * tc_ld(d) * 2 + (2 * 2 * kTcRows + kTcKeys + d) * 4 + 2 * kWarps * 4;
}

// acc (16 x DP) += X B, where x holds X (16 x 16) as the C fragments of two
// 8-column tiles (f32) and B is rows r16.. of a tile in shared memory (16 x
// DP, read by ldmatrix.trans). dK/dV: X = P^T or dS^T (this warp's 16 keys x
// 16 rows), B = dO or Q; dQ: X = dS (this warp's 16 rows x 16 keys), B = K.
// With PARTS = 2, X goes in as two bf16 parts, x0 = bf16(x) and x1 = bf16(x -
// x0), the passes x0 B + x1 B: x0 + x1 carries x to ~2^-17 of itself; with
// PARTS = 1 it is rounded once.
template <int DP, int PARTS>
__device__ __forceinline__ void pass_x(const float (&x)[2][4], const bf16* tile, int r16, int lane,
                                       float (&acc)[DP / 8][4]) {
  uint32_t a0[4];
  [[maybe_unused]] uint32_t a1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // A fragment register i: n-tile i / 2, rows (lane / 4) + 8 (i % 2)
    const float u = x[i >> 1][2 * (i & 1)], w = x[i >> 1][2 * (i & 1) + 1];
    const __nv_bfloat162 hi = __floats2bfloat162_rn(u, w);
    a0[i] = *reinterpret_cast<const uint32_t*>(&hi);
    if constexpr (PARTS == 2) a1[i] = pgica::pack_bf16x2(u - __low2float(hi), w - __high2float(hi));
  }
#pragma unroll
  for (int np = 0; np < DP / 16; ++np) {
    uint32_t b[4];
    pgica::ldsm_x4_trans(b, pgica::smem_u32(tile + (r16 + (lane & 7) + ((lane >> 3) & 1) * 8) * (DP + 8) + np * 16 +
                                              (lane >> 4) * 8));
    pgica::mma_bf16(acc[2 * np], a0, b[0], b[1]);
    pgica::mma_bf16(acc[2 * np + 1], a0, b[2], b[3]);
    if constexpr (PARTS == 2) {
      pgica::mma_bf16(acc[2 * np], a1, b[0], b[1]);
      pgica::mma_bf16(acc[2 * np + 1], a1, b[2], b[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                          const float* __restrict__ bias, const float* __restrict__ lse,
                          const float* __restrict__ delta, const bf16* __restrict__ dout,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int sq, int sk, int causal,
                          float sm_scale) {
  constexpr int kDp = padded_dim(D), kLd = tc_ld(D), kTile = kTcRows * kLd;
  constexpr int kNt = kDp / 8;         // 8-column tiles of a warp's dk and dv
  constexpr int kRowVecs = D / 8;      // 16-byte vectors of a row in global memory
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kTile;
  bf16* q_s = v_s + kTile;       // [2][kTile]
  bf16* do_s = q_s + 2 * kTile;  // [2][kTile]
  float* stat_s = reinterpret_cast<float*>(do_s + 2 * kTile);  // [2][lse 64 | delta 64]
  float* b_s = stat_s + 2 * 2 * kTcRows;
  float* spread_s = b_s + kTcKeys;
  int* scratch_s = reinterpret_cast<int*>(spread_s + D);

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTcKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t q_base = static_cast<size_t>(bh) * sq;
  const size_t k_base = static_cast<size_t>(bh) * sk;
  const bf16* qg = q + q_base * D;
  const bf16* dog = dout + q_base * D;
  const float* lse_row = lse + q_base;
  const float* delta_row = delta + q_base;
  const float* bias_row = bias == nullptr ? nullptr : bias + static_cast<size_t>(bh / heads) * sk;
  const int last_kept = dkv_prologue<bf16, D>(lse_row, dog, bias_row, sq, sk, spread_s, scratch_s);

  float dk_acc[kNt][4], dv_acc[kNt][4];
#pragma unroll
  for (int i = 0; i < kNt; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  const int q_first = causal ? k0 : 0;  // under `causal` no row above the tile's diagonal keeps a key
  if (k0 <= last_kept && q_first < sq) {  // block-uniform
    const int kv_end = min(sk, last_kept + 1);
    const int n_tiles = (sq - q_first + kTcRows - 1) / kTcRows;
    if constexpr (kDp > D) {  // zero the padded columns once: the copies never write them
      for (int r = threadIdx.x; r < 6 * kTcRows; r += kThreads)
        for (int c = D; c < kDp; c += 8) *reinterpret_cast<uint4*>(k_s + r * kLd + c) = make_uint4(0u, 0u, 0u, 0u);
    }
    // rows [r0, r0 + 64) of a (n, D) array into a tile; rows at or past n as zeros
    auto stage = [&](bf16* dst, const bf16* src, int r0, int n) {
      for (int i = threadIdx.x; i < kTcRows * kRowVecs; i += kThreads) {
        const int r = i / kRowVecs, c = (i % kRowVecs) * 8;
        const bool ok = r0 + r < n;
        pgica::cp_async16(pgica::smem_u32(dst + r * kLd + c), ok ? src + static_cast<size_t>(r0 + r) * D + c : src,
                          ok);
      }
    };
    // thread t < 64: lse of the tile's row t (NEG_INF past sq: p = 0); else delta of row t - 64
    auto row_stat = [&](int r0) {
      const int r = r0 + (threadIdx.x & (kTcRows - 1));
      if (threadIdx.x < kTcRows) return r < sq ? lse_row[r] : kNegInf;
      return r < sq ? delta_row[r] : 0.f;
    };
    stage(k_s, k + k_base * D, k0, kv_end);
    stage(v_s, v + k_base * D, k0, kv_end);
    stage(q_s, qg, q_first, sq);
    stage(do_s, dog, q_first, sq);
    pgica::cp_async_commit();
    if (threadIdx.x < kTcKeys) {
      const int key = k0 + threadIdx.x;
      const float b = bias_row == nullptr || key >= kv_end ? 0.f : bias_row[key];
      b_s[threadIdx.x] = key < kv_end ? b : 2.f * kNegInf;  // a key past kv_end is masked
    }
    stat_s[threadIdx.x] = row_stat(q_first);

    const int key_w = k0 + warp * 16;  // the warp's first key
    for (int t = 0; t < n_tiles; ++t) {
      const int buf = t & 1;
      const int row0 = q_first + t * kTcRows;
      float next_stat = 0.f;
      if (t + 1 < n_tiles) {  // the next tile's copies fly while this one is multiplied
        stage(q_s + (buf ^ 1) * kTile, qg, row0 + kTcRows, sq);
        stage(do_s + (buf ^ 1) * kTile, dog, row0 + kTcRows, sq);
        next_stat = row_stat(row0 + kTcRows);
      }
      pgica::cp_async_commit();
      pgica::cp_async_wait<1>();
      __syncthreads();  // this tile (and the first time, K, V, b_s, stat_s) is in place
      const bf16* qt = q_s + buf * kTile;
      const bf16* dot = do_s + buf * kTile;
      const float* lse_t = stat_s + buf * 2 * kTcRows;
      const float* delta_t = lse_t + kTcRows;
#pragma unroll 1
      for (int qc = 0; qc < kTcRows / 16; ++qc) {
        const int r16 = qc * 16;  // the chunk's first row in the tile
        if (row0 + r16 >= sq) break;                            // warp-uniform
        if (causal && row0 + r16 + 15 < key_w) continue;        // every row above every key: p = 0
        float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kDp / 16; ++kk) {
          uint32_t ka[4], va[4], qb[4], ob[4];
          const int a_off = (warp * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8;
          const int b_off = (r16 + (lane & 7) + (lane >> 4) * 8) * kLd + kk * 16 + ((lane >> 3) & 1) * 8;
          pgica::ldsm_x4(ka, pgica::smem_u32(k_s + a_off));
          pgica::ldsm_x4(va, pgica::smem_u32(v_s + a_off));
          pgica::ldsm_x4(qb, pgica::smem_u32(qt + b_off));
          pgica::ldsm_x4(ob, pgica::smem_u32(dot + b_off));
          pgica::mma_bf16(s[0], ka, qb[0], qb[1]);
          pgica::mma_bf16(s[1], ka, qb[2], qb[3]);
          pgica::mma_bf16(dp[0], va, ob[0], ob[1]);
          pgica::mma_bf16(dp[1], va, ob[2], ob[3]);
        }
        // P^T and dS^T in place of S^T and dP^T: element e of n-tile nt is key
        // (lane / 4 + 8 (e / 2)), row r16 + 8 nt + 2 (lane % 4) + e % 2
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kl = warp * 16 + (lane >> 2) + 8 * (e >> 1);  // key in the tile
            const int rl = r16 + nt * 8 + (lane & 3) * 2 + (e & 1);   // row in the tile
            const float b = b_s[kl], row_lse = lse_t[rl];
            const bool keep = b > kNegInf && row_lse > kNoKeyLse && (!causal || row0 + rl >= k0 + kl);
            s[nt][e] = keep ? expf(s[nt][e] * sm_scale + b - row_lse) : 0.f;
            dp[nt][e] = s[nt][e] * (dp[nt][e] - delta_t[rl]);
          }
        }
        // dV += P^T dO, then dK += dS^T Q, over the chunk's 16 rows, each A in two bf16 parts
        pass_x<kDp, 2>(s, dot, r16, lane, dv_acc);
        pass_x<kDp, 2>(dp, qt, r16, lane, dk_acc);
      }
      if (t + 1 < n_tiles) stat_s[(buf ^ 1) * 2 * kTcRows + threadIdx.x] = next_stat;  // read last in tile t - 1
      __syncthreads();  // this tile is consumed before its buffers are refilled
    }
  }

  // dk = sm_scale * acc, dv = acc + spread; columns past D (D = 72) are not stored
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + warp * 16 + (lane >> 2) + 8 * half;
    if (key >= sk) continue;
    const size_t row = (k_base + key) * D;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const int c = nt * 8 + (lane & 3) * 2;
      if (D % 16 != 0 && c >= D) continue;
      *reinterpret_cast<uint32_t*>(dk + row + c) =
          pgica::pack_bf16x2(dk_acc[nt][2 * half] * sm_scale, dk_acc[nt][2 * half + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(dv + row + c) =
          pgica::pack_bf16x2(dv_acc[nt][2 * half] + spread_s[c], dv_acc[nt][2 * half + 1] + spread_s[c + 1]);
    }
  }
}

// bf16 dQ on the tensor cores (see the note above). Dynamic shared memory:
// Q, dO, K[2], V[2] tiles of 64 x (DP + 8) bf16 (O passes through K[1] before
// the walk), then the key bias [2][64] f32.
constexpr int kDqDsParts = 1;  // dS rounded once to bf16 for dS K (the note has why)
__host__ __device__ constexpr int dq_tc_smem_bytes(int d) {
  return 6 * kTcRows * tc_ld(d) * 2 + 2 * kTcKeys * 4 + kWarps * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                         const float* __restrict__ bias, const bf16* __restrict__ o, const float* __restrict__ lse,
                         const bf16* __restrict__ dout, bf16* __restrict__ dq, float* __restrict__ delta, int heads,
                         int sq, int sk, int causal, float sm_scale) {
  constexpr int kDp = padded_dim(D), kLd = tc_ld(D), kTile = kTcRows * kLd;
  constexpr int kNt = kDp / 8;     // 8-column tiles of a warp's dq
  constexpr int kRowVecs = D / 8;  // 16-byte vectors of a row in global memory
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kTile;
  bf16* k_s = do_s + kTile;     // [2][kTile]
  bf16* v_s = k_s + 2 * kTile;  // [2][kTile]
  float* b_s = reinterpret_cast<float*>(v_s + 2 * kTile);  // [2][kTcKeys]
  int* scratch_s = reinterpret_cast<int*>(b_s + 2 * kTcKeys);

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTcRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t q_base = static_cast<size_t>(bh) * sq;
  const bf16* kg = k + static_cast<size_t>(bh) * sk * D;
  const bf16* vg = v + static_cast<size_t>(bh) * sk * D;
  const float* bias_row = bias == nullptr ? nullptr : bias + static_cast<size_t>(bh / heads) * sk;

  if constexpr (kDp > D) {  // zero the padded columns once: the copies never write them
    for (int r = tid; r < 6 * kTcRows; r += kThreads)
      for (int c = D; c < kDp; c += 8) *reinterpret_cast<uint4*>(q_s + r * kLd + c) = make_uint4(0u, 0u, 0u, 0u);
  }
  // rows [r0, r0 + 64) of a (n, D) array into a tile; rows at or past n as zeros
  auto stage = [&](bf16* dst, const bf16* src, int r0, int n) {
    for (int i = tid; i < kTcRows * kRowVecs; i += kThreads) {
      const int r = i / kRowVecs, c = (i % kRowVecs) * 8;
      const bool ok = r0 + r < n;
      pgica::cp_async16(pgica::smem_u32(dst + r * kLd + c), ok ? src + static_cast<size_t>(r0 + r) * D + c : src, ok);
    }
  };
  bf16* o_s = k_s + kTile;  // K[1], free until the walk's first prefetch
  stage(q_s, q + q_base * D, q0, sq);
  stage(do_s, dout + q_base * D, q0, sq);
  stage(o_s, o + q_base * D, q0, sq);
  pgica::cp_async_commit();

  const int q_end = min(q0 + kTcRows, sq);
  int kv_end = causal ? min(sk, q_end) : sk;  // rows >= cols: cols < q_end suffice
  if (bias_row != nullptr) kv_end = min(kv_end, last_kept_key(bias_row, sk, scratch_s) + 1);  // block-uniform
  const int n_tiles = (kv_end + kTcKeys - 1) / kTcKeys;
  // key tile [k0, k0 + 64) into buffer buf; a key past kv_end is masked, whatever its bias
  auto stage_keys = [&](int buf, int k0) {
    stage(k_s + buf * kTile, kg, k0, kv_end);
    stage(v_s + buf * kTile, vg, k0, kv_end);
    if (tid < kTcKeys) {
      const int key = k0 + tid;
      b_s[buf * kTcKeys + tid] = key >= kv_end ? 2.f * kNegInf : bias_row == nullptr ? 0.f : bias_row[key];
    }
  };
  if (n_tiles > 0) stage_keys(0, 0);
  pgica::cp_async_commit();
  pgica::cp_async_wait<1>();
  __syncthreads();  // Q, dO and O are in place

  const int row_w = q0 + warp * 16;             // the warp's first row
  const int row_a = row_w + (lane >> 2);        // this thread's rows: row_a (fragment e < 2) and row_a + 8
  uint32_t qf[kDp / 16][4], of[kDp / 16][4];    // Q and dO as A fragments, for the whole walk
#pragma unroll
  for (int kk = 0; kk < kDp / 16; ++kk) {
    const int off = (warp * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8;
    pgica::ldsm_x4(qf[kk], pgica::smem_u32(q_s + off));
    pgica::ldsm_x4(of[kk], pgica::smem_u32(do_s + off));
  }
  // delta = rowsum(dO O) in f32 (the f32 kernel's order), for this warp's rows and the dK/dV kernel
  float row_lse[2] = {kNegInf, kNegInf}, row_delta[2] = {0.f, 0.f};
  for (int i = 0; i < 16 && row_w + i < sq; ++i) {  // warp-uniform
    const bf16* dor = do_s + (warp * 16 + i) * kLd;
    const bf16* orow = o_s + (warp * 16 + i) * kLd;
    float part = 0.f;
    for (int c = lane; c < D; c += 32) part = fmaf(__bfloat162float(dor[c]), __bfloat162float(orow[c]), part);
    const float sum = warp_sum(part);
    if (lane == 0) delta[q_base + row_w + i] = sum;
    if (i == (lane >> 2)) row_delta[0] = sum;
    if (i == (lane >> 2) + 8) row_delta[1] = sum;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (row_a + 8 * h < sq) row_lse[h] = lse[q_base + row_a + 8 * h];  // past sq: NEG_INF, p = 0
  __syncthreads();  // O is read: K[1] is free

  float acc[kNt][4];
#pragma unroll
  for (int i = 0; i < kNt; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1, k0 = t * kTcKeys;
    if (t + 1 < n_tiles) stage_keys(buf ^ 1, k0 + kTcKeys);  // the next tile's copies fly while this one is used
    pgica::cp_async_commit();
    pgica::cp_async_wait<1>();
    __syncthreads();  // tile t is in place
    const bf16* kt = k_s + buf * kTile;
    const bf16* vt = v_s + buf * kTile;
    const float* bt = b_s + buf * kTcKeys;
    if (row_w < sq) {  // warp-uniform
#pragma unroll  // kept rolled, the D = 32 instance spilled 4 bytes
      for (int kc = 0; kc < kTcKeys; kc += 16) {  // 16 keys at a time
        if (k0 + kc >= kv_end) break;                    // keys past the last kept one
        if (causal && k0 + kc > row_w + 15) break;       // every key above every row of the warp
        // S = Q K^T and dP = dO V^T: element e of n-tile nt is row row_a + 8 (e / 2), key kc + 8 nt + 2 (lane % 4) + e % 2
        float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kDp / 16; ++kk) {
          uint32_t kb[4], vb[4];
          const int off = (kc + (lane & 7) + (lane >> 4) * 8) * kLd + kk * 16 + ((lane >> 3) & 1) * 8;
          pgica::ldsm_x4(kb, pgica::smem_u32(kt + off));
          pgica::ldsm_x4(vb, pgica::smem_u32(vt + off));
          pgica::mma_bf16(s[0], qf[kk], kb[0], kb[1]);
          pgica::mma_bf16(s[1], qf[kk], kb[2], kb[3]);
          pgica::mma_bf16(dp[0], of[kk], vb[0], vb[1]);
          pgica::mma_bf16(dp[1], of[kk], vb[2], vb[3]);
        }
        // dS = P (dP - delta) in place of S, with P = 0 where the key or the causal entry is masked or
        // the row keeps no key
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kl = kc + nt * 8 + (lane & 3) * 2 + (e & 1);  // key in the tile
            const int h = e >> 1;
            const float b = bt[kl];
            const bool keep = b > kNegInf && row_lse[h] > kNoKeyLse && (!causal || row_a + 8 * h >= k0 + kl);
            const float p = keep ? expf(s[nt][e] * sm_scale + b - row_lse[h]) : 0.f;
            s[nt][e] = p * (dp[nt][e] - row_delta[h]);
          }
        pass_x<kDp, kDqDsParts>(s, kt, kc, lane, acc);  // dQ += dS K over these 16 keys
      }
    }
    __syncthreads();  // tile t is consumed before its buffers are refilled
  }
  pgica::cp_async_wait<0>();

  // dq = sm_scale * acc; columns past D (D = 72) are not stored
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + 8 * h;
    if (row >= sq) continue;
    bf16* dqrow = dq + (q_base + row) * D;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const int c = nt * 8 + (lane & 3) * 2;
      if (D % 16 != 0 && c >= D) continue;
      *reinterpret_cast<uint32_t*>(dqrow + c) = pgica::pack_bf16x2(acc[nt][2 * h] * sm_scale, acc[nt][2 * h + 1] * sm_scale);
    }
  }
}

int launch_dq_f32(const void* q, const void* k, const void* v, const void* bias, const void* o, const void* lse,
                  const void* dout, void* dq, void* delta, int bh, int heads, int sq, int sk, int head_dim, int causal,
                  float sm_scale, cudaStream_t stream) {
  switch (head_dim) {
#define PGICA_DQ_CASE(DIM)                                                                                    \
  case DIM:                                                                                                   \
    flash_attn_bwd_dq<float, DIM><<<dim3(bh, (sq + rows_staged(DIM) - 1) / rows_staged(DIM)), kThreads, 0,    \
                                    stream>>>(                                                                \
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),              \
        static_cast<const float*>(bias), static_cast<const float*>(o), static_cast<const float*>(lse),         \
        static_cast<const float*>(dout), static_cast<float*>(dq), static_cast<float*>(delta), heads, sq, sk,    \
        causal, sm_scale);                                                                                    \
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

template <int D>
int launch_dq_tc(const void* q, const void* k, const void* v, const void* bias, const void* o, const void* lse,
                 const void* dout, void* dq, void* delta, int bh, int heads, int sq, int sk, int causal,
                 float sm_scale, cudaStream_t stream) {
  constexpr int kSmem = dq_tc_smem_bytes(D);
  static const cudaError_t attr =  // once per instance: above 48 KB, dynamic shared memory must be asked for
      cudaFuncSetAttribute(flash_attn_bwd_dq_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(bh, (sq + kTcRows - 1) / kTcRows);
  flash_attn_bwd_dq_tc<D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<const bf16*>(o), static_cast<const float*>(lse),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<float*>(delta), heads, sq, sk, causal,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_dq_bf16(const void* q, const void* k, const void* v, const void* bias, const void* o, const void* lse,
                   const void* dout, void* dq, void* delta, int bh, int heads, int sq, int sk, int head_dim, int causal,
                   float sm_scale, cudaStream_t stream) {
  switch (head_dim) {
#define PGICA_DQ_CASE(DIM) \
  case DIM:                \
    return launch_dq_tc<DIM>(q, k, v, bias, o, lse, dout, dq, delta, bh, heads, sq, sk, causal, sm_scale, stream);
    PGICA_DQ_CASE(16)
    PGICA_DQ_CASE(32)
    PGICA_DQ_CASE(64)
    PGICA_DQ_CASE(72)
    PGICA_DQ_CASE(128)
#undef PGICA_DQ_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_dkv_f32(const void* q, const void* k, const void* v, const void* bias, const void* lse,
                   const void* delta, const void* dout, void* dk, void* dv, int bh, int heads, int sq, int sk,
                   int head_dim, int causal, float sm_scale, cudaStream_t stream) {
  const dim3 grid(bh, (sk + kBlockK - 1) / kBlockK);
  switch (head_dim) {
#define PGICA_DKV_CASE(DIM)                                                                     \
  case DIM:                                                                                     \
    flash_attn_bwd_dkv_simt<float, DIM><<<grid, kThreads, 0, stream>>>(                         \
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), \
        static_cast<const float*>(bias), static_cast<const float*>(lse),                        \
        static_cast<const float*>(delta), static_cast<const float*>(dout),                      \
        static_cast<float*>(dk), static_cast<float*>(dv), heads, sq, sk, causal, sm_scale);     \
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

template <int D>
int launch_dkv_tc(const void* q, const void* k, const void* v, const void* bias, const void* lse,
                  const void* delta, const void* dout, void* dk, void* dv, int bh, int heads, int sq, int sk,
                  int causal, float sm_scale, cudaStream_t stream) {
  constexpr int kSmem = tc_smem_bytes(D);
  static const cudaError_t attr =  // once per instance: above 48 KB, dynamic shared memory must be asked for
      cudaFuncSetAttribute(flash_attn_bwd_dkv_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(bh, (sk + kTcKeys - 1) / kTcKeys);
  flash_attn_bwd_dkv_tc<D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads, sq, sk, causal,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_dkv_bf16(const void* q, const void* k, const void* v, const void* bias, const void* lse,
                    const void* delta, const void* dout, void* dk, void* dv, int bh, int heads, int sq, int sk,
                    int head_dim, int causal, float sm_scale, cudaStream_t stream) {
  switch (head_dim) {
#define PGICA_DKV_CASE(DIM) \
  case DIM:                 \
    return launch_dkv_tc<DIM>(q, k, v, bias, lse, delta, dout, dk, dv, bh, heads, sq, sk, causal, sm_scale, stream);
    PGICA_DKV_CASE(16)
    PGICA_DKV_CASE(32)
    PGICA_DKV_CASE(64)
    PGICA_DKV_CASE(72)
    PGICA_DKV_CASE(128)
#undef PGICA_DKV_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool bad_shape(int bh, int heads, int sq, int sk) {
  return bh <= 0 || heads <= 0 || bh % heads != 0 || sq <= 0 || sk <= 0 ||
         sq > 65535 * rows_staged(128) || sk > 65535 * kBlockK;
}

}  // namespace

// q, o, dout, dq: (bh, sq, head_dim); k, v: (bh, sk, head_dim), contiguous in
// `dtype`; bias: (bh / heads, sk) f32 or NULL; lse, delta: (bh, sq) f32.
// Writes dq and delta = rowsum(dout * o): bf16 on the tensor cores
// (flash_attn_bwd_dq_tc), f32 on the CUDA cores (flash_attn_bwd_dq).
// Returns a cudaError_t code.
extern "C" int pgica_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* bias, const void* o, const void* lse,
                                       const void* dout, void* dq, void* delta, int bh, int heads,
                                       int sq, int sk, int head_dim, int causal, float sm_scale,
                                       int dtype, void* stream) {
  if (bad_shape(bh, heads, sq, sk)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == pgica::kFloat32)
    return launch_dq_f32(q, k, v, bias, o, lse, dout, dq, delta, bh, heads, sq, sk, head_dim, causal, sm_scale, s);
  if (dtype == pgica::kBFloat16)
    return launch_dq_bf16(q, k, v, bias, o, lse, dout, dq, delta, bh, heads, sq, sk, head_dim, causal, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As above, with delta from pgica_flash_attn_bwd_dq; writes dk and dv
// (bh, sk, head_dim) in `dtype`: bf16 on the tensor cores
// (flash_attn_bwd_dkv_tc), f32 on the CUDA cores (flash_attn_bwd_dkv_simt).
// Returns a cudaError_t code.
extern "C" int pgica_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* bias, const void* lse, const void* delta,
                                        const void* dout, void* dk, void* dv, int bh, int heads,
                                        int sq, int sk, int head_dim, int causal, float sm_scale,
                                        int dtype, void* stream) {
  if (bad_shape(bh, heads, sq, sk)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == pgica::kFloat32)
    return launch_dkv_f32(q, k, v, bias, lse, delta, dout, dk, dv, bh, heads, sq, sk, head_dim, causal,
                          sm_scale, s);
  if (dtype == pgica::kBFloat16)
    return launch_dkv_bf16(q, k, v, bias, lse, delta, dout, dk, dv, bh, heads, sq, sk, head_dim, causal,
                           sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
