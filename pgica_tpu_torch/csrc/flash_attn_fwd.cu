// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: pgica_tpu/ops/flash_attention.py:34 `_fwd_kernel` (Pallas, TPU).
//   Online-softmax attention over (B*H, S, D) tensors with a per-key additive
//   bias (B, Sk) in f32 shared across heads, an optional causal mask with the
//   JAX semantics `rows >= cols` (not offset by Sk - Sq), softmax statistics
//   in f32; writes O in the input dtype and the row logsumexp in f32.
//   A masked key (bias <= NEG_INF, or above the causal diagonal) scores
//   exactly NEG_INF = -1e9, the finite fill of the plain JAX path
//   (attention.py:_xla_attention): in a row that keeps any key its p is
//   exp(-1e9 - m) = 0 in f32, and a row whose keys are all masked averages V
//   over all Sk keys, as that path does, instead of giving 0 or NaN.
//
// What bounds it on the H100: memory, at both serving shapes. ViT-B/32:
// Sq = Sk = 50, D = 64, about 9.8 MB of q, k, v and o per call at batch 32
// for ~63 MFLOP. Decode: Sq = 1 over a cache of Sk = max_length + 1 whose
// slots past the position are masked, so the K/V it must read is that of the
// kept keys only: 2 * 32 * 16 * (pos + 1) * 64 * 2 bytes at batch 32 in bf16
// (8.5 MB at the last step, 64 max_length), with ~1 flop per byte. Both sit
// far below the card's ~295 flops per byte, so the floor is bytes / 3.35 TB/s.
// So does the stage-1 text tower: (B*H, S, D) = (2048, 128, 64) bf16 moves
// ~134 MB of q, k, v and o for ~4.3 GFLOP of the causal half.
//
// Design (simple and correct first; wgmma, TMA and warp specialisation are
// later work): one 128-thread block per (b*h, 16-row q tile). The q tile is
// staged once in shared memory in f32 with sm_scale folded in (as :38 does).
// K/V tiles of 32 keys are staged through shared memory in f32, rows padded to
// D+1 floats so that lane j reading K[j][d] hits bank (j + d) % 32, with
// 16-byte global loads all in flight before the first store. Each warp
// owns four q rows (interleaved, so a ragged last tile still spreads over
// warps). For one row and one tile, lane j computes the score of key j with
// scalar FMAs; the tile max and sum are warp shuffles; the PV product
// broadcasts p_j by shuffle while lane l accumulates output columns l, l+32,
// ... in registers (at SigLIP's D = 72 the third column group holds columns
// 64..71 only: the PV product and the store skip columns >= D). Ragged edges
// of Sq and Sk are masked in the kernel (keys
// past Sk get p = 0 and never enter the max), which replaces the reference's
// power-of-two block division (`_pick_block`, :170-174): S = 50 and Sk = 65
// are the real shapes. Under `causal`, tiles wholly above the diagonal of the
// q tile are skipped. Keys after the last one whose bias is above NEG_INF
// (the empty cache slots of decode, the padding of a ragged batch row) are
// neither loaded nor scored: their p is 0 for every row that keeps a key.
// Both skips hold only for rows that keep a key. A q tile holding a row
// that keeps none (no kept key in the batch row, or under `causal` none at
// or before the row) reads all Sk keys, so that row averages V over all of
// them; its other rows still give masked keys p = 0.
#include <math.h>

#include "common.cuh"

namespace {

using pgica::from_float;
using pgica::load16;
using pgica::unpack16;
using pgica::warp_max;
using pgica::warp_sum;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockQ = 16;
constexpr int kRowsPerWarp = kBlockQ / kWarps;
constexpr int kBlockK = 32;  // one key per lane in the score step
constexpr float kNegInf = -1.0e9f;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attn_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ bias, T* __restrict__ o, float* __restrict__ lse,
                   int heads, int sq, int sk, int causal, float sm_scale) {
  constexpr int kPad = D + 1;
  constexpr int kColsPerLane = (D + 31) / 32;
  __shared__ float q_s[kBlockQ][D];
  __shared__ float k_s[kBlockK][kPad];
  __shared__ float v_s[kBlockK][kPad];
  __shared__ float b_s[kBlockK];
  __shared__ int last_kept_s[kWarps];
  __shared__ int first_kept_s[kWarps];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const T* qg = q + static_cast<size_t>(bh) * sq * D;
  const T* kg = k + static_cast<size_t>(bh) * sk * D;
  const T* vg = v + static_cast<size_t>(bh) * sk * D;
  const float* bias_row = bias == nullptr ? nullptr : bias + static_cast<size_t>(bh / heads) * sk;

  // Staging: 16-byte loads, all of a tile's issued before any is stored, so
  // they are in flight together (one memory latency per tile, not one per
  // element). Rows are D * sizeof(T) bytes, a multiple of 16; the wrapper
  // checks that the base pointers are 16-byte aligned.
  constexpr int kVecN = 16 / static_cast<int>(sizeof(T));
  constexpr int kRowVecs = D / kVecN;
  constexpr int kQVecs = kBlockQ * kRowVecs;
  constexpr int kQLoads = (kQVecs + kThreads - 1) / kThreads;
  constexpr int kKVecs = kBlockK * kRowVecs;
  constexpr int kKLoads = (kKVecs + kThreads - 1) / kThreads;
  const int q_end = min(q0 + kBlockQ, sq);
  int kv_end = causal ? min(sk, q_end) : sk;  // rows >= cols: cols < q_end suffice
  {
    uint4 raw[kQLoads];
#pragma unroll
    for (int it = 0; it < kQLoads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kRowVecs, c = (i % kRowVecs) * kVecN;
      raw[it] = load16(qg + static_cast<size_t>(q0 + r) * D + c, i < kQVecs && q0 + r < sq);
    }
    if (bias_row != nullptr) {  // first and last kept key, read while the q loads are in flight
      int first_kept = sk, last_kept = -1;
      for (int j = tid; j < kv_end; j += kThreads) {
        if (bias_row[j] > kNegInf) {
          first_kept = min(first_kept, j);
          last_kept = j;
        }
      }
      first_kept = __reduce_min_sync(0xffffffffu, first_kept);
      last_kept = __reduce_max_sync(0xffffffffu, last_kept);
      if (lane == 0) {
        first_kept_s[warp] = first_kept;
        last_kept_s[warp] = last_kept;
      }
    }
#pragma unroll
    for (int it = 0; it < kQLoads; ++it) {
      const int i = tid + it * kThreads;
      if (i >= kQVecs) break;
      const int r = i / kRowVecs, c = (i % kRowVecs) * kVecN;
      float f[kVecN];
      unpack16(raw[it], f, qg);
#pragma unroll
      for (int e = 0; e < kVecN; ++e) q_s[r][c + e] = f[e] * sm_scale;
    }
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) acc[rr][i] = 0.f;
  }

  if (bias_row != nullptr) {  // block-uniform
    __syncthreads();  // first_kept_s and last_kept_s are complete
    int first_kept = first_kept_s[0], last_kept = last_kept_s[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      first_kept = min(first_kept, first_kept_s[w]);
      last_kept = max(last_kept, last_kept_s[w]);
    }
    // Row q0, the tile's first, keeps no key: it averages V over all Sk keys.
    const bool row_without_key = last_kept < 0 || (causal && first_kept > q0);
    kv_end = row_without_key ? sk : last_kept + 1;  // trailing padding adds p = 0 only
  }
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed (and q_s is visible)
    uint4 kraw[kKLoads], vraw[kKLoads];
#pragma unroll
    for (int it = 0; it < kKLoads; ++it) {
      const int i = tid + it * kThreads;
      const int j = i / kRowVecs, c = (i % kRowVecs) * kVecN;
      const bool in = i < kKVecs && k0 + j < kv_end;  // keys past kv_end stage as zeros
      const size_t g = static_cast<size_t>(k0 + j) * D + c;
      kraw[it] = load16(kg + g, in);
      vraw[it] = load16(vg + g, in);
    }
#pragma unroll
    for (int it = 0; it < kKLoads; ++it) {
      const int i = tid + it * kThreads;
      if (i >= kKVecs) break;
      const int j = i / kRowVecs, c = (i % kRowVecs) * kVecN;
      float kf[kVecN], vf[kVecN];
      unpack16(kraw[it], kf, kg);
      unpack16(vraw[it], vf, vg);
#pragma unroll
      for (int e = 0; e < kVecN; ++e) {
        k_s[j][c + e] = kf[e];
        v_s[j][c + e] = vf[e];
      }
    }
    if (tid < kBlockK)
      b_s[tid] = bias_row != nullptr && k0 + tid < kv_end ? bias_row[k0 + tid] : 0.f;
    __syncthreads();

    const int col = k0 + lane;
    const bool col_ok = col < kv_end;
    const bool col_kept = col_ok && b_s[lane] > kNegInf;  // b_s is 0 without a bias
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = rr * kWarps + warp;
      const int row = q0 + r;
      if (row >= sq) break;  // warp-uniform
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) s = fmaf(q_s[r][c], k_s[lane][c], s);
      // a masked key scores NEG_INF exactly, as the reference's fill
      s = col_kept && (!causal || row >= col) ? s + b_s[lane] : kNegInf;
      const float m_new = fmaxf(m[rr], warp_max(col_ok ? s : -INFINITY));
      const float p = col_ok ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < kColsPerLane; ++i) acc[rr][i] *= alpha;
#pragma unroll 8
      for (int j = 0; j < kBlockK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < kColsPerLane; ++i) {
          const int c = lane + 32 * i;
          if (D % 32 == 0 || c < D) acc[rr][i] = fmaf(pj, v_s[j][c], acc[rr][i]);
        }
      }
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + rr * kWarps + warp;
    if (row >= sq) break;
    const float l_safe = l[rr] == 0.f ? 1.f : l[rr];
    T* og = o + (static_cast<size_t>(bh) * sq + row) * D;
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < D) og[c] = from_float<T>(acc[rr][i] / l_safe);
    }
    if (lane == 0) lse[static_cast<size_t>(bh) * sq + row] = m[rr] + logf(l_safe);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias, void* o, void* lse,
           int bh, int heads, int sq, int sk, int head_dim, int causal, float sm_scale,
           cudaStream_t stream) {
  const dim3 grid(bh, (sq + kBlockQ - 1) / kBlockQ);
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  const auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<T*>(o);
  auto* lp = static_cast<float*>(lse);
  switch (head_dim) {
#define PGICA_FA_CASE(DIM)                                                                   \
  case DIM:                                                                                  \
    flash_attn_fwd<T, DIM><<<grid, kThreads, 0, stream>>>(qp, kp, vp, bp, op, lp, heads, sq, \
                                                          sk, causal, sm_scale);             \
    break;
    PGICA_FA_CASE(16)
    PGICA_FA_CASE(32)
    PGICA_FA_CASE(64)
    PGICA_FA_CASE(72)
    PGICA_FA_CASE(128)
#undef PGICA_FA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (bh, sq, head_dim); k, v: (bh, sk, head_dim), contiguous in `dtype`;
// bias: (bh / heads, sk) f32 or NULL; lse: (bh, sq) f32.
// Returns a cudaError_t code (0 = launched).
extern "C" int pgica_flash_attn_fwd(const void* q, const void* k, const void* v, const void* bias,
                                    void* o, void* lse, int bh, int heads, int sq, int sk,
                                    int head_dim, int causal, float sm_scale, int dtype,
                                    void* stream) {
  if (bh <= 0 || heads <= 0 || bh % heads != 0 || sq <= 0 || sk <= 0 || sq > 65535 * kBlockQ)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == pgica::kFloat32)
    return launch<float>(q, k, v, bias, o, lse, bh, heads, sq, sk, head_dim, causal, sm_scale, s);
  if (dtype == pgica::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, bias, o, lse, bh, heads, sq, sk, head_dim, causal,
                                 sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
