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
// Two kernels, chosen by the wrapper (ops/flash_attention.py:
// fwd_on_tensor_cores) from the dtype and Sq, never by a failure: bf16 at Sq
// >= its threshold runs flash_attn_fwd_tc on the tensor cores (below);
// decode (Sq = 1), short Sq and f32 run flash_attn_fwd on the CUDA cores.
// Both keep the semantics above and below exactly.
//
// flash_attn_fwd (CUDA cores; simple and correct first, and faster than the
// tensor-core kernel at decode, where one q row cannot fill an mma tile):
// one 128-thread block per (b*h, 16-row q tile). The q tile is
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
//
// flash_attn_fwd_tc (bf16, tensor cores): FlashAttention-2's forward on
// mma.sync m16n8k16 (mma.cuh; bf16 in, f32 sums). What bounds it: at
// SigLIP's (32, 730, 730, 72) it does 4 * 730^2 * 80 flops a head with D
// padded, 5.5 GFLOP, 5.5 us at the bf16 peak, against 13.5 MB of q, k, v and
// o (4.0 us at 3.35 TB/s): the products must run on the tensor cores. A
// 128-thread block owns a 64-row q tile of one (batch*head), one warp per 16
// rows, with Q's A fragments held in registers for the whole walk. K and V
// tiles of 64 keys come in as bf16 through a double-buffered cp.async ring
// (the next tile's copies fly while this one is multiplied), rows padded to
// D + 8 bf16 so that ldmatrix reads no bank twice; D = 72 is zero-filled to
// 80, the mma depth being 16. Per tile and warp:
//   S = Q K^T into f32 accumulators (K through ldmatrix), scaled by
//       1/sqrt(d) on the f32 sum (not Q before rounding), plus the key's
//       bias; masked keys NEG_INF, keys past kv_end -inf (out of the max);
//   the online max and sum in f32 on the accumulator fragments (a row's
//       four lanes agree by two shuffles);
//   P repacked to bf16 A fragments in registers (no trip through shared
//       memory), then O += P V with V through ldmatrix.trans.
// P rounded once to bf16 is the usual forward: o is a p-weighted mean with
// p >= 0, so there is no cancellation for the rounding to expose (unlike
// dV; tests/test_torch_ops.py emulates it at the main path's shapes), and
// the sum l stays f32. The tile skipping above (causal, trailing padding,
// a row without a kept key) is the same, per 64-row q tile.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

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

// ------------------------------------------------------------------ tensor cores

using bf16 = __nv_bfloat16;
constexpr int kTcRows = 64;  // q rows per block: 16 per warp
constexpr int kTcKeys = 64;  // keys per staged tile
__host__ __device__ constexpr int padded_dim(int d) { return (d + 15) / 16 * 16; }
__host__ __device__ constexpr int tc_ld(int d) { return padded_dim(d) + 8; }
// Dynamic shared memory: Q, K[2], V[2] tiles of 64 x (DP + 8) bf16, then the key bias [2][64] f32.
__host__ __device__ constexpr int tc_smem_bytes(int d) { return 5 * kTcRows * tc_ld(d) * 2 + 2 * kTcKeys * 4; }

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attn_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                      const float* __restrict__ bias, bf16* __restrict__ o, float* __restrict__ lse, int heads,
                      int sq, int sk, int causal, float sm_scale) {
  constexpr int kDp = padded_dim(D), kLd = tc_ld(D), kTile = kTcRows * kLd;
  constexpr int kNt = kDp / 8;     // 8-column tiles of a warp's O
  constexpr int kRowVecs = D / 8;  // 16-byte vectors of a row in global memory
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kTile;      // [2][kTile]
  bf16* v_s = k_s + 2 * kTile;  // [2][kTile]
  float* b_s = reinterpret_cast<float*>(v_s + 2 * kTile);  // [2][kTcKeys]
  __shared__ int kept_s[2 * kWarps];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTcRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* qg = q + static_cast<size_t>(bh) * sq * D;
  const bf16* kg = k + static_cast<size_t>(bh) * sk * D;
  const bf16* vg = v + static_cast<size_t>(bh) * sk * D;
  const float* bias_row = bias == nullptr ? nullptr : bias + static_cast<size_t>(bh / heads) * sk;

  if constexpr (kDp > D) {  // zero the padded columns once: the copies never write them
    for (int r = tid; r < 5 * kTcRows; r += kThreads)
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
  stage(q_s, qg, q0, sq);

  const int q_end = min(q0 + kTcRows, sq);
  int kv_end = causal ? min(sk, q_end) : sk;  // rows >= cols: cols < q_end suffice
  if (bias_row != nullptr) {  // block-uniform; the q copies fly meanwhile
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
      kept_s[warp] = first_kept;
      kept_s[kWarps + warp] = last_kept;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      first_kept = min(first_kept, kept_s[w]);
      last_kept = max(last_kept, kept_s[kWarps + w]);
    }
    // Row q0, the tile's first, keeps no key: it averages V over all Sk keys.
    const bool row_without_key = last_kept < 0 || (causal && first_kept > q0);
    kv_end = row_without_key ? sk : last_kept + 1;  // trailing padding adds p = 0 only
  }
  const int n_tiles = (kv_end + kTcKeys - 1) / kTcKeys;
  // the key tile's bias into b_s[buf]; a key past kv_end is cut below, whatever its bias
  auto stage_bias = [&](int buf, int k0) {
    if (tid < kTcKeys)
      b_s[buf * kTcKeys + tid] = bias_row != nullptr && k0 + tid < kv_end ? bias_row[k0 + tid] : 0.f;
  };
  stage(k_s, kg, 0, kv_end);
  stage(v_s, vg, 0, kv_end);
  pgica::cp_async_commit();
  stage_bias(0, 0);

  const int row_a = q0 + warp * 16 + (lane >> 2);  // this thread's rows: row_a (fragment e < 2) and row_a + 8
  const bool warp_rows = q0 + warp * 16 < sq;       // warp-uniform: the warp holds a row of q
  uint32_t qf[kDp / 16][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kNt][4];
#pragma unroll
  for (int i = 0; i < kNt; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1, k0 = t * kTcKeys;
    pgica::cp_async_wait<0>();
    __syncthreads();  // tile t (the first time also Q) is in place; tile t - 1 is consumed by every warp
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < kDp / 16; ++kk)
        pgica::ldsm_x4(qf[kk], pgica::smem_u32(q_s + (warp * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8));
    }
    if (t + 1 < n_tiles) {  // the next tile's copies fly while this one is multiplied
      stage(k_s + (buf ^ 1) * kTile, kg, k0 + kTcKeys, kv_end);
      stage(v_s + (buf ^ 1) * kTile, vg, k0 + kTcKeys, kv_end);
      stage_bias(buf ^ 1, k0 + kTcKeys);
    }
    pgica::cp_async_commit();
    if (!warp_rows) continue;
    const bf16* kt = k_s + buf * kTile;
    const bf16* vt = v_s + buf * kTile;
    const float* bt = b_s + buf * kTcKeys;

    // S = Q K^T: element e of n-tile nt is row row_a + 8 (e / 2), key nt * 8 + 2 (lane % 4) + e % 2
    float s[kTcKeys / 8][4];
#pragma unroll
    for (int i = 0; i < kTcKeys / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDp / 16; ++kk)
#pragma unroll
      for (int np = 0; np < kTcKeys / 16; ++np) {
        uint32_t r[4];
        pgica::ldsm_x4(r, pgica::smem_u32(kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kLd + kk * 16 +
                                          ((lane >> 3) & 1) * 8));
        pgica::mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
        pgica::mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
      }
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kTcKeys / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = nt * 8 + (lane & 3) * 2 + (e & 1);
        const int col = k0 + key, row = row_a + 8 * (e >> 1);
        float x = -INFINITY;  // past kv_end: neither in the max nor in the sum
        if (col < kv_end) {
          const float b = bt[key];
          // a masked key scores NEG_INF exactly, as the reference's fill
          x = b > kNegInf && (!causal || row >= col) ? s[nt][e] * sm_scale + b : kNegInf;
        }
        s[nt][e] = x;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the four lanes of a row hold its 64 keys
      tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 1));
      tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 2));
      const float m_new = fmaxf(m[h], tile_max[h]);  // finite: key k0 < kv_end scores at least NEG_INF
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];  // this lane's share of the row's sum; the shares are added at the end
    }
#pragma unroll
    for (int nt = 0; nt < kTcKeys / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);
        l[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int i = 0; i < kNt; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha[e >> 1];
    // O += P V over the tile's 64 keys, 16 at a time; the C fragments of n-tiles 2 kk and 2 kk + 1
    // are the A fragment of keys 16 kk .. 16 kk + 15
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      const uint32_t a[4] = {pgica::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                             pgica::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                             pgica::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pgica::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < kDp / 16; ++np) {
        uint32_t r[4];
        pgica::ldsm_x4_trans(r, pgica::smem_u32(vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                                np * 16 + (lane >> 4) * 8));
        pgica::mma_bf16(acc[2 * np], a, r[0], r[1]);
        pgica::mma_bf16(acc[2 * np + 1], a, r[2], r[3]);
      }
    }
  }
  pgica::cp_async_wait<0>();

  // o = acc / l, lse = m + log(l); columns past D (D = 72) are not stored
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = row_a + 8 * h;
    if (!warp_rows || row >= sq) continue;
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    bf16* orow = o + (static_cast<size_t>(bh) * sq + row) * D;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const int c = nt * 8 + (lane & 3) * 2;
      if (D % 16 != 0 && c >= D) continue;
      *reinterpret_cast<uint32_t*>(orow + c) = pgica::pack_bf16x2(acc[nt][2 * h] / l_safe, acc[nt][2 * h + 1] / l_safe);
    }
    if ((lane & 3) == 0) lse[static_cast<size_t>(bh) * sq + row] = m[h] + logf(l_safe);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* bias, void* o, void* lse, int bh, int heads,
              int sq, int sk, int causal, float sm_scale, cudaStream_t stream) {
  constexpr int kSmem = tc_smem_bytes(D);
  static const cudaError_t attr =  // once per instance: above 48 KB, dynamic shared memory must be asked for
      cudaFuncSetAttribute(flash_attn_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(bh, (sq + kTcRows - 1) / kTcRows);
  flash_attn_fwd_tc<D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(o), static_cast<float*>(lse), heads, sq, sk, causal,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc_dim(const void* q, const void* k, const void* v, const void* bias, void* o, void* lse, int bh,
                  int heads, int sq, int sk, int head_dim, int causal, float sm_scale, cudaStream_t stream) {
  switch (head_dim) {
#define PGICA_FA_TC_CASE(DIM) \
  case DIM:                   \
    return launch_tc<DIM>(q, k, v, bias, o, lse, bh, heads, sq, sk, causal, sm_scale, stream);
    PGICA_FA_TC_CASE(16)
    PGICA_FA_TC_CASE(32)
    PGICA_FA_TC_CASE(64)
    PGICA_FA_TC_CASE(72)
    PGICA_FA_TC_CASE(128)
#undef PGICA_FA_TC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------------------------ dispatch

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
// bias: (bh / heads, sk) f32 or NULL; lse: (bh, sq) f32. tensor_cores != 0
// runs flash_attn_fwd_tc (bf16 only), else flash_attn_fwd.
// Returns a cudaError_t code (0 = launched).
extern "C" int pgica_flash_attn_fwd(const void* q, const void* k, const void* v, const void* bias,
                                    void* o, void* lse, int bh, int heads, int sq, int sk,
                                    int head_dim, int causal, float sm_scale, int dtype,
                                    int tensor_cores, void* stream) {
  if (bh <= 0 || heads <= 0 || bh % heads != 0 || sq <= 0 || sk <= 0 || sq > 65535 * kBlockQ)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (tensor_cores)
    return dtype == pgica::kBFloat16
               ? launch_tc_dim(q, k, v, bias, o, lse, bh, heads, sq, sk, head_dim, causal, sm_scale, s)
               : static_cast<int>(cudaErrorInvalidValue);
  if (dtype == pgica::kFloat32)
    return launch<float>(q, k, v, bias, o, lse, bh, heads, sq, sk, head_dim, causal, sm_scale, s);
  if (dtype == pgica::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, bias, o, lse, bh, heads, sq, sk, head_dim, causal,
                                 sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
