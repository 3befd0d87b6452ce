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
// The f32 instance is flash_attn_bwd_dkv_f32 (below); the C entry point
// dispatches by dtype. Both share the prologue (dkv_prologue) and the
// semantics above.
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
// The f32 instance is flash_attn_bwd_dq_f32 (below). Both skip the key tiles
// wholly above the diagonal and the keys after the batch row's last kept key.
//
// float32 on the CUDA cores (flash_attn_bwd_dkv_f32, flash_attn_bwd_dq_f32):
// the same FlashAttention-2 layout in full f32 FMAs. f32 inputs are held to
// 2e-5 (chip_smoke.py:ATTN_BWD_F32_TOL), which bf16 or TF32 products break:
// a single TF32 rounding of P and dS alone misses it (tests/
// test_torch_backward.py), and a three-part TF32 scheme would trade three
// tensor-core passes and the operand splits for a bound that f32 FMAs meet
// exactly. So the products stay f32 and the design is about feeding the FMA
// units: 67 TFLOP/s against 32 floats a clock an SM from shared memory, so
// each float read from shared memory must feed several FMAs (register
// tiling). A 256-thread block works in two phases on tiles in shared memory
// (f32 rows padded to D + 4 floats: the 8 lanes of a quarter-warp that read
// 8 consecutive rows hit 8 different 16-byte bank groups):
//   A: the scores and dP of a 64 x R tile, register-tiled outer products fed
//      by float4 reads. The block's two halves split the work: threads 0-127
//      compute S = Q K^T, threads 128-255 dP = dO V^T, 16 or 32 elements a
//      thread (keys 4 kg + i x rows rg + 8 j in dK/dV, rows rg + 16 i x keys
//      kg + 8 j in dQ), each element an FMA chain over the D columns in
//      order. P (masked, exp(s * scale + bias - lse)) and dP - delta go to
//      shared memory once.
//   B: the output products (dV += P^T dO and dK += dS^T Q, dS = P (dP -
//      delta); dQ += dS K), each thread owning 4 output rows (keys or q rows;
//      2 at D = 32, 1 at D = 16) x 16-byte column chunks cg, cg + 16, ...
//      (OutTile), accumulated in registers over every tile: 64 f32 registers
//      a thread at D = 128 for dK and dV, 32 for dQ. Nothing spills at any D
//      (phase 3 reports ptxas's count for every instance).
// dK/dV: a block owns 64 keys with K and V in shared memory and walks the q
// rows from the tile's diagonal on in tiles of R = 32 rows (48 at D = 128),
// Q, dO and the rows' lse and delta double-buffered by cp.async (the next
// tile's copies fly while this one is computed); two barriers a tile. dQ: a
// block owns 64 q rows (Q, dO in shared memory; delta = rowsum(dO O) from O
// staged once, written for dK/dV) and walks tiles of 64 keys (32 at D <= 64,
// for two blocks an SM) of K, V and the bias, double-buffered, up to its
// last causal column and the batch row's last kept key; dS goes through
// shared memory in place of dP - delta, three barriers a tile. Warps skip the rows (dK/dV) or keys (dQ) wholly on the
// masked side of the diagonal, and dK/dV's score warps the 16 keys above
// every row of a tile: the terms skipped are exact zeros, so the sums are
// the same bits either way. Every output element has one owner thread and a
// fixed order (tiles in order, rows or keys in order within a tile): no
// atomics, the same bits from run to run. The scale multiplies the f32
// score and the finished dq and dk.
//
// Both dK/dV instances: a tile past the batch row's last kept key reads no
// k or v: its dk is 0 and its dv only the spread of the rows that keep no
// key.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using pgica::to_float;
using pgica::warp_sum;

constexpr int kThreads = 128;  // the bf16 kernels' block
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1.0e9f;
constexpr float kNoKeyLse = 0.5f * kNegInf;  // a row's lse at or below this: it kept no key

// The batch row's last key with bias > NEG_INF among [0, n), block-wide
// (-1 if none); `scratch` holds THREADS / 32 ints. All threads must call it.
template <int THREADS = kThreads>
__device__ __forceinline__ int last_kept_key(const float* bias_row, int n, int* scratch) {
  int last = -1;
  for (int j = threadIdx.x; j < n; j += THREADS)
    if (bias_row[j] > kNegInf) last = j;
  last = __reduce_max_sync(0xffffffffu, last);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = last;
  __syncthreads();
  last = scratch[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) last = max(last, scratch[w]);
  return last;
}

// The dK/dV prologue, block-wide (all threads call it; it ends with a
// barrier): returns the batch row's last kept key (sk - 1 without a bias)
// and writes spread[c] = sum of dO[i][c] / Sk over the rows i that keep no
// key. `scratch` holds 2 * THREADS / 32 ints.
template <typename T, int D, int THREADS = kThreads>
__device__ int dkv_prologue(const float* lse_row, const T* dog, const float* bias_row, int sq, int sk,
                            float* spread, int* scratch) {
  constexpr int kW = THREADS / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int no_key = 0;  // does any row keep no key? (block-uniform)
  for (int i = threadIdx.x; i < sq; i += THREADS) no_key |= lse_row[i] <= kNoKeyLse;
  no_key = __any_sync(0xffffffffu, no_key);
  if (lane == 0) scratch[warp] = no_key;
  const int last_kept = bias_row == nullptr ? sk - 1 : last_kept_key<THREADS>(bias_row, sk, scratch + kW);
  __syncthreads();  // scratch (also when last_kept_key did not run)
#pragma unroll
  for (int w = 0; w < kW; ++w) no_key |= scratch[w];
  for (int c = threadIdx.x; c < D; c += THREADS) {
    float sum = 0.f;
    if (no_key)
      for (int i = 0; i < sq; ++i)
        if (lse_row[i] <= kNoKeyLse) sum += to_float(dog[static_cast<size_t>(i) * D + c]);
    spread[c] = sum / static_cast<float>(sk);
  }
  __syncthreads();  // spread
  return last_kept;
}

// ------------------------------------------------------------ float32, CUDA cores (see the note above)
constexpr int kF32Threads = 256;
constexpr int kF32Warps = kF32Threads / 32;
constexpr int kF32Tile = 64;           // dK/dV: keys a block; dQ: q rows a block and keys a staged tile
constexpr int kF32TLd = kF32Tile + 4;  // pitch of the P and dS tiles in shared memory
__host__ __device__ constexpr int f32_ld(int d) { return d + 4; }  // pitch of a staged row, in floats
// dK/dV: q rows a staged tile. At D = 128 two buffers of 64 rows of Q and dO besides K and V would pass
// the 227 KB a block may have; at D <= 64, 32 rows leave room for two blocks an SM.
__host__ __device__ constexpr int dkv_f32_rows(int d) { return d >= 128 ? 48 : 32; }
__host__ __device__ constexpr int dkv_f32_smem_bytes(int d) {
  return 4 * (2 * kF32Tile * f32_ld(d) + 4 * dkv_f32_rows(d) * f32_ld(d) + 2 * dkv_f32_rows(d) * kF32TLd +
              4 * dkv_f32_rows(d) + kF32Tile + d + 2 * kF32Warps);
}
// dQ: keys a staged tile; at D <= 64, 32 leave room for two blocks an SM.
__host__ __device__ constexpr int dq_f32_keys(int d) { return d <= 64 ? 32 : 64; }
__host__ __device__ constexpr int dq_f32_smem_bytes(int d) {
  return 4 * (2 * kF32Tile * f32_ld(d) + 4 * dq_f32_keys(d) * f32_ld(d) + dq_f32_keys(d) * kF32TLd +
              2 * dq_f32_keys(d) + 2 * kF32Tile + kF32Warps);
}

// Phase B's layout: the block's 64 x D outputs (dK and dV: 64 keys; dQ: 64 q rows) over its 256
// threads. Thread tid owns the kPer consecutive tile rows from (tid / kColGroups) kPer and the 16-byte
// column chunks cg, cg + kColGroups, ... (cg = tid % kColGroups) below kChunks; at D = 72, 18 chunks
// over 16 groups, so groups 0 and 1 own two. The 8 lanes of a quarter-warp read one tile row's
// value (a broadcast) and 8 consecutive chunks of a staged row.
template <int D>
struct OutTile {
  static constexpr int kChunks = D / 4;
  static constexpr int kPer = D >= 64 ? 4 : D / 16;
  static constexpr int kColGroups = kF32Threads * kPer / kF32Tile;
  static constexpr int kCpt = (kChunks + kColGroups - 1) / kColGroups;
  __host__ __device__ static constexpr bool chunk_ok(int ch) { return kChunks % kColGroups == 0 || ch < kChunks; }
};

// N consecutive floats of shared memory (p 4N-byte aligned)
template <int N>
__device__ __forceinline__ void lds(float (&out)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x, out[1] = x.y;
  } else {
    out[0] = *p;
  }
}

// acc[i][j] = sum over c in order of a[i][c] b[j][c], one FMA chain an element, where a[i] is the row
// a + i * a_step * LD and b[j] the row b + j * b_step * LD of staged tiles (pitch LD = f32_ld(D)),
// read as float4.
template <int D, int NA, int NB>
__device__ __forceinline__ void tile_dots(float (&acc)[NA][NB], const float* a, int a_step, const float* b,
                                          int b_step) {
  constexpr int kLd = f32_ld(D);
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    float4 x[NA], y[NB];
#pragma unroll
    for (int i = 0; i < NA; ++i) x[i] = *reinterpret_cast<const float4*>(a + i * a_step * kLd + c);
#pragma unroll
    for (int j = 0; j < NB; ++j) y[j] = *reinterpret_cast<const float4*>(b + j * b_step * kLd + c);
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// ROWS rows [r0, r0 + ROWS) of a (n, D) f32 array into a staged tile (pitch f32_ld(D)) by cp.async,
// 16 bytes a copy; rows at or past n as zeros.
template <int D, int ROWS>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int r0, int n) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kF32Threads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool ok = r0 + r < n;
    pgica::cp_async16(pgica::smem_u32(dst + r * f32_ld(D) + c), ok ? src + static_cast<size_t>(r0 + r) * D + c : src,
                      ok);
  }
}

// f32 dK/dV. Dynamic shared memory (floats): K, V [64][LD]; Q[2], dO[2] [R][LD]; P^T and dP^T - delta
// as [R][68] (row-major in the q row); the rows' statistics [2][lse R | delta R]; the key bias [64];
// spread [D]; then 2 * 8 ints of scratch.
template <int D>
__global__ void __launch_bounds__(kF32Threads, D >= 72 ? 1 : 2)
    flash_attn_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                           const float* __restrict__ bias, const float* __restrict__ lse,
                           const float* __restrict__ delta, const float* __restrict__ dout, float* __restrict__ dk,
                           float* __restrict__ dv, int heads, int sq, int sk, int causal, float sm_scale) {
  using Out = OutTile<D>;
  constexpr int kLd = f32_ld(D), kRows = dkv_f32_rows(D), kRowsA = kRows / 8, kRowTile = kRows * kLd;
  extern __shared__ __align__(16) float smem_f[];
  float* k_s = smem_f;
  float* v_s = k_s + kF32Tile * kLd;
  float* q_s = v_s + kF32Tile * kLd;  // [2][kRowTile]
  float* do_s = q_s + 2 * kRowTile;   // [2][kRowTile]
  float* p_s = do_s + 2 * kRowTile;
  float* dp_s = p_s + kRows * kF32TLd;
  float* stat_s = dp_s + kRows * kF32TLd;
  float* b_s = stat_s + 4 * kRows;
  float* spread_s = b_s + kF32Tile;
  int* scratch_s = reinterpret_cast<int*>(spread_s + D);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int bh = blockIdx.x, k0 = blockIdx.y * kF32Tile;
  const size_t q_base = static_cast<size_t>(bh) * sq, k_base = static_cast<size_t>(bh) * sk;
  const float* qg = q + q_base * D;
  const float* dog = dout + q_base * D;
  const float* lse_row = lse + q_base;
  const float* delta_row = delta + q_base;
  const float* bias_row = bias == nullptr ? nullptr : bias + static_cast<size_t>(bh / heads) * sk;
  const int last_kept = dkv_prologue<float, D, kF32Threads>(lse_row, dog, bias_row, sq, sk, spread_s, scratch_s);

  const int og = tid / Out::kColGroups, cg = tid % Out::kColGroups;  // phase B: keys og kPer + i
  float dk_acc[Out::kPer][Out::kCpt][4], dv_acc[Out::kPer][Out::kCpt][4];
#pragma unroll
  for (int i = 0; i < Out::kPer; ++i)
#pragma unroll
    for (int j = 0; j < Out::kCpt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[i][j][e] = dv_acc[i][j][e] = 0.f;

  const int q_first = causal ? k0 : 0;  // under `causal` no row above the tile's diagonal keeps a key
  if (k0 <= last_kept && q_first < sq) {  // block-uniform
    const int kv_end = min(sk, last_kept + 1);
    const int n_tiles = (sq - q_first + kRows - 1) / kRows;
    // thread t < R: lse of the tile's row t (NEG_INF past sq: p = 0); R <= t < 2R: delta of row t - R
    auto row_stat = [&](int r0) {
      const int r = r0 + (tid < kRows ? tid : tid - kRows);
      if (tid < kRows) return r < sq ? lse_row[r] : kNegInf;
      return r < sq ? delta_row[r] : 0.f;
    };
    stage_f32<D, kF32Tile>(k_s, k + k_base * D, k0, kv_end);
    stage_f32<D, kF32Tile>(v_s, v + k_base * D, k0, kv_end);
    stage_f32<D, kRows>(q_s, qg, q_first, sq);
    stage_f32<D, kRows>(do_s, dog, q_first, sq);
    pgica::cp_async_commit();
    if (tid < kF32Tile) {
      const int key = k0 + tid;  // a key past kv_end is masked
      b_s[tid] = key >= kv_end ? 2.f * kNegInf : bias_row == nullptr ? 0.f : bias_row[key];
    }
    if (tid < 2 * kRows) stat_s[tid] = row_stat(q_first);

    // phase A: threads 0-127 S^T = K Q^T, 128-255 dP^T = V dO^T, keys 4 kg + i x rows rg + 8 j
    const int grp = tid >> 7, kg = (tid & 127) >> 3, rg = tid & 7;
    const int key_a = k0 + 16 * ((tid & 127) >> 5);  // the first of this warp's 16 keys
    const float* keys_s = (grp == 0 ? k_s : v_s) + 4 * kg * kLd;
    float* out_s = (grp == 0 ? p_s : dp_s) + 4 * kg;
    for (int t = 0; t < n_tiles; ++t) {
      const int buf = t & 1, row0 = q_first + t * kRows;
      pgica::cp_async_wait<0>();
      __syncthreads();  // tile t is in place (the first time K, V, b_s, stat_s too); tile t - 1 is consumed
      float next_stat = 0.f;
      if (t + 1 < n_tiles) {  // the next tile's copies fly while this one is computed
        stage_f32<D, kRows>(q_s + (buf ^ 1) * kRowTile, qg, row0 + kRows, sq);
        stage_f32<D, kRows>(do_s + (buf ^ 1) * kRowTile, dog, row0 + kRows, sq);
        pgica::cp_async_commit();
        if (tid < 2 * kRows) next_stat = row_stat(row0 + kRows);
      }
      const float* qt = q_s + buf * kRowTile;
      const float* dot = do_s + buf * kRowTile;
      const float* lse_t = stat_s + buf * 2 * kRows;
      const float* delta_t = lse_t + kRows;

      float acc[4][kRowsA];
      if (causal && row0 + kRows - 1 < key_a) {  // warp-uniform: every row above every key, p = 0
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kRowsA; ++j) acc[i][j] = 0.f;
      } else {
        tile_dots<D, 4, kRowsA>(acc, keys_s, 1, (grp == 0 ? qt : dot) + rg * kLd, 8);
      }
#pragma unroll
      for (int j = 0; j < kRowsA; ++j) {
        const int rl = rg + 8 * j;  // row in the tile
        float x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (grp == 0) {  // P^T, 0 where the key or the causal entry is masked or the row keeps no key
            const int kl = 4 * kg + i;
            const float b = b_s[kl], row_lse = lse_t[rl];
            const bool keep = b > kNegInf && row_lse > kNoKeyLse && (!causal || row0 + rl >= k0 + kl);
            x[i] = keep ? expf(acc[i][j] * sm_scale + b - row_lse) : 0.f;
          } else {
            x[i] = acc[i][j] - delta_t[rl];
          }
        }
        *reinterpret_cast<float4*>(out_s + rl * kF32TLd) = make_float4(x[0], x[1], x[2], x[3]);
      }
      if (t + 1 < n_tiles && tid < 2 * kRows) stat_s[(buf ^ 1) * 2 * kRows + tid] = next_stat;  // read last in t - 1
      __syncthreads();  // P^T and dP^T - delta are in place

      // phase B: dV += P^T dO and dK += dS^T Q over the tile's rows, dS^T = P^T (dP^T - delta); rows
      // above every key of the warp (its first is k0 + 8 warp) and past sq add nothing
      const int r_begin = causal ? max(0, k0 + 8 * warp - row0) : 0;
      const int r_end = min(kRows, sq - row0);
      for (int r = r_begin; r < r_end; ++r) {
        float p[Out::kPer], ds[Out::kPer];
        lds(p, p_s + r * kF32TLd + og * Out::kPer);
        lds(ds, dp_s + r * kF32TLd + og * Out::kPer);
#pragma unroll
        for (int i = 0; i < Out::kPer; ++i) ds[i] *= p[i];
#pragma unroll
        for (int j = 0; j < Out::kCpt; ++j) {
          const int ch = cg + j * Out::kColGroups;
          if (!Out::chunk_ok(ch)) continue;
          const float4 g = *reinterpret_cast<const float4*>(dot + r * kLd + 4 * ch);
          const float4 x = *reinterpret_cast<const float4*>(qt + r * kLd + 4 * ch);
#pragma unroll
          for (int i = 0; i < Out::kPer; ++i) {
            dv_acc[i][j][0] = fmaf(p[i], g.x, dv_acc[i][j][0]);
            dv_acc[i][j][1] = fmaf(p[i], g.y, dv_acc[i][j][1]);
            dv_acc[i][j][2] = fmaf(p[i], g.z, dv_acc[i][j][2]);
            dv_acc[i][j][3] = fmaf(p[i], g.w, dv_acc[i][j][3]);
            dk_acc[i][j][0] = fmaf(ds[i], x.x, dk_acc[i][j][0]);
            dk_acc[i][j][1] = fmaf(ds[i], x.y, dk_acc[i][j][1]);
            dk_acc[i][j][2] = fmaf(ds[i], x.z, dk_acc[i][j][2]);
            dk_acc[i][j][3] = fmaf(ds[i], x.w, dk_acc[i][j][3]);
          }
        }
      }
    }
  }

  // dk = sm_scale * acc, dv = acc + spread
#pragma unroll
  for (int i = 0; i < Out::kPer; ++i) {
    const int key = k0 + og * Out::kPer + i;
    if (key >= sk) continue;
    const size_t row = (k_base + key) * D;
#pragma unroll
    for (int j = 0; j < Out::kCpt; ++j) {
      const int ch = cg + j * Out::kColGroups;
      if (!Out::chunk_ok(ch)) continue;
      const int c = 4 * ch;
      *reinterpret_cast<float4*>(dk + row + c) = make_float4(dk_acc[i][j][0] * sm_scale, dk_acc[i][j][1] * sm_scale,
                                                             dk_acc[i][j][2] * sm_scale, dk_acc[i][j][3] * sm_scale);
      *reinterpret_cast<float4*>(dv + row + c) =
          make_float4(dv_acc[i][j][0] + spread_s[c], dv_acc[i][j][1] + spread_s[c + 1],
                      dv_acc[i][j][2] + spread_s[c + 2], dv_acc[i][j][3] + spread_s[c + 3]);
    }
  }
}

// f32 dQ. Dynamic shared memory (floats): Q, dO [64][LD]; buffers 0 and 1 of K and V, [KT][LD] each,
// K then V (O's 64 rows pass through buffer 1 before the walk); dS as [KT keys][68]; the key bias
// [2][KT]; lse, delta [64]; then 8 ints of scratch. KT = dq_f32_keys(D).
template <int D>
__global__ void __launch_bounds__(kF32Threads, D <= 64 ? 2 : 1)
    flash_attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                          const float* __restrict__ bias, const float* __restrict__ o, const float* __restrict__ lse,
                          const float* __restrict__ dout, float* __restrict__ dq, float* __restrict__ delta,
                          int heads, int sq, int sk, int causal, float sm_scale) {
  using Out = OutTile<D>;
  constexpr int kLd = f32_ld(D), kTile = kF32Tile * kLd;
  constexpr int kKeys = dq_f32_keys(D), kKeysA = kKeys / 8, kKTile = kKeys * kLd;
  extern __shared__ __align__(16) float smem_f[];
  float* q_s = smem_f;
  float* do_s = q_s + kTile;
  float* kv_s = do_s + kTile;  // buffer b: K at kv_s + 2 b kKTile, V kKTile after it
  float* ds_s = kv_s + 4 * kKTile;
  float* b_s = ds_s + kKeys * kF32TLd;  // [2][kKeys]
  float* lse_s = b_s + 2 * kKeys;
  float* delta_s = lse_s + kF32Tile;
  int* scratch_s = reinterpret_cast<int*>(delta_s + kF32Tile);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32Tile;  // under `causal` the longest walks start first
  const size_t q_base = static_cast<size_t>(bh) * sq;
  const float* kg = k + static_cast<size_t>(bh) * sk * D;
  const float* vg = v + static_cast<size_t>(bh) * sk * D;
  const float* bias_row = bias == nullptr ? nullptr : bias + static_cast<size_t>(bh / heads) * sk;

  float* o_s = kv_s + 2 * kKTile;  // buffer 1 (2 kKeys >= 64 rows), free until the walk's first prefetch
  stage_f32<D, kF32Tile>(q_s, q + q_base * D, q0, sq);
  stage_f32<D, kF32Tile>(do_s, dout + q_base * D, q0, sq);
  stage_f32<D, kF32Tile>(o_s, o + q_base * D, q0, sq);
  pgica::cp_async_commit();

  const int q_end = min(q0 + kF32Tile, sq);
  int kv_end = causal ? min(sk, q_end) : sk;  // rows >= cols: cols < q_end suffice
  if (bias_row != nullptr) kv_end = min(kv_end, last_kept_key<kF32Threads>(bias_row, sk, scratch_s) + 1);
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;
  // key tile [k0, k0 + KT) into buffer buf; a key past kv_end is masked, whatever its bias
  auto stage_keys = [&](int buf, int k0) {
    stage_f32<D, kKeys>(kv_s + 2 * buf * kKTile, kg, k0, kv_end);
    stage_f32<D, kKeys>(kv_s + (2 * buf + 1) * kKTile, vg, k0, kv_end);
    if (tid < kKeys) {
      const int key = k0 + tid;
      b_s[buf * kKeys + tid] = key >= kv_end ? 2.f * kNegInf : bias_row == nullptr ? 0.f : bias_row[key];
    }
  };
  if (n_tiles > 0) stage_keys(0, 0);
  pgica::cp_async_commit();
  pgica::cp_async_wait<1>();
  __syncthreads();  // Q, dO and O are in place

  // delta = rowsum(dO O): warp w sums rows w, w + 8, ... (lane-strided partials, then the butterfly)
  for (int r = warp; r < kF32Tile; r += kF32Warps) {
    float part = 0.f;
    for (int c = lane; c < D; c += 32) part = fmaf(do_s[r * kLd + c], o_s[r * kLd + c], part);
    const float sum = warp_sum(part);
    if (lane == 0) {
      delta_s[r] = sum;
      if (q0 + r < sq) delta[q_base + q0 + r] = sum;
    }
  }
  if (tid < kF32Tile) lse_s[tid] = q0 + tid < sq ? lse[q_base + q0 + tid] : kNegInf;  // past sq: p = 0

  const int og = tid / Out::kColGroups, cg = tid % Out::kColGroups;  // phase B: rows og kPer + i
  float acc[Out::kPer][Out::kCpt][4];
#pragma unroll
  for (int i = 0; i < Out::kPer; ++i)
#pragma unroll
    for (int j = 0; j < Out::kCpt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // phase A: threads 0-127 S = Q K^T, 128-255 dP = dO V^T, rows rg + 16 i x keys kg + 8 j
  const int grp = tid >> 7, kg8 = tid & 7, rg = (tid & 127) >> 3;
  const float* rows_s = (grp == 0 ? q_s : do_s) + rg * kLd;
  const int row_w_last = q0 + 8 * warp + 7;  // phase B: the last of this warp's 8 rows
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1, k0 = t * kKeys;
    pgica::cp_async_wait<0>();
    __syncthreads();  // tile t is in place; tile t - 1 (and O, the first time) is consumed
    if (t + 1 < n_tiles) {  // the next tile's copies fly while this one is computed
      stage_keys(buf ^ 1, k0 + kKeys);
      pgica::cp_async_commit();
    }
    const float* kt = kv_s + 2 * buf * kKTile;
    const float* bt = b_s + buf * kKeys;

    float sa[4][kKeysA];
    tile_dots<D, 4, kKeysA>(sa, rows_s, 16, (grp == 0 ? kt : kt + kKTile) + kg8 * kLd, 8);
    if (grp == 0) {  // P in place of S, 0 where the key or the causal entry is masked or the row keeps no key
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kKeysA; ++j) {
          const int rl = rg + 16 * i, kl = kg8 + 8 * j;
          const float b = bt[kl], row_lse = lse_s[rl];
          const bool keep = b > kNegInf && row_lse > kNoKeyLse && (!causal || q0 + rl >= k0 + kl);
          sa[i][j] = keep ? expf(sa[i][j] * sm_scale + b - row_lse) : 0.f;
        }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kKeysA; ++j) ds_s[(kg8 + 8 * j) * kF32TLd + rg + 16 * i] = sa[i][j] - delta_s[rg + 16 * i];
    }
    __syncthreads();  // dP - delta is in place
    if (grp == 0) {  // dS = P (dP - delta)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kKeysA; ++j) {
          float& x = ds_s[(kg8 + 8 * j) * kF32TLd + rg + 16 * i];
          x = sa[i][j] * x;
        }
    }
    __syncthreads();  // dS is in place

    // phase B: dQ += dS K over the tile's keys; keys past kv_end or after every row of the warp add nothing
    const int kk_end = min(min(kKeys, kv_end - k0), causal ? row_w_last - k0 + 1 : kKeys);
    for (int kk = 0; kk < kk_end; ++kk) {
      float ds[Out::kPer];
      lds(ds, ds_s + kk * kF32TLd + og * Out::kPer);
#pragma unroll
      for (int j = 0; j < Out::kCpt; ++j) {
        const int ch = cg + j * Out::kColGroups;
        if (!Out::chunk_ok(ch)) continue;
        const float4 x = *reinterpret_cast<const float4*>(kt + kk * kLd + 4 * ch);
#pragma unroll
        for (int i = 0; i < Out::kPer; ++i) {
          acc[i][j][0] = fmaf(ds[i], x.x, acc[i][j][0]);
          acc[i][j][1] = fmaf(ds[i], x.y, acc[i][j][1]);
          acc[i][j][2] = fmaf(ds[i], x.z, acc[i][j][2]);
          acc[i][j][3] = fmaf(ds[i], x.w, acc[i][j][3]);
        }
      }
    }
  }
  pgica::cp_async_wait<0>();

  // dq = sm_scale * acc
#pragma unroll
  for (int i = 0; i < Out::kPer; ++i) {
    const int row = q0 + og * Out::kPer + i;
    if (row >= sq) continue;
    float* dqrow = dq + (q_base + row) * D;
#pragma unroll
    for (int j = 0; j < Out::kCpt; ++j) {
      const int ch = cg + j * Out::kColGroups;
      if (!Out::chunk_ok(ch)) continue;
      *reinterpret_cast<float4*>(dqrow + 4 * ch) = make_float4(acc[i][j][0] * sm_scale, acc[i][j][1] * sm_scale,
                                                               acc[i][j][2] * sm_scale, acc[i][j][3] * sm_scale);
    }
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

template <int D>
int launch_dq_f32(const void* q, const void* k, const void* v, const void* bias, const void* o, const void* lse,
                  const void* dout, void* dq, void* delta, int bh, int heads, int sq, int sk, int causal,
                  float sm_scale, cudaStream_t stream) {
  constexpr int kSmem = dq_f32_smem_bytes(D);
  static const cudaError_t attr =  // once per instance: above 48 KB, dynamic shared memory must be asked for
      cudaFuncSetAttribute(flash_attn_bwd_dq_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(bh, (sq + kF32Tile - 1) / kF32Tile);
  flash_attn_bwd_dq_f32<D><<<grid, kF32Threads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<const float*>(o), static_cast<const float*>(lse),
      static_cast<const float*>(dout), static_cast<float*>(dq), static_cast<float*>(delta), heads, sq, sk, causal,
      sm_scale);
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

int launch_dq(const void* q, const void* k, const void* v, const void* bias, const void* o, const void* lse,
              const void* dout, void* dq, void* delta, int bh, int heads, int sq, int sk, int head_dim, int causal,
              float sm_scale, int dtype, cudaStream_t stream) {
  const bool f32 = dtype == pgica::kFloat32;
  switch (head_dim) {
#define PGICA_DQ_CASE(DIM)                                                                                   \
  case DIM:                                                                                                  \
    return f32 ? launch_dq_f32<DIM>(q, k, v, bias, o, lse, dout, dq, delta, bh, heads, sq, sk, causal, sm_scale, \
                                    stream)                                                                  \
               : launch_dq_tc<DIM>(q, k, v, bias, o, lse, dout, dq, delta, bh, heads, sq, sk, causal, sm_scale,  \
                                   stream);
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

template <int D>
int launch_dkv_f32(const void* q, const void* k, const void* v, const void* bias, const void* lse,
                   const void* delta, const void* dout, void* dk, void* dv, int bh, int heads, int sq, int sk,
                   int causal, float sm_scale, cudaStream_t stream) {
  constexpr int kSmem = dkv_f32_smem_bytes(D);
  static const cudaError_t attr =  // once per instance: above 48 KB, dynamic shared memory must be asked for
      cudaFuncSetAttribute(flash_attn_bwd_dkv_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(bh, (sk + kF32Tile - 1) / kF32Tile);
  flash_attn_bwd_dkv_f32<D><<<grid, kF32Threads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(dout), static_cast<float*>(dk), static_cast<float*>(dv), heads, sq, sk, causal,
      sm_scale);
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

int launch_dkv(const void* q, const void* k, const void* v, const void* bias, const void* lse, const void* delta,
               const void* dout, void* dk, void* dv, int bh, int heads, int sq, int sk, int head_dim, int causal,
               float sm_scale, int dtype, cudaStream_t stream) {
  const bool f32 = dtype == pgica::kFloat32;
  switch (head_dim) {
#define PGICA_DKV_CASE(DIM)                                                                                      \
  case DIM:                                                                                                      \
    return f32 ? launch_dkv_f32<DIM>(q, k, v, bias, lse, delta, dout, dk, dv, bh, heads, sq, sk, causal, sm_scale, \
                                     stream)                                                                     \
               : launch_dkv_tc<DIM>(q, k, v, bias, lse, delta, dout, dk, dv, bh, heads, sq, sk, causal, sm_scale,  \
                                    stream);
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
         sq > 65535 * kTcRows || sk > 65535 * kTcKeys;  // grid.y: 64 rows or keys a block
}

}  // namespace

// q, o, dout, dq: (bh, sq, head_dim); k, v: (bh, sk, head_dim), contiguous in
// `dtype`; bias: (bh / heads, sk) f32 or NULL; lse, delta: (bh, sq) f32.
// Writes dq and delta = rowsum(dout * o): bf16 on the tensor cores
// (flash_attn_bwd_dq_tc), f32 on the CUDA cores (flash_attn_bwd_dq_f32).
// Returns a cudaError_t code.
extern "C" int pgica_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* bias, const void* o, const void* lse,
                                       const void* dout, void* dq, void* delta, int bh, int heads,
                                       int sq, int sk, int head_dim, int causal, float sm_scale,
                                       int dtype, void* stream) {
  if (bad_shape(bh, heads, sq, sk) || (dtype != pgica::kFloat32 && dtype != pgica::kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_dq(q, k, v, bias, o, lse, dout, dq, delta, bh, heads, sq, sk, head_dim, causal, sm_scale, dtype,
                   static_cast<cudaStream_t>(stream));
}

// As above, with delta from pgica_flash_attn_bwd_dq; writes dk and dv
// (bh, sk, head_dim) in `dtype`: bf16 on the tensor cores
// (flash_attn_bwd_dkv_tc), f32 on the CUDA cores (flash_attn_bwd_dkv_f32).
// Returns a cudaError_t code.
extern "C" int pgica_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* bias, const void* lse, const void* delta,
                                        const void* dout, void* dk, void* dv, int bh, int heads,
                                        int sq, int sk, int head_dim, int causal, float sm_scale,
                                        int dtype, void* stream) {
  if (bad_shape(bh, heads, sq, sk) || (dtype != pgica::kFloat32 && dtype != pgica::kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_dkv(q, k, v, bias, lse, delta, dout, dk, dv, bh, heads, sq, sk, head_dim, causal, sm_scale, dtype,
                    static_cast<cudaStream_t>(stream));
}
