// Fused linear + cross-entropy, backward (dh and dW), on Hopper's tensor cores (sm_90a).
//
// Replaces: pgica_tpu/ops/fused_ce.py:108 `_bwd_dh_kernel` and :134
// `_bwd_dw_kernel` (Pallas, TPU). With the scores s = h W^T (N x V), the
// forward's saved lse, p = exp(s - lse), onehot[r, v] = (v == y[r]) and the
// cotangent g of logp:
//   dh = g * ((onehot - p) @ W)          in h's dtype
//   dW = ((onehot - p) * g)^T @ h        in W's dtype
// h (N, d) and W (V, d) are each f32 or bf16 (all four pairs).
//
// What bounds them on the H100: operations. Each is two N x V x d products
// (the scores, then coefficients x W or x h): 4 N V d flops, 4.3 TFLOP at the
// Llama stage-2 shape (N = 2,044, d = 4,096, V = 128,256), 4.3 ms at the bf16
// tensor-core peak; the bytes (W once, ~2 GB in f32) take 0.6 ms.
//
// Design: every score is computed once per kernel. The TPU kernels keep an
// accumulator in VMEM across their grid (dh: rows x d; dW: a vocab block x d
// over the rows); here the vocab is walked in chunks of `chunk` columns (a
// multiple of 128, planned by ops/fused_ce.py so that the coefficient
// scratch stays <= 256 MiB), each chunk in two GEMM launches:
//   dh 1. coefficients: C = onehot - exp(h W[chunk]^T - lse) (N x chunk),
//         with the `cols < vocab` guard, into a bf16 scratch (2 parts);
//      2. product: acc (N x d, f32 scratch) += C @ W[chunk], chunk after
//         chunk in vocab order, one block per output tile: no split-K, no
//         atomics, so dh is the same from run to run. The last chunk's
//         epilogue is the TPU kernel's finish, dh = (acc * g).astype(h.dtype).
//   dW 1. coefficients, roles swapped: W[chunk] is A and h is B, and the
//         GEMM writes C^T = (g (onehot - p))^T (chunk x N, K-major in the
//         rows), the vocab guard on its M dimension;
//      2. product: dW[chunk] = C^T @ h, h read row-major (ldmatrix.trans) as
//         dh's product reads W. The K loop runs over the rows, so each output
//         tile is complete after one pass: no cross-chunk sums, no split-K,
//         no atomics; dW is the same from run to run.
// One C call runs the whole loop, so each wrapper counts one launch. All four
// GEMMs, and the forward's score GEMM (fused_ce.cu), are one template
// (fce_gemm.cuh: 128 x 128 x 32 block tiles, mma.sync fed by ldmatrix from
// a cp.async ring). The products read W (dh) and h (dW) row-major: neither
// is copied transposed or padded (rows past the end stage as zeros).
//
// Rows with g = 0 (masked caption positions). dh: a 128-row tile whose g are
// all 0 skips both GEMMs and writes exact zeros; a row with g = 0 inside a
// live tile gets C = 0, so its dh is exactly 0. dW: the wrapper hands the
// kernel the rows reordered, those with g != 0 first in their order, and the
// count of them in device memory (no host sync); the kernel reads the count,
// skips the score tiles past it and ends the product's K loop there. The
// tensor cores sum a k tile's terms by position, so masked rows left between
// live ones would regroup the live rows' sums: with them moved behind, dW
// over all rows is bit-identical to dW over the live rows alone
// (chip_smoke.py checks it), and masked rows cost no work.
//
// Precision, the hard part. chip_smoke.py holds each element to 1e-4 of its
// own sum of |terms| (sum_v |C[r, v]| |W[v, j]| for dh, sum_r |C[r, v]|
// |h[r, j]| for dW) against the f32 plain version. Two things make that hard:
// * The products. The target's term (1 - p_y) W[y, j] is most of a dh
//   element's sum, so rounding W to bf16 (up to 2^-9 of it, typically
//   ~2^-10) alone misses the bound by 10x or more; in dW a row's C[r, y]
//   likewise dominates its terms, and C rounded once to bf16 misses too.
// * The scores. lse is the forward's, fixed: a score off by e moves p_y by
//   p_y e and C[r, y] = 1 - p_y by the same, while the bound scales with
//   1 - p_y. At a row whose target takes p_y = 0.995 (trained weights
//   peak so; random ones are flat and their errors cancel over the vocab)
//   the scores need f32's own accuracy.
// So an f32 operand goes in as bf16 parts, the passes of fce_gemm.cuh:
//   scores  (ORDER 3, f32 operands in 3 parts): both bf16 1 pass; h bf16
//           and the f32 master W (the policy's pair) 3 passes, h.W0 + h.W1
//           + h.W2; h f32 and W bf16 3; both f32 6. Dropped terms ~2^-24:
//           the scores are as exact as an f32 sum.
//   product (ORDER 2, 2 parts: C is f32 always, and the other operand's
//           first two parts): that operand bf16 2 passes, C0.X + C1.X; f32
//           3, C0.X0 + C0.X1 + C1.X0 (X = W for dh, h for dW). Each dropped
//           part is ~2^-16 of its term: an element moves by < ~2e-5 of its
//           sum of |terms|, plus the f32 sums' own rounding (kept
//           round-to-nearest: see `mainloop`).
// tests/test_torch_fused_ce.py emulates these passes on the CPU at a
// Llama-like d and W scale and holds them to the bound with p flat and
// peaked; it shows that W rounded once to bf16 in dh's product, C rounded
// once in dW's, or W in two parts in the scores at a sharp peak, breaks it.
// The f32 operands are split once per call into bf16 scratch by
// `split_bf16` (W: 3 x 1.05 GB at Llama; h: 3 x 17 MB), allocated by the
// wrapper.
#include "fce_gemm.cuh"

#include <algorithm>
#include <cstdint>

namespace {

using namespace pgica::fce;
using pgica::from_float;

constexpr int kProductOrder = 2;  // passes i + j < 2: C and W in 2 parts

// Whether any of the block's 128 rows has g != 0 (block-wide, all threads).
__device__ __forceinline__ bool tile_live(const float* g, int m0, int m) {
  const int r = m0 + static_cast<int>(threadIdx.x);
  return __syncthreads_or(threadIdx.x < kBM && r < m && g[r] != 0.f) != 0;
}

// dh, step 1 of a chunk: coefficients C[r, v - v0] = onehot - p for the chunk's
// columns; 0 for a row with g = 0 and for a column past V. Grid (row
// tiles, column tiles of the chunk).
template <int PH, int PW>
__global__ void __launch_bounds__(kGemmThreads) fused_ce_dh_coeff(const Gemm p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  if (!tile_live(p.g, m0, p.m)) return;  // the product skips this tile too: nothing reads it
  float acc[4][4][4];
  mainloop<PH, PW, kScoreOrder, true>(p, m0, n0, p.k, p.a_k_valid, reinterpret_cast<bf16*>(smem_raw), acc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm * 64 + mt * 16 + (lane >> 2) + 8 * half;
      if (r >= p.m) continue;
      const bool live = p.g[r] != 0.f;
      const int y = p.y[r];
      const float lse = p.lse[r];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;  // column in the chunk; c + 1 < chunk too
        if (c >= p.ldc) continue;
        float x0[2], x1[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int v = p.v0 + c + j;
          const float x = live && v < p.vocab
                              ? (v == y ? 1.f : 0.f) - expf(acc[mt][nt][2 * half + j] - lse)
                              : 0.f;
          x0[j] = __bfloat162float(__float2bfloat16(x));
          x1[j] = x - x0[j];
        }
        const size_t at = static_cast<size_t>(r) * p.ldc + c;
        *reinterpret_cast<uint32_t*>(p.c0 + at) = pgica::pack_bf16x2(x0[0], x0[1]);
        *reinterpret_cast<uint32_t*>(p.c1 + at) = pgica::pack_bf16x2(x1[0], x1[1]);
      }
    }
}

// dh, step 2 of a chunk: acc += C @ W[chunk]; the last chunk writes dh = acc * g.
// Grid (row tiles, column tiles of d).
template <typename TH, int PW>
__global__ void __launch_bounds__(kGemmThreads) fused_ce_dh_product(const Gemm p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  TH* dh = static_cast<TH*>(p.out);
  float acc[4][4][4];
  const bool live = tile_live(p.g, m0, p.m);
  if (live) {
    mainloop<2, PW, kProductOrder, false>(p, m0, n0, p.k, p.a_k_valid, reinterpret_cast<bf16*>(smem_raw), acc);
  } else {
    if (!p.last) return;  // every row has g = 0: dh is 0, written once
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm * 64 + mt * 16 + (lane >> 2) + 8 * half;
      if (r >= p.m) continue;
      const float g = p.g[r];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;  // d % 8 == 0: c + 1 < d too
        if (c >= p.n) continue;
        const size_t at = static_cast<size_t>(r) * p.n + c;
        float2 t = make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        if (live && !p.first) {
          const float2 before = *reinterpret_cast<const float2*>(p.acc + at);
          t = make_float2(before.x + t.x, before.y + t.y);
        }
        if (p.last) {
          dh[at] = from_float<TH>(t.x * g);
          dh[at + 1] = from_float<TH>(t.y * g);
        } else {
          *reinterpret_cast<float2*>(p.acc + at) = t;
        }
      }
    }
}

// dW, step 1 of a chunk: C^T[v - v0, r] = g[r] (onehot - p) for the chunk's
// vocab rows (M) and the rows (N); 0 for a row at or past the live count, up
// to ldc. Grid (vocab tiles of the chunk, row tiles).
template <int PW, int PH>
__global__ void __launch_bounds__(kGemmThreads) fused_ce_dw_coeff(const Gemm p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int live = *p.live;
  if (n0 >= live) return;  // block-uniform; n0 % 8 == 0, so the zeros up to live's next 8 lie in an earlier tile
  float acc[4][4][4];
  mainloop<PW, PH, kScoreOrder, true>(p, m0, n0, p.k, p.a_k_valid, reinterpret_cast<bf16*>(smem_raw), acc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + mt * 16 + (lane >> 2) + 8 * half;  // vocab row in the chunk
      if (m >= p.m) continue;
      const int v = p.v0 + m;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;  // row of h; ldc % 8 == 0: c + 1 < ldc too
        if (c >= p.ldc) continue;
        float x0[2], x1[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = c + j;
          float x = 0.f;
          if (r < live) x = p.g[r] * ((v == p.y[r] ? 1.f : 0.f) - expf(acc[mt][nt][2 * half + j] - p.lse[r]));
          x0[j] = __bfloat162float(__float2bfloat16(x));
          x1[j] = x - x0[j];
        }
        const size_t at = static_cast<size_t>(m) * p.ldc + c;
        *reinterpret_cast<uint32_t*>(p.c0 + at) = pgica::pack_bf16x2(x0[0], x0[1]);
        *reinterpret_cast<uint32_t*>(p.c1 + at) = pgica::pack_bf16x2(x1[0], x1[1]);
      }
    }
}

// dW, step 2 of a chunk: dW[v0 + m] = C^T[m] @ h over the live rows, written
// in W's dtype. Grid (vocab tiles of the chunk, column tiles of d).
template <typename TW, int PH>
__global__ void __launch_bounds__(kGemmThreads) fused_ce_dw_product(const Gemm p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int live = *p.live;
  float acc[4][4][4];
  // step 1 wrote C^T zeros from `live` up to the next multiple of 8
  mainloop<2, PH, kProductOrder, false>(p, m0, n0, live, (live + 7) / 8 * 8, reinterpret_cast<bf16*>(smem_raw), acc);
  TW* dw = static_cast<TW*>(p.out);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + mt * 16 + (lane >> 2) + 8 * half;
      if (m >= p.m) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;  // d % 8 == 0: c + 1 < d too
        if (c >= p.n) continue;
        const size_t at = static_cast<size_t>(p.v0 + m) * p.n + c;
        dw[at] = from_float<TW>(acc[mt][nt][2 * half]);
        dw[at + 1] = from_float<TW>(acc[mt][nt][2 * half + 1]);
      }
    }
}

Operand offset_rows(const Operand& o, int rows) {
  Operand out = o;
  for (auto& part : out.part)
    if (part != nullptr) part += static_cast<size_t>(rows) * o.ld;
  return out;
}

// PH, PW: parts of h and W (1 for bf16, kMaxParts for f32).
template <typename TH, int PH, int PW>
int run_dh(const void* h, const void* w, const int* y, const float* lse, const float* g, void* dh, void* h_split,
        void* w_split, void* coeff, float* acc, int n, int vocab, int d, int chunk, cudaStream_t stream) {
  constexpr int kPwProduct = PW > 1 ? 2 : 1;
  constexpr int kCoeffSmem = Smem<PH, PW, true>::kBytes;
  constexpr int kProductSmem = Smem<2, kPwProduct, false>::kBytes;
  static const cudaError_t attr = [] {  // once per instance
    const cudaError_t e = allow_smem(fused_ce_dh_coeff<PH, PW>, kCoeffSmem);
    return e != cudaSuccess ? e : allow_smem(fused_ce_dh_product<TH, kPwProduct>, kProductSmem);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Operand hb = as_bf16(h, PH > 1, h_split, static_cast<size_t>(n) * d, d, stream);
  const Operand wb = as_bf16(w, PW > 1, w_split, static_cast<size_t>(vocab) * d, d, stream);
  auto* c0 = static_cast<bf16*>(coeff);
  bf16* c1 = c0 + static_cast<size_t>(n) * chunk;
  const int row_tiles = (n + kBM - 1) / kBM;
  for (int v0 = 0; v0 < vocab; v0 += chunk) {
    const int width = std::min(chunk, vocab - v0);
    Gemm p{};
    p.y = y;
    p.lse = lse;
    p.g = g;
    p.v0 = v0;
    p.vocab = vocab;
    p.c0 = c0;
    p.c1 = c1;
    p.ldc = chunk;
    p.acc = acc;
    p.out = dh;
    p.first = v0 == 0;
    p.last = v0 + chunk >= vocab;
    // 1. C (n x width) = onehot - exp(h W[chunk]^T - lse)
    p.a = hb;
    p.b = offset_rows(wb, v0);
    p.m = n;
    p.n = width;
    p.k = d;
    p.a_k_valid = d;
    fused_ce_dh_coeff<PH, PW><<<dim3(row_tiles, (width + kBN - 1) / kBN), kGemmThreads, kCoeffSmem, stream>>>(p);
    // 2. acc (n x d) += C @ W[chunk]
    p.a = Operand{{c0, c1, nullptr}, chunk};
    p.m = n;
    p.n = d;
    p.k = width;
    p.a_k_valid = (width + 7) / 8 * 8;  // the coefficient tiles wrote zeros up to here
    fused_ce_dh_product<TH, kPwProduct>
        <<<dim3(row_tiles, (d + kBN - 1) / kBN), kGemmThreads, kProductSmem, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TW, int PH, int PW>
int run_dw(const void* h, const void* w, const int* y, const float* lse, const float* g, const int* live, void* dw,
           void* h_split, void* w_split, void* coeff, int n, int vocab, int d, int chunk, cudaStream_t stream) {
  constexpr int kPhProduct = PH > 1 ? 2 : 1;
  constexpr int kCoeffSmem = Smem<PW, PH, true>::kBytes;
  constexpr int kProductSmem = Smem<2, kPhProduct, false>::kBytes;
  static const cudaError_t attr = [] {  // once per instance
    const cudaError_t e = allow_smem(fused_ce_dw_coeff<PW, PH>, kCoeffSmem);
    return e != cudaSuccess ? e : allow_smem(fused_ce_dw_product<TW, kPhProduct>, kProductSmem);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Operand hb = as_bf16(h, PH > 1, h_split, static_cast<size_t>(n) * d, d, stream);
  const Operand wb = as_bf16(w, PW > 1, w_split, static_cast<size_t>(vocab) * d, d, stream);
  const int ldc = (n + 7) / 8 * 8;
  auto* c0 = static_cast<bf16*>(coeff);
  bf16* c1 = c0 + static_cast<size_t>(chunk) * ldc;
  for (int v0 = 0; v0 < vocab; v0 += chunk) {
    const int width = std::min(chunk, vocab - v0);
    const int vocab_tiles = (width + kBM - 1) / kBM;
    Gemm p{};
    p.y = y;
    p.lse = lse;
    p.g = g;
    p.live = live;
    p.v0 = v0;
    p.vocab = vocab;
    p.c0 = c0;
    p.c1 = c1;
    p.ldc = ldc;
    p.out = dw;
    // 1. C^T (width x n) = (g (onehot - exp(h W[chunk]^T - lse)))^T
    p.a = offset_rows(wb, v0);
    p.b = hb;
    p.m = width;
    p.n = n;
    p.k = d;
    p.a_k_valid = d;
    fused_ce_dw_coeff<PW, PH><<<dim3(vocab_tiles, (n + kBN - 1) / kBN), kGemmThreads, kCoeffSmem, stream>>>(p);
    // 2. dW[chunk] (width x d) = C^T @ h
    p.a = Operand{{c0, c1, nullptr}, ldc};
    p.n = d;
    fused_ce_dw_product<TW, kPhProduct>
        <<<dim3(vocab_tiles, (d + kBN - 1) / kBN), kGemmThreads, kProductSmem, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h: (n, d) in h_dtype; w: (vocab, d) in w_dtype; y: (n,) int32; lse, g: (n,)
// f32; dh: (n, d) in h_dtype. Scratch, allocated by the caller:
// h_split: 3 n d bf16 if h is f32 (else unused); w_split: 3 vocab d bf16 if W
// is f32; coeff: 2 n chunk bf16; acc: n d f32 if vocab > chunk. chunk is a
// positive multiple of 128; d % 8 == 0; pointers 16-byte aligned. Returns a
// cudaError_t code (0 = launched).
extern "C" int pgica_fused_ce_bwd_dh(const void* h, const void* w, const void* y, const void* lse, const void* g,
                                     void* dh, void* h_split, void* w_split, void* coeff, void* acc, int n,
                                     int vocab, int d, int chunk, int h_dtype, int w_dtype, void* stream) {
  if (n <= 0 || vocab <= 0 || d <= 0 || d % 8 != 0 || chunk <= 0 || chunk % kBN != 0 || chunk / kBN > 65535 ||
      (d + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* yp = static_cast<const int*>(y);
  const auto* lp = static_cast<const float*>(lse);
  const auto* gp = static_cast<const float*>(g);
  auto* ap = static_cast<float*>(acc);
  const int code = h_dtype * 2 + w_dtype;
  constexpr int F = kMaxParts;  // parts of an f32 operand
  if (code == 0) return run_dh<float, F, F>(h, w, yp, lp, gp, dh, h_split, w_split, coeff, ap, n, vocab, d, chunk, s);
  if (code == 1) return run_dh<float, F, 1>(h, w, yp, lp, gp, dh, h_split, w_split, coeff, ap, n, vocab, d, chunk, s);
  if (code == 2) return run_dh<bf16, 1, F>(h, w, yp, lp, gp, dh, h_split, w_split, coeff, ap, n, vocab, d, chunk, s);
  if (code == 3) return run_dh<bf16, 1, 1>(h, w, yp, lp, gp, dh, h_split, w_split, coeff, ap, n, vocab, d, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dW. h, w as above, its rows reordered by the caller so that the rows with
// g != 0 come first in their order; y, lse, g: (n,) in that order; live: a
// device int, the number of rows with g != 0; dw: (vocab, d) in w_dtype.
// Scratch: h_split, w_split as above; coeff: 2 chunk ldc bf16 with ldc = n
// rounded up to 8. chunk is a positive multiple of 128; d % 8 == 0; pointers
// 16-byte aligned. Returns a cudaError_t code (0 = launched).
extern "C" int pgica_fused_ce_bwd_dw(const void* h, const void* w, const void* y, const void* lse, const void* g,
                                     const void* live, void* dw, void* h_split, void* w_split, void* coeff, int n,
                                     int vocab, int d, int chunk, int h_dtype, int w_dtype, void* stream) {
  if (n <= 0 || vocab <= 0 || d <= 0 || d % 8 != 0 || chunk <= 0 || chunk % kBM != 0 ||
      (n + kBN - 1) / kBN > 65535 || (d + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* yp = static_cast<const int*>(y);
  const auto* lp = static_cast<const float*>(lse);
  const auto* gp = static_cast<const float*>(g);
  const auto* np = static_cast<const int*>(live);
  const int code = h_dtype * 2 + w_dtype;
  constexpr int F = kMaxParts;
  if (code == 0) return run_dw<float, F, F>(h, w, yp, lp, gp, np, dw, h_split, w_split, coeff, n, vocab, d, chunk, s);
  if (code == 1) return run_dw<bf16, F, 1>(h, w, yp, lp, gp, np, dw, h_split, w_split, coeff, n, vocab, d, chunk, s);
  if (code == 2) return run_dw<float, 1, F>(h, w, yp, lp, gp, np, dw, h_split, w_split, coeff, n, vocab, d, chunk, s);
  if (code == 3) return run_dw<bf16, 1, 1>(h, w, yp, lp, gp, np, dw, h_split, w_split, coeff, n, vocab, d, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
