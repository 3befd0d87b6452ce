// Fused linear + cross-entropy for Hopper (sm_90a): the forward, on the tensor cores.
//
// Replaces: pgica_tpu/ops/fused_ce.py:60 `_fwd_kernel` (Pallas, TPU); the
// backward (:108 `_bwd_dh_kernel`, :134 `_bwd_dw_kernel`) is fused_ce_bwd.cu.
// With the scores s = h W^T (N x V, never stored) and lse = logsumexp over
// the vocab of s:
//   logp[r] = s[r, y[r]] - lse[r], and lse[r]        (f32)
// h (N, d) and W (V, d) are each f32 or bf16 (all four pairs).
//
// What bounds it on the H100: operations. One N x V x d product: 2 N V d =
// 2.15 TFLOP at the Llama stage-2 shape (N = 2,044, d = 4,096, V = 128,256),
// 2.2 ms at the bf16 tensor-core peak, against ~2.1 GB of bytes (W in f32)
// in 0.6 ms.
//
// Design: the score GEMM of the backward (fce_gemm.cuh), h as A and W as B,
// both K-major, 128 x 128 x 32 block tiles, grid (row tiles, column tiles)
// with the row tile fastest, so the blocks that read one W tile run
// together and W comes from HBM about once. The scores take the backward's
// passes (kScoreOrder: an f32 operand in three bf16 parts; 1 pass for bf16 x
// bf16, 3 for the policy's bf16 h with the f32 master W, 6 for f32 x f32),
// so the lse saved here is the one the backward's scores imply: the backward
// holds it fixed, and the forward with W in two parts would move p_y at a
// sharp peak by more than dh's bound allows (tests/test_torch_fused_ce.py
// emulates both). The TPU kernel's online logsumexp over vocab tiles becomes
// one epilogue per 128 x 128 tile, on the accumulator fragments: each row's
// max over the tile's columns below V (the `cols < vocab` guard), its sum of
// exp(s - max) and its target's score if the target lies in the tile,
// reduced within each quad of lanes by shuffle and across the four warps
// that share the row through shared memory, then written as one (m, l, t)
// partial per row and column tile. A second kernel combines a row's
// partials in vocab order, with the TPU kernel's `l == 0` guard. No
// atomics: logp and lse are the same from run to run. Partials: 12 bytes per
// row and column tile (24.6 MB at Llama, 38 MB at GPT-2's 8,128 rows).
// Rows past N and columns past V stage as zeros and are masked, so W is
// never copied or padded. An f32 operand is split into its bf16 parts in
// scratch the wrapper allocates (W: 3 x 1.05 GB at Llama).
#include "fce_gemm.cuh"

#include <cstdint>

namespace {

using namespace pgica::fce;

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kCombineThreads = 256;

// Tile (row tile i, column tile z) writes, for each of its rows r < N, the
// max m of the scores of columns [128 z, min(V, 128 z + 128)), their sum l
// of exp(s - m) and the target's score t (0 if the target is elsewhere) to
// part[0 | 1 | 2][z][r] (p.acc).
template <int PH, int PW>
__global__ void __launch_bounds__(kGemmThreads) fused_ce_fwd_tiles(const Gemm p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[4][4][4];
  mainloop<PH, PW, kScoreOrder, true>(p, m0, n0, p.k, p.a_k_valid, reinterpret_cast<bf16*>(smem_raw), acc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  __syncthreads();  // every warp is done with the ring: it holds the warps' partials now
  float* red = reinterpret_cast<float*>(smem_raw);  // [m | l | t][wn][row in the tile]
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = wm * 64 + mt * 16 + (lane >> 2) + 8 * half;
      const int y = m0 + rl < p.m ? p.y[m0 + rl] : -1;
      float m = kNegInf;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (n0 + wn * 32 + nt * 8 + (lane & 3) * 2 + j < p.n) m = fmaxf(m, acc[mt][nt][2 * half + j]);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));  // the quad's four lanes hold the row's 32 columns
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float l = 0.f, t = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int v = n0 + wn * 32 + nt * 8 + (lane & 3) * 2 + j;
          if (v < p.n) {
            const float s = acc[mt][nt][2 * half + j];
            l += expf(s - m);
            if (v == y) t = s;
          }
        }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        l += __shfl_xor_sync(0xffffffffu, l, x);
        t += __shfl_xor_sync(0xffffffffu, t, x);  // one lane at most holds the target: the others add 0
      }
      if ((lane & 3) == 0) {
        red[(0 * 4 + wn) * kBM + rl] = m;
        red[(1 * 4 + wn) * kBM + rl] = l;
        red[(2 * 4 + wn) * kBM + rl] = t;
      }
    }
  __syncthreads();
  const int rl = threadIdx.x, r = m0 + rl;
  if (rl >= kBM || r >= p.m) return;
  float m = red[rl];  // column n0 < V lies in warp wn = 0: m is a score
#pragma unroll
  for (int w = 1; w < 4; ++w) m = fmaxf(m, red[w * kBM + rl]);
  float l = 0.f, t = 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {  // a warp whose columns are all past V adds 0 * exp(NEG_INF - m)
    l += red[(4 + w) * kBM + rl] * expf(red[w * kBM + rl] - m);
    t += red[(8 + w) * kBM + rl];
  }
  const size_t plane = static_cast<size_t>(gridDim.y) * p.m;
  const size_t at = static_cast<size_t>(blockIdx.y) * p.m + r;
  p.acc[at] = m;
  p.acc[plane + at] = l;
  p.acc[2 * plane + at] = t;
}

// One thread per row: combine the column tiles' partials in vocab order.
__global__ void __launch_bounds__(kCombineThreads)
    fused_ce_fwd_combine(const float* __restrict__ part, float* __restrict__ logp, float* __restrict__ lse, int n,
                         int tiles) {
  const int row = blockIdx.x * kCombineThreads + threadIdx.x;
  if (row >= n) return;
  const size_t plane = static_cast<size_t>(tiles) * n;
  float m = kNegInf;
  for (int z = 0; z < tiles; ++z) m = fmaxf(m, part[static_cast<size_t>(z) * n + row]);
  float l = 0.f, t = 0.f;
  for (int z = 0; z < tiles; ++z) {
    const size_t at = static_cast<size_t>(z) * n + row;
    l += part[plane + at] * expf(part[at] - m);
    t += part[2 * plane + at];
  }
  const float x = m + logf(l == 0.f ? 1.f : l);
  lse[row] = x;
  logp[row] = t - x;
}

// PH, PW: parts of h and W (1 for bf16, kMaxParts for f32).
template <int PH, int PW>
int run_fwd(const void* h, const void* w, const int* y, void* h_split, void* w_split, float* part, float* logp,
            float* lse, int n, int vocab, int d, cudaStream_t stream) {
  constexpr int kSmem = Smem<PH, PW, true>::kBytes;
  static const cudaError_t attr = allow_smem(fused_ce_fwd_tiles<PH, PW>, kSmem);  // once per instance
  if (attr != cudaSuccess) return static_cast<int>(attr);
  Gemm p{};
  p.a = as_bf16(h, PH > 1, h_split, static_cast<size_t>(n) * d, d, stream);
  p.b = as_bf16(w, PW > 1, w_split, static_cast<size_t>(vocab) * d, d, stream);
  p.m = n;
  p.n = vocab;
  p.k = d;
  p.a_k_valid = d;
  p.y = y;
  p.acc = part;
  const int tiles = (vocab + kBN - 1) / kBN;
  fused_ce_fwd_tiles<PH, PW><<<dim3((n + kBM - 1) / kBM, tiles), kGemmThreads, kSmem, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_ce_fwd_combine<<<(n + kCombineThreads - 1) / kCombineThreads, kCombineThreads, 0, stream>>>(part, logp, lse,
                                                                                                    n, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h: (n, d) in h_dtype; w: (vocab, d) in w_dtype; y: (n,) int32; logp, lse:
// (n,) f32. Scratch, allocated by the caller: h_split: 3 n d bf16 if h is f32
// (else unused); w_split: 3 vocab d bf16 if W is f32; partials: f32 of 3
// tiles n, tiles = ceil(vocab / 128) <= 65535. d % 8 == 0, all pointers
// 16-byte aligned. Returns a cudaError_t code (0 = launched).
extern "C" int pgica_fused_ce_fwd(const void* h, const void* w, const void* y, void* h_split, void* w_split,
                                  void* partials, void* logp, void* lse, int n, int vocab, int d, int h_dtype,
                                  int w_dtype, void* stream) {
  if (n <= 0 || vocab <= 0 || d <= 0 || d % 8 != 0 || (vocab + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* yp = static_cast<const int*>(y);
  auto* part = static_cast<float*>(partials);
  auto* lp = static_cast<float*>(logp);
  auto* ls = static_cast<float*>(lse);
  const int code = h_dtype * 2 + w_dtype;
  constexpr int F = kMaxParts;  // parts of an f32 operand
  if (code == 0) return run_fwd<F, F>(h, w, yp, h_split, w_split, part, lp, ls, n, vocab, d, s);
  if (code == 1) return run_fwd<F, 1>(h, w, yp, h_split, w_split, part, lp, ls, n, vocab, d, s);
  if (code == 2) return run_fwd<1, F>(h, w, yp, h_split, w_split, part, lp, ls, n, vocab, d, s);
  if (code == 3) return run_fwd<1, 1>(h, w, yp, h_split, w_split, part, lp, ls, n, vocab, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
