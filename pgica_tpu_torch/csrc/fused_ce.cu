// Fused linear + cross-entropy for Hopper (sm_90a): the forward.
//
// Replaces: pgica_tpu/ops/fused_ce.py:60 `_fwd_kernel` (Pallas, TPU); the
// backward (:108 `_bwd_dh_kernel`, :134 `_bwd_dw_kernel`) runs on the tensor
// cores in fused_ce_bwd.cu. With the scores s = h W^T (N x V, never stored)
// and lse = logsumexp over the vocab of s:
//   logp[r] = s[r, y[r]] - lse[r], and lse[r]        (f32)
// h (N, d) and W (V, d) are each f32 or bf16 (four instantiations, so
// nothing is converted or copied before a launch); every product is taken
// in f32 from the inputs as given, as the TPU body does (astype(f32),
// preferred_element_type=f32).
//
// What bounds it on the H100: operations. One N x V x d product: 2 N V d =
// 0.84 TFLOP at the stage-2 flagship shape (N = 8,128, d = 1,024, V =
// 50,262) against ~0.2 GB of bytes. This first version computes on the CUDA
// cores in f32 (67 TFLOP/s peak, so >= 12.5 ms); the tensor cores are the
// redesign's work (ROADMAP queue 2).
//
// Design. A tile of scores (A rows x B rows, K = d) is staged through shared
// memory in 32-wide K chunks, the next chunk's 16-byte loads in flight while
// the current one is multiplied, each thread holding a register block of the
// tile. Rows and vocab need no padding: rows and columns past the end stage
// as zeros and are masked in the epilogue, so W is never copied (JAX pads
// it, a 206 MB copy per call at the flagship) and never indexed by a target:
// the target's score is found by matching the column inside the vocab loop,
// with the `cols < vocab` guard of the TPU kernel. The vocab loop moves into
// the block. A block takes 64 rows and a contiguous range of the vocab
// (split-vocab) and carries the online logsumexp (m, l) and the target score
// over its 128-column tiles; one row of the tile lives in one warp, so the
// row max is a warp shuffle. 64-row tiles alone give 127 blocks at N =
// 8,128, under one wave of 132 SMs, so the vocab is split until there are ~8
// blocks per SM; each split writes partial (m, l, t) and a second kernel
// combines them per row in split order (deterministic), with the TPU
// kernel's `l == 0` guard.
#include "common.cuh"

#include <cstdint>

namespace {

using pgica::load16;
using pgica::unpack16;
using pgica::warp_max;
using pgica::warp_sum;

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kThreads = 256;      // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;            // K (d) chunk staged per step
constexpr int kFwdRows = 64;       // forward: rows per block (ops/fused_ce.py repeats it)
constexpr int kVTile = 128;        // vocab columns per tile (ops/fused_ce.py repeats it)

// Chunk [k0, k0 + kBK) of rows [r0, r0 + ROWS) of a row-major (n, d) array,
// loaded into registers as 16-byte vectors and stored to shared memory as
// f32. Rows at or past n and columns at or past d stage as zeros (d % 8 == 0,
// so a vector is all in or all out).
template <int ROWS, typename T>
struct Chunk {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kRowVecs = kBK / kVec;
  static constexpr int kVecs = ROWS * kRowVecs;
  static constexpr int kLoads = (kVecs + kThreads - 1) / kThreads;
  uint4 raw[kLoads];

  __device__ __forceinline__ void load(const T* g, int r0, int n, int k0, int d) {
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int i = static_cast<int>(threadIdx.x) + it * kThreads;
      const int r = i / kRowVecs, k = k0 + (i % kRowVecs) * kVec;
      raw[it] = load16(g + static_cast<size_t>(r0 + r) * d + k, i < kVecs && r0 + r < n && k < d);
    }
  }

  __device__ __forceinline__ void store(float (*dst)[kBK + 1]) const {
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int i = static_cast<int>(threadIdx.x) + it * kThreads;
      if (i >= kVecs) break;
      const int r = i / kRowVecs, c = (i % kRowVecs) * kVec;
      float f[kVec];
      unpack16(raw[it], f, static_cast<const T*>(nullptr));
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[r][c + e] = f[e];
    }
  }
};

// s[i][j] = sum over all d of A[a0 + warp + 8i] . B[b0 + lane + 32j], f32.
// A rows past na and B rows past nb count as zeros. Ends with the shared
// buffers still being read: a caller that writes them must sync first (the
// next call does).
template <int AROWS, int BROWS, typename TA, typename TB>
__device__ __forceinline__ void score_tile(float (&s)[AROWS / kWarps][BROWS / 32], const TA* A,
                                           int a0, int na, const TB* B, int b0, int nb, int d,
                                           float (*As)[kBK + 1], float (*Bs)[kBK + 1]) {
  constexpr int R = AROWS / kWarps, C = BROWS / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) s[i][j] = 0.f;
  Chunk<AROWS, TA> ca;
  Chunk<BROWS, TB> cb;
  ca.load(A, a0, na, 0, d);
  cb.load(B, b0, nb, 0, d);
#pragma unroll 1
  for (int k0 = 0; k0 < d; k0 += kBK) {
    __syncthreads();  // every thread is done with the buffers' previous contents
    ca.store(As);
    cb.store(Bs);
    __syncthreads();
    if (k0 + kBK < d) {  // the next chunk's loads fly while this one is multiplied
      ca.load(A, a0, na, k0 + kBK, d);
      cb.load(B, b0, nb, k0 + kBK, d);
    }
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[R], b[C];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = As[warp + kWarps * i][k];  // broadcast in the warp
#pragma unroll
      for (int j = 0; j < C; ++j) b[j] = Bs[lane + 32 * j][k];  // stride 33: no bank conflict
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
  }
}

// ------------------------------------------------------------------ forward

// Grid (row tiles, vocab splits). Split z covers columns [z * span,
// min(V, (z + 1) * span)) and writes its partial max m, sum l (relative to
// m) and target score t for each of its rows to part[0 | 1 | 2][z][row].
template <typename TH, typename TW>
__global__ void __launch_bounds__(kThreads, 2)
    fused_ce_fwd_partial(const TH* __restrict__ h, const TW* __restrict__ w,
                         const int* __restrict__ y, float* __restrict__ part, int n, int vocab,
                         int d, int span) {
  __shared__ float As[kFwdRows][kBK + 1];
  __shared__ float Bs[kVTile][kBK + 1];
  constexpr int R = kFwdRows / kWarps, C = kVTile / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kFwdRows;
  const int v_begin = blockIdx.y * span;
  const int v_end = min(vocab, v_begin + span);
  int yr[R];
  float m[R], l[R], t[R];  // m is the same in every lane; l and t are this lane's columns'
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = r0 + warp + kWarps * i;
    yr[i] = row < n ? y[row] : -1;
    m[i] = kNegInf;
    l[i] = t[i] = 0.f;
  }
#pragma unroll 1
  for (int v0 = v_begin; v0 < v_end; v0 += kVTile) {
    float s[R][C];
    score_tile<kFwdRows, kVTile>(s, h, r0, n, w, v0, v_end, d, As, Bs);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float tile_max = kNegInf;
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (v0 + lane + 32 * j < v_end) tile_max = fmaxf(tile_max, s[i][j]);
      const float m_new = fmaxf(m[i], warp_max(tile_max));  // column v0 is real: m_new is a score
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int v = v0 + lane + 32 * j;
        if (v < v_end) {
          sum += expf(s[i][j] - m_new);
          if (v == yr[i]) t[i] += s[i][j];
        }
      }
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }
  const size_t plane = static_cast<size_t>(gridDim.y) * n;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float l_row = warp_sum(l[i]), t_row = warp_sum(t[i]);  // one lane holds the target, if any
    const int row = r0 + warp + kWarps * i;
    if (lane == 0 && row < n) {
      const size_t at = static_cast<size_t>(blockIdx.y) * n + row;
      part[at] = m[i];
      part[plane + at] = l_row;
      part[2 * plane + at] = t_row;
    }
  }
}

// One thread per row: combine the splits in order.
__global__ void __launch_bounds__(kThreads)
    fused_ce_fwd_combine(const float* __restrict__ part, float* __restrict__ logp,
                         float* __restrict__ lse, int n, int splits) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  const size_t plane = static_cast<size_t>(splits) * n;
  float m = kNegInf;
  for (int z = 0; z < splits; ++z) m = fmaxf(m, part[static_cast<size_t>(z) * n + row]);
  float l = 0.f, t = 0.f;
  for (int z = 0; z < splits; ++z) {
    const size_t at = static_cast<size_t>(z) * n + row;
    l += part[plane + at] * expf(part[at] - m);
    t += part[2 * plane + at];
  }
  const float x = m + logf(l == 0.f ? 1.f : l);
  lse[row] = x;
  logp[row] = t - x;
}

template <typename TH, typename TW>
int launch_fwd(const void* h, const void* w, const int* y, float* part, float* logp, float* lse,
               int n, int vocab, int d, int splits, int span, cudaStream_t stream) {
  const dim3 grid((n + kFwdRows - 1) / kFwdRows, splits);
  fused_ce_fwd_partial<TH, TW><<<grid, kThreads, 0, stream>>>(
      static_cast<const TH*>(h), static_cast<const TW*>(w), y, part, n, vocab, d, span);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_ce_fwd_combine<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(part, logp, lse, n,
                                                                               splits);
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int n, int vocab, int d) { return n > 0 && vocab > 0 && d > 0 && d % 8 == 0; }

}  // namespace

// h: (n, d) in h_dtype; w: (vocab, d) in w_dtype; y: (n,) int32; partials:
// f32 scratch of 3 * splits * n; logp, lse: (n,) f32. Split z covers vocab
// columns [z * span, (z + 1) * span); span is a multiple of 128 (kVTile) and
// splits * span >= vocab > (splits - 1) * span. d % 8 == 0, all pointers
// 16-byte aligned. Returns a cudaError_t code (0 = launched).
extern "C" int pgica_fused_ce_fwd(const void* h, const void* w, const void* y, void* partials,
                                  void* logp, void* lse, int n, int vocab, int d, int splits,
                                  int span, int h_dtype, int w_dtype, void* stream) {
  if (!valid_shape(n, vocab, d) || splits <= 0 || splits > 65535 || span <= 0 ||
      span % kVTile != 0 || static_cast<long long>(splits) * span < vocab ||
      static_cast<long long>(splits - 1) * span >= vocab)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* yp = static_cast<const int*>(y);
  auto* part = static_cast<float*>(partials);
  auto* lp = static_cast<float*>(logp);
  auto* ls = static_cast<float*>(lse);
  const int code = h_dtype * 2 + w_dtype;
  if (code == 0) return launch_fwd<float, float>(h, w, yp, part, lp, ls, n, vocab, d, splits, span, s);
  if (code == 1)
    return launch_fwd<float, __nv_bfloat16>(h, w, yp, part, lp, ls, n, vocab, d, splits, span, s);
  if (code == 2)
    return launch_fwd<__nv_bfloat16, float>(h, w, yp, part, lp, ls, n, vocab, d, splits, span, s);
  if (code == 3)
    return launch_fwd<__nv_bfloat16, __nv_bfloat16>(h, w, yp, part, lp, ls, n, vocab, d, splits,
                                                    span, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
