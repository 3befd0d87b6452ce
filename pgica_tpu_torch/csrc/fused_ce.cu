// Fused linear + cross-entropy for Hopper (sm_90a): forward and dW.
//
// Replaces: pgica_tpu/ops/fused_ce.py:60 `_fwd_kernel` and :134
// `_bwd_dw_kernel` (Pallas, TPU); dh (:108 `_bwd_dh_kernel`) runs on the
// tensor cores in fused_ce_dh.cu. With the scores s = h W^T (N x V, never
// stored), lse = logsumexp over the vocab of s, p = exp(s - lse) and
// onehot[r, v] = (v == y[r]):
//   forward  logp[r] = s[r, y[r]] - lse[r], and lse[r]        (f32)
//   dW       dW = ((onehot - p) * g)^T @ h                    (W's dtype)
// h (N, d) and W (V, d) are each f32 or bf16 (four instantiations of each
// kernel, so nothing is converted or copied before a launch); every product
// is taken in f32 from the inputs as given, as the TPU body does
// (astype(f32), preferred_element_type=f32).
//
// What bounds it on the H100: operations. The forward does one N x V x d
// product, dW two: 2 N V d = 0.84 TFLOP at the stage-2 flagship
// shape (N = 8,128, d = 1,024, V = 50,262) against ~0.2 GB of bytes. This
// first version computes on the CUDA cores in f32 (67 TFLOP/s peak, so
// >= 12.5 ms per product); tensor cores (bf16 wgmma, or TF32 with a
// tolerance argument for the f32 master W) are the redesign's work.
//
// Design. Both kernels share one building block: a tile of scores
// (A rows x B rows, K = d) staged through shared memory in 32-wide K chunks,
// the next chunk's 16-byte loads in flight while the current one is
// multiplied, each thread holding a register block of the tile. Rows and
// vocab need no padding: rows and columns past the end stage as zeros and
// are masked in the epilogue, so W is never copied (JAX pads it, a 206 MB
// copy per call at the flagship) and never indexed by a target: the target's
// score is found by matching the column inside the vocab loop, with the
// `cols < vocab` guard of the TPU kernel.
// * Forward: the vocab loop moves into the block. A block takes 64 rows and
//   a contiguous range of the vocab (split-vocab) and carries the online
//   logsumexp (m, l) and the target score over its 128-column tiles; one row
//   of the tile lives in one warp, so the row max is a warp shuffle. 64-row
//   tiles alone give 127 blocks at N = 8,128, under one wave of 132 SMs, so
//   the vocab is split until there are ~8 blocks per SM; each split writes
//   partial (m, l, t) and a second kernel combines them per row in split
//   order (deterministic), with the TPU kernel's `l == 0` guard.
// * dW: as the TPU grid does with rows inner, a block owns 32 vocab rows of
//   dW and loops over all rows of h, so each dW element is summed by one
//   thread in a fixed order; each thread holds 4 columns of d for the 32
//   rows, so d > 1,024 runs column passes (grid y), each recomputing the
//   scores. No atomics: dW is the same from run to run. A row with g = 0 (a
//   masked position, the [:, :-1] shift) has coefficient 0 and adds exactly
//   0.
#include "common.cuh"

#include <cstdint>

namespace {

using pgica::from_float;
using pgica::load16;
using pgica::unpack16;
using pgica::warp_max;
using pgica::warp_sum;

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kThreads = 256;      // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;            // K (d) chunk staged per step
constexpr int kFwdRows = 64;       // forward: rows per block (ops/fused_ce.py repeats it)
constexpr int kVTile = 128;        // vocab (and, in dW, row) columns per tile (ops/fused_ce.py repeats it)
constexpr int kColsPerPass = 4 * kThreads;  // dW: columns of d per block

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

// ------------------------------------------------------------------ backward

__device__ __forceinline__ void load4(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&out)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  out[0] = __uint_as_float(v.x << 16);
  out[1] = __uint_as_float(v.x & 0xffff0000u);
  out[2] = __uint_as_float(v.y << 16);
  out[3] = __uint_as_float(v.y & 0xffff0000u);
}

// dW: the block owns OWN vocab rows of W and streams the rows of h.
// Grid (owned tiles, column passes of kColsPerPass over d).
template <typename TH, typename TW, int OWN>
__global__ void __launch_bounds__(kThreads)
    fused_ce_bwd_dw(const TH* __restrict__ h, const TW* __restrict__ w, const int* __restrict__ y,
                    const float* __restrict__ lse, const float* __restrict__ g, TW* __restrict__ out, int n,
                    int vocab, int d) {
  constexpr int R = OWN / kWarps, C = kVTile / 32;
  constexpr int kCt = OWN + 4;  // row stride of the coefficient tile: float4 rows
  __shared__ float As[OWN][kBK + 1];
  __shared__ float Bs[kVTile][kBK + 1];
  __shared__ __align__(16) float Ct[kVTile][kCt];  // coefficients, one row per row of h
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o0 = blockIdx.x * OWN;
  const int c0 = blockIdx.y * kColsPerPass + 4 * threadIdx.x;  // this thread's 4 columns of d
  const bool has_cols = c0 < d;
  float acc[OWN][4];
#pragma unroll
  for (int o = 0; o < OWN; ++o)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[o][e] = 0.f;

#pragma unroll 1
  for (int t0 = 0; t0 < n; t0 += kVTile) {
    float s[R][C];
    score_tile<OWN, kVTile>(s, w, o0, vocab, h, t0, n, d, As, Bs);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int t = lane + 32 * j;
      const int r = t0 + t;
      int y_t = -1;
      float lse_t = 0.f, g_t = 0.f;
      if (r < n) {
        y_t = y[r];
        lse_t = lse[r];
        g_t = g[r];
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int v = o0 + warp + kWarps * i;
        float c = 0.f;
        if (r < n && v < vocab) c = ((v == y_t ? 1.f : 0.f) - expf(s[i][j] - lse_t)) * g_t;
        Ct[t][warp + kWarps * i] = c;
      }
    }
    __syncthreads();
    if (has_cols) {
      const int nt = min(kVTile, n - t0);
#pragma unroll 4
      for (int t = 0; t < nt; ++t) {
        float tv[4];
        load4(h + static_cast<size_t>(t0 + t) * d + c0, tv);
#pragma unroll
        for (int o = 0; o < OWN; o += 4) {
          const float4 cv = *reinterpret_cast<const float4*>(&Ct[t][o]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[o][e] = fmaf(cv.x, tv[e], acc[o][e]);
            acc[o + 1][e] = fmaf(cv.y, tv[e], acc[o + 1][e]);
            acc[o + 2][e] = fmaf(cv.z, tv[e], acc[o + 2][e]);
            acc[o + 3][e] = fmaf(cv.w, tv[e], acc[o + 3][e]);
          }
        }
      }
    }
    // the next score_tile syncs before it overwrites As/Bs, and Ct is
    // written only after that tile's own syncs
  }
  if (!has_cols) return;
#pragma unroll
  for (int o = 0; o < OWN; ++o) {
    const int v = o0 + o;
    if (v >= vocab) break;
    TW* dst = out + static_cast<size_t>(v) * d + c0;
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[e] = from_float<TW>(acc[o][e]);
  }
}

int sm_count() {
  int device = 0, count = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 132;
  return count;
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

template <typename TH, typename TW>
int launch_dw(const void* h, const void* w, const int* y, const float* lse, const float* g, void* out, int n,
              int vocab, int d, cudaStream_t stream) {
  const int passes = (d + kColsPerPass - 1) / kColsPerPass;
  const auto* hp = static_cast<const TH*>(h);
  const auto* wp = static_cast<const TW*>(w);
  auto* op = static_cast<TW*>(out);
  if ((vocab + 31) / 32 >= sm_count()) {
    const dim3 grid((vocab + 31) / 32, passes);
    fused_ce_bwd_dw<TH, TW, 32><<<grid, kThreads, 0, stream>>>(hp, wp, y, lse, g, op, n, vocab, d);
  } else {  // too few 32-row tiles to fill the card
    const dim3 grid((vocab + 15) / 16, passes);
    fused_ce_bwd_dw<TH, TW, 16><<<grid, kThreads, 0, stream>>>(hp, wp, y, lse, g, op, n, vocab, d);
  }
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

// h, w, y as above; lse: (n,) f32 from the forward; g: (n,) f32, the
// cotangent of logp; dw: (vocab, d) in w_dtype.
extern "C" int pgica_fused_ce_bwd_dw(const void* h, const void* w, const void* y, const void* lse,
                                     const void* g, void* dw, int n, int vocab, int d, int h_dtype,
                                     int w_dtype, void* stream) {
  if (!valid_shape(n, vocab, d)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* yp = static_cast<const int*>(y);
  const auto* lp = static_cast<const float*>(lse);
  const auto* gp = static_cast<const float*>(g);
  const int code = h_dtype * 2 + w_dtype;
  if (code == 0) return launch_dw<float, float>(h, w, yp, lp, gp, dw, n, vocab, d, s);
  if (code == 1) return launch_dw<float, __nv_bfloat16>(h, w, yp, lp, gp, dw, n, vocab, d, s);
  if (code == 2) return launch_dw<__nv_bfloat16, float>(h, w, yp, lp, gp, dw, n, vocab, d, s);
  if (code == 3) return launch_dw<__nv_bfloat16, __nv_bfloat16>(h, w, yp, lp, gp, dw, n, vocab, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
