// Int8 decode matmul for Hopper (sm_90a): y = x @ dequant(W).T (+ bias).
//
// Replaces: no Pallas kernel. pgica_tpu/ops/quant.py:68-82 `q8_matmul` is an
//   XLA int8 dot on the TPU. Its library counterpart here, torch._int_mm,
//   takes only more than 16 rows and K, N multiples of 8, while decode runs
//   at 1-32 rows; and a dequantized bf16 copy through F.linear would read the
//   bf16 weights every step, which is what int8 storage is there to avoid.
//
// Two entry points, W the (N, K) int8 weight of an (out, in) nn.Linear with
// one f32 scale per output channel n, x (M, K) in the compute dtype:
//
// * W8A8 (`pgica_q8_matmul_w8a8`): two launches. `quantize_rows` takes each
//   row's amax in f32, sx = max(amax, 1e-12) / 127 and q = rint(x / sx)
//   (IEEE division, round half to even) clamped to +-127: bit for bit the JAX
//   package's `_quantize_rows`. `gemm_s8` then sums int8 x int8 products in
//   int32 on the tensor cores (mma.sync m16n8k32 s8), exactly, and writes
//   (float(acc) * sx[m]) * scale[n] in the output dtype, then adds the bias
//   rounded to that dtype, as quant.py:133-135 does.
// * Weight-only (`pgica_q8_matmul_w8`): bf16 loads the int8 weight and
//   dequantizes it in registers as bf16(float(q) * float(bf16(scale[n]))),
//   which is XLA's `kernel_q.astype(bf16) * scale.astype(bf16)` bit for bit,
//   then mma.sync m16n8k16 bf16 with f32 sums; f32 (the smoke config's type)
//   takes a CUDA-core kernel with float(q) * scale in f32.
//
// What bounds it on the H100: memory. At decode's M <= 128 the work is about
// 2 M flops per weight byte, far below the ~590 int8 (~295 bf16) operations
// per byte at which the tensor cores would be the limit; the floor is the
// weight's N * K bytes (plus x and y) over 3.35 TB/s: 0.31 us for a GPT-2
// Medium 1024 x 1024 projection, 17.5 us for a Llama-3-8B 14336 x 4096 one.
//
// Design: one block of 8 warps per 8 output columns and up to 64 rows, so the
// N dimension is spread over the SMs (128 blocks at N = 1024, 1,792 at
// N = 14,336). The 8 warps split K in 64-wide steps, each lane loading 16
// contiguous bytes of its weight row and of its x rows straight from global
// memory: since a dot product may take its K terms in any order, the k
// indices of the mma fragments are permuted so that each lane's 16 bytes are
// exactly its part of two (int8) or four (bf16) fragment products. The
// warps' partial sums meet in shared memory and are added in warp order
// (integers: exact; weight-only: a fixed f32 order). Rows, columns and K past
// the ends read as zeros and are not written; K that is no multiple of 16 (or
// an unaligned pointer) takes an element-by-element load. No host sync and
// no allocation: a CUDA graph captures both entry points.
#include <initializer_list>

#include "common.cuh"
#include "mma.cuh"

namespace {

using pgica::from_float;
using pgica::to_float;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;   // output columns a block computes (one n8 tile)
constexpr int kKStep = 64; // k values a warp takes per step
constexpr int kStride = kWarps * kKStep;  // k between a warp's steps
// steps a warp's loop body takes, their weight loads issued together (fewer x rows: more steps)
template <int MT>
constexpr int kUnroll = MT == 1 ? 4 : 2;

// ------------------------------------------------------------ row quantizer

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_rows(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx, int K) {
  __shared__ float part_s[kWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads) amax = fmaxf(amax, fabsf(to_float(x[base + k])));
  amax = pgica::warp_max(amax);
  if ((threadIdx.x & 31) == 0) part_s[threadIdx.x >> 5] = amax;
  __syncthreads();
  float m = part_s[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, part_s[w]);
  const float s = __fdiv_rn(fmaxf(m, 1e-12f), 127.0f);
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(to_float(x[base + k]), s)), -127.f), 127.f);
    xq[base + k] = static_cast<int8_t>(q);
  }
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
}

// ------------------------------------------------------------ loads

// 16 bytes of row `row` (of `rows`, each `K` bytes wide) at byte column k; zeros past either end.
template <bool VEC>
__device__ __forceinline__ uint4 load_bytes16(const int8_t* p, int row, int rows, int k, int K) {
  if (row >= rows) return make_uint4(0u, 0u, 0u, 0u);
  const int8_t* r = p + static_cast<size_t>(row) * K;
  if constexpr (VEC) return pgica::load16(r + k, k < K);
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (k + e < K) w[e >> 2] |= (static_cast<unsigned>(static_cast<uint8_t>(r[k + e]))) << (8 * (e & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 bf16 values (32 bytes) of row `row` at column k as 8 words (element 0 in the low half of word 0).
template <bool VEC>
__device__ __forceinline__ void load_bf16x16(const __nv_bfloat16* p, int row, int rows, int k, int K,
                                             uint32_t (&w)[8]) {
  if (row >= rows) {
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = 0u;
    return;
  }
  const __nv_bfloat16* r = p + static_cast<size_t>(row) * K;
  if constexpr (VEC) {
    const uint4 lo = pgica::load16(r + k, k < K), hi = pgica::load16(r + k + 8, k + 8 < K);
    w[0] = lo.x, w[1] = lo.y, w[2] = lo.z, w[3] = lo.w, w[4] = hi.x, w[5] = hi.y, w[6] = hi.z, w[7] = hi.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const unsigned a = k + 2 * i < K ? __bfloat16_as_ushort(r[k + 2 * i]) : 0u;
    const unsigned b = k + 2 * i + 1 < K ? __bfloat16_as_ushort(r[k + 2 * i + 1]) : 0u;
    w[i] = a | (b << 16);
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// y = v rounded to TO, plus the bias rounded to TO, the sum rounded to TO (JAX: y + bias.astype(dtype)).
template <typename TO>
__device__ __forceinline__ TO with_bias(float v, const float* bias, int n) {
  const TO y = from_float<TO>(v);
  if (bias == nullptr) return y;
  return from_float<TO>(__fadd_rn(to_float(y), to_float(from_float<TO>(bias[n]))));
}

// ------------------------------------------------------------ W8A8

// Fragment k permutation (g = lane / 4, t = lane % 4): lane t holds the 16 bytes k0 + 16t .. + 15 of
// its rows; bytes 0-3 and 4-7 are the fragment columns 4t.. and 16 + 4t.. of the first product,
// bytes 8-11 and 12-15 those of the second. A and B use the same permutation, so every product
// pairs the x and W values of one k.
template <typename TO, int MT, bool VEC>
__global__ void __launch_bounds__(kThreads)
    gemm_s8(const int8_t* __restrict__ xq, const float* __restrict__ sx, const int8_t* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ bias, TO* __restrict__ out, int M, int N,
            int K) {
  constexpr int kRows = 16 * MT;
  __shared__ int part_s[kWarps][kRows][kCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kCols, m0 = blockIdx.y * kRows;
  int acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;
  for (int kb = warp * kKStep; kb < K; kb += kWarps * kKStep * kUnroll<MT>) {
    uint4 b[kUnroll<MT>];  // the weight's loads of kUnroll steps in flight together
#pragma unroll
    for (int u = 0; u < kUnroll<MT>; ++u) b[u] = load_bytes16<VEC>(w, n0 + g, N, kb + u * kStride + 16 * t, K);
#pragma unroll
    for (int u = 0; u < kUnroll<MT>; ++u) {
      const int k = kb + u * kStride + 16 * t;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = m0 + 16 * i + g;
        const uint4 a0 = load_bytes16<VEC>(xq, r, M, k, K), a1 = load_bytes16<VEC>(xq, r + 8, M, k, K);
        mma_s8(acc[i], a0.x, a1.x, a0.y, a1.y, b[u].x, b[u].y);
        mma_s8(acc[i], a0.z, a1.z, a0.w, a1.w, b[u].z, b[u].w);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    part_s[warp][16 * i + g][2 * t] = acc[i][0];
    part_s[warp][16 * i + g][2 * t + 1] = acc[i][1];
    part_s[warp][16 * i + g + 8][2 * t] = acc[i][2];
    part_s[warp][16 * i + g + 8][2 * t + 1] = acc[i][3];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * kCols; e += kThreads) {
    const int row = e / kCols, col = e % kCols, m = m0 + row, n = n0 + col;
    if (m >= M || n >= N) continue;
    int total = 0;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) total += part_s[wp][row][col];
    const float v = __fmul_rn(__fmul_rn(static_cast<float>(total), sx[m]), scale[n]);
    out[static_cast<size_t>(m) * N + n] = with_bias<TO>(v, bias, n);
  }
}

// ------------------------------------------------------------ weight-only, bf16

// Lane t holds the 16 k values k0 + 16t .. + 15 of its rows; fragment product j (0-3) takes its k
// pairs (2t, 2t + 1) and (2t + 8, 2t + 9) from the values 4j, 4j + 1 and 4j + 2, 4j + 3.
template <int MT, bool VEC>
__global__ void __launch_bounds__(kThreads)
    gemm_w8_bf16(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  constexpr int kRows = 16 * MT;
  __shared__ float part_s[kWarps][kRows][kCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kCols, m0 = blockIdx.y * kRows;
  const float s = n0 + g < N ? __bfloat162float(__float2bfloat16(scale[n0 + g])) : 0.f;
  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int kb = warp * kKStep; kb < K; kb += kWarps * kKStep * kUnroll<MT>) {
    uint4 raw[kUnroll<MT>];  // the weight's loads of kUnroll steps in flight together
#pragma unroll
    for (int u = 0; u < kUnroll<MT>; ++u) raw[u] = load_bytes16<VEC>(w, n0 + g, N, kb + u * kStride + 16 * t, K);
#pragma unroll
    for (int u = 0; u < kUnroll<MT>; ++u) {
      const int k = kb + u * kStride + 16 * t;
      const unsigned words[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
      uint32_t bw[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const unsigned word = words[p >> 1] >> (16 * (p & 1));
        const float q0 = static_cast<float>(static_cast<int8_t>(word & 0xffu));
        const float q1 = static_cast<float>(static_cast<int8_t>((word >> 8) & 0xffu));
        bw[p] = pgica::pack_bf16x2(__fmul_rn(q0, s), __fmul_rn(q1, s));
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = m0 + 16 * i + g;
        uint32_t a0[8], a1[8];
        load_bf16x16<VEC>(x, r, M, k, K, a0);
        load_bf16x16<VEC>(x, r + 8, M, k, K, a1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t a[4] = {a0[2 * j], a1[2 * j], a0[2 * j + 1], a1[2 * j + 1]};
          pgica::mma_bf16(acc[i], a, bw[2 * j], bw[2 * j + 1]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    part_s[warp][16 * i + g][2 * t] = acc[i][0];
    part_s[warp][16 * i + g][2 * t + 1] = acc[i][1];
    part_s[warp][16 * i + g + 8][2 * t] = acc[i][2];
    part_s[warp][16 * i + g + 8][2 * t + 1] = acc[i][3];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * kCols; e += kThreads) {
    const int row = e / kCols, col = e % kCols, m = m0 + row, n = n0 + col;
    if (m >= M || n >= N) continue;
    float total = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) total = __fadd_rn(total, part_s[wp][row][col]);
    out[static_cast<size_t>(m) * N + n] = with_bias<__nv_bfloat16>(total, bias, n);
  }
}

// ------------------------------------------------------------ weight-only, f32 (CUDA cores)

constexpr int kF32Rows = 8;  // rows a block computes; warp w takes column n0 + w

__global__ void __launch_bounds__(kThreads)
    gemm_w8_f32(const float* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
                const float* __restrict__ bias, float* __restrict__ out, int M, int N, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kCols + warp, m0 = blockIdx.y * kF32Rows;
  if (n >= N) return;
  const float s = scale[n];
  const int8_t* wr = w + static_cast<size_t>(n) * K;
  float acc[kF32Rows];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) acc[r] = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float wv = __fmul_rn(static_cast<float>(wr[k]), s);
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r)
      if (m0 + r < M) acc[r] = fmaf(x[static_cast<size_t>(m0 + r) * K + k], wv, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    const float v = pgica::warp_sum(acc[r]);
    if (lane == 0 && m0 + r < M) out[static_cast<size_t>(m0 + r) * N + n] = with_bias<float>(v, bias, n);
  }
}

// ------------------------------------------------------------ launches

bool vec_ok(int K, std::initializer_list<const void*> ptrs) {
  if (K % 16 != 0) return false;
  for (const void* p : ptrs)
    if (!pgica::aligned16(p)) return false;
  return true;
}

template <int MT>
dim3 grid_of(int M, int N) {
  return dim3((N + kCols - 1) / kCols, (M + 16 * MT - 1) / (16 * MT));
}

template <typename TO, bool VEC>
int launch_gemm_s8(const int8_t* xq, const float* sx, const int8_t* w, const float* scale, const float* bias,
                   TO* out, int M, int N, int K, cudaStream_t st) {
  if (M <= 16)
    gemm_s8<TO, 1, VEC><<<grid_of<1>(M, N), kThreads, 0, st>>>(xq, sx, w, scale, bias, out, M, N, K);
  else if (M <= 32)
    gemm_s8<TO, 2, VEC><<<grid_of<2>(M, N), kThreads, 0, st>>>(xq, sx, w, scale, bias, out, M, N, K);
  else
    gemm_s8<TO, 4, VEC><<<grid_of<4>(M, N), kThreads, 0, st>>>(xq, sx, w, scale, bias, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int w8a8(const void* x, void* xq, void* sx, const void* w, const void* scale, const void* bias, void* out, int M,
         int N, int K, cudaStream_t st) {
  quantize_rows<T><<<M, kThreads, 0, st>>>(static_cast<const T*>(x), static_cast<int8_t*>(xq),
                                           static_cast<float*>(sx), K);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* q = static_cast<const int8_t*>(xq);
  const auto* s = static_cast<const float*>(sx);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(scale);
  const auto* b = static_cast<const float*>(bias);
  auto* o = static_cast<T*>(out);
  if (vec_ok(K, {xq, w}))
    return launch_gemm_s8<T, true>(q, s, wp, sc, b, o, M, N, K, st);
  return launch_gemm_s8<T, false>(q, s, wp, sc, b, o, M, N, K, st);
}

template <bool VEC>
void launch_w8_bf16(const __nv_bfloat16* x, const int8_t* w, const float* scale, const float* bias,
                    __nv_bfloat16* out, int M, int N, int K, cudaStream_t st) {
  if (M <= 16)
    gemm_w8_bf16<1, VEC><<<grid_of<1>(M, N), kThreads, 0, st>>>(x, w, scale, bias, out, M, N, K);
  else if (M <= 32)
    gemm_w8_bf16<2, VEC><<<grid_of<2>(M, N), kThreads, 0, st>>>(x, w, scale, bias, out, M, N, K);
  else
    gemm_w8_bf16<4, VEC><<<grid_of<4>(M, N), kThreads, 0, st>>>(x, w, scale, bias, out, M, N, K);
}

}  // namespace

// x: (M, K) contiguous in `dtype` (f32 or bf16); xq: (M, K) int8 and sx: (M,) f32 scratch; w: (N, K)
// int8; scale: (N,) f32; bias: (N,) f32 or null; out: (M, N) in `dtype`. Returns a cudaError_t code.
extern "C" int pgica_q8_matmul_w8a8(const void* x, void* xq, void* sx, const void* w, const void* scale,
                                    const void* bias, void* out, int M, int N, int K, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == pgica::kFloat32) return w8a8<float>(x, xq, sx, w, scale, bias, out, M, N, K, st);
  if (dtype == pgica::kBFloat16) return w8a8<__nv_bfloat16>(x, xq, sx, w, scale, bias, out, M, N, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x: (M, K) contiguous in `dtype`; w: (N, K) int8; scale: (N,) f32; bias: (N,) f32 or null; out: (M, N)
// in `dtype`. Returns a cudaError_t code.
extern "C" int pgica_q8_matmul_w8(const void* x, const void* w, const void* scale, const void* bias, void* out,
                                  int M, int N, int K, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(scale);
  const auto* b = static_cast<const float*>(bias);
  if (dtype == pgica::kFloat32) {
    const dim3 grid((N + kCols - 1) / kCols, (M + kF32Rows - 1) / kF32Rows);
    gemm_w8_f32<<<grid, kThreads, 0, st>>>(static_cast<const float*>(x), wp, sc, b, static_cast<float*>(out), M,
                                           N, K);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == pgica::kBFloat16) {
    const auto* xp = static_cast<const __nv_bfloat16*>(x);
    auto* o = static_cast<__nv_bfloat16*>(out);
    if (vec_ok(K, {x, w}))
      launch_w8_bf16<true>(xp, wp, sc, b, o, M, N, K, st);
    else
      launch_w8_bf16<false>(xp, wp, sc, b, o, M, N, K, st);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
