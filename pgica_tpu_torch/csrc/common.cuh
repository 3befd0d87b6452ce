// Helpers shared by the port's hand-written kernels.
//
// Each kernel source is compiled by nvcc into a shared library of its own with
// a plain C interface (no PyTorch headers) and loaded with ctypes; see
// pgica_tpu_torch/ops/_kernels.py. Every C entry point launches on the stream
// it is given and returns cudaGetLastError(), which the Python wrapper turns
// into an exception.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pgica {

// dtype codes passed from Python (ops/_kernels.py:DTYPE_CODES).
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as .to(torch.bfloat16)
}

// 16 bytes of global memory as floats: 4 f32 values or 8 bf16 values (a
// bf16 is the top half of the f32 with the same value; element 0 is the low
// half of the first word). The pointer argument only selects the type.
__device__ __forceinline__ void unpack16(const uint4& r, float* out, const float*) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack16(const uint4& r, float* out, const __nv_bfloat16*) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 load16(const void* p, bool valid) {
  return valid ? *static_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
}

// 16 / sizeof(T) f32 values -> 16 bytes of T (element 0 in the low half, as unpack16).
__device__ __forceinline__ uint4 pack16(const float* f, const float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack16(const float* f, const __nv_bfloat16*) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned lo = __bfloat16_as_ushort(__float2bfloat16(f[2 * i]));
    const unsigned hi = __bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// g[c .. c + N) into out (N = 4 or 8, c a multiple of 4, g 16-byte aligned).
template <int N>
__device__ __forceinline__ void load_weight(const float* g, int c, bool valid, float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 w = valid ? *reinterpret_cast<const float4*>(g + c + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    out[i] = w.x;
    out[i + 1] = w.y;
    out[i + 2] = w.z;
    out[i + 3] = w.w;
  }
}

// The same three moves for a row of n elements of T whose 16-byte slots need not be aligned or
// whole: the slot of 16 / sizeof(T) elements at column c. VEC: one 16-byte access (n is a multiple
// of the slot and the pointer 16-byte aligned); otherwise element by element, columns at or past n
// reading as 0 and not written. Either way the slot's bits sit in a uint4 as load16 gives them.
template <bool VEC, typename T>
__device__ __forceinline__ uint4 load_slot(const T* p, int c, int n) {
  constexpr int kN = 16 / static_cast<int>(sizeof(T));
  if constexpr (VEC) return load16(p + c, c < n);
  unsigned short h[8] = {};
  float f[4] = {};
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    if (c + e >= n) break;
    if constexpr (sizeof(T) == 2) h[e] = __bfloat16_as_ushort(p[c + e]);
    else f[e] = to_float(p[c + e]);
  }
  if constexpr (sizeof(T) == 2)
    return make_uint4(h[0] | (unsigned(h[1]) << 16), h[2] | (unsigned(h[3]) << 16),
                      h[4] | (unsigned(h[5]) << 16), h[6] | (unsigned(h[7]) << 16));
  else
    return pack16(f, static_cast<const float*>(nullptr));
}

template <bool VEC, typename T>
__device__ __forceinline__ void store_slot(T* p, int c, int n, const float* f) {
  constexpr int kN = 16 / static_cast<int>(sizeof(T));
  if constexpr (VEC) {
    if (c < n) *reinterpret_cast<uint4*>(p + c) = pack16(f, p);
    return;
  }
#pragma unroll
  for (int e = 0; e < kN; ++e)
    if (c + e < n) p[c + e] = from_float<T>(f[e]);
}

template <bool VEC, int N>
__device__ __forceinline__ void load_weight_slot(const float* g, int c, int n, float* out) {
  if constexpr (VEC) {
    load_weight<N>(g, c, c < n, out);
    return;
  }
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] = c + e < n ? g[c + e] : 0.f;
}

// The LayerNorm kernels' row layout (layernorm_fwd.cu, layernorm_bwd.cu): a row's 16-byte slots
// spread over TPR = 32, 64, 128 or 256 threads, at most kRowSlotsPerThread each; a block of 128
// threads holds 128 / TPR rows at once, a wider TPR is a block of its own.
constexpr int kRowSlotsPerThread = 4;
__host__ __device__ constexpr int row_block_threads(int tpr) { return tpr < 128 ? 128 : tpr; }

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Rows [r0, r0 + ROWS) of a (n, D) row-major array in global memory, times
// `scale`, into dst[ROWS][LD] f32 in shared memory; rows at or past n stage
// as zeros. 16-byte loads, all issued before any store, so they are in
// flight together. D * sizeof(T) is a multiple of 16 and `g` 16-byte aligned.
template <int THREADS, int ROWS, int D, int LD, typename T>
__device__ __forceinline__ void stage_rows(float (*dst)[LD], const T* g, int r0, int n,
                                           float scale) {
  constexpr int kVecN = 16 / static_cast<int>(sizeof(T));
  constexpr int kRowVecs = D / kVecN;
  constexpr int kVecs = ROWS * kRowVecs;
  constexpr int kLoads = (kVecs + THREADS - 1) / THREADS;
  uint4 raw[kLoads];
#pragma unroll
  for (int it = 0; it < kLoads; ++it) {
    const int i = static_cast<int>(threadIdx.x) + it * THREADS;
    const int r = i / kRowVecs, c = (i % kRowVecs) * kVecN;
    raw[it] = load16(g + static_cast<size_t>(r0 + r) * D + c, i < kVecs && r0 + r < n);
  }
#pragma unroll
  for (int it = 0; it < kLoads; ++it) {
    const int i = static_cast<int>(threadIdx.x) + it * THREADS;
    if (i >= kVecs) break;
    const int r = i / kRowVecs, c = (i % kRowVecs) * kVecN;
    float f[kVecN];
    unpack16(raw[it], f, g);
#pragma unroll
    for (int e = 0; e < kVecN; ++e) dst[r][c + e] = f[e] * scale;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

}  // namespace pgica

// Message for a code returned by an entry point (one definition per library).
extern "C" const char* pgica_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
