// Helpers shared by the port's hand-written kernels.
//
// Each kernel source is compiled by nvcc into a shared library of its own with
// a plain C interface (no PyTorch headers) and loaded with ctypes; see
// pgica_tpu_torch/ops/_kernels.py. Every C entry point launches on the stream
// it is given and returns cudaGetLastError(), which the Python wrapper turns
// into an exception.
#pragma once

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
