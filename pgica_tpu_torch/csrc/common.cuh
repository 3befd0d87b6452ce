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
