// Float32 building blocks shared by the register-tiled f32 flash kernels on the CUDA cores
// (flash_attn_fwd.cu: flash_attn_fwd_f32; flash_attn_bwd.cu: flash_attn_bwd_dq_f32 and
// flash_attn_bwd_dkv_f32). A 256-thread block works on tiles staged in shared memory with rows padded
// to D + 4 floats: the 8 lanes of a quarter-warp that read 8 consecutive rows as float4 hit 8
// different 16-byte bank groups. Each product element is one FMA chain over the D columns in order
// (tile_dots), so the forward and the backward form a score with the same bits.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace pgica {
namespace f32 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;           // rows of a block's resident tile (q rows, or keys in dK/dV)
constexpr int kTLd = kTile + 4;     // pitch of a transposed P or dS tile in shared memory
__host__ __device__ constexpr int ld(int d) { return d + 4; }  // pitch of a staged row, in floats

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
// a + i * a_step * LD and b[j] the row b + j * b_step * LD of staged tiles (pitch LD = ld(D)),
// read VEC floats at a time (float4, or float2 for half the registers); UNROLL steps unrolled.
template <int D, int NA, int NB, int UNROLL = 4, int VEC = 4>
__device__ __forceinline__ void tile_dots(float (&acc)[NA][NB], const float* a, int a_step, const float* b,
                                          int b_step) {
  static_assert(VEC == 4 || VEC == 2, "float4 or float2 reads");
  using Vec = typename std::conditional<VEC == 4, float4, float2>::type;
  constexpr int kLd = ld(D);
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[i][j] = 0.f;
#pragma unroll (UNROLL)
  for (int c = 0; c < D; c += VEC) {
    Vec x[NA], y[NB];
#pragma unroll
    for (int i = 0; i < NA; ++i) x[i] = *reinterpret_cast<const Vec*>(a + i * a_step * kLd + c);
#pragma unroll
    for (int j = 0; j < NB; ++j) y[j] = *reinterpret_cast<const Vec*>(b + j * b_step * kLd + c);
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        if constexpr (VEC == 4) {
          acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
          acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
        }
      }
  }
}

// ROWS rows [r0, r0 + ROWS) of a (n, D) f32 array into a staged tile (pitch ld(D)) by cp.async,
// 16 bytes a copy; rows at or past n as zeros.
template <int D, int ROWS>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0, int n) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool ok = r0 + r < n;
    cp_async16(smem_u32(dst + r * ld(D) + c), ok ? src + static_cast<size_t>(r0 + r) * D + c : src, ok);
  }
}

}  // namespace f32
}  // namespace pgica
