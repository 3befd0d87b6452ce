// Tensor-core building blocks shared by the port's redesigned kernels:
// cp.async copies into shared memory, ldmatrix fragment loads and the
// mma.sync m16n8k16 product (bf16 in, f32 accumulate), all sm_80 PTX that
// sm_90a runs.
//
// Fragment layouts of mma.m16n8k16.row.col (g = lane / 4, t = lane % 4):
//   A (16 x 16):  a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..), a2 = (g, 2t + 8..),
//                 a3 = (g + 8, 2t + 8..)
//   B (16 x 8):   b0 = (k 2t..2t+1, n g), b1 = (k 2t + 8.., n g)
//   C (16 x 8):   c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, 2t..2t+1)
// So the C fragments of two neighbouring 8-column tiles, packed to bf16, are
// the A fragment of a 16 x 16 tile (FlashAttention-2 keeps P in registers so).
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace pgica {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; !valid writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// As ldsm_x4, each matrix transposed: a row-major k x n tile gives B fragments.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a * b on the tensor cores: products of bf16 values are exact, sums f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as bf16 (round to nearest even), `first` in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float first, float second) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(first, second);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace pgica
