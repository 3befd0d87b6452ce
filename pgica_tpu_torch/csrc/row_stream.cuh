// A ring of whole rows in shared memory, filled by Hopper's bulk copy engine
// (TMA: cp.async.bulk, global -> shared, completion counted in bytes on an
// mbarrier), for the RMSNorm kernels (rmsnorm_fwd.cu, rmsnorm_bwd.cu).
//
// A block walks its rows b, b + G, b + 2G, ... (G blocks). One thread asks for
// the next rows' bytes, up to `stages` rows ahead, each stage with an
// mbarrier of its own; the other threads spend no registers or instructions
// on the copies. Use k of a stage (k = i / stages for the block's row i) waits
// on phase parity k & 1. A stage is refilled once every thread has read it:
// after the block-wide barrier of the row that used it.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace pgica {

__device__ __forceinline__ uint32_t shared_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_u32(bar)), "r"(count) : "memory");
}

// The barriers' initialization made visible to the bulk copy engine; then a __syncthreads.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of bulk copies to complete on `bar`.
__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(shared_u32(bar)), "r"(bytes)
               : "memory");
}

// An L2 policy that marks the lines it touches first to go: rows read once, then dead.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global `src` to shared `dst`, its
// lines in L2 under `policy`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], "
      "%4;\n" ::"r"(shared_u32(dst)),
      "l"(src), "r"(bytes), "r"(shared_u32(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = shared_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Rows a block of a G-block grid takes: b, b + G, ... below `rows`.
__device__ __forceinline__ int strided_rows(int rows) {
  return rows > static_cast<int>(blockIdx.x)
             ? (rows - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) / static_cast<int>(gridDim.x)
             : 0;
}

// The block's sum of v, the same in every thread, added in warp order. Callers alternate
// between the two halves of scratch[2][WARPS] by the parity of their iteration, so one
// barrier per call suffices: a half is written again only after the next call's barrier,
// which every thread reaches after it has read this one.
template <int WARPS>
__device__ __forceinline__ float block_sum2(float v, float (*scratch)[WARPS], int iteration) {
  v = warp_sum(v);
  float* half = scratch[iteration & 1];
  if constexpr (WARPS == 1) return v;
  if ((threadIdx.x & 31) == 0) half[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += half[w];
  return s;
}

}  // namespace pgica
