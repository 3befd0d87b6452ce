// The fused linear + cross-entropy kernels' GEMM template on Hopper's tensor
// cores (sm_90a), shared by the forward (fused_ce.cu) and the backward
// (fused_ce_bwd.cu).
//
// One block computes a 128 x 128 output tile, summed over k in 32-deep k
// tiles: 8 warps of 64 x 32, mma.sync m16n8k16 (bf16 in, f32 sums) fed by
// ldmatrix from a 3-stage cp.async ring. K-major tiles are padded to 40 bf16
// a row and the k-major tile of a product to 136, so ldmatrix reads no bank
// twice. A is m x k, K-major; B is K-major n x k (the score GEMMs: h W^T or
// W h^T) or k-major k x n (the backward's products). Rows past the end stage
// as zeros, so no operand is copied, transposed or padded.
//
// Precision. An f32 operand x goes in as bf16 parts (x0 = bf16(x), x1 =
// bf16(x - x0), x2 = bf16(x - x0 - x1), made once per call by `split_bf16`):
// x0 + x1 carries x to ~2^-17 of itself, x0 + x1 + x2 to f32's 2^-24. Each
// product of two bf16 values is exact in the f32 accumulator; a pass is the
// product of one part of each operand, and the passes whose parts' orders sum
// below ORDER are taken. The scores (ORDER kScoreOrder = 3) so take 1 pass for
// bf16 x bf16, 3 for one f32 operand (h bf16 with the f32 master W: h.W0 +
// h.W1 + h.W2) and 6 for two: the dropped terms are ~2^-24, the scores as
// exact as an f32 sum. The forward's lse and the backward's p then come from
// the same scores: the backward holds the forward's lse fixed, and a score
// error e moves p_y by p_y e, which at a sharp peak (p_y ~ 0.995) passes
// dh's bound unless the scores carry f32's accuracy (fused_ce_bwd.cu has the
// bound; tests/test_torch_fused_ce.py emulates both kernels' passes).
#pragma once

#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace pgica {
namespace fce {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128, kBK = 32;  // block tile; ops/fused_ce.py repeats kBN (GEMM_TILE)
constexpr int kStages = 3;
constexpr int kGemmThreads = 256;  // 8 warps: 2 (m) x 4 (n) of 64 x 32
constexpr int kLdK = kBK + 8;      // row of a K-major tile (128 rows x 32 k): 80 bytes
constexpr int kLdN = kBN + 8;      // row of a k-major tile (32 k x 128 n): 272 bytes
constexpr int kTileK = kBM * kLdK;
constexpr int kTileN = kBK * kLdN;
constexpr int kScoreOrder = 3;  // passes i + j < 3: f32 operands in 3 parts (the note has why)

// An operand as bf16 parts (one where it is bf16 itself; the split of an
// f32 one). Row r, column c of part i is at part[i][r * ld + c].
constexpr int kMaxParts = 3;
struct Operand {
  const bf16* part[kMaxParts];
  int ld;
};

// Per-launch roles of the GEMM and what the epilogues read and write.
struct Gemm {
  Operand a, b;
  int m, n, k;       // A rows; B columns; depth (dW's product: the live rows, read from `live`)
  int a_k_valid;     // columns of A that exist (k rounded up to 8)
  const int* y;
  const float* lse;
  const float* g;
  const int* live;   // dW: the number of rows with g != 0 (they come first)
  int v0, vocab;     // the first vocab column (the backward's chunk), V
  bf16* c0;          // the backward's coefficients in 2 parts: out; products: A
  bf16* c1;
  int ldc;           // their row stride (dh: the chunk; dW: N rounded up to 8)
  float* acc;        // dh's product: the N x d f32 sums over earlier chunks; the forward: its partials
  void* out;         // dh (dh's last chunk) or dW
  int first, last;   // dh's product
};

// PA, PB: the parts of A and B that the passes read.
template <int PA, int PB, bool B_KMAJOR>
struct Smem {
  static constexpr int kBTile = B_KMAJOR ? kTileK : kTileN;
  static constexpr int kA = kTileK * PA;
  static constexpr int kB = kBTile * PB;
  static constexpr int kStage = kA + kB;  // bf16 elements
  static constexpr int kBytes = kStages * kStage * 2;
};

// The GEMM mainloop: acc[mt][nt][e] of this warp's 64 x 32 tile, summed
// over k (columns of A past a_k_valid and rows of a k-major B past k stage
// as zeros) and over the passes A_i B_j with i < PA, j < PB, i + j < ORDER.
// Warp (wm, wn) = (warp / 4, warp % 4) holds rows wm * 64 + mt * 16 + lane / 4
// (+ 8 for e >= 2) and columns wn * 32 + nt * 8 + 2 (lane % 4) + e % 2.
// The tensor cores' f32 sums truncate: over one accumulator that runs
// through 33,792 vocab columns in 3 passes the drift toward 0 passed the
// f32 dh bound on the H100 (phase 3, h and W f32). So each 32-deep k tile
// is summed in `part` (at most 12 mma adds) and promoted into acc with
// round-to-nearest f32 adds on the CUDA cores. Ends with no copy in flight;
// other warps may still read the ring: sync before reusing it.
template <int PA, int PB, int ORDER, bool B_KMAJOR>
__device__ __forceinline__ void mainloop(const Gemm& p, int m0, int n0, int k, int a_k_valid, bf16* smem,
                                         float (&acc)[4][4][4]) {
  using S = Smem<PA, PB, B_KMAJOR>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_k = (k + kBK - 1) / kBK;
  auto load = [&](int stage, int kt) {
    bf16* sa = smem + stage * S::kStage;
    bf16* sb = sa + S::kA;
    const int k0 = kt * kBK;
#pragma unroll
    for (int it = 0; it < 2; ++it) {  // A: 128 rows x 4 vectors
      const int i = tid + it * kGemmThreads;
      const int r = i >> 2, c = (i & 3) * 8;
      const bool ok = m0 + r < p.m && k0 + c < a_k_valid;
      const size_t at = static_cast<size_t>(m0 + r) * p.a.ld + k0 + c;
#pragma unroll
      for (int part = 0; part < PA; ++part)
        pgica::cp_async16(pgica::smem_u32(sa + part * kTileK + r * kLdK + c), p.a.part[part] + (ok ? at : 0), ok);
    }
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int i = tid + it * kGemmThreads;
      int r, c, off;
      bool ok;
      size_t at;
      if constexpr (B_KMAJOR) {  // 128 rows of B x 4 vectors of k
        r = i >> 2;
        c = (i & 3) * 8;
        ok = n0 + r < p.n && k0 + c < k;
        at = static_cast<size_t>(n0 + r) * p.b.ld + k0 + c;
        off = r * kLdK + c;
      } else {  // 32 rows (k) x 16 vectors of n
        r = i >> 4;
        c = (i & 15) * 8;
        ok = k0 + r < k && n0 + c < p.n;
        at = static_cast<size_t>(k0 + r) * p.b.ld + n0 + c;
        off = r * kLdN + c;
      }
#pragma unroll
      for (int part = 0; part < PB; ++part)
        pgica::cp_async16(pgica::smem_u32(sb + part * S::kBTile + off), p.b.part[part] + (ok ? at : 0), ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load(s, s);
    pgica::cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < n_k; ++kt) {
    pgica::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt is in place; stage kt - 1 is consumed by every warp
    const int nxt = kt + kStages - 1;
    if (nxt < n_k) load(nxt % kStages, nxt);
    pgica::cp_async_commit();
    const bf16* sa = smem + (kt % kStages) * S::kStage;
    const bf16* sb = sa + S::kA;
    float part[4][4][4] = {};
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[PA][4][4], b[PB][4][2];
#pragma unroll
      for (int part = 0; part < PA; ++part)
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          pgica::ldsm_x4(a[part][mt], pgica::smem_u32(sa + part * kTileK +
                                                      (wm * 64 + mt * 16 + (lane & 15)) * kLdK + ks * 16 +
                                                      (lane >> 4) * 8));
#pragma unroll
      for (int part = 0; part < PB; ++part)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          if constexpr (B_KMAJOR)
            pgica::ldsm_x4(r, pgica::smem_u32(sb + part * S::kBTile +
                                              (wn * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8) * kLdK +
                                              ks * 16 + ((lane >> 3) & 1) * 8));
          else
            pgica::ldsm_x4_trans(r, pgica::smem_u32(sb + part * S::kBTile +
                                                    (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdN +
                                                    wn * 32 + np * 16 + (lane >> 4) * 8));
          b[part][2 * np][0] = r[0];
          b[part][2 * np][1] = r[1];
          b[part][2 * np + 1][0] = r[2];
          b[part][2 * np + 1][1] = r[3];
        }
#pragma unroll
      for (int i = 0; i < PA; ++i)
#pragma unroll
        for (int j = 0; j < PB; ++j)
          if (i + j < ORDER)
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) pgica::mma_bf16(part[mt][nt], a[i][mt], b[j][nt][0], b[j][nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }
  pgica::cp_async_wait<0>();
}

// x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1) into parts[0..2]
// (each `count` long), 4 values a thread (count % 4 == 0).
__global__ void split_bf16(const float* __restrict__ x, bf16* __restrict__ parts, size_t count) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x * 4;
  for (size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4; i < count; i += stride) {
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    float r[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int part = 0; part < kMaxParts; ++part) {
      float q[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        q[e] = __bfloat162float(__float2bfloat16(r[e]));
        r[e] -= q[e];
      }
      *reinterpret_cast<uint2*>(parts + part * count + i) =
          make_uint2(pgica::pack_bf16x2(q[0], q[1]), pgica::pack_bf16x2(q[2], q[3]));
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return bytes > 48 * 1024 ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
                           : cudaSuccess;
}

// An operand as bf16: itself, or its 3 parts made in `scratch`.
inline Operand as_bf16(const void* x, bool f32, void* scratch, size_t count, int ld, cudaStream_t stream) {
  if (!f32) return Operand{{static_cast<const bf16*>(x), nullptr, nullptr}, ld};
  auto* parts = static_cast<bf16*>(scratch);
  const int blocks = static_cast<int>(std::min<size_t>((count / 4 + 255) / 256, 132 * 16));
  split_bf16<<<blocks, 256, 0, stream>>>(static_cast<const float*>(x), parts, count);
  return Operand{{parts, parts + count, parts + 2 * count}, ld};
}

}  // namespace fce
}  // namespace pgica
