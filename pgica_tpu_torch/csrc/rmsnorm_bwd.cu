// RMSNorm backward for Hopper (sm_90a).
//
// Replaces: pgica_tpu/ops/layernorm.py:127 `_rms_bwd_kernel` (Pallas, TPU).
//   With xhat = x * rstd from the forward's f32 rstd:
//     dx = rstd * (dy * g - xhat * mean(dy * g * xhat))   (x's dtype)
//     dg = sum over rows of dy * xhat                     (f32)
//
// What bounds it on the H100: memory. It reads x and dy and writes dx (plus
// rstd, g and dg) for ~8 flops per element, far below the ~295 flops per byte
// where the card stops being memory-bound: 50.4 MB, 15.0 us at 3.35 TB/s at
// the Llama training shape (2048, 4096) in bf16.
//
// Design: one cooperative launch of G blocks, G = min(rows, MAX_PARTS = 114)
// from ops/rmsnorm.py:bwd_partition (a function of the row count alone, so
// the order of every sum, and so dg's bits, are the same on every H100).
// * Rows. Block b walks the rows b, b + G, ... in order. A row's 16-byte
//   slots spread over 256 threads, NS a thread, with the matching slice of g
//   and of the block's dg in registers. x and dy arrive through a ring of four
//   whole rows of each in shared memory that one thread fills with bulk
//   copies (row_stream.cuh), their lines in L2 marked evict-first, so a block
//   keeps three rows of loads in flight through each row's reduction and dx
//   stores (st.global.cs), whatever the number of its rows; rstd comes 32
//   rows at a time, one a lane, a chunk ahead. The row mean is a warp
//   butterfly and the warps' sums through shared memory in warp order, one
//   barrier a row, after which the row's stage is refilled.
// * dg. A thread owns the same columns in every row of its block, so its
//   slice of dg is a register accumulator added in row order; the block
//   writes it as one f32 partial row. After a grid-wide barrier
//   (cooperative_groups; the launch is refused where G blocks would not be
//   co-resident on an H100 of 114 SMs) the partials are added in one fixed
//   order, chain w (of 8) summing the partials w, w + 8, ... and the chains
//   meeting in order: a warp a chain and 32 columns a block where G is large,
//   a thread all chains of four columns where G <= 32 (decode's few rows,
//   whose few blocks would otherwise walk every column chunk in turn). No
//   atomics: dg is the same bit for bit from run to run. Rows past a call's
//   last live row with dy = 0 add exactly 0 at the end of their block's sum,
//   and their blocks' zero partials come after the live ones in every chain,
//   so a call with dead rows at the end gives the dg of the call without
//   them (tests/test_torch_llama.py emulates the order).
// * Rows wider than the ring's instances (H > 4,096) take the wide instance:
//   the same partition and sums, each row read twice (its mean, then dx), its
//   dg slice kept in the block's partial row in global memory.
// The launch is the time floor at few rows: at 4-32 rows most of the ~6 us
// is the cooperative launch, the barrier and the sum.
#include <cooperative_groups.h>

#include <algorithm>
#include <initializer_list>

#include "row_stream.cuh"

namespace {

using pgica::block_sum2;
using pgica::load16;
using pgica::load_weight;
using pgica::pack16;
using pgica::unpack16;

constexpr int kMaxParts = 114;    // ops/rmsnorm.py: MAX_PARTS, one block a SM of an H100 PCIe
constexpr int kAnyH100Sms = 114;  // the H100 PCIe; the SXM and NVL parts have 132
// The ring's layout, from sweeps on an H100 SXM at (2048, 4096) bf16 and f32: 256 threads, four rows of x
// and dy in the ring (64 KB in bf16, 128 KB in f32), one block a SM.
constexpr int kStreamThreads = 256;
constexpr int kStreamStages = 4;
constexpr int kRingBytes = 128 * 1024;
constexpr int kWideThreads = 256;

template <int N>
__device__ __forceinline__ void store_f32(float* dst, const float* v) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(dst + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

// dg[c] = sum over w < warps of (sum over k of partials[w + k * warps][c]): chain w adds its partials
// in order from 0, the chains meet in order; after the grid-wide barrier. Two ways to the same bits.
// Many blocks: a block takes 32 columns, warp w computes chain w with every load issued before the
// first add, and the chains meet in shared memory.
template <int THREADS>
__device__ __forceinline__ void sum_partials_by_warp(const float* partials, float* __restrict__ dg, int hidden) {
  constexpr int kWarps = THREADS / 32;
  constexpr int kPerWarp = (kMaxParts + kWarps - 1) / kWarps;
  __shared__ float sum_s[kWarps][32];
  const int n_parts = static_cast<int>(gridDim.x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = (hidden + 31) / 32;
  for (int u = blockIdx.x; u < chunks; u += n_parts) {  // block-uniform
    const int c = u * 32 + lane;
    float v[kPerWarp];
#pragma unroll
    for (int k = 0; k < kPerWarp; ++k) {
      const int p = warp + k * kWarps;
      v[k] = p < n_parts && c < hidden ? __ldcg(partials + static_cast<size_t>(p) * hidden + c) : 0.f;
    }
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < kPerWarp; ++k)
      if (warp + k * kWarps < n_parts) a += v[k];
    sum_s[warp][lane] = a;
    __syncthreads();
    if (warp == 0 && c < hidden) {
#pragma unroll
      for (int w = 1; w < kWarps; ++w) a += sum_s[w][lane];
      dg[c] = a;
    }
    __syncthreads();
  }
}

// Few blocks (at most kFewParts partials): a thread takes four columns and computes every chain
// itself, a partial of each chain loaded at once.
constexpr int kFewParts = 32;

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

template <int THREADS>
__device__ __forceinline__ void sum_partials_by_column(const float* partials, float* __restrict__ dg,
                                                       int hidden) {
  constexpr int kWarps = THREADS / 32;
  const int n_parts = static_cast<int>(gridDim.x);
  for (int c = (blockIdx.x * THREADS + threadIdx.x) * 4; c < hidden; c += n_parts * THREADS * 4) {
    float4 chain[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) chain[w] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
    for (int k0 = 0; k0 < n_parts; k0 += kWarps) {
      float4 v[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        v[w] = k0 + w < n_parts
                   ? __ldcg(reinterpret_cast<const float4*>(partials + static_cast<size_t>(k0 + w) * hidden + c))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (k0 + w < n_parts) add4(chain[w], v[w]);
    }
    float4 total = chain[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) add4(total, chain[w]);
    *reinterpret_cast<float4*>(dg + c) = total;
  }
}

template <int THREADS>
__device__ __forceinline__ void sum_partials(const float* partials, float* __restrict__ dg, int hidden) {
  if (static_cast<int>(gridDim.x) <= kFewParts)
    sum_partials_by_column<THREADS>(partials, dg, hidden);
  else
    sum_partials_by_warp<THREADS>(partials, dg, hidden);
}

template <typename T, int THREADS, int NS>
__global__ void __launch_bounds__(THREADS, 2)
    rmsnorm_bwd_stream(const T* __restrict__ x, const float* __restrict__ g, const T* __restrict__ dy,
                       const float* __restrict__ rstd, T* __restrict__ dx, float* partials,
                       float* __restrict__ dg, int rows, int hidden, int stages) {
  constexpr int kN = 16 / static_cast<int>(sizeof(T));
  constexpr int kWarps = THREADS / 32;
  extern __shared__ __align__(128) unsigned char ring[];  // stages x (a row of x, the row of dy)
  __shared__ uint64_t bar[kStreamStages];
  __shared__ float red_s[2][kWarps];
  const int n = pgica::strided_rows(rows);
  const int grid = static_cast<int>(gridDim.x);
  const unsigned row_bytes = static_cast<unsigned>(hidden) * sizeof(T);
  const int slots = hidden / kN;
  const int lane = threadIdx.x & 31;
  const float inv_h = 1.f / static_cast<float>(hidden);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) pgica::mbar_init(&bar[s], 1);
    pgica::mbar_init_fence();
  }
  __syncthreads();
  const uint64_t policy = pgica::evict_first_policy();
  auto fill = [&](int i) {  // the block's row i of x and dy into stage i % stages
    const int s = i % stages;
    const size_t at = (static_cast<size_t>(blockIdx.x) + static_cast<size_t>(i) * grid) * hidden;
    unsigned char* dst = ring + static_cast<size_t>(s) * 2 * row_bytes;
    pgica::mbar_expect_bytes(&bar[s], 2 * row_bytes);
    pgica::bulk_copy(dst, x + at, row_bytes, &bar[s], policy);
    pgica::bulk_copy(dst + row_bytes, dy + at, row_bytes, &bar[s], policy);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < min(stages, n); ++i) fill(i);

  float w[NS][kN], acc[NS][kN];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int c = threadIdx.x + j * THREADS;
    load_weight<kN>(g, c * kN, c < slots, w[j]);
#pragma unroll
    for (int e = 0; e < kN; ++e) acc[j][e] = 0.f;
  }
  // the block's rows' rstd, 32 at a time: lane l holds row 32 q + l's, the next chunk loading meanwhile
  auto rstd_of = [&](int i) { return i < n ? rstd[blockIdx.x + static_cast<size_t>(i) * grid] : 0.f; };
  float rs_now = rstd_of(lane), rs_next = rstd_of(32 + lane);

#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    if (i > 0 && (i & 31) == 0) {
      rs_now = rs_next;
      rs_next = rstd_of(i + 32 + lane);
    }
    const float rs = __shfl_sync(0xffffffffu, rs_now, i & 31);
    const int s = i % stages;
    pgica::mbar_wait(&bar[s], static_cast<unsigned>(i / stages) & 1u);
    const T* xs = reinterpret_cast<const T*>(ring + static_cast<size_t>(s) * 2 * row_bytes);
    const T* ds = reinterpret_cast<const T*>(ring + static_cast<size_t>(s) * 2 * row_bytes + row_bytes);
    float xh[NS][kN], gdy[NS][kN];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int c = threadIdx.x + j * THREADS;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      float xv[kN], dv[kN];
      unpack16(c < slots ? *reinterpret_cast<const uint4*>(xs + c * kN) : zero, xv, x);
      unpack16(c < slots ? *reinterpret_cast<const uint4*>(ds + c * kN) : zero, dv, dy);
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        xh[j][e] = xv[e] * rs;
        gdy[j][e] = dv[e] * w[j][e];
        sum += gdy[j][e] * xh[j][e];
        acc[j][e] += dv[e] * xh[j][e];
      }
    }
    const float m2 = block_sum2<kWarps>(sum, red_s, i) * inv_h;  // every thread has read stage s
    if (threadIdx.x == 0 && i + stages < n) fill(i + stages);
    T* dst = dx + (static_cast<size_t>(blockIdx.x) + static_cast<size_t>(i) * grid) * hidden;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int c = threadIdx.x + j * THREADS;
      if (c >= slots) break;
      float out[kN];
#pragma unroll
      for (int e = 0; e < kN; ++e) out[e] = rs * (gdy[j][e] - xh[j][e] * m2);
      __stcs(reinterpret_cast<uint4*>(dst + c * kN), pack16(out, dx));  // streamed: evict first
    }
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int c = threadIdx.x + j * THREADS;
    if (c >= slots) break;
    store_f32<kN>(partials + static_cast<size_t>(blockIdx.x) * hidden + c * kN, acc[j]);
  }
  cooperative_groups::this_grid().sync();  // every partial written and visible
  sum_partials<THREADS>(partials, dg, hidden);
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads, 2)
    rmsnorm_bwd_wide(const T* __restrict__ x, const float* __restrict__ g, const T* __restrict__ dy,
                     const float* __restrict__ rstd, T* __restrict__ dx, float* partials, float* __restrict__ dg,
                     int rows, int hidden, int /*stages*/) {
  constexpr int kN = 16 / static_cast<int>(sizeof(T));
  __shared__ float red_s[2][kWideThreads / 32];
  const int n = pgica::strided_rows(rows);
  const int grid = static_cast<int>(gridDim.x);
  const int slots = hidden / kN;
  const float inv_h = 1.f / static_cast<float>(hidden);
  float* part = partials + static_cast<size_t>(blockIdx.x) * hidden;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const size_t base = (static_cast<size_t>(blockIdx.x) + static_cast<size_t>(i) * grid) * hidden;
    const float rs = rstd[blockIdx.x + static_cast<size_t>(i) * grid];
    float sum = 0.f;
    for (int c = threadIdx.x; c < slots; c += kWideThreads) {
      float xv[kN], dv[kN], w[kN];
      unpack16(load16(x + base + static_cast<size_t>(c) * kN, true), xv, x);
      unpack16(load16(dy + base + static_cast<size_t>(c) * kN, true), dv, dy);
      load_weight<kN>(g, c * kN, true, w);
#pragma unroll
      for (int e = 0; e < kN; ++e) sum += (dv[e] * w[e]) * (xv[e] * rs);
    }
    const float m2 = block_sum2<kWideThreads / 32>(sum, red_s, i) * inv_h;
    for (int c = threadIdx.x; c < slots; c += kWideThreads) {  // the same columns as above: own writes
      float xv[kN], dv[kN], w[kN], out[kN], acc[kN];
      unpack16(load16(x + base + static_cast<size_t>(c) * kN, true), xv, x);
      unpack16(load16(dy + base + static_cast<size_t>(c) * kN, true), dv, dy);
      load_weight<kN>(g, c * kN, true, w);
      if (i == 0) {
#pragma unroll
        for (int e = 0; e < kN; ++e) acc[e] = 0.f;
      } else {
        load_weight<kN>(part, c * kN, true, acc);
      }
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float xh = xv[e] * rs;
        out[e] = rs * (dv[e] * w[e] - xh * m2);
        acc[e] += dv[e] * xh;
      }
      *reinterpret_cast<uint4*>(dx + base + static_cast<size_t>(c) * kN) = pack16(out, dx);
      store_f32<kN>(part + c * kN, acc);
    }
  }
  cooperative_groups::this_grid().sync();  // every partial written and visible
  sum_partials<kWideThreads>(partials, dg, hidden);
}

int slots_per_thread(int slots, int threads) {
  const int need = (slots + threads - 1) / threads;
  for (int ns : {1, 2, 4})
    if (need <= ns) return ns;
  return 0;
}

template <typename T>
using Kernel = void (*)(const T*, const float*, const T*, const float*, T*, float*, float*, int, int, int);

// The ring's instances that keep their four slices of NS slots (g, dg, xhat, dy * g) in the registers a
// thread of 256 has at two blocks a SM, with ~32 to spare (H <= 4,096 in bf16 and f32); no other is built.
template <typename T, int NS>
Kernel<T> stream_kernel() {
  constexpr int kN = 16 / static_cast<int>(sizeof(T));
  if constexpr (4 * NS * kN + 32 <= 65536 / (2 * kStreamThreads)) return rmsnorm_bwd_stream<T, kStreamThreads, NS>;
  return nullptr;
}

template <typename T>
Kernel<T> stream_instance(int hidden) {
  constexpr int kN = 16 / static_cast<int>(sizeof(T));
  switch (slots_per_thread(hidden / kN, kStreamThreads)) {
    case 1: return stream_kernel<T, 1>();
    case 2: return stream_kernel<T, 2>();
    case 4: return stream_kernel<T, 4>();
    default: return nullptr;
  }
}

template <typename T>
int launch_cooperative(Kernel<T> kernel, int threads, size_t smem, const void* x, const void* g, const void* dy,
                       const void* rstd, void* dx, void* dg, void* partials, int rows, int hidden, int n_parts,
                       int stages, cudaStream_t stream) {
  if (smem > 0) {  // the ring: with the kernel's static shared memory, past the 48 KB a block gets unasked
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0;
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (occ != cudaSuccess) return static_cast<int>(occ);
  if (per_sm * kAnyH100Sms < n_parts) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const auto* xp = static_cast<const T*>(x);
  const auto* gp = static_cast<const float*>(g);
  const auto* dyp = static_cast<const T*>(dy);
  const auto* rp = static_cast<const float*>(rstd);
  auto* dxp = static_cast<T*>(dx);
  auto* pp = static_cast<float*>(partials);
  auto* dgp = static_cast<float*>(dg);
  void* args[] = {&xp, &gp, &dyp, &rp, &dxp, &pp, &dgp, &rows, &hidden, &stages};
  return static_cast<int>(
      cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), n_parts, threads, args, smem, stream));
}

// The ring's instance where one holds a thread's slots and the ring two rows of x and dy or more; the wide
// one beyond (H > 4,096).
template <typename T>
int run(const void* x, const void* g, const void* dy, const void* rstd, void* dx, void* dg, void* partials,
        int rows, int hidden, int n_parts, cudaStream_t stream) {
  if (n_parts < 1 || n_parts > std::min(rows, kMaxParts)) return static_cast<int>(cudaErrorInvalidValue);
  const int stages = std::min(kStreamStages, kRingBytes / (2 * hidden * static_cast<int>(sizeof(T))));
  const Kernel<T> kernel = stream_instance<T>(hidden);
  if (kernel == nullptr || stages < 2)
    return launch_cooperative<T>(rmsnorm_bwd_wide<T>, kWideThreads, 0, x, g, dy, rstd, dx, dg, partials, rows,
                                 hidden, n_parts, 0, stream);
  const size_t smem = static_cast<size_t>(stages) * 2 * hidden * sizeof(T);
  return launch_cooperative<T>(kernel, kStreamThreads, smem, x, g, dy, rstd, dx, dg, partials, rows, hidden, n_parts,
                               stages, stream);
}

}  // namespace

// x, dy, dx: (rows, hidden) contiguous in `dtype`, hidden % 8 == 0, 16-byte
// aligned; g, dg: (hidden,) f32 (g 16-byte aligned); rstd: (rows,) f32 from
// the forward; partials: f32 scratch of n_parts * hidden, n_parts the blocks
// of ops/rmsnorm.py:bwd_partition (at most min(rows, 228)). Returns a
// cudaError_t code (0 = launched).
extern "C" int pgica_rmsnorm_bwd(const void* x, const void* g, const void* dy, const void* rstd,
                                 void* dx, void* dg, void* partials, int rows, int hidden, int n_parts,
                                 int dtype, void* stream) {
  if (rows <= 0 || hidden <= 0 || hidden % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == pgica::kFloat32) return run<float>(x, g, dy, rstd, dx, dg, partials, rows, hidden, n_parts, s);
  if (dtype == pgica::kBFloat16)
    return run<__nv_bfloat16>(x, g, dy, rstd, dx, dg, partials, rows, hidden, n_parts, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
