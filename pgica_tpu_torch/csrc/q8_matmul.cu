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
// * W8A8 (`pgica_q8_matmul_w8a8`, kernel `gemm_w8a8_fused`): one launch. Each
//   row's amax in f32, sx = max(amax, 1e-12) / 127 and q = rint(x / sx) (IEEE
//   division, round half to even) clamped to +-127: bit for bit the JAX
//   package's `_quantize_rows`, computed inside the product. The int8 x int8
//   products are summed in int32 on the tensor cores (mma.sync m16n8k32 s8),
//   exactly, and the output is (float(acc) * sx[m]) * scale[n] in the output
//   dtype plus the bias rounded to that dtype, as quant.py:133-135 does. The
//   row scales go to `sx`.
// * Weight-only (`pgica_q8_matmul_w8`): bf16 (`gemm_w8_bf16_tiled`) dequantizes
//   the int8 weight in registers as bf16(float(q) * float(bf16(scale[n]))),
//   which is XLA's `kernel_q.astype(bf16) * scale.astype(bf16)` bit for bit,
//   then mma.sync m16n8k16 bf16 with f32 sums; f32 (the smoke config's type)
//   takes a CUDA-core kernel (`gemm_w8_f32`) with float(q) * scale in f32.
//
// What bounds it on the H100: memory. At decode's M <= 128 the work is about
// 2 M flops per weight byte, far below the ~590 int8 (~295 bf16) operations
// per byte at which the tensor cores would be the limit; the floor is the
// weight's N * K bytes (plus x and y) over 3.35 TB/s: 0.31 us for a GPT-2
// Medium 1024 x 1024 projection, 17.5 us for a Llama-3-8B 14336 x 4096 one.
// What the card spends beyond it is in re-reading x: a block that owns few
// output columns reads all of x again through L2 (the first design's 8-column
// blocks moved 32x the weight's bytes in x at 128 rows), in W8A8 in
// quantizing it again, and in each launch's fixed latency.
//
// Design of the two tensor-core kernels:
// * Swapped operands: the weight is the 16-row A operand, x's rows the n8 B
//   operand, so 1-8 rows fill one n8 tile; C holds (output column, row).
// * A block owns 64 or 128 output columns (4 or 8 warps of 16 weight rows; a
//   second set of 4 warps takes half the rows of 64-column blocks from 16 rows
//   on) and a tile of 8-32 of x's rows (weight-only also 128; more rows: more
//   tiles, grid.y). x's slice of the block reaches shared memory once, by
//   cp.async in the commit group of the weight's same k chunk (weight-only: it
//   stays for the whole K loop; W8A8: into a slot beside the weight's, then
//   quantized into the int8 tile of the chunk in use), so x moves
//   ceil(N / columns) times through L2 instead of N / 8.
// * The weight streams through a kStages-deep ring of 128-byte-wide tiles filled
//   by cp.async; fragments come by ldmatrix (int8: the A and B fragments of
//   m16n8k32 are ldmatrix's b16 layout; weight-only: A by ldmatrix, dequantized
//   in registers (`dequant2`), x's B fragments by 8-byte ld.shared, the k index
//   permuted so that lane t's bytes 4t..4t+3 and 16+4t.. of a 32-wide k step are
//   the fragment columns of two m16n8k16 products). Rows are padded (16 bytes
//   for ldmatrix, 32 for the 8-byte reads) so a warp's shared reads are
//   conflict-free. Column tiles start their k loops at different chunks, so
//   that the card's requests spread over the weight's rows.
// * K is split over a thread-block cluster of `split` blocks (1-8, portable
//   size) that own the same columns: block r takes the r-th run of 128-wide k
//   chunks. Their partial tiles meet through distributed shared memory, each
//   pushed to the block that owns its rows, and are summed there in rank order
//   (int32: exact; f32: a fixed order). One launch, no atomics, no scratch: two
//   runs are bit-equal.
// * W8A8's rows: each block reads their amax from L2 while its first chunks
//   fly, over whole rows where a thread takes at most 16 pieces of them, else
//   over its k slice with the cluster's blocks pushing theirs to one another
//   (a cluster barrier more). Every column tile quantizes its rows again (ALU
//   work beside the products; the int8 copy of x never leaves shared memory).
//   The division x / sx is a multiply by 1 / sx rounded once a row, rounded to the
//   integer in one FMA, with the division itself where the product falls within
//   4e-5 of a half-integer (`quantize_piece`): exactly rint(__fdiv_rn(x, sx)),
//   in a third of the division's operations.
// * The tiling comes from (M, N, K) in `plan_for`, never from a failure, chosen
//   by timing tilings on the H100 (the int8 table of PERF.md): about 128 blocks,
//   all resident at once (occupancy query); e.g. GPT-2 Medium's q/k/v at 1-8
//   rows 16 column tiles x a split of 8, Llama-3-8B's gate/up 112 x 2. A
//   block's column scale and bias are loaded while its first copies fly, and
//   kept in registers until the epilogue.
// Rows, columns and K past the ends read as zeros and are not written; K that
// is no multiple of 16 (or an unaligned pointer) stages element by element.
// No host sync and no allocation: a CUDA graph captures both entry points (the
// occupancy query runs once per tiling, in the eager call before a capture).
#include <cooperative_groups.h>

#include <algorithm>
#include <initializer_list>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

using pgica::from_float;
using pgica::to_float;

// ------------------------------------------------------------ tiling of the tensor-core kernels

constexpr int kBK = 128;              // k a ring stage holds: 128 bytes of each weight row
constexpr int kStages = 4;            // ring depth: 3 weight tiles in flight behind the one in use
constexpr int kWPitch = kBK + 16;     // bytes a staged weight row takes (rows 16 B apart mod 128)
constexpr int kMaxSplit = 8;          // blocks of a cluster (the portable limit)
constexpr int kSmemCap = 200 * 1024;  // dynamic shared memory a block may ask for

// The cluster's partial tiles of a block (rows x columns + 4, 4-byte words): a region of their own up to 20 KB
// (no barrier before they are pushed), else in the ring once every block of the cluster is done with it.
__host__ __device__ constexpr int recv_bytes(int bn, int mt) { return 8 * mt * (bn + 4) * 4; }
__host__ __device__ constexpr bool own_recv(int bn, int mt) { return recv_bytes(bn, mt) <= 20 * 1024; }

template <int BN, int MT>
struct Tiling {
  static constexpr int kRows = 8 * MT;                                // x rows a block holds
  static constexpr int kWarpsN = BN / 16;                             // warps over the columns
  static constexpr int kWarpsM = BN == 64 && MT >= 2 ? 2 : 1;       // warps over the rows
  static constexpr int kTiles = MT / kWarpsM;                         // n8 tiles of rows a warp takes
  static constexpr int kThreads = 32 * kWarpsN * kWarpsM;
  static constexpr int kPartPitch = BN + 4;                           // partial tile row, in 4-byte words
  static constexpr int kRingBytes = kStages * BN * kWPitch;
  static constexpr int kRecvBytes = recv_bytes(BN, MT);
  static constexpr bool kOwnRecv = own_recv(BN, MT);
  static constexpr int kXOffset = kRingBytes + (kOwnRecv ? kRecvBytes : 0);  // the resident x
  static_assert(kRecvBytes <= kRingBytes, "the cluster's partial tiles fit the ring");
};

// bytes of one resident x row: int8 (W8A8) or bf16 (weight-only) over `chunks` k chunks, padded
__host__ __device__ constexpr int x_pitch(int chunks, int elem_bytes) { return elem_bytes * (chunks * kBK + 16); }

// W8A8: bytes of a row of one k chunk of x as it is (f32 or bf16), and of the chunk quantized, padded
__host__ __device__ constexpr int raw_pitch(int elem_bytes) { return elem_bytes * kBK + 16; }
constexpr int kQPitch = kBK + 16;

__host__ __device__ constexpr int k_chunks(int K) { return (K + kBK - 1) / kBK; }

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n" : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// A cluster barrier in two halves: every block arrives at its start and waits before its first access to another
// block's shared memory, which is then sure to exist.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// y = v rounded to TO, plus the bias rounded to TO, the sum rounded to TO (JAX: y + bias.astype(dtype)).
template <typename TO>
__device__ __forceinline__ TO with_bias(float v, const float* bias, int n) {
  const TO y = from_float<TO>(v);
  if (bias == nullptr) return y;
  return from_float<TO>(__fadd_rn(to_float(y), to_float(from_float<TO>(bias[n]))));
}

// The same with the bias value at hand (has_bias false: no bias).
template <typename TO>
__device__ __forceinline__ TO with_bias_value(float v, bool has_bias, float b) {
  const TO y = from_float<TO>(v);
  if (!has_bias) return y;
  return from_float<TO>(__fadd_rn(to_float(y), to_float(from_float<TO>(b))));
}

// 16 bytes of an int8 row at column k, element by element; zeros past K (K no multiple of 16, or unaligned).
__device__ __noinline__ uint4 bytes16_scalar(const int8_t* row, int k, int K) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (k + e < K) w[e >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(row[k + e])) << (8 * (e & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The weight's tile of chunk k0: rows n0.. n0 + BN, bytes k0.. k0 + 128, into ring slot `dst`.
template <int BN, int THREADS>
__device__ __forceinline__ void stage_weight(int8_t* dst, const int8_t* w, int n0, int N, int k0, int K, bool vec) {
  constexpr int kPieces = BN * (kBK / 16);
#pragma unroll
  for (int it = 0; it < kPieces / THREADS; ++it) {
    const int i = static_cast<int>(threadIdx.x) + it * THREADS;
    const int r = i / (kBK / 16), c = (i % (kBK / 16)) * 16, n = n0 + r, k = k0 + c;
    int8_t* d = dst + r * kWPitch + c;
    if (vec) {
      const bool ok = n < N && k < K;
      pgica::cp_async16(pgica::smem_u32(d), ok ? w + static_cast<size_t>(n) * K + k : w, ok);
    } else {
      *reinterpret_cast<uint4*>(d) =
          n < N ? bytes16_scalar(w + static_cast<size_t>(n) * K, k, K) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// ------------------------------------------------------------ the k loop shared by both kernels

// Products of one ring slot (128 k) with the resident x at column xk: W8A8, int8 x.
template <int TILES>
__device__ __forceinline__ void chunk_s8(int (&acc)[TILES][4], const int8_t* ws, const int8_t* xb, int xp, int lane) {
#pragma unroll
  for (int ks = 0; ks < kBK / 32; ++ks) {
    uint32_t a[4];
    pgica::ldsm_x4(a, pgica::smem_u32(ws + (lane & 15) * kWPitch + ks * 32 + (lane >> 4) * 16));
    if constexpr (TILES == 1) {
      uint32_t b[2];
      ldsm_x2(b, pgica::smem_u32(xb + (lane & 7) * xp + ks * 32 + ((lane >> 3) & 1) * 16));
      mma_s8(acc[0], a, b[0], b[1]);
    } else {
#pragma unroll
      for (int j = 0; j < TILES; j += 2) {
        uint32_t b[4];
        pgica::ldsm_x4(b, pgica::smem_u32(xb + ((j + (lane >> 4)) * 8 + (lane & 7)) * xp + ks * 32 +
                                          ((lane >> 3) & 1) * 16));
        mma_s8(acc[j], a, b[0], b[1]);
        mma_s8(acc[j + 1], a, b[2], b[3]);
      }
    }
  }
}

// bf16(float(q) * s) of the int8 bytes 2h, 2h + 1 of a word, packed (byte 2h in the low half), from
// biased = word ^ 0x80808080 and s2 = (s, s) in bf16: each byte b + 128 becomes the float 2^23 + b + 128 by a
// byte permute, less 2^23 + 128 that is b exactly; two such pack exactly into bf16 (|b| <= 127), and one
// bf16x2 product rounds q * s once, which is bf16(float(q) * float(bf16(scale))).
__device__ __forceinline__ uint32_t dequant2(uint32_t biased, int h, __nv_bfloat162 s2) {
  const float q0 = __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 + 2 * h)), 8388736.f);
  const float q1 = __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7441 + 2 * h)), 8388736.f);
  const __nv_bfloat162 p = __hmul2(__floats2bfloat162_rn(q0, q1), s2);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Weight-only: the same slot, its int8 tile dequantized in registers, against resident bf16 x (xp in bytes).
// In a 32-wide k step lane (g, t) holds k 4t..4t+3 and 16 + 4t.. of its rows; the first m16n8k16 product takes
// 4t, 4t + 1 as fragment columns 2t, 2t + 1 and 4t + 2, 4t + 3 as 2t + 8, 2t + 9; the second the same 16 on.
template <int TILES>
__device__ __forceinline__ void chunk_bf16(float (&acc)[TILES][4], const int8_t* ws, const __nv_bfloat16* xb, int xp,
                                           int lane, __nv_bfloat162 s_lo, __nv_bfloat162 s_hi) {
  const int g = lane >> 2, t = lane & 3;
  const uint32_t xrow = pgica::smem_u32(xb) + g * xp + 8 * t;
#pragma unroll
  for (int ks = 0; ks < kBK / 32; ++ks) {
    uint32_t a[4];
    pgica::ldsm_x4(a, pgica::smem_u32(ws + (lane & 15) * kWPitch + ks * 32 + (lane >> 4) * 16));
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] ^= 0x80808080u;
    const uint32_t a0[4] = {dequant2(a[0], 0, s_lo), dequant2(a[1], 0, s_hi), dequant2(a[0], 1, s_lo),
                            dequant2(a[1], 1, s_hi)};
    const uint32_t a1[4] = {dequant2(a[2], 0, s_lo), dequant2(a[3], 0, s_hi), dequant2(a[2], 1, s_lo),
                            dequant2(a[3], 1, s_hi)};
#pragma unroll
    for (int j = 0; j < TILES; ++j) {
      const uint32_t at = xrow + j * 8 * xp + ks * 64;
      const uint2 b0 = lds64(at), b1 = lds64(at + 32);
      pgica::mma_bf16(acc[j], a0, b0.x, b0.y);
      pgica::mma_bf16(acc[j], a1, b1.x, b1.y);
    }
  }
}

// This rank's run of the K chunks: nc chunks from kbase, taken from chunk `rot` on (wrapping), so that the
// column tiles, which all start together, read different k at once rather than one 128-byte column of every
// weight row (a power-of-two stride that piles the requests onto few memory channels).
struct KSlice {
  int kbase, nc, rot;
  __device__ __forceinline__ int k(int c) const { return (c + rot < nc ? c + rot : c + rot - nc) * kBK; }  // c-th taken
};
__device__ __forceinline__ KSlice k_slice(int K, int chunks_per_rank, int rank, int tile) {
  const int kchunks = (K + kBK - 1) / kBK;
  const int first = rank * chunks_per_rank, nc = max(0, min(chunks_per_rank, kchunks - first));
  return {first * kBK, nc, nc ? tile % nc : 0};
}

// The weight's first kStages - 1 chunks, each its own commit group with whatever `also` copies for it.
template <int BN, int THREADS, typename Also>
__device__ __forceinline__ void ring_prologue(int8_t* ring, const int8_t* w, int n0, int N, const KSlice& ks, int K,
                                              bool vec, Also&& also) {
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ks.nc) {
      stage_weight<BN, THREADS>(ring + s * BN * kWPitch, w, n0, N, ks.kbase + ks.k(s), K, vec);
      also(s);
    }
    pgica::cp_async_commit();
  }
}

// The ring after its prologue: consume the nc chunks, issuing each next one into the slot that the chunk before
// freed (with also(next)); chunk(slot, c, offset in the slice of the c-th chunk taken).
template <int BN, int THREADS, typename Also, typename Chunk>
__device__ __forceinline__ void k_loop(int8_t* ring, const int8_t* w, int n0, int N, const KSlice& ks, int K, bool vec,
                                       Also&& also, Chunk&& chunk) {
  for (int c = 0; c < ks.nc; ++c) {
    pgica::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = c + kStages - 1;
    if (next < ks.nc) {
      stage_weight<BN, THREADS>(ring + (next % kStages) * BN * kWPitch, w, n0, N, ks.kbase + ks.k(next), K, vec);
      also(next);
    }
    pgica::cp_async_commit();
    chunk(ring + (c % kStages) * BN * kWPitch, c, ks.k(c));
  }
  pgica::cp_async_wait<0>();
}

// The partial tiles of the cluster's `split` blocks, which share a column tile, pushed to the rank that sums
// them: rank r owns the tile's rows [r * rpr, (r + 1) * rpr), rpr = rows / split, and receives every rank's
// values for them in recv[q][row][column] (q the sender). The stores to other blocks are posted, so no thread
// waits on a remote read. C of a warp: rows g, g + 8 of its 16 weight rows (output columns), columns 2t, 2t + 1
// of its tiles (x rows). Called after a cluster barrier (every ring is free); the caller's next cluster barrier
// makes the values visible.
template <int BN, int MT, typename Acc>
__device__ __forceinline__ void push_partials(const cg::cluster_group& cluster, Acc* recv,
                                              const Acc (&acc)[Tiling<BN, MT>::kTiles][4], int wn, int wm, int lane,
                                              int split, int rank, int rows) {
  using Tl = Tiling<BN, MT>;
  const int g = lane >> 2, t = lane & 3, rpr = Tl::kRows / split, shift = __ffs(rpr) - 1;
#pragma unroll
  for (int j = 0; j < Tl::kTiles; ++j) {
    if ((wm * Tl::kTiles + j) * 8 < rows) {  // else the tile's rows are all past M
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = (wm * Tl::kTiles + j) * 8 + 2 * t + (i & 1), n = wn * 16 + g + 8 * (i >> 1);
        *cluster.map_shared_rank(recv + ((rank << shift) + (m & (rpr - 1))) * Tl::kPartPitch + n,
                                 m >> shift) = acc[j][i];
      }
    }
  }
}

// x's 16-byte piece at row m, column gk (zeros past M and K), as load16 gives it; element by element out of line.
template <typename T>
__device__ __noinline__ uint4 x_piece_scalar(const T* row, int gk, int K) {
  return pgica::load_slot<false>(row, gk, K);
}
template <typename T>
__device__ __forceinline__ uint4 x_piece(const T* x, int m, int M, int K, int gk, bool vec) {
  if (m >= M) return make_uint4(0u, 0u, 0u, 0u);
  const T* row = x + static_cast<size_t>(m) * K;
  return vec ? pgica::load16(row + gk, gk < K) : x_piece_scalar(row, gk, K);
}

// How a block walks its rows of x, 16 bytes a thread: thread i takes piece i % kPerRow of each 128-wide chunk row
// of rows i / kPerRow + kRowStep * u (u < kSteps).
template <typename T, int THREADS, int ROWS>
struct XWalk {
  static constexpr int kVecN = 16 / static_cast<int>(sizeof(T));
  static constexpr int kPerRow = kBK / kVecN;  // 16 (bf16) or 32 (f32) pieces: lanes sharing a row
  static constexpr int kRowStep = THREADS / kPerRow;
  static constexpr int kSteps = (ROWS + kRowStep - 1) / kRowStep;
};

// The rank's rows [first, first + rpr) of the tile, 8 neighbouring columns a thread (kThreads is a multiple of
// BN / 8): the split's partial tiles (recv, `pitch` words a row) summed in rank order, then out = value(sum, row,
// column in the block) in TO, with 16-byte stores where the 8 columns are whole and 16-byte aligned.
template <int BN, int THREADS, typename Acc, typename TO, typename Value>
__device__ __forceinline__ void write_rows(const Acc* recv, int pitch, int split, int rpr, int first, int m0, int M,
                                           int n0, int N, TO* out, Value&& value) {
  constexpr int kGroups = BN / 8, kVecOut = 16 / static_cast<int>(sizeof(TO));
  const int c0 = (static_cast<int>(threadIdx.x) % kGroups) * 8;
  const bool whole = n0 + c0 + 8 <= N && N % kVecOut == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int row = static_cast<int>(threadIdx.x) / kGroups; row < rpr; row += THREADS / kGroups) {
    const int m = first + row;
    if (m0 + m >= M || n0 + c0 >= N) break;
    Acc total[8];
    const Acc* at = recv + row * pitch + c0;
    for (int q = 0; q < split; ++q) {  // 16-byte reads: a row is (BN + 4) words, c0 a multiple of 8
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(at + q * rpr * pitch + e);
        const Acc* w = reinterpret_cast<const Acc*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) total[e + i] = q == 0 ? w[i] : total[e + i] + w[i];
      }
    }
    TO* dst = out + static_cast<size_t>(m0 + m) * N + n0 + c0;
    if (whole) {
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = to_float(value(total[e], m, c0 + e));
#pragma unroll
      for (int e = 0; e < 8; e += kVecOut) *reinterpret_cast<uint4*>(dst + e) = pgica::pack16(f + e, dst);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (n0 + c0 + e < N) dst[e] = value(total[e], m, c0 + e);
    }
  }
}

// ------------------------------------------------------------ W8A8, the row quantizer fused

constexpr float kRoundMagic = 12582912.f;  // 1.5 * 2^23: q + it holds rint(q) in its low bits (|q| < 2^22)

// The int8 of N values of a row, rint(x / s) ties to even, as rint(__fdiv_rn(x, s)), packed 4 to a word
// (|x / s| <= 127, since s = max |x| / 127 rounded, so the clamp to +-127 never binds). t = x * r + 1.5 * 2^23
// in one FMA, r = 1 / s rounded once a row, rounds x * r to an integer in t's low byte; x * r lies within
// 1.2e-5 of the rounded quotient, so where it is farther than 4e-5 from a half-integer both round to the same
// integer. When one of the N is not (about one value in 12,000), the piece takes the division.
__device__ __forceinline__ uint32_t quantize_exact(float x, float s) {
  return __float_as_uint(__fadd_rn(__fdiv_rn(x, s), kRoundMagic));
}

template <int N>
__device__ __forceinline__ void quantize_piece(const float (&f)[N], float s, float r, uint32_t (&words)[N / 4]) {
  uint32_t t[N];
  bool near_half = false;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float te = __fmaf_rn(f[e], r, kRoundMagic);
    near_half |= fabsf(__fmaf_rn(f[e], r, -__fsub_rn(te, kRoundMagic))) > 0.49996f;
    t[e] = __float_as_uint(te);
  }
  if (near_half) {
#pragma unroll
    for (int e = 0; e < N; ++e) t[e] = quantize_exact(f[e], s);
  }
#pragma unroll
  for (int h = 0; h < N / 4; ++h)
    words[h] = __byte_perm(__byte_perm(t[4 * h], t[4 * h + 1], 0x0040), __byte_perm(t[4 * h + 2], t[4 * h + 3], 0x0040),
                           0x5410);
}

template <typename T, int BN, int MT>
__global__ void __launch_bounds__(Tiling<BN, MT>::kThreads, 1)
    gemm_w8a8_fused(const T* __restrict__ x, float* __restrict__ sx, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ bias, T* __restrict__ out, int M, int N,
                    int K, int chunks_per_rank, int vec, int whole) {
  using Tl = Tiling<BN, MT>;
  using W = XWalk<T, Tl::kThreads, Tl::kRows>;
  constexpr int kRows = Tl::kRows, kThreads = Tl::kThreads, kRawPitch = raw_pitch(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float amax_s[kRows], amax_all[kMaxSplit][kRows], sx_s[kRows], rcp_s[kRows], col_sc[BN], col_b[BN];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  unsigned char* raw_ring = smem + Tl::kXOffset;  // x's chunks as they are, a slot beside each weight slot
  int8_t* xq = reinterpret_cast<int8_t*>(raw_ring + kStages * kRows * kRawPitch);  // the chunk in use, int8

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp % Tl::kWarpsN, wm = warp / Tl::kWarpsN;
  const int n0 = (blockIdx.x / split) * BN, m0 = blockIdx.y * kRows;
  const KSlice ks = k_slice(K, chunks_per_rank, rank, blockIdx.x / split);
  const int rows = min(kRows, M - m0);
  const bool exchange = !whole && split > 1;
  cluster_arrive();

  // x by XWalk: thread i takes the 16-byte piece i % kPerRow of a chunk's rows i / kPerRow + kRowStep * u. Each
  // chunk is staged as it is in the commit group of the weight's same chunk (zeros past K). Rows past M are not
  // read: they only reach outputs that are not written.
  const int piece = threadIdx.x % W::kPerRow, row0 = threadIdx.x / W::kPerRow;
  auto stage_raw = [&](int c) {  // the c-th chunk taken, into the slot of the weight's
    unsigned char* slot = raw_ring + (c % kStages) * kRows * kRawPitch + piece * 16;
    const int k = ks.kbase + ks.k(c) + piece * W::kVecN;
#pragma unroll
    for (int u = 0; u < W::kSteps; ++u) {
      const int r = row0 + W::kRowStep * u;
      if (r >= rows) break;
      if (vec)
        pgica::cp_async16(pgica::smem_u32(slot + r * kRawPitch), k < K ? x + static_cast<size_t>(m0 + r) * K + k : x,
                          k < K);
      else
        *reinterpret_cast<uint4*>(slot + r * kRawPitch) = x_piece(x, m0 + r, M, K, k, false);
    }
  };
  ring_prologue<BN, kThreads>(ring, w, n0, N, ks, K, vec, stage_raw);
  // the epilogue's column scale and bias, in flight meanwhile
  const int col = n0 + static_cast<int>(threadIdx.x);
  const bool has_col = threadIdx.x < BN && col < N;
  const float my_sc = has_col ? scale[col] : 0.f, my_b = has_col && bias != nullptr ? bias[col] : 0.f;

  {  // each row's amax, read from L2 while the first chunks fly, over the whole rows where they are short (no
     // exchange), else over this rank's slice: a thread's pieces, then the lanes of the row by shuffles
    constexpr int kBatch = W::kSteps <= 2 ? 16 / W::kSteps : W::kSteps < 8 ? 8 / W::kSteps : 1;  // chunks at once
    float a[W::kSteps];
#pragma unroll
    for (int u = 0; u < W::kSteps; ++u) a[u] = 0.f;
    const int k0 = whole ? 0 : ks.kbase, chunks = whole ? k_chunks(K) : ks.nc;
    for (int c0 = 0; c0 < chunks; c0 += kBatch) {
      uint4 v[kBatch][W::kSteps];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
#pragma unroll
        for (int u = 0; u < W::kSteps; ++u) {
          const int r = row0 + W::kRowStep * u;
          v[j][u] = c0 + j < chunks && r < rows
                        ? x_piece(x, m0 + r, M, K, k0 + (c0 + j) * kBK + piece * W::kVecN, vec)
                        : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
#pragma unroll
        for (int u = 0; u < W::kSteps; ++u) {
          float f[W::kVecN];
          pgica::unpack16(v[j][u], f, x);
#pragma unroll
          for (int e = 0; e < W::kVecN; ++e) a[u] = fmaxf(a[u], fabsf(f[e]));
        }
    }
#pragma unroll
    for (int u = 0; u < W::kSteps; ++u) {
      const int r = row0 + W::kRowStep * u;
      if (r >= kRows) break;  // the same for every lane of a warp
#pragma unroll
      for (int o = W::kPerRow / 2; o > 0; o >>= 1) a[u] = fmaxf(a[u], __shfl_xor_sync(0xffffffffu, a[u], o));
      if (piece == 0) amax_s[r] = a[u];
    }
  }
  __syncthreads();
  if (exchange) {  // the cluster's amax of each row: every block pushes its own to all of them
    cluster_wait();
    for (int i = threadIdx.x; i < kRows * split; i += kThreads)
      *cluster.map_shared_rank(&amax_all[rank][i % kRows], i / kRows) = amax_s[i % kRows];
    cluster.sync();
  }
  for (int i = threadIdx.x; i < kRows; i += kThreads) {
    float a = amax_s[i];
    if (exchange)
      for (int q = 0; q < split; ++q) a = fmaxf(a, amax_all[q][i]);
    sx_s[i] = __fdiv_rn(fmaxf(a, 1e-12f), 127.f);
    rcp_s[i] = __frcp_rn(sx_s[i]);
    if (blockIdx.x == 0 && m0 + i < M) sx[m0 + i] = sx_s[i];
  }
  // (the k loop's first barrier makes the scales visible)

  int acc[Tl::kTiles][4];
#pragma unroll
  for (int j = 0; j < Tl::kTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
  const int8_t* xw = xq + wm * Tl::kTiles * 8 * kQPitch;
  k_loop<BN, kThreads>(ring, w, n0, N, ks, K, vec, stage_raw, [&](const int8_t* slot, int c, int) {
    // the chunk's x, quantized from its raw slot into the int8 tile (whose last readers passed the k loop's
    // barrier), then the products after a second barrier
    const unsigned char* src = raw_ring + (c % kStages) * kRows * kRawPitch + piece * 16;
#pragma unroll
    for (int u = 0; u < W::kSteps; ++u) {
      const int r = row0 + W::kRowStep * u;
      if (r >= rows) break;
      float f[W::kVecN];
      pgica::unpack16(*reinterpret_cast<const uint4*>(src + r * kRawPitch), f, x);
      uint32_t words[W::kVecN / 4];
      quantize_piece<W::kVecN>(f, sx_s[r], rcp_s[r], words);
      int8_t* dst = xq + r * kQPitch + piece * W::kVecN;
      if constexpr (W::kVecN == 8)
        *reinterpret_cast<uint2*>(dst) = make_uint2(words[0], words[1]);
      else
        *reinterpret_cast<uint32_t*>(dst) = words[0];
    }
    __syncthreads();
    chunk_s8<Tl::kTiles>(acc, slot + wn * 16 * kWPitch, xw, kQPitch, lane);
  });

  int* recv = reinterpret_cast<int*>(smem + (Tl::kOwnRecv ? Tl::kRingBytes : 0));
  if (!exchange) cluster_wait();
  if (threadIdx.x < BN) col_sc[threadIdx.x] = my_sc, col_b[threadIdx.x] = my_b;
  if constexpr (!Tl::kOwnRecv) cluster.sync();  // every block's ring is free
  push_partials<BN, MT>(cluster, recv, acc, wn, wm, lane, split, rank, M - m0);
  cluster.sync();
  const int rpr = kRows / split;
  write_rows<BN, kThreads>(recv, Tl::kPartPitch, split, rpr, rank * rpr, m0, M, n0, N, out,
                           [&](int total, int m, int c) {
                             const float v = __fmul_rn(__fmul_rn(static_cast<float>(total), sx_s[m]), col_sc[c]);
                             return with_bias_value<T>(v, bias != nullptr, col_b[c]);
                           });
}

// ------------------------------------------------------------ weight-only, bf16

template <int BN, int MT>
__global__ void __launch_bounds__(Tiling<BN, MT>::kThreads)
    gemm_w8_bf16_tiled(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, int M, int N, int K, int chunks_per_rank, int vec) {
  using Tl = Tiling<BN, MT>;
  using W = XWalk<__nv_bfloat16, Tl::kThreads, Tl::kRows>;
  constexpr int kRows = Tl::kRows, kThreads = Tl::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  unsigned char* xs = smem + Tl::kXOffset;
  const int xp = x_pitch(chunks_per_rank, 2);

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int wn = warp % Tl::kWarpsN, wm = warp / Tl::kWarpsN;
  const int n0 = (blockIdx.x / split) * BN, m0 = blockIdx.y * kRows;
  const KSlice ks = k_slice(K, chunks_per_rank, rank, blockIdx.x / split);

  __shared__ float col_b[BN];
  cluster_arrive();
  // this rank's slice of x, resident (zeros past K), staged a chunk at a time by XWalk in the commit group of the
  // weight's same chunk (rows past M are not staged: they only reach outputs that are not written)
  const int piece = threadIdx.x % W::kPerRow, row0 = threadIdx.x / W::kPerRow;
  auto stage_x = [&](int c) {  // the c-th chunk taken
    const int col = ks.k(c) + piece * 8;
#pragma unroll
    for (int u = 0; u < W::kSteps; ++u) {
      const int r = row0 + W::kRowStep * u;
      if (r >= kRows || m0 + r >= M) break;
      const int k = ks.kbase + col;
      unsigned char* d = xs + r * xp + 2 * col;
      if (vec)
        pgica::cp_async16(pgica::smem_u32(d), k < K ? x + static_cast<size_t>(m0 + r) * K + k : x, k < K);
      else
        *reinterpret_cast<uint4*>(d) = x_piece(x, m0 + r, M, K, k, false);
    }
  };
  ring_prologue<BN, kThreads>(ring, w, n0, N, ks, K, vec, stage_x);
  const int col = n0 + static_cast<int>(threadIdx.x);  // the epilogue's column bias, in flight meanwhile
  const float my_b = threadIdx.x < BN && col < N && bias != nullptr ? bias[col] : 0.f;

  const int nw = n0 + wn * 16 + g;
  const __nv_bfloat162 s_lo = __float2bfloat162_rn(nw < N ? scale[nw] : 0.f);
  const __nv_bfloat162 s_hi = __float2bfloat162_rn(nw + 8 < N ? scale[nw + 8] : 0.f);
  float acc[Tl::kTiles][4];
#pragma unroll
  for (int j = 0; j < Tl::kTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const auto* xw = reinterpret_cast<const __nv_bfloat16*>(xs + wm * Tl::kTiles * 8 * xp);
  k_loop<BN, kThreads>(ring, w, n0, N, ks, K, vec, stage_x, [&](const int8_t* slot, int, int xk) {
    chunk_bf16<Tl::kTiles>(acc, slot + wn * 16 * kWPitch, xw + xk, xp, lane, s_lo, s_hi);
  });

  float* recv = reinterpret_cast<float*>(smem + (Tl::kOwnRecv ? Tl::kRingBytes : 0));
  cluster_wait();
  if (threadIdx.x < BN) col_b[threadIdx.x] = my_b;
  if constexpr (!Tl::kOwnRecv) cluster.sync();  // every block's ring is free
  push_partials<BN, MT>(cluster, recv, acc, wn, wm, lane, split, rank, M - m0);
  cluster.sync();
  const int rpr = kRows / split;
  write_rows<BN, kThreads>(recv, Tl::kPartPitch, split, rpr, rank * rpr, m0, M, n0, N, out,
                           [&](float total, int, int c) {
                             return with_bias_value<__nv_bfloat16>(total, bias != nullptr, col_b[c]);
                           });
}

// ------------------------------------------------------------ weight-only, f32 (CUDA cores)

constexpr int kThreadsF32 = 256;
constexpr int kCols = 8;     // columns a block computes; warp w takes column n0 + w
constexpr int kF32Rows = 8;  // rows a block computes

__global__ void __launch_bounds__(kThreadsF32)
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

// ------------------------------------------------------------ plans and launches

bool vec_ok(int K, std::initializer_list<const void*> ptrs) {
  if (K % 16 != 0) return false;
  for (const void* p : ptrs)
    if (!pgica::aligned16(p)) return false;
  return true;
}

// What a launch takes: x rows a block holds (8 * mt), its columns, the cluster's split of K, the k chunks a
// rank takes, the dynamic shared memory and (W8A8) whether a block takes the amax of whole rows itself.
struct Plan {
  int mt, bn, split, chunks_per_rank, smem;
  bool whole;
};

// The instances: W8A8 MT in {1, 2, 4}, weight-only MT in {1, 2, 4, 16}; BN in {64, 128}.
template <int BN>
const void* w8_fn(int mt) {
  switch (mt) {
    case 1: return reinterpret_cast<const void*>(gemm_w8_bf16_tiled<BN, 1>);
    case 2: return reinterpret_cast<const void*>(gemm_w8_bf16_tiled<BN, 2>);
    case 4: return reinterpret_cast<const void*>(gemm_w8_bf16_tiled<BN, 4>);
    default: return reinterpret_cast<const void*>(gemm_w8_bf16_tiled<BN, 16>);
  }
}

template <typename T, int BN>
const void* w8a8_fn(int mt) {
  switch (mt) {
    case 1: return reinterpret_cast<const void*>(gemm_w8a8_fused<T, BN, 1>);
    case 2: return reinterpret_cast<const void*>(gemm_w8a8_fused<T, BN, 2>);
    default: return reinterpret_cast<const void*>(gemm_w8a8_fused<T, BN, 4>);
  }
}

// Blocks of kernel `fn` the card holds at once in clusters of `split`, each with `smem` dynamic bytes: the
// occupancy query's clusters times split, asked once per (kernel, smem, split) (0 where the query fails).
int capacity(const void* fn, int threads, int smem, int split) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, int> known;
  const auto key = std::make_tuple(fn, smem, split);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = known.find(key);
  if (hit != known.end()) return hit->second;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = static_cast<unsigned>(split);
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg) != cudaSuccess) {
    cudaGetLastError();
    clusters = 0;
  }
  return known[key] = clusters * split;
}

int threads_of(int bn, int mt) { return 32 * (bn / 16) * (bn == 64 && mt >= 2 ? 2 : 1); }

const void* kernel_of(bool weight_only, int dtype, int bn, int mt) {
  if (weight_only) return bn == 128 ? w8_fn<128>(mt) : w8_fn<64>(mt);
  if (dtype == pgica::kFloat32) return bn == 128 ? w8a8_fn<float, 128>(mt) : w8a8_fn<float, 64>(mt);
  return bn == 128 ? w8a8_fn<__nv_bfloat16, 128>(mt) : w8a8_fn<__nv_bfloat16, 64>(mt);
}

// The tiling of a call, from (M, N, K) alone, chosen by timing every tiling at phase 12a's shapes on the H100
// (the int8 table of PERF.md). Of the tilings that fit and that the card holds at once, the one with the most
// blocks up to 128 (W8A8 to 8 rows: 64 columns and up to 256 blocks, or 128 columns where N >= 8192; past 8
// rows 16-row tiles first, then 128 columns, then the smallest split; weight-only the tallest rows, then the
// smallest split, then 128 columns). Weight-only up to 32 rows keeps the rule it was
// tuned with: columns 128 where N >= 8192, else 64; the tallest row tile that holds M and fits; the smallest
// split that gives 128 blocks, halved while the card cannot hold every block at once. False if nothing fits.
bool plan_for(int M, int N, int K, bool weight_only, int dtype, Plan* p) {
  const int kchunks = k_chunks(K), elem = !weight_only && dtype == pgica::kFloat32 ? 4 : 2;
  auto make = [&](int bn, int mt, int s, Plan* q) {  // false where it does not fit
    const int cpr = (kchunks + s - 1) / s;
    const int x_bytes = weight_only ? x_pitch(cpr, 2) : kStages * raw_pitch(elem) + kQPitch;
    // W8A8 takes whole rows' amax where a thread reads at most 16 pieces of 16 bytes of them
    const int row_step = threads_of(bn, mt) / (kBK * elem / 16), steps = (8 * mt + row_step - 1) / row_step;
    *q = Plan{mt, bn, s, cpr, kStages * bn * kWPitch + (own_recv(bn, mt) ? recv_bytes(bn, mt) : 0) + 8 * mt * x_bytes,
              !weight_only && steps * kchunks <= 16};
    return q->smem <= kSmemCap;
  };
  auto blocks = [&](const Plan& q) { return ((N + q.bn - 1) / q.bn) * q.split * ((M + 8 * q.mt - 1) / (8 * q.mt)); };
  auto at_once = [&](const Plan& q) {
    return blocks(q) <= capacity(kernel_of(weight_only, dtype, q.bn, q.mt), threads_of(q.bn, q.mt), q.smem, q.split);
  };
  const int mt_max = M <= 8 ? 1 : M <= 16 ? 2 : weight_only && M > 32 ? 16 : 4;
  if (weight_only && M <= 32) {
    const int bn = N >= 8192 ? 128 : 64;
    auto fit = [&](int s, Plan* q) {  // the tallest row tile that fits at split s
      for (int mt = mt_max; mt >= 1; mt /= 2)
        if (make(bn, mt, s, q)) return true;
      return false;
    };
    Plan q;
    int s = 1;
    while (2 * s <= kMaxSplit && 2 * s <= kchunks && (!fit(s, &q) || blocks(q) < 128)) s *= 2;
    if (!fit(s, &q)) return false;
    while (q.split > 1 && !at_once(q)) {  // one wave: every block resident at once
      Plan r;
      if (!fit(q.split / 2, &r)) break;
      q = r;
    }
    *p = q;
    return true;
  }
  // W8A8 to 8 rows: columns 128 where N >= 8192, else 64 with 256 blocks
  const int bn_only = !weight_only && M <= 8 ? (N >= 8192 ? 128 : 64) : 0, target = bn_only == 64 ? 256 : 128;
  auto key = [&](const Plan& r) {
    const int rows = weight_only ? r.mt : M > 8 && r.mt == 2;  // W8A8: 16-row tiles first
    return std::make_tuple(at_once(r), std::min(blocks(r), target), rows, weight_only ? -r.split : r.bn == 128,
                           weight_only ? r.bn == 128 : -r.split);
  };
  bool found = false;
  for (int bn : {128, 64}) {
    if (bn_only && bn != bn_only) continue;
    for (int s = 1; s <= (weight_only ? 2 : kMaxSplit) && s <= kchunks; s *= 2)
      for (int mt = mt_max; mt >= 1; mt = mt == 16 ? 4 : mt / 2) {
        Plan r;
        if (make(bn, mt, s, &r) && (!found || key(r) > key(*p))) *p = r, found = true;
      }
  }
  return found;
}

// One cluster launch of `Kernel` (a block of `threads`; grid: column tiles x split, row tiles).
template <auto Kernel, int BN, int MT, typename... Args>
int launch_cluster(const Plan& p, int M, int N, cudaStream_t st, Args... args) {
  static const cudaError_t attr =  // once per instance: above 48 KB, dynamic shared memory must be asked for
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = static_cast<unsigned>(p.split);
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + BN - 1) / BN) * p.split, (M + 8 * MT - 1) / (8 * MT));
  cfg.blockDim = dim3(Tiling<BN, MT>::kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = st;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, Kernel, args...));
}

template <typename T, int BN>
int launch_w8a8(const Plan& p, const T* x, float* sx, const int8_t* w, const float* scale, const float* bias, T* out,
                int M, int N, int K, int vec, cudaStream_t st) {
  switch (p.mt) {
#define PGICA_W8A8(MT)                                                                                          \
  return launch_cluster<gemm_w8a8_fused<T, BN, MT>, BN, MT>(p, M, N, st, x, sx, w, scale, bias, out, M, N, K, \
                                                            p.chunks_per_rank, vec, static_cast<int>(p.whole))
    case 1: PGICA_W8A8(1);
    case 2: PGICA_W8A8(2);
    default: PGICA_W8A8(4);
#undef PGICA_W8A8
  }
}

template <int BN>
int launch_w8(const Plan& p, const __nv_bfloat16* x, const int8_t* w, const float* scale, const float* bias,
              __nv_bfloat16* out, int M, int N, int K, int vec, cudaStream_t st) {
  switch (p.mt) {
#define PGICA_W8(MT)                                                                                     \
  return launch_cluster<gemm_w8_bf16_tiled<BN, MT>, BN, MT>(p, M, N, st, x, w, scale, bias, out, M, N, K, \
                                                            p.chunks_per_rank, vec)
    case 1: PGICA_W8(1);
    case 2: PGICA_W8(2);
    case 4: PGICA_W8(4);
    default: PGICA_W8(16);
#undef PGICA_W8
  }
}

// The launches of a plan (a tuning driver may call these with a plan of its own).
int run_w8a8(const Plan& p, const void* x, void* sx, const void* w, const void* scale, const void* bias, void* out,
             int M, int N, int K, int dtype, cudaStream_t st) {
  const int vec = vec_ok(K, {x, w});
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(scale);
  const auto* b = static_cast<const float*>(bias);
  auto* s = static_cast<float*>(sx);
  if (dtype == pgica::kFloat32) {
    const auto* xf = static_cast<const float*>(x);
    auto* of = static_cast<float*>(out);
    if (p.bn == 128) return launch_w8a8<float, 128>(p, xf, s, wp, sc, b, of, M, N, K, vec, st);
    return launch_w8a8<float, 64>(p, xf, s, wp, sc, b, of, M, N, K, vec, st);
  }
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (p.bn == 128) return launch_w8a8<__nv_bfloat16, 128>(p, xb, s, wp, sc, b, ob, M, N, K, vec, st);
  return launch_w8a8<__nv_bfloat16, 64>(p, xb, s, wp, sc, b, ob, M, N, K, vec, st);
}

int run_w8(const Plan& p, const void* x, const void* w, const void* scale, const void* bias, void* out, int M, int N,
           int K, cudaStream_t st) {
  const int vec = vec_ok(K, {x, w});
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(scale);
  const auto* b = static_cast<const float*>(bias);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (p.bn == 128) return launch_w8<128>(p, xp, wp, sc, b, o, M, N, K, vec, st);
  return launch_w8<64>(p, xp, wp, sc, b, o, M, N, K, vec, st);
}

}  // namespace

// x: (M, K) contiguous in `dtype` (f32 or bf16); sx: (M,) f32, the row scales out; w: (N, K) int8; scale: (N,)
// f32; bias: (N,) f32 or null; out: (M, N) in `dtype`. Returns a cudaError_t code.
extern "C" int pgica_q8_matmul_w8a8(const void* x, void* sx, const void* w, const void* scale, const void* bias,
                                    void* out, int M, int N, int K, int dtype, void* stream) {
  Plan p;
  if (M <= 0 || N <= 0 || K <= 0 || (dtype != pgica::kFloat32 && dtype != pgica::kBFloat16) ||
      !plan_for(M, N, K, false, dtype, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  return run_w8a8(p, x, sx, w, scale, bias, out, M, N, K, dtype, static_cast<cudaStream_t>(stream));
}

// x: (M, K) contiguous in `dtype`; w: (N, K) int8; scale: (N,) f32; bias: (N,) f32 or null; out: (M, N) in
// `dtype`. Returns a cudaError_t code.
extern "C" int pgica_q8_matmul_w8(const void* x, const void* w, const void* scale, const void* bias, void* out,
                                  int M, int N, int K, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == pgica::kFloat32) {
    const dim3 grid((N + kCols - 1) / kCols, (M + kF32Rows - 1) / kF32Rows);
    gemm_w8_f32<<<grid, kThreadsF32, 0, st>>>(static_cast<const float*>(x), static_cast<const int8_t*>(w),
                                              static_cast<const float*>(scale), static_cast<const float*>(bias),
                                              static_cast<float*>(out), M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  Plan p;
  if (dtype != pgica::kBFloat16 || !plan_for(M, N, K, true, dtype, &p)) return static_cast<int>(cudaErrorInvalidValue);
  return run_w8(p, x, w, scale, bias, out, M, N, K, st);
}

// The plan of either entry point at (M, N, K) into plan[0..6]: rows a block holds, its columns, the split, k
// chunks a rank takes, dynamic shared memory, blocks and the clusters the card can hold at once (0 when the
// occupancy query fails). Returns a cudaError_t code (cudaErrorInvalidValue: no plan).
extern "C" int pgica_q8_matmul_plan(int M, int N, int K, int dtype, int weight_only, int* plan) {
  Plan p;
  if (M <= 0 || N <= 0 || K <= 0 || (weight_only && dtype != pgica::kBFloat16) ||
      (dtype != pgica::kFloat32 && dtype != pgica::kBFloat16) || !plan_for(M, N, K, weight_only != 0, dtype, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = 8 * p.mt, blocks = ((N + p.bn - 1) / p.bn) * p.split * ((M + rows - 1) / rows);
  const int clusters =
      capacity(kernel_of(weight_only != 0, dtype, p.bn, p.mt), threads_of(p.bn, p.mt), p.smem, p.split) / p.split;
  const int out[7] = {rows, p.bn, p.split, p.chunks_per_rank, p.smem, blocks, clusters};
  for (int i = 0; i < 7; ++i) plan[i] = out[i];
  return 0;
}
