// Streaming InfoNCE negative sums for Hopper (sm_90a), over the live rows only.
//
//   K1  s[q]    = sum_n w[n] * exp(inv_temp * <a[q], r[n]>)          (forward)
//   K2  M[q, :] = sum_n bf16(w[n] * exp(inv_temp * <a[q], r[n]>)) * r[n]
//                                                                    (backward)
//
// Which TPU kernels these replace.  The Pallas kernels of
// css_tpu/ops/pallas/contrastive_kernels.py: K1 (`k1_live_kernel` +
// `sum_partials_kernel`) is `_fwd_kernel`, launched by `_run_fwd`; K2
// (`k2_live_kernel` + `sum_partials_kernel`) is `_bwd_kernel`, launched by
// `_run_bwd` from the custom_vjp backward.  The compactions replace the
// TPU's per-tile liveness vector `_live_tiles` (`:155`, an XLA op): on the
// loss's path `class_live_rows_kernel`, one launch for every class, and for
// one weight vector `count_live_kernel` + `scatter_live_kernel`.  Same
// function, same casts: bf16 operands
// with f32 accumulation, K2 rounds the weighted exponentials to bf16 before
// its second product, no max-subtraction (anchors and rows are both
// L2-normalised, so |logit| <= inv_temp = 2 on the main path), and no
// floating-point atomics anywhere, so two runs give identical bits.
//
// What bounds them on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s).  Only rows
// with a nonzero weight contribute.  On the main path (Q = 256, D = 256,
// N = 262,144) the weights are thinned multiplicities with about 480 live
// rows: the data needs well under a microsecond, so what is left is the
// latency of a few small launches, the anchor stage and one tile's gather.
// With dense weights (131,072 live rows on half the table) K1 is bound by
// the bytes of the live rows and K2 by its tensor-core operations, about
// 20 and 35 us.
//
// The compaction for every class reads the classes' uniforms [C, N] f32 and
// the rows' classes [N] int32 once and writes 8 bytes per live row: bound by
// bytes, about 7 us at VOC's C = 21, N = 262,144 (22 MB of uniforms).
//
// Design.
//  * Compaction for every class at once (the loss's path): one cluster of
//    eight CTAs per class, each over a contiguous share of the rows; it
//    computes the weights from the class's row of p_over_cnt and the
//    uniforms, ballots them into shared memory, takes its offset from the
//    counts of the CTAs before it through distributed shared memory, and
//    scatters; see the section below.
//  * Compaction, once per weight vector: one pass counts the live weights
//    of each 2,048-weight block (warp ballots); a second pass takes the
//    exclusive prefix of the block counts and scatters the live row indices
//    (ascending) and their weights, and the last block writes the count L
//    to device memory.  L never goes to the host.
//  * K1/K2 walk the ceil(L / 64) live tiles.  The grid is fixed by Q and the
//    SM count (anchor blocks x chunks, about one wave); each CTA reads L and
//    takes a contiguous share of the tiles, so the split, and with it the
//    order of every sum, depends only on L.  A CTA without tiles writes
//    nothing; the second pass adds the min(chunks, tiles) partials in chunk
//    order.
//  * Two warpgroups per CTA, each with its own 64 anchors, share every
//    gathered tile, so each live row crosses L2 once per 128 anchors.  The
//    [64, D] anchor blocks and each gathered tile of 64 live rows sit in
//    shared memory in the 128-byte-swizzled layout that wgmma reads.  Live
//    rows are scattered, so they arrive through 16-byte cp.async copies (the
//    tiled TMA cannot gather) in a ring of three stages: the gathers of the
//    next two tiles overlap this tile's products.  Rows past L are
//    zero-filled and their weights are zero.
//  * The [64 x 64] logit tile is one wgmma m64n64k16 chain (K-major A and B,
//    f32 accumulators in registers); K1 then takes exp, times the weights,
//    and a per-row sum in registers.  K2 rounds w * exp(l) to bf16 in
//    registers, where the accumulator layout is the layout of wgmma's
//    register A operand, and multiplies it by the same shared tile read as
//    an MN-major B (the transpose flag), accumulating M [64, D] in registers
//    (128 a thread at D = 256).
// The kernels launch on the caller's stream, never synchronise and allocate
// nothing; the caller passes outputs and scratch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 64;         // live rows per tile = anchors per warpgroup (the wgmma M)
constexpr int kGroups = 2;        // consumer warpgroups per CTA, sharing each gathered tile
constexpr int kThreads = 128 * kGroups;
constexpr int kAnchors = kTile * kGroups;  // anchors per CTA
constexpr int kStages = 3;        // ring of gathered tiles
constexpr int kAtomBytes = kTile * 128;  // one 64-column slab of a tile: 64 rows x 128 B
constexpr int kCompactThreads = 256;
constexpr int kCompactRounds = 8;
constexpr int kCompactBlock = kCompactThreads * kCompactRounds;  // weights per block
static_assert(kCompactRounds * (kCompactThreads / 32) == 64, "scan assumes 64 groups");

template <int DP>
struct Smem {
  static constexpr int kTileBytes = kTile * DP * 2;  // a [64, DP] bf16 tile
  static constexpr uint32_t kA = 0;                                   // kGroups anchor blocks
  static constexpr uint32_t kR = kGroups * kTileBytes;                // kStages tiles
  static constexpr uint32_t kW = kR + kStages * kTileBytes;           // kStages x 64 f32
  static constexpr size_t kBytes = kW + kStages * kTile * 4 + 1024;   // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row `row` in a [64, DP] tile: 64-column
// slabs of 64 rows x 128 B, chunks XOR-swizzled by row % 8 (128-byte swizzle).
__device__ __forceinline__ uint32_t swizzled(int row, int c) {
  return (c >> 3) * kAtomBytes + row * 128 + (((c & 7) ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (1ull << 62);
}
// K-major operand: 8-row groups 1024 B apart (LBO unused with swizzle).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) { return smem_desc(addr, 1, 64); }
// MN-major operand, N = 64: one 64-wide MN slab, so the only stride read is
// the one between 8-row K groups, 1024 B (given in both offset fields).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) { return smem_desc(addr, 64, 64); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator accesses across async wgmma.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define CSS_D32                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define CSS_D32_OPERANDS(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),  \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),       \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),    \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])

// d[64 x 64] += A[64 x 16] . B[16 x 64], both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CSS_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : CSS_D32_OPERANDS(d)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[64 x 64] += A[64 x 16] (registers, bf16x2) . B[16 x 64], B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CSS_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : CSS_D32_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------- compaction --

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// Sum of v over the block, returned to every thread.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int i = 0; i < kCompactThreads / 32; ++i) total += scratch[i];
  __syncthreads();
  return total;
}

// counts[b] = number of nonzero weights in block b's kCompactBlock weights.
__global__ void __launch_bounds__(kCompactThreads)
count_live_kernel(const float* __restrict__ w, long long n, int* __restrict__ counts) {
  __shared__ int scratch[kCompactThreads / 32];
  const long long first = static_cast<long long>(blockIdx.x) * kCompactBlock;
  int c = 0;
#pragma unroll
  for (int k = 0; k < kCompactRounds; ++k) {
    const long long i = first + k * kCompactThreads + threadIdx.x;
    c += (i < n && w[i] != 0.f) ? 1 : 0;
  }
  c = block_sum(c, scratch);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

// Writes the live rows of block b at their rank: idx[pos] = row, wv[pos] =
// w[row], ascending; the last block writes the total to n_live.
__global__ void __launch_bounds__(kCompactThreads)
scatter_live_kernel(const float* __restrict__ w, long long n, const int* __restrict__ counts,
                    int* __restrict__ idx, float* __restrict__ wv, int* __restrict__ n_live) {
  __shared__ int scratch[kCompactThreads / 32];
  __shared__ int offset[64];  // exclusive prefix of each (round, warp) group in the block
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int before = 0;
  for (int b = threadIdx.x; b < static_cast<int>(blockIdx.x); b += kCompactThreads) {
    before += counts[b];
  }
  const int base = block_sum(before, scratch);

  const long long first = static_cast<long long>(blockIdx.x) * kCompactBlock;
  float v[kCompactRounds];
  unsigned ballot[kCompactRounds];
#pragma unroll
  for (int k = 0; k < kCompactRounds; ++k) {
    const long long i = first + k * kCompactThreads + threadIdx.x;
    v[k] = i < n ? w[i] : 0.f;
    ballot[k] = __ballot_sync(0xffffffffu, v[k] != 0.f);
    if (lane == 0) offset[k * (kCompactThreads / 32) + warp] = __popc(ballot[k]);
  }
  __syncthreads();
  if (warp == 0) {  // groups in element order: round-major, then warp
    const int c0 = offset[2 * lane];
    const int c1 = offset[2 * lane + 1];
    int incl = c0 + c1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    const int excl = incl - c0 - c1;
    offset[2 * lane] = excl;
    offset[2 * lane + 1] = excl + c0;
    if (lane == 31 && blockIdx.x == gridDim.x - 1) *n_live = base + incl;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kCompactRounds; ++k) {
    if (v[k] != 0.f) {
      const int pos =
          base + offset[k * (kCompactThreads / 32) + warp] + __popc(ballot[k] & below);
      idx[pos] = static_cast<int>(first + k * kCompactThreads + threadIdx.x);
      wv[pos] = v[k];
    }
  }
}

// ------------------------------------------- every class's live rows at once --
//
// For each class c (one thread-block cluster of kClassCluster CTAs) the
// weights w[c, n] = p_over_cnt[c, cls[n]], thinned when the uniforms u are
// given: lam = g * p, m = floor(lam) + (u[c, n] < lam - floor(lam)), in the
// same f32 operations and order as the plain version (no contraction into an
// FMA); their nonzero rows are listed in ascending order.  Each CTA takes a
// contiguous share of N: pass 1 ballots its weights into shared memory, one
// word per 32 rows in row order, and counts them; the CTAs publish their
// counts in their own shared memory, cross cluster.sync(), and each reads the
// counts of the CTAs before it through distributed shared memory; pass 2 walks
// the ballot words in order and, for each live row only, computes its weight
// again and writes its index and weight at its rank.  One launch for every
// class, one read of u and cls; no atomics, no global scratch, no spin.

constexpr int kClassCluster = 8;        // CTAs per class: the portable cluster size
constexpr int kClassUnroll = 32;        // ballot words per warp in flight in either pass
constexpr int kClassRowsPerStep = kCompactThreads * kClassUnroll;  // rows per pass-1 step
constexpr int kMaxClasses = 127;        // p_over_cnt rows are C + 1 <= 128 wide
constexpr int kClassSmemLimit = 227 * 1024 - 4096;  // ballot words; the rest is static

// A row's weight from its class's entry p of p_over_cnt and, when thinned,
// its uniform: as torch computes g * p, then thinned_multiplicities.
__device__ __forceinline__ float class_weight(float p, float g, bool thinned, float u) {
  if (!thinned) return p;
  const float lam = __fmul_rn(g, p);
  const float base = floorf(lam);
  return __fadd_rn(base, u < __fsub_rn(lam, base) ? 1.f : 0.f);
}

__global__ void __cluster_dims__(kClassCluster, 1, 1) __launch_bounds__(kCompactThreads)
class_live_rows_kernel(const float* __restrict__ p_over_cnt, int num_classes,
                       const int* __restrict__ cls, const float* __restrict__ u, float g,
                       long long n, int share, long long n_pad, int* __restrict__ idx,
                       float* __restrict__ wv, int* __restrict__ n_live) {
  extern __shared__ unsigned ballots[];  // share / 32 words, row order
  __shared__ float p_row[kMaxClasses + 1];
  __shared__ int scratch[kCompactThreads / 32];
  __shared__ int cta_live;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int c = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int words = share / 32;
  const long long first = static_cast<long long>(rank) * share;
  const float* u_c = u == nullptr ? nullptr : u + static_cast<long long>(c) * n;
  for (int k = threadIdx.x; k <= num_classes; k += kCompactThreads) {
    p_row[k] = p_over_cnt[static_cast<long long>(c) * (num_classes + 1) + k];
  }
  __syncthreads();

  // pass 1: word j holds the live bits of rows first + 32 j .. first + 32 j + 31
  // (share is a multiple of kClassRowsPerStep, so every word is the CTA's own)
  const bool thinned = u_c != nullptr;
  int live = 0;
  for (int w0 = 0; w0 < words; w0 += kClassUnroll * (kCompactThreads / 32)) {
    int k_cls[kClassUnroll];
    float k_u[kClassUnroll];
#pragma unroll
    for (int k = 0; k < kClassUnroll; ++k) {  // the loads first, all in flight
      const long long i =
          first + static_cast<long long>(w0 + k * (kCompactThreads / 32) + warp) * 32 + lane;
      const bool in = i < n;
      k_cls[k] = in ? __ldg(cls + i) : -1;
      k_u[k] = (in && thinned) ? __ldg(u_c + i) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kClassUnroll; ++k) {
      const int word = w0 + k * (kCompactThreads / 32) + warp;
      const bool on = k_cls[k] >= 0 && class_weight(p_row[k_cls[k]], g, thinned, k_u[k]) != 0.f;
      const unsigned b = __ballot_sync(0xffffffffu, on);
      if (lane == 0) ballots[word] = b;
      live += __popc(b);
    }
  }
  live = block_sum(lane == 0 ? live : 0, scratch);
  if (threadIdx.x == 0) cta_live = live;
  cluster.sync();  // every CTA's count published
  int before = 0;
  if (threadIdx.x < rank) before = *cluster.map_shared_rank(&cta_live, threadIdx.x);
  cluster.sync();  // no CTA leaves while another reads its count
  int running = block_sum(before, scratch);
  if (rank == kClassCluster - 1 && threadIdx.x == 0) n_live[c] = running + live;

  // pass 2: the words in chunks of one per thread; each chunk's exclusive
  // prefix, then each warp scatters 32 of the chunk's words, live rows only,
  // their classes and uniforms loaded together
  static_assert(kClassUnroll == 32, "pass 2 takes a warp's 32 words at once");
  int* idx_c = idx + static_cast<long long>(c) * n_pad;
  float* wv_c = wv + static_cast<long long>(c) * n_pad;
  const unsigned below = (1u << lane) - 1u;
  for (int w0 = 0; w0 < words; w0 += kCompactThreads) {
    const int word = w0 + threadIdx.x;
    const unsigned mine = word < words ? ballots[word] : 0u;
    const int cnt = __popc(mine);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) scratch[warp] = incl;
    __syncthreads();
    int warp_off = 0, chunk = 0;
#pragma unroll
    for (int k = 0; k < kCompactThreads / 32; ++k) {
      warp_off += k < warp ? scratch[k] : 0;
      chunk += scratch[k];
    }
    const int pos = running + warp_off + incl - cnt;  // this word's first rank
    running += chunk;
    __syncthreads();  // scratch is refilled by the next chunk
    if (!__any_sync(0xffffffffu, mine != 0u)) continue;  // the warp's words are all dead
    // lane j's word is word w0 + 32 warp + j: lane l takes row 32 word + l of each
    int k_cls[kClassUnroll];
    float k_u[kClassUnroll];
#pragma unroll
    for (int j = 0; j < kClassUnroll; ++j) {
      const bool on = __shfl_sync(0xffffffffu, mine, j) >> lane & 1u;
      const long long i = first + static_cast<long long>(w0 + warp * 32 + j) * 32 + lane;
      k_cls[j] = on ? __ldg(cls + i) : 0;
      k_u[j] = (on && thinned) ? __ldg(u_c + i) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kClassUnroll; ++j) {
      const unsigned b = __shfl_sync(0xffffffffu, mine, j);
      const int at = __shfl_sync(0xffffffffu, pos, j) + __popc(b & below);
      if (b >> lane & 1u) {
        idx_c[at] = static_cast<int>(first + static_cast<long long>(w0 + warp * 32 + j) * 32 +
                                     lane);
        wv_c[at] = class_weight(p_row[k_cls[j]], g, thinned, k_u[j]);
      }
    }
  }
}

// ------------------------------------------------------------- K1 and K2 ---

// This CTA's live tiles [t0, t1); false if it has none.
__device__ __forceinline__ bool chunk_tiles(int live, int chunks, long long& t0,
                                            long long& t1) {
  const long long tiles = (static_cast<long long>(live) + kTile - 1) / kTile;
  const long long used = min(static_cast<long long>(chunks), tiles);
  const long long chunk = blockIdx.y;
  if (chunk >= used) return false;
  t0 = chunk * tiles / used;
  t1 = (chunk + 1) * tiles / used;
  return true;
}

// The CTA's anchor blocks, one [64, DP] tile per warpgroup; a block at or
// past q_pad (a warpgroup with no anchors) is not loaded.
template <int DP>
__device__ __forceinline__ void load_anchors(uint32_t a_s, const __nv_bfloat16* a, int q0,
                                             int q_pad) {
  constexpr int kChunks = DP / 8;
  const int rows = min(kAnchors, q_pad - q0);
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int row = i / kChunks;
    const int c = i % kChunks;
    cp_async16(a_s + (row / kTile) * Smem<DP>::kTileBytes + swizzled(row % kTile, c),
               a + static_cast<size_t>(q0 + row) * DP + c * 8, 16);
  }
}

// Gathers live rows first .. first + 63 (rows at or past `live` zero-filled)
// and their weights into one ring slot.
template <int DP>
__device__ __forceinline__ void gather_tile(uint32_t r_s, uint32_t w_s,
                                            const __nv_bfloat16* r, const int* idx,
                                            const float* wv, long long first, int live) {
  constexpr int kChunks = DP / 8;
  constexpr int kRowsPerPass = kThreads / kChunks;
  const int c = threadIdx.x % kChunks;
  const int row0 = threadIdx.x / kChunks;
  int src[kTile / kRowsPerPass];
#pragma unroll
  for (int p = 0; p < kTile / kRowsPerPass; ++p) {
    const long long j = first + row0 + p * kRowsPerPass;
    src[p] = j < live ? __ldg(idx + j) : -1;
  }
#pragma unroll
  for (int p = 0; p < kTile / kRowsPerPass; ++p) {
    const int row = row0 + p * kRowsPerPass;
    const bool ok = src[p] >= 0;
    cp_async16(r_s + swizzled(row, c), r + static_cast<size_t>(ok ? src[p] : 0) * DP + c * 8,
               ok ? 16 : 0);
  }
  if (threadIdx.x < kTile / 4) {
    const long long j = first + threadIdx.x * 4;
    const long long rest = live - j;
    const int bytes = rest >= 4 ? 16 : rest > 0 ? static_cast<int>(rest) * 4 : 0;
    cp_async16(w_s + threadIdx.x * 16, bytes > 0 ? wv + j : wv, bytes);
  }
}

// acc = the [64 x 64] logit tile (before inv_temp) of the anchor block
// against one gathered tile; thread layout of wgmma's accumulator.
template <int DP>
__device__ __forceinline__ void logit_tile(float (&acc)[32], uint32_t a_s, uint32_t r_s) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < DP / 16; ++k) {
    const uint32_t off = (k / 4) * kAtomBytes + (k % 4) * 32;
    wgmma_ss(acc, kmajor_desc(a_s + off), kmajor_desc(r_s + off));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

// The gather ring both kernels share.  `ring_start` puts the anchors and
// the first kStages - 1 tiles in flight (one commit group each, the anchors
// with tile 0); `ring_next` waits for tile t, refills the slot that tile t - 1
// used with tile t + kStages - 1, and returns tile t's slot.
template <int DP>
__device__ __forceinline__ void ring_start(uint32_t base, const __nv_bfloat16* a, int q_pad,
                                           const __nv_bfloat16* r, const int* idx,
                                           const float* wv, int live, long long t0, int count) {
  using S = Smem<DP>;
  load_anchors<DP>(base + S::kA, a, blockIdx.x * kAnchors, q_pad);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < count) {
      gather_tile<DP>(base + S::kR + s * S::kTileBytes, base + S::kW + s * kTile * 4, r, idx,
                      wv, (t0 + s) * kTile, live);
    }
    cp_async_commit();
  }
}

template <int DP>
__device__ __forceinline__ int ring_next(uint32_t base, const __nv_bfloat16* r, const int* idx,
                                         const float* wv, int live, long long t0, int count,
                                         int t) {
  using S = Smem<DP>;
  cp_async_wait<kStages - 2>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // cp.async -> wgmma
  __syncthreads();  // every thread is done with tile t - 1
  const int next = t + kStages - 1;
  if (next < count) {
    const int slot = next % kStages;
    gather_tile<DP>(base + S::kR + slot * S::kTileBytes, base + S::kW + slot * kTile * 4, r,
                    idx, wv, (t0 + next) * kTile, live);
  }
  cp_async_commit();
  return t % kStages;
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
k1_live_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ r,
               const int* __restrict__ idx, const float* __restrict__ wv,
               const int* __restrict__ n_live, float* __restrict__ partial, int q_pad,
               int chunks, float inv_temp) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const float* w_s = reinterpret_cast<const float*>(smem_raw + (base - raw) + Smem<DP>::kW);
  const int live = *n_live;
  long long t0, t1;
  if (!chunk_tiles(live, chunks, t0, t1)) return;

  const int group = threadIdx.x / 128;  // this warpgroup's anchors: q0 .. q0 + 63
  const int q0 = blockIdx.x * kAnchors + group * kTile;
  const bool active = q0 < q_pad;       // uniform across the warpgroup
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int col = 2 * (lane % 4);
  float sum_lo = 0.f, sum_hi = 0.f;  // rows lane/4 and lane/4 + 8 of this warp's 16
  float acc[32];
  const int count = static_cast<int>(t1 - t0);
  ring_start<DP>(base, a, q_pad, r, idx, wv, live, t0, count);
  for (int t = 0; t < count; ++t) {
    const int slot = ring_next<DP>(base, r, idx, wv, live, t0, count, t);
    if (!active) continue;
    logit_tile<DP>(acc, base + Smem<DP>::kA + group * Smem<DP>::kTileBytes,
                   base + Smem<DP>::kR + slot * Smem<DP>::kTileBytes);
    const float* w_t = w_s + slot * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float w0 = w_t[8 * j + col];
      const float w1 = w_t[8 * j + col + 1];
      sum_lo += expf(acc[4 * j] * inv_temp) * w0 + expf(acc[4 * j + 1] * inv_temp) * w1;
      sum_hi += expf(acc[4 * j + 2] * inv_temp) * w0 + expf(acc[4 * j + 3] * inv_temp) * w1;
    }
  }
  sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 1);
  sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 2);
  sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 1);
  sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 2);
  if (active && lane % 4 == 0) {
    float* out = partial + static_cast<size_t>(blockIdx.y) * q_pad + q0 + 16 * warp + lane / 4;
    out[0] = sum_lo;
    out[8] = sum_hi;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
k2_live_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ r,
               const int* __restrict__ idx, const float* __restrict__ wv,
               const int* __restrict__ n_live, float* __restrict__ partial, int q_pad,
               int chunks, float inv_temp) {
  constexpr int kSlabs = DP / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const float* w_s = reinterpret_cast<const float*>(smem_raw + (base - raw) + Smem<DP>::kW);
  const int live = *n_live;
  long long t0, t1;
  if (!chunk_tiles(live, chunks, t0, t1)) return;

  const int group = threadIdx.x / 128;  // this warpgroup's anchors: q0 .. q0 + 63
  const int q0 = blockIdx.x * kAnchors + group * kTile;
  const bool active = q0 < q_pad;       // uniform across the warpgroup
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int col = 2 * (lane % 4);
  float m[kSlabs][32];  // M[64, DP]: slab p holds columns 64p .. 64p + 63
#pragma unroll
  for (int p = 0; p < kSlabs; ++p) {
#pragma unroll
    for (int i = 0; i < 32; ++i) m[p][i] = 0.f;
  }
  float acc[32];
  const int count = static_cast<int>(t1 - t0);
  ring_start<DP>(base, a, q_pad, r, idx, wv, live, t0, count);
  for (int t = 0; t < count; ++t) {
    const int slot = ring_next<DP>(base, r, idx, wv, live, t0, count, t);
    if (!active) continue;
    const uint32_t r_slot = base + Smem<DP>::kR + slot * Smem<DP>::kTileBytes;
    logit_tile<DP>(acc, base + Smem<DP>::kA + group * Smem<DP>::kTileBytes, r_slot);
    const float* w_t = w_s + slot * kTile;
    // e = bf16(w * exp(l)) as the A fragments of the k16 steps s = 0..3:
    // columns 16s .. 16s + 15 are accumulator blocks j = 2s and 2s + 1.
    uint32_t e[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * s + h;
        const float w0 = w_t[8 * j + col];
        const float w1 = w_t[8 * j + col + 1];
        e[s][2 * h] = pack_bf16(expf(acc[4 * j] * inv_temp) * w0,
                                expf(acc[4 * j + 1] * inv_temp) * w1);
        e[s][2 * h + 1] = pack_bf16(expf(acc[4 * j + 2] * inv_temp) * w0,
                                    expf(acc[4 * j + 3] * inv_temp) * w1);
      }
    }
#pragma unroll
    for (int p = 0; p < kSlabs; ++p) fence_regs(m[p]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < kSlabs; ++p) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        // rows 16s .. 16s + 15 of the tile, columns 64p .. 64p + 63
        wgmma_rs_mn(m[p], e[s], mnmajor_desc(r_slot + p * kAtomBytes + s * 16 * 128));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < kSlabs; ++p) fence_regs(m[p]);
  }
  if (!active) return;
  float* out = partial + (static_cast<size_t>(blockIdx.y) * q_pad + q0 + 16 * warp + lane / 4) *
                             DP + col;
#pragma unroll
  for (int p = 0; p < kSlabs; ++p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(out + 64 * p + 8 * j) = make_float2(m[p][4 * j], m[p][4 * j + 1]);
      *reinterpret_cast<float2*>(out + 8 * DP + 64 * p + 8 * j) =
          make_float2(m[p][4 * j + 2], m[p][4 * j + 3]);
    }
  }
}

// out[i] = sum over the used chunks c, in order, of partial[c, i]; float4 lanes.
__global__ void sum_partials_kernel(const float4* __restrict__ partial, int chunks,
                                    long long len4, const int* __restrict__ n_live,
                                    float4* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= len4) return;
  const long long tiles = (static_cast<long long>(*n_live) + kTile - 1) / kTile;
  const int used = static_cast<int>(min(static_cast<long long>(chunks), tiles));
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < used; ++c) {
    const float4 p = partial[static_cast<long long>(c) * len4 + i];
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  out[i] = s;
}

template <int DP, bool kBackward>
int launch(const void* a, const void* r, const void* idx, const void* wv, const void* n_live,
           void* partial, void* out, int q_pad, int chunks, float inv_temp,
           cudaStream_t stream) {
  if (q_pad <= 0 || q_pad % kTile != 0 || chunks <= 0 || chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = kBackward ? k2_live_kernel<DP> : k1_live_kernel<DP>;
  constexpr size_t smem = Smem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((q_pad + kAnchors - 1) / kAnchors, chunks);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(r),
      static_cast<const int*>(idx), static_cast<const float*>(wv),
      static_cast<const int*>(n_live), static_cast<float*>(partial), q_pad, chunks, inv_temp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long len4 = (kBackward ? static_cast<long long>(q_pad) * DP : q_pad) / 4;
  const int threads = 256;
  sum_partials_kernel<<<static_cast<unsigned>((len4 + threads - 1) / threads), threads, 0,
                        stream>>>(static_cast<const float4*>(partial), chunks, len4,
                                  static_cast<const int*>(n_live), static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <bool kBackward>
int dispatch(const void* a, const void* r, const void* idx, const void* wv, const void* n_live,
             void* partial, void* out, int q_pad, int d_pad, int chunks, float inv_temp,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d_pad) {
    case 64:
      return launch<64, kBackward>(a, r, idx, wv, n_live, partial, out, q_pad, chunks, inv_temp, s);
    case 128:
      return launch<128, kBackward>(a, r, idx, wv, n_live, partial, out, q_pad, chunks, inv_temp,
                                    s);
    case 256:
      return launch<256, kBackward>(a, r, idx, wv, n_live, partial, out, q_pad, chunks, inv_temp,
                                    s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// w [n] f32 contiguous, 16-byte aligned; counts [max(1, ceil(n / 2048))]
// int32 scratch; idx [n] int32 and wv [n] f32 outputs (first L used);
// n_live [1] int32 output.  Returns a cudaError_t.
extern "C" int css_compact_live_rows(const void* w, long long n, void* counts, void* idx,
                                     void* wv, void* n_live, void* stream) {
  const long long blocks = n > 0 ? (n + kCompactBlock - 1) / kCompactBlock : 1;
  if (n < 0 || n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  count_live_kernel<<<static_cast<unsigned>(blocks), kCompactThreads, 0, s>>>(
      static_cast<const float*>(w), n, static_cast<int*>(counts));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_live_kernel<<<static_cast<unsigned>(blocks), kCompactThreads, 0, s>>>(
      static_cast<const float*>(w), n, static_cast<const int*>(counts), static_cast<int*>(idx),
      static_cast<float*>(wv), static_cast<int*>(n_live));
  return static_cast<int>(cudaGetLastError());
}

// a [q_pad, d_pad] bf16 (q_pad a multiple of 64), r [rows, d_pad] bf16,
// idx/wv/n_live from css_compact_live_rows, all contiguous and 16-byte
// aligned; the grid is ceil(q_pad / 128) x chunks; partial [chunks, q_pad]
// f32 scratch; out [q_pad] f32.  Returns a cudaError_t.
extern "C" int css_weighted_exp_softsum_fwd(const void* a, const void* r, const void* idx,
                                            const void* wv, const void* n_live, void* partial,
                                            void* out, int q_pad, int d_pad, int chunks,
                                            float inv_temp, void* stream) {
  return dispatch<false>(a, r, idx, wv, n_live, partial, out, q_pad, d_pad, chunks, inv_temp,
                         stream);
}

// Same inputs; partial [chunks, q_pad, d_pad] f32 scratch; out [q_pad, d_pad] f32.
extern "C" int css_weighted_exp_softsum_bwd(const void* a, const void* r, const void* idx,
                                            const void* wv, const void* n_live, void* partial,
                                            void* out, int q_pad, int d_pad, int chunks,
                                            float inv_temp, void* stream) {
  return dispatch<true>(a, r, idx, wv, n_live, partial, out, q_pad, d_pad, chunks, inv_temp,
                        stream);
}

// p_over_cnt [C, C + 1] f32 (1 <= C <= 127), masked_cls [n] int32 with values
// in [0, C], u null or [C, n] f32, all contiguous; idx [C, n_pad] int32, wv
// [C, n_pad] f32 (row c's first n_live[c] entries used, n_pad >= n) and
// n_live [C] int32 outputs.  One launch: a cluster of kClassCluster CTAs per
// class.  Returns a cudaError_t.
extern "C" int css_class_live_rows(const void* p_over_cnt, int num_classes, const void* masked_cls,
                                   long long n, float g, const void* u, void* idx, void* wv,
                                   void* n_live, long long n_pad, void* stream) {
  if (num_classes < 1 || num_classes > kMaxClasses || n < 0 || n > 0x7fffffffLL || n_pad < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // each CTA's share of the rows, a whole number of pass-1 steps
  const long long per_cta = (n + kClassCluster - 1) / kClassCluster;
  const long long share =
      (max(per_cta, 1LL) + kClassRowsPerStep - 1) / kClassRowsPerStep * kClassRowsPerStep;
  const long long smem = share / 32 * 4;
  if (smem > kClassSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(class_live_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(kClassCluster, num_classes);
  class_live_rows_kernel<<<grid, kCompactThreads, static_cast<size_t>(smem),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p_over_cnt), num_classes, static_cast<const int*>(masked_cls),
      static_cast<const float*>(u), g, n, static_cast<int>(share), n_pad,
      static_cast<int*>(idx), static_cast<float*>(wv), static_cast<int*>(n_live));
  return static_cast<int>(cudaGetLastError());
}
