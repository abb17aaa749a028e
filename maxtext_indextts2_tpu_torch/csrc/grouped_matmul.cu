// The grouped products of the MoE layer's sparse route for Hopper (sm_90a):
//   y[r, :] = x[r, :] @ w[g(r)]     for every row r of x [R, K], rows sorted by group,
// w [G, K, N], offsets [G + 1] int32 on the device (group g holds rows
// [offsets[g], offsets[g + 1])), float32 sums. Two variants:
//   grouped_matmul_bf16: bf16 x and w, y in bf16 (the float32 sum rounded);
//   grouped_matmul_int8: int8 x and w, int32 sums; y the int32 sums, or
//     (float(sum) * row_scale[r]) * w_scale[g(r), n] in bf16.
//
// Replaces no Pallas kernel: it is the counterpart of `jax.lax.ragged_dot`,
// which XLA lowers on the TPU for the JAX package's `RoutedMoE._sparse_experts`
// (maxtext_indextts2_tpu/models/moe.py:252-281; the int8 arithmetic of the
// int8w_serve experts at :241-266). Without it the port would loop over the
// experts with a matmul each, which needs every expert's row count on the host
// (a sync in every MoE layer of a decode step, so no captured graph), or take
// the dense einsum route, which reads every expert's weights and does E / k
// times the products.
//
// What bounds it on this card: bytes at decode shapes (R = slots x top-k rows
// over up to R experts: each touched expert's K x N weights are read once, the
// rows are few), operations at prefill and training shapes (R up to 32,768
// rows: 2 R K N products on the tensor cores). What the design does about it: a
// kernel for each regime. The host picks the regime from the rows a touched
// group holds at least on average (ops/grouped_matmul.py `forward_plan`: R >=
// 32 G is "many rows"), a rule on the shape, and both regimes find every
// block's (group, row tile) from `offsets` on the device, so nothing is read
// back to the host and a captured decode step holds the launch.
//
// bf16, many rows a group (prefill, the MoE training step's forward):
// grouped_wgmma.cuh's `rows_kernel<true>`, persistent and warp-specialised,
// TMA into a 4-stage mbarrier ring, two `wgmma` m64n256k16 consumer
// warpgroups on 128 x 256 tiles; x is the K-major A operand, w[g] the MN-major
// B operand read in [64 of K][64 of N] boxes of a 3-d tensor map over [G, K,
// N] through `wgmma`'s transpose bit; items group by group with a group's row
// tiles together, so each slice of w[g] comes from device memory once and is
// shared in the L2; masked 16-byte stores where a group ends inside a tile.
//
// bf16, few rows a group (decode): `grouped_matmul_bf16_few_rows_kernel`, a
// weight stream. A block computes 16 rows x 128 columns of y for one row tile
// of a group (4 warps, 32 columns each, `mma.sync` m16n8k16 from mma_bf16.cuh):
// x's rows and w[g]'s columns stream through a ring of stages of 64 K (18 KB
// each, `cp.async` with zero fill past the group's rows, past N and past the
// block's K range): 6 stages where K is long (two blocks an SM, 80 KB of
// weights in flight a block while one stage is multiplied), else 4 (three
// blocks an SM) or 3 (four), as the host picks from the blocks it expects at
// work: a ring too deep for them leaves blocks waiting for a slot. The group of
// a block comes from a warp scan of `offsets` that loads 128 groups' bounds in
// one round trip. Where the touched groups' column tiles alone would leave SMs
// without a block (8 rows over 128 experts: 48 tiles for 132 SMs), the K axis
// is split over a thread-block cluster of `splits` blocks (grid z, cluster dims
// (1, 1, splits), up to 8): each block sums its K range, writes its float32
// partial tile to its shared memory, and after cluster.sync() each block adds
// its share of the tile over the cluster's blocks in rank order through
// distributed shared memory, rounds once to bf16 and stores it; a last
// cluster.sync() keeps the partials alive until every peer has read them. No
// atomics, no workspace in device memory, no second launch. The grid's row
// tiles are sized to the touched work, the most tiles R rows can fill over G
// groups (min(R, G) + (R - min(R, G)) / 16), so 8 rows over 128 experts launch
// 8 row tiles, not 129; a spare tile's blocks find no group and leave at once.
//
// int8 (the int8w_serve experts; bytes bound at decode, the int8 tensor
// cores' operations or the weights' bytes at prefill): `mma.sync` m16n8k32 s8
// with int32 sums. Its B fragment wants each column's 4 k bytes in one word,
// w[g] is [K, N] with N contiguous, and neither `ldmatrix .trans` nor
// `wgmma`'s transpose bit takes 8-bit operands, so the weights stream raw
// (16-byte cp.async, no second, transposed copy of the experts) into a ring
// of [128 of K][128 columns] stages whose 16-byte chunks are XOR-swizzled by
// the k quad, and each lane transposes its own fragments in registers: it
// reads the word of 4 columns in each of 4 k rows (conflict-free through the
// swizzle) and `__byte_perm`s the 4 x 4 bytes into the B fragments of four
// n-tiles, whose columns interleave (column 4 p + j of a warp's 32 is column
// p of n-tile j), so that a lane's sums are 8 consecutive columns of a row
// and go out in one 16-byte store. Both regimes, as the bf16 forward's, from
// the host's `int8_plan` (ops/grouped_matmul.py):
//   few rows (decode): `grouped_matmul_int8_few_rows_kernel`, 16 rows x 128
//   columns a block, a ring of 3 or 4 stages of 18 KB sized by residency,
//   the grid sized to the tiles the rows can fill, K split over a cluster
//   where the blocks are fewer than the SMs, the int32 partials summed in
//   distributed shared memory in rank order (exact);
//   many rows (prefill): `grouped_matmul_int8_rows_kernel`, persistent (as
//   many blocks as the SMs hold), 64-row x 128-column items group by group
//   with a group's row tiles together, a 3-stage ring of 24 KB.
// The epilogue: the int32 sums, or (float(sum) * row_scale) * the expert's
// channel scale, in that order, rounded once to bf16.
//
// Every sum runs in a fixed order (the wgmma tiles' in K, the split partials
// in rank order): two launches give the same bits. Products are exact bf16 x
// bf16, sums float32, rounded once to bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "grouped_wgmma.cuh"
#include "mma_bf16.cuh"

namespace gmm {

constexpr int kBN = 128;                 // columns of y a block
constexpr int kWarps = 4;                // 32 columns each
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 64;                  // bf16: K a stage (128 bytes a row)
constexpr int kFewRows = 16;             // bf16 few rows: rows of y a block
constexpr int kMaxSplits = 8;            // the portable cluster size
constexpr int kBK8 = 128;                // int8: K a stage (128 bytes a row)
constexpr unsigned kFull = 0xffffffffu;

// The (group, row tile within it) of row-tile block `t`, or group -1 for a
// spare block: an exclusive scan of ceil(rows / BM) over the groups by warp 0,
// 128 groups a step (each lane loads the 5 bounds of its 4 groups at once, so
// a step costs one round trip to the L2). Every thread reads the answer.
template <int BM>
__device__ __forceinline__ void find_tile(const int* __restrict__ offsets, int groups, int t,
                                          int* s_group, int* s_tile) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    if (lane == 0) *s_group = -1;  // a spare block unless a lane finds its group
    __syncwarp();
    int carry = 0;
    for (int base = 0; base < groups; base += 128) {
      const int g0 = base + 4 * lane;
      int bound[5];
#pragma unroll
      for (int j = 0; j < 5; ++j) bound[j] = g0 + j <= groups ? offsets[g0 + j] : 0;
      int cnt[4], own = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cnt[j] = g0 + j < groups ? (max(0, bound[j + 1] - bound[j]) + BM - 1) / BM : 0;
        own += cnt[j];
      }
      int incl = own;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      const int excl = incl - own;
      const unsigned hit = __ballot_sync(kFull, t >= carry + excl && t < carry + incl);
      if (hit) {
        const int src = __ffs(hit) - 1;
        if (lane == src) {  // the group among this lane's four
          int before = carry + excl, group = -1, tile = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (group < 0 && t < before + cnt[j]) {
              group = g0 + j;
              tile = t - before;
            }
            before += cnt[j];
          }
          *s_group = group;
          *s_tile = tile;
        }
        break;
      }
      carry += __shfl_sync(kFull, incl, 31);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace gmm

// ---- bf16

namespace gmm {
namespace cg = cooperative_groups;

// stage `kt` of x's rows [row0, row_end) and of w[g]'s columns [n0, n0 + 128)
// over K [k0, k0 + 64), zeros past row_end, past k_end and past N, into one
// ring slot: x as a swizzled [16][64] tile, w as 4 warp tiles [64][32]
__device__ __forceinline__ void load_stage_few(unsigned xs, unsigned ws,
                                               const __nv_bfloat16* __restrict__ x,
                                               const __nv_bfloat16* __restrict__ wg, int row0,
                                               int row_end, int n0, int k0, int k_end, int k,
                                               int n) {
  constexpr int kXChunks = kFewRows * (kBK / 8);
  static_assert(kXChunks <= kThreads, "a chunk of x a thread at most");
  if (threadIdx.x < kXChunks) {
    const int r = threadIdx.x / (kBK / 8), c = threadIdx.x % (kBK / 8);
    const int row = row0 + r, kc = k0 + 8 * c;
    const bool ok = row < row_end && kc < k_end;
    hopper::cp_async16(xs + hopper::swz<kBK>(r, c),
                       x + (ok ? (long long)row * k + kc : 0), ok);
  }
  constexpr int kWChunks = kBK * (kBN / 8);
#pragma unroll
  for (int it = 0; it < kWChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int kr = i / (kBN / 8), cc = i % (kBN / 8);
    const int krow = k0 + kr, col = n0 + 8 * cc;
    const bool ok = krow < k_end && col < n;
    const unsigned dst = ws + (cc / 4) * (kBK * 32 * 2) + hopper::swz<32>(kr, cc % 4);
    hopper::cp_async16(dst, wg + (ok ? (long long)krow * n + col : 0), ok);
  }
}

constexpr int kFewXBytes = kFewRows * kBK * 2, kFewWBytes = kBK * kBN * 2;
constexpr int kFewStageBytes = kFewXBytes + kFewWBytes;  // 18 KB
// the ring's depth: 6 stages (108 KB, two blocks an SM), 4 (72 KB, three) or
// 3 (54 KB, four); the host picks it (ops/grouped_matmul.py `forward_plan`)
template <int STAGES>
constexpr int few_smem() { return STAGES * kFewStageBytes; }

// grid (row tiles, column tiles, splits), launched as clusters of `splits`
// blocks along z when splits > 1; each split covers k_per_split of K (a
// multiple of 64, every split non-empty)
template <int STAGES>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_bf16_few_rows_kernel(const __nv_bfloat16* __restrict__ x,
                                    const __nv_bfloat16* __restrict__ w,
                                    const int* __restrict__ offsets,
                                    __nv_bfloat16* __restrict__ out, int rows, int k, int n,
                                    int groups, int k_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_group, s_tile;

  find_tile<kFewRows>(offsets, groups, blockIdx.x, &s_group, &s_tile);
  const int g = s_group;
  if (g < 0) return;  // a spare row tile: every block of its cluster leaves here
  const int row0 = offsets[g] + s_tile * kFewRows;
  const int row_end = min(offsets[g + 1], rows);
  const int n0 = blockIdx.y * kBN;
  const int k_begin = blockIdx.z * k_per_split, k_end = min(k, k_begin + k_per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* wg = w + (long long)g * k * n;
  const unsigned base = hopper::smem_addr(smem);

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int ktiles = (k_end - k_begin + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles)
      load_stage_few(base + s * kFewStageBytes, base + s * kFewStageBytes + kFewXBytes, x, wg,
                     row0, row_end, n0, k_begin + s * kBK, k_end, k, n);
    hopper::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt has landed; every warp is done with stage kt - 1
    const int next = kt + STAGES - 1;
    if (next < ktiles) {
      const int slot = next % STAGES;
      load_stage_few(base + slot * kFewStageBytes, base + slot * kFewStageBytes + kFewXBytes, x,
                     wg, row0, row_end, n0, k_begin + next * kBK, k_end, k, n);
    }
    hopper::cp_async_commit();
    const unsigned xs = base + (kt % STAGES) * kFewStageBytes;
    unsigned a[kBK / 16][4];
    hopper::load_a<kBK>(a, xs, 0, lane);
    hopper::product_am<32, kBK / 16>(acc, a, xs + kFewXBytes + warp * (kBK * 32 * 2), lane);
  }
  hopper::cp_async_wait<0>();

  // element e of fragment j: row lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2
  if (gridDim.z == 1) {  // no split: the block's sums are final
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + lane / 4 + 8 * h;
        const int col = n0 + 32 * warp + 8 * j + 2 * (lane % 4);
        if (row < row_end && col < n)  // n is even: col + 1 < n too
          store_bf16x2(out + (long long)row * n + col, acc[j][2 * h], acc[j][2 * h + 1]);
      }
    return;
  }

  // the split's partial [16][128] float32 tile into this block's shared memory
  __syncthreads();  // every warp is done with the ring
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane / 4 + 8 * h, c = 32 * warp + 8 * j + 2 * (lane % 4);
      *reinterpret_cast<float2*>(part + r * kBN + c) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cluster.sync();
  // this block's share of the tile's column pairs, summed over the splits in rank order
  constexpr int kPairs = kFewRows * kBN / 2;
  const int per = (kPairs + splits - 1) / splits;
  const int lo = rank * per, hi = min(kPairs, lo + per);
  for (int p = lo + static_cast<int>(threadIdx.x); p < hi; p += kThreads) {
    const int r = p / (kBN / 2), c = 2 * (p % (kBN / 2));
    float2 sum = *reinterpret_cast<const float2*>(cluster.map_shared_rank(part, 0) + r * kBN + c);
    for (int q = 1; q < splits; ++q) {
      const float2 v =
          *reinterpret_cast<const float2*>(cluster.map_shared_rank(part, q) + r * kBN + c);
      sum.x += v.x;
      sum.y += v.y;
    }
    const int row = row0 + r, col = n0 + c;
    if (row < row_end && col < n) store_bf16x2(out + (long long)row * n + col, sum.x, sum.y);
  }
  cluster.sync();  // no block leaves (and frees its partial) while a peer reads it
}

// the row tiles of the few-rows grid: the most R rows can fill over G groups,
// min(R, G) + (R - min(R, G)) / 16 (a touched group's first row takes a tile,
// each 16 rows more another)
inline long long few_row_tiles(int rows, int groups) {
  const int touched = rows < groups ? rows : groups;
  return touched + (rows - touched) / kFewRows;
}

template <int STAGES>
int launch_few_rows(const void* x, const void* w, const void* offsets, void* out, int rows,
                    int k, int n, int groups, int splits, cudaStream_t st) {
  const int ktiles = (k + kBK - 1) / kBK;
  const int k_per_split = (ktiles + splits - 1) / splits * kBK;
  const long long tiles = few_row_tiles(rows, groups);
  const int ncol = (n + kBN - 1) / kBN;
  if ((splits - 1) * k_per_split >= k || tiles > 2147483647LL || ncol > 65535)
    return static_cast<int>(cudaErrorInvalidValue);  // an empty split, or a grid too large
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(grouped_matmul_bf16_few_rows_kernel<STAGES>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           few_smem<STAGES>());
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(ncol),
                     static_cast<unsigned>(splits));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = few_smem<STAGES>();
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = static_cast<unsigned>(splits);
  cfg.attrs = &attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // no split: a plain launch, no cluster barriers
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, grouped_matmul_bf16_few_rows_kernel<STAGES>, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const int*>(offsets),
      static_cast<__nv_bfloat16*>(out), rows, k, n, groups, k_per_split);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gmm

// x [rows, k] bf16 (rows sorted by group), w [groups, k, n] bf16, offsets
// [groups + 1] int32, out [rows, n] bf16; k and n multiples of 8, every
// pointer 16-byte aligned. splits 0: the many-rows regime (the persistent
// wgmma kernel); 1..8: the few-rows regime with K split over a cluster of
// `splits` blocks (each split non-empty: (splits - 1) * ceil(ceil(k / 64) /
// splits) * 64 < k) and a ring of `stages` stages (3, 4 or 6).
extern "C" int grouped_matmul_bf16(const void* x, const void* w, const void* offsets, void* out,
                                   int rows, int k, int n, int groups, int splits, int stages,
                                   void* stream) {
  if (rows <= 0 || k <= 0 || n <= 0 || groups <= 0 || k % 8 != 0 || n % 8 != 0 || splits < 0 ||
      splits > gmm::kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits == 0) return gmm_wg::launch_rows<true>(x, w, offsets, out, rows, n, k, groups, st);
  if (stages == 6)
    return gmm::launch_few_rows<6>(x, w, offsets, out, rows, k, n, groups, splits, st);
  if (stages == 4)
    return gmm::launch_few_rows<4>(x, w, offsets, out, rows, k, n, groups, splits, st);
  if (stages == 3)
    return gmm::launch_few_rows<3>(x, w, offsets, out, rows, k, n, groups, splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- int8

namespace gmm {

constexpr int kX8Few = kFewRows * kBK8;               // 2 KB: 16 rows of x a stage
constexpr int kW8Bytes = kBK8 * kBN;                  // 16 KB: w[g]'s raw [128 of K][128 columns]
constexpr int kFew8Stage = kX8Few + kW8Bytes;         // 18 KB, as the bf16 few-rows stage
constexpr int kMany8Rows = 64;                        // many rows: rows of y a block
constexpr int kMany8Stage = kMany8Rows * kBK8 + kW8Bytes;  // 24 KB
constexpr int kMany8Stages = 3;                       // 72 KB: three blocks an SM
template <int STAGES>
constexpr int few8_smem() { return STAGES * kFew8Stage; }
constexpr int kMany8Smem = kMany8Stages * kMany8Stage;

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned lds32(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// byte offset of 16-byte chunk c (16 columns) of k row r in a raw weight stage
// [128 of K][128 columns]: the chunks XOR-swizzled by 2 ((r / 4) % 4), so that
// the four k quads a warp reads at once (rows 4 q + i, q = 0..3) fall on
// distinct banks
__device__ __forceinline__ unsigned w8_off(int r, int c) {
  return static_cast<unsigned>(r * kBN + ((c ^ (2 * ((r >> 2) & 3))) << 4));
}

// rows [row0, row_end) of x and w[g]'s columns [n0, n0 + 128) over K [k0, k0 +
// 128) into one ring slot, zeros past row_end, past k_end and past N: x as a
// swizzled [BM][64] b16 tile (ldmatrix reads its A fragments), w raw (w8_off)
template <int BM>
__device__ __forceinline__ void load_stage8(unsigned xs, unsigned ws,
                                            const int8_t* __restrict__ x,
                                            const int8_t* __restrict__ wg, int row0, int row_end,
                                            int n0, int k0, int k_end, int k, int n) {
  constexpr int kXChunks = BM * (kBK8 / 16);
#pragma unroll
  for (int it = 0; it < (kXChunks + kThreads - 1) / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (kXChunks % kThreads != 0 && i >= kXChunks) break;
    const int r = i / (kBK8 / 16), c = i % (kBK8 / 16);
    const int row = row0 + r, kc = k0 + 16 * c;
    const bool ok = row < row_end && kc < k_end;
    hopper::cp_async16(xs + hopper::swz<kBK8 / 2>(r, c), x + (ok ? (long long)row * k + kc : 0),
                       ok);
  }
  constexpr int kWChunks = kBK8 * (kBN / 16);
#pragma unroll
  for (int it = 0; it < kWChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / (kBN / 16), c = i % (kBN / 16);
    const int krow = k0 + r, col = n0 + 16 * c;
    const bool ok = krow < k_end && col < n;
    hopper::cp_async16(ws + w8_off(r, c), wg + (ok ? (long long)krow * n + col : 0), ok);
  }
}

// o[j]: the 4 bytes of column j of v[0..3] (v[i]: row i's 4 columns)
__device__ __forceinline__ void transpose4(const unsigned (&v)[4], unsigned (&o)[4]) {
  const unsigned ab_lo = __byte_perm(v[0], v[1], 0x5140), ab_hi = __byte_perm(v[0], v[1], 0x7362);
  const unsigned cd_lo = __byte_perm(v[2], v[3], 0x5140), cd_hi = __byte_perm(v[2], v[3], 0x7362);
  o[0] = __byte_perm(ab_lo, cd_lo, 0x5410);
  o[1] = __byte_perm(ab_lo, cd_lo, 0x7632);
  o[2] = __byte_perm(ab_hi, cd_hi, 0x5410);
  o[3] = __byte_perm(ab_hi, cd_hi, 0x7632);
}

// acc[mt][j] += rows [16 mt, 16 mt + 16) of the x stage times the warp's 32
// columns of the raw w stage, over the stage's 128 of K (m16n8k32, int32 sums).
// Column 32 warp + 4 p + j of the block is column p of n-tile j: lane (p =
// lane / 4, q = lane % 4) reads the word of columns 4 p..4 p + 3 in k rows
// 4 q..4 q + 3 (and 16 past them) and transposes the 4 x 4 bytes into its B
// fragments of the four n-tiles; the A fragments come by ldmatrix, once a
// row tile for the four n-tiles
template <int MT>
__device__ __forceinline__ void product_s8(int (&acc)[MT][4][4], unsigned xs, unsigned ws,
                                           int warp, int lane) {
  const int p = lane >> 2, q = lane & 3;
  const int chunk = 2 * warp + (p >> 2);
  const unsigned word = (p & 3) * 4;
#pragma unroll
  for (int kk = 0; kk < kBK8 / 32; ++kk) {
    unsigned b[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = lds32(ws + w8_off(32 * kk + 16 * h + 4 * q + i, chunk) + word);
      transpose4(v, b[h]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      unsigned a[4];
      hopper::ldsm_x4(xs + hopper::swz<kBK8 / 2>(16 * mt + (lane & 15), 2 * kk + (lane >> 4)), a);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[mt][j], a, b[0][j], b[1][j]);
    }
  }
}

// acc += x rows [row0, row_end) over K [k_begin, k_end) times w[g]'s columns
// [n0, n0 + 128): a ring of STAGES stages of 128 of K through cp.async, the
// next stages in flight while one is multiplied
template <int BM, int STAGES>
__device__ __forceinline__ void stream_s8(int (&acc)[BM / 16][4][4], unsigned base,
                                          const int8_t* __restrict__ x,
                                          const int8_t* __restrict__ wg, int row0, int row_end,
                                          int n0, int k_begin, int k_end, int k, int n) {
  constexpr int kXBytes = BM * kBK8, kStage = kXBytes + kW8Bytes;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ktiles = (k_end - k_begin + kBK8 - 1) / kBK8;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles)
      load_stage8<BM>(base + s * kStage, base + s * kStage + kXBytes, x, wg, row0, row_end, n0,
                      k_begin + s * kBK8, k_end, k, n);
    hopper::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt has landed; every warp is done with stage kt - 1
    const int next = kt + STAGES - 1;
    if (next < ktiles) {
      const unsigned slot = base + (next % STAGES) * kStage;
      load_stage8<BM>(slot, slot + kXBytes, x, wg, row0, row_end, n0, k_begin + next * kBK8,
                      k_end, k, n);
    }
    hopper::cp_async_commit();
    const unsigned slot = base + (kt % STAGES) * kStage;
    product_s8<BM / 16>(acc, slot, slot + kXBytes, warp, lane);
  }
  hopper::cp_async_wait<0>();
}

// a lane's 8 consecutive columns [col, col + 8) of `row`: the int32 sums
// (row_scale null), else the JAX package's order, (float(sum) * row scale) *
// the expert's channel scale, rounded once to bf16: one 16-byte store
__device__ __forceinline__ void store8(void* __restrict__ out, const float* __restrict__ row_scale,
                                       const float* __restrict__ w_scale, int g, int row, int col,
                                       int n, const int (&s)[8]) {
  const long long at = (long long)row * n + col;
  if (row_scale == nullptr) {
    int4* o = reinterpret_cast<int4*>(static_cast<int*>(out) + at);
    o[0] = make_int4(s[0], s[1], s[2], s[3]);
    o[1] = make_int4(s[4], s[5], s[6], s[7]);
    return;
  }
  const float rs = row_scale[row];
  const float4* cs = reinterpret_cast<const float4*>(w_scale + (long long)g * n + col);
  const float4 c0 = cs[0], c1 = cs[1];
  uint4 v;
  v.x = hopper::pack_bf16((static_cast<float>(s[0]) * rs) * c0.x,
                          (static_cast<float>(s[1]) * rs) * c0.y);
  v.y = hopper::pack_bf16((static_cast<float>(s[2]) * rs) * c0.z,
                          (static_cast<float>(s[3]) * rs) * c0.w);
  v.z = hopper::pack_bf16((static_cast<float>(s[4]) * rs) * c1.x,
                          (static_cast<float>(s[5]) * rs) * c1.y);
  v.w = hopper::pack_bf16((static_cast<float>(s[6]) * rs) * c1.z,
                          (static_cast<float>(s[7]) * rs) * c1.w);
  *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + at) = v;
}

// row half h of m-tile mt: the lane's 8 columns, 8 q..8 q + 7 of its warp's 32
// (element e of n-tile j is column 4 (2 q + e % 2) + j, row p + 8 (e / 2))
template <int MT>
__device__ __forceinline__ void lane_sums(const int (&acc)[MT][4][4], int mt, int h, int (&s)[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] = acc[mt][j][2 * h];
    s[4 + j] = acc[mt][j][2 * h + 1];
  }
}

// few rows a group (decode): grid (row tiles, column tiles, splits), launched
// as clusters of `splits` blocks along z when splits > 1; each split covers
// k_per_split of K (a multiple of 128, every split non-empty)
template <int STAGES>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_int8_few_rows_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                                    const int* __restrict__ offsets,
                                    const float* __restrict__ row_scale,
                                    const float* __restrict__ w_scale, void* __restrict__ out,
                                    int rows, int k, int n, int groups, int k_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_group, s_tile;

  find_tile<kFewRows>(offsets, groups, blockIdx.x, &s_group, &s_tile);
  const int g = s_group;
  if (g < 0) return;  // a spare row tile: every block of its cluster leaves here
  const int row0 = offsets[g] + s_tile * kFewRows;
  const int row_end = min(offsets[g + 1], rows);
  const int n0 = blockIdx.y * kBN;
  const int k_begin = blockIdx.z * k_per_split, k_end = min(k, k_begin + k_per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int acc[1][4][4] = {};
  stream_s8<kFewRows, STAGES>(acc, hopper::smem_addr(smem), x, w + (long long)g * k * n, row0,
                              row_end, n0, k_begin, k_end, k, n);

  const int col = 32 * warp + 8 * (lane & 3);  // the lane's 8 columns of the block's 128
  if (gridDim.z == 1) {  // no split: the block's sums are final
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + (lane >> 2) + 8 * h;
      int s[8];
      lane_sums<1>(acc, 0, h, s);
      if (row < row_end && n0 + col < n) store8(out, row_scale, w_scale, g, row, n0 + col, n, s);
    }
    return;
  }

  // the split's partial [16][128] int32 tile into this block's shared memory
  __syncthreads();  // every warp is done with the ring
  int* part = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int s[8];
    lane_sums<1>(acc, 0, h, s);
    int4* p = reinterpret_cast<int4*>(part + ((lane >> 2) + 8 * h) * kBN + col);
    p[0] = make_int4(s[0], s[1], s[2], s[3]);
    p[1] = make_int4(s[4], s[5], s[6], s[7]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cluster.sync();
  // this block's share of the tile's 8-column units, summed over the splits
  // in rank order (int32: exact in any order)
  constexpr int kUnits = kFewRows * kBN / 8;
  const int per = (kUnits + splits - 1) / splits;
  const int lo = rank * per, hi = min(kUnits, lo + per);
  for (int u = lo + static_cast<int>(threadIdx.x); u < hi; u += kThreads) {
    const int r = u / (kBN / 8), c = 8 * (u % (kBN / 8));
    int s[8] = {};
    for (int q = 0; q < splits; ++q) {
      const int4* v = reinterpret_cast<const int4*>(cluster.map_shared_rank(part, q) + r * kBN + c);
      const int4 v0 = v[0], v1 = v[1];
      s[0] += v0.x, s[1] += v0.y, s[2] += v0.z, s[3] += v0.w;
      s[4] += v1.x, s[5] += v1.y, s[6] += v1.z, s[7] += v1.w;
    }
    const int row = row0 + r;
    if (row < row_end && n0 + c < n) store8(out, row_scale, w_scale, g, row, n0 + c, n, s);
  }
  cluster.sync();  // no block leaves (and frees its partial) while a peer reads it
}

// many rows a group (prefill), persistent: each block walks items blockIdx.x,
// blockIdx.x + gridDim.x, ..., (a 64-row tile of a group, 128 columns) group by
// group with a group's row tiles together within each column tile (the bf16
// persistent kernel's order: gmm_wg::find_item)
__global__ void __launch_bounds__(kThreads)
grouped_matmul_int8_rows_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                                const int* __restrict__ offsets,
                                const float* __restrict__ row_scale,
                                const float* __restrict__ w_scale, void* __restrict__ out,
                                int rows, int k, int n, int groups) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ncol = (n + kBN - 1) / kBN;
  const int col = 32 * warp + 8 * (lane & 3);
  int scan_base = 0, scan_carry = 0;
  for (int item = blockIdx.x;; item += gridDim.x) {
    int local;
    const int g = gmm_wg::find_item<kMany8Rows>(offsets, groups, ncol, item, scan_base,
                                                 scan_carry, local);
    if (g < 0) break;
    const int tiles = gmm_wg::row_tiles<kMany8Rows>(offsets, g);
    const int row0 = offsets[g] + kMany8Rows * (local % tiles);
    const int row_end = min(offsets[g + 1], rows);
    const int n0 = (local / tiles) * kBN;
    __syncthreads();  // every warp is done with the previous item's ring
    int acc[kMany8Rows / 16][4][4] = {};
    stream_s8<kMany8Rows, kMany8Stages>(acc, hopper::smem_addr(smem), x,
                                        w + (long long)g * k * n, row0, row_end, n0, 0, k, k, n);
    if (n0 + col >= n) continue;
#pragma unroll
    for (int mt = 0; mt < kMany8Rows / 16; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 16 * mt + (lane >> 2) + 8 * h;
        int s[8];
        lane_sums<kMany8Rows / 16>(acc, mt, h, s);
        if (row < row_end) store8(out, row_scale, w_scale, g, row, n0 + col, n, s);
      }
  }
}

template <int STAGES>
int launch_int8_few(const void* x, const void* w, const void* offsets, const void* row_scale,
                    const void* w_scale, void* out, int rows, int k, int n, int groups,
                    int splits, cudaStream_t st) {
  const int ktiles = (k + kBK8 - 1) / kBK8;
  const int k_per_split = (ktiles + splits - 1) / splits * kBK8;
  const long long tiles = few_row_tiles(rows, groups);
  const int ncol = (n + kBN - 1) / kBN;
  if ((splits - 1) * k_per_split >= k || tiles > 2147483647LL || ncol > 65535)
    return static_cast<int>(cudaErrorInvalidValue);  // an empty split, or a grid too large
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(grouped_matmul_int8_few_rows_kernel<STAGES>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           few8_smem<STAGES>());
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(ncol),
                     static_cast<unsigned>(splits));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = few8_smem<STAGES>();
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = static_cast<unsigned>(splits);
  cfg.attrs = &attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, grouped_matmul_int8_few_rows_kernel<STAGES>, static_cast<const int8_t*>(x),
      static_cast<const int8_t*>(w), static_cast<const int*>(offsets),
      static_cast<const float*>(row_scale), static_cast<const float*>(w_scale), out, rows, k, n,
      groups, k_per_split);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the persistent grid: as many blocks as the SMs hold at once, at most one an item
inline int launch_int8_rows(const void* x, const void* w, const void* offsets,
                            const void* row_scale, const void* w_scale, void* out, int rows, int k,
                            int n, int groups, cudaStream_t st) {
  static bool configured = false;
  static int per_sm = 0;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(grouped_matmul_int8_rows_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMany8Smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grouped_matmul_int8_rows_kernel,
                                                          kThreads, kMany8Smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    configured = true;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // at most ceil(rows / 64) + groups row tiles, each ceil(n / 128) items
  const long long items =
      (static_cast<long long>(rows + kMany8Rows - 1) / kMany8Rows + groups) * ((n + kBN - 1) / kBN);
  const long long slots = static_cast<long long>(per_sm) * sms;
  grouped_matmul_int8_rows_kernel<<<static_cast<unsigned>(items < slots ? items : slots), kThreads,
                                    kMany8Smem, st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int*>(offsets), static_cast<const float*>(row_scale),
      static_cast<const float*>(w_scale), out, rows, k, n, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gmm

// x [rows, k] int8, w [groups, k, n] int8, offsets as above; without scales
// (both null) out [rows, n] int32 sums; with them out [rows, n] bf16
// (float(sum) * row_scale[r]) * w_scale[g, n], row_scale [rows] and w_scale
// [groups, n] float32. k and n multiples of 16, every pointer 16-byte aligned.
// splits 0: the many-rows regime (the persistent kernel); 1..8: the few-rows
// regime with K split over a cluster of `splits` blocks (each split non-empty:
// (splits - 1) * ceil(ceil(k / 128) / splits) * 128 < k) and a ring of
// `stages` stages (3 or 4).
extern "C" int grouped_matmul_int8(const void* x, const void* w, const void* offsets,
                                   const void* row_scale, const void* w_scale, void* out,
                                   int rows, int k, int n, int groups, int splits, int stages,
                                   void* stream) {
  if (rows <= 0 || k <= 0 || n <= 0 || groups <= 0 || k % 16 != 0 || n % 16 != 0 || splits < 0 ||
      splits > gmm::kMaxSplits || (row_scale == nullptr) != (w_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits == 0)
    return gmm::launch_int8_rows(x, w, offsets, row_scale, w_scale, out, rows, k, n, groups, st);
  if (stages == 4)
    return gmm::launch_int8_few<4>(x, w, offsets, row_scale, w_scale, out, rows, k, n, groups,
                                   splits, st);
  if (stages == 3)
    return gmm::launch_int8_few<3>(x, w, offsets, row_scale, w_scale, out, rows, k, n, groups,
                                   splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
