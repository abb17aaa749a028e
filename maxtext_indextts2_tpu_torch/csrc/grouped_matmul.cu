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
// int8 (the int8w_serve experts): a block computes BM x 128 of y, 4 warps of
// 32 columns, `mma.sync` int8 m16n8k32 with int32 sums. The m16n8k32 B
// fragment wants each column's k bytes together, so the weights are
// transposed 4 x 4 bytes at a time in registers (`__byte_perm`) on their way
// to shared memory, and the next stage's weights are loaded into registers
// while this one is multiplied. BM is 16 (decode: most groups hold a row or
// two) or 64 (prefill); the grid is launched at its upper bound, ceil(R / BM)
// + G row tiles by ceil(N / 128) column tiles, spare blocks exit.
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

// ---- shared by both entry points

inline bool bad_shape(int rows, int k, int n, int groups, int tile_rows, int k_align,
                      int n_align) {
  return rows <= 0 || k <= 0 || n <= 0 || groups <= 0 || k % k_align != 0 ||
         n % n_align != 0 || (tile_rows != 16 && tile_rows != 64);
}

inline dim3 grid_of(int rows, int n, int groups, int tile_rows) {
  // the row tiles' upper bound: sum_g ceil(rows_g / BM) <= ceil(R / BM) + G
  return dim3(static_cast<unsigned>((rows + tile_rows - 1) / tile_rows + groups),
              static_cast<unsigned>((n + kBN - 1) / kBN), 1);
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
namespace {

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a thread's share of a stage of w[g]: 4 k rows x 16 columns, 2 such groups
constexpr int kW8Groups = (kBK8 / 4) * (kBN / 16) / kThreads;

__device__ __forceinline__ void load_w8(uint4 (&reg)[kW8Groups][4],
                                        const int8_t* __restrict__ wg, int n0, int k0, int k,
                                        int n) {
#pragma unroll
  for (int i = 0; i < kW8Groups; ++i) {
    const int gi = threadIdx.x + i * kThreads;
    const int kq = gi / (kBN / 16), cc = gi % (kBN / 16);
    const int col = n0 + 16 * cc;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int krow = k0 + 4 * kq + r;
      reg[i][r] = (krow < k && col < n)
                      ? __ldg(reinterpret_cast<const uint4*>(wg + (long long)krow * n + col))
                      : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// the registers of load_w8 transposed into 4 warp tiles [32 columns][128 k
// bytes] (swizzled as [32][64] bf16 units): column j's 4 k bytes as one word
__device__ __forceinline__ void store_w8(unsigned char* ws, const uint4 (&reg)[kW8Groups][4]) {
#pragma unroll
  for (int i = 0; i < kW8Groups; ++i) {
    const int gi = threadIdx.x + i * kThreads;
    const int kq = gi / (kBN / 16), cc = gi % (kBN / 16);
    const int kb = 4 * kq;  // the k byte of this group's word
#pragma unroll
    for (int wi = 0; wi < 4; ++wi) {
      const unsigned a = reinterpret_cast<const unsigned*>(&reg[i][0])[wi];
      const unsigned b = reinterpret_cast<const unsigned*>(&reg[i][1])[wi];
      const unsigned c = reinterpret_cast<const unsigned*>(&reg[i][2])[wi];
      const unsigned d = reinterpret_cast<const unsigned*>(&reg[i][3])[wi];
      const unsigned ab_lo = __byte_perm(a, b, 0x5140), ab_hi = __byte_perm(a, b, 0x7362);
      const unsigned cd_lo = __byte_perm(c, d, 0x5140), cd_hi = __byte_perm(c, d, 0x7362);
      const unsigned col_words[4] = {__byte_perm(ab_lo, cd_lo, 0x5410),
                                     __byte_perm(ab_lo, cd_lo, 0x7632),
                                     __byte_perm(ab_hi, cd_hi, 0x5410),
                                     __byte_perm(ab_hi, cd_hi, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 16 * cc + 4 * wi + j;  // the block's column
        unsigned char* tile = ws + (col / 32) * (32 * kBK8);
        *reinterpret_cast<unsigned*>(tile + hopper::swz<kBK8 / 2>(col % 32, kb / 16) +
                                     (kb % 16)) = col_words[j];
      }
    }
  }
}

template <int BM>
__device__ __forceinline__ void load_x8(unsigned xs, const int8_t* __restrict__ x, int row0,
                                        int row_end, int k0, int k) {
  constexpr int kChunks = BM * (kBK8 / 16);
#pragma unroll
  for (int it = 0; it < (kChunks + kThreads - 1) / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (kChunks % kThreads != 0 && i >= kChunks) break;
    const int r = i / (kBK8 / 16), c = i % (kBK8 / 16);
    const int row = row0 + r, kc = k0 + 16 * c;
    const bool ok = row < row_end && kc < k;
    hopper::cp_async16(xs + hopper::swz<kBK8 / 2>(r, c), x + (ok ? (long long)row * k + kc : 0),
                       ok);
  }
}

// kSums: out the int32 sums; else bf16 (float(sum) * row scale) * channel scale
template <int BM, bool kSums>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                           const int* __restrict__ offsets, const float* __restrict__ row_scale,
                           const float* __restrict__ w_scale, void* __restrict__ out, int rows,
                           int k, int n, int groups) {
  constexpr int RT = BM / 16;
  constexpr int kXBytes = BM * kBK8, kWBytes = kBK8 * kBN;
  // [x buffer 0 | x buffer 1 | w buffer 0 | w buffer 1]
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_group, s_tile;

  find_tile<BM>(offsets, groups, blockIdx.x, &s_group, &s_tile);
  const int g = s_group;
  if (g < 0) return;
  const int row0 = offsets[g] + s_tile * BM;
  const int row_end = min(offsets[g + 1], rows);
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int8_t* wg = w + (long long)g * k * n;

  int acc[RT][4][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rt][j][e] = 0;

  const int ktiles = (k + kBK8 - 1) / kBK8;
  uint4 reg[kW8Groups][4];
  load_w8(reg, wg, n0, 0, k, n);
  unsigned char* ws = smem + 2 * kXBytes;
  const unsigned xs = hopper::smem_addr(smem);
  load_x8<BM>(xs, x, row0, row_end, 0, k);
  hopper::cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int buf = kt & 1;
    store_w8(ws + buf * kWBytes, reg);
    hopper::cp_async_wait<0>();
    __syncthreads();  // stage kt is in shared memory; every warp is done with stage kt - 1
    if (kt + 1 < ktiles) {
      load_x8<BM>(xs + (buf ^ 1) * kXBytes, x, row0, row_end, (kt + 1) * kBK8, k);
      hopper::cp_async_commit();
      load_w8(reg, wg, n0, (kt + 1) * kBK8, k, n);  // in flight while this stage multiplies
    }
    const unsigned xa = xs + buf * kXBytes;
    const unsigned wt = hopper::smem_addr(ws + buf * kWBytes) + warp * (32 * kBK8);
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      unsigned a[kBK8 / 32][4];  // one m16n8k32 A fragment a 32 k bytes
      hopper::load_a<kBK8 / 2>(a, xa, 16 * rt, lane);
#pragma unroll
      for (int kk = 0; kk < kBK8 / 32; ++kk)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned b[4];
          hopper::ldsm_x4(wt + hopper::swz<kBK8 / 2>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                                     2 * kk + ((lane >> 3) & 1)),
                          b);
          mma_s8(acc[rt][2 * np], a[kk], b[0], b[1]);
          mma_s8(acc[rt][2 * np + 1], a[kk], b[2], b[3]);
        }
    }
  }

#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 16 * rt + lane / 4 + 8 * h;
        const int col = n0 + 32 * warp + 8 * j + 2 * (lane % 4);
        if (row >= row_end || col >= n) continue;
        const int s0 = acc[rt][j][2 * h], s1 = acc[rt][j][2 * h + 1];
        const long long at = (long long)row * n + col;
        if (kSums) {
          *reinterpret_cast<int2*>(static_cast<int*>(out) + at) = make_int2(s0, s1);
        } else {
          // the JAX package's order: (sum * row scale) * the expert's channel scale
          const float rs = row_scale[row];
          const float* cs = w_scale + (long long)g * n + col;
          store_bf16x2(static_cast<__nv_bfloat16*>(out) + at,
                       (static_cast<float>(s0) * rs) * cs[0],
                       (static_cast<float>(s1) * rs) * cs[1]);
        }
      }
}

template <int BM, bool kSums>
int launch_int8(const void* x, const void* w, const void* offsets, const void* row_scale,
                const void* w_scale, void* out, int rows, int k, int n, int groups,
                cudaStream_t st) {
  constexpr int smem = 2 * (BM * kBK8 + kBK8 * kBN);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(grouped_matmul_int8_kernel<BM, kSums>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  grouped_matmul_int8_kernel<BM, kSums><<<grid_of(rows, n, groups, BM), kThreads, smem, st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int*>(offsets), static_cast<const float*>(row_scale),
      static_cast<const float*>(w_scale), out, rows, k, n, groups);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSums>
int launch_int8_rows(const void* x, const void* w, const void* offsets, const void* row_scale,
                     const void* w_scale, void* out, int rows, int k, int n, int groups,
                     int tile_rows, cudaStream_t st) {
  if (tile_rows == 16)
    return launch_int8<16, kSums>(x, w, offsets, row_scale, w_scale, out, rows, k, n, groups, st);
  return launch_int8<64, kSums>(x, w, offsets, row_scale, w_scale, out, rows, k, n, groups, st);
}

}  // namespace
}  // namespace gmm

// x [rows, k] int8, w [groups, k, n] int8, offsets as above; without scales
// (both null) out [rows, n] int32 sums; with them out [rows, n] bf16
// (float(sum) * row_scale[r]) * w_scale[g, n], row_scale [rows] and w_scale
// [groups, n] float32. k and n multiples of 16; tile_rows 16 or 64.
extern "C" int grouped_matmul_int8(const void* x, const void* w, const void* offsets,
                                   const void* row_scale, const void* w_scale, void* out,
                                   int rows, int k, int n, int groups, int tile_rows,
                                   void* stream) {
  if (gmm::bad_shape(rows, k, n, groups, tile_rows, 16, 16) ||
      (row_scale == nullptr) != (w_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (row_scale == nullptr)
    return gmm::launch_int8_rows<true>(x, w, offsets, row_scale, w_scale, out, rows, k, n,
                                       groups, tile_rows, st);
  return gmm::launch_int8_rows<false>(x, w, offsets, row_scale, w_scale, out, rows, k, n,
                                      groups, tile_rows, st);
}
