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
// rows are few), operations at prefill shapes (R up to 2048 x k rows: 2 R K N
// products on the tensor cores). What the design does about it: the grid is
// launched at its upper bound, ceil(R / BM) + G row tiles by ceil(N / 128)
// column tiles, and each block finds its (group, row tile) from `offsets` with
// a warp scan (spare blocks exit), so nothing is read back to the host and a
// captured decode step holds the launch. A block computes BM x 128 of y: 4
// warps, 32 columns each, on `mma.sync` (bf16 m16n8k16 fragments from
// mma_bf16.cuh; int8 m16n8k32 with int32 sums). bf16: x's and w's tiles stream
// through a 3-stage ring of `cp.async` copies in shared memory (rows past the
// group and columns past N zero-filled by the copy), so the weight bytes of
// the next stages are in flight while the tensor cores work. int8: the
// m16n8k32 B fragment wants each column's k bytes together, so the weights
// are transposed 4 x 4 bytes at a time in registers (`__byte_perm`) on their
// way to shared memory, and the next stage's weights are loaded into registers
// while this one is multiplied. BM is 16 (decode: most groups hold a row or
// two) or 64 (prefill). Every sum runs in a fixed order: two launches give the
// same bits. `wgmma`, TMA and a persistent scheduler are later work (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace gmm {

constexpr int kBN = 128;                 // columns of y a block
constexpr int kWarps = 4;                // 32 columns each
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 64;                  // bf16: K a stage (128 bytes a row)
constexpr int kStages = 3;
constexpr int kBK8 = 128;                // int8: K a stage (128 bytes a row)
constexpr unsigned kFull = 0xffffffffu;

// The (group, row tile within it) of row-tile block `t`, or group -1 for a
// spare block: an exclusive scan of ceil(rows / BM) over the groups by warp 0,
// 32 groups a step. Every thread reads the answer.
template <int BM>
__device__ __forceinline__ void find_tile(const int* __restrict__ offsets, int groups, int t,
                                          int* s_group, int* s_tile) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int carry = 0, group = -1, tile = 0;
    for (int base = 0; base < groups; base += 32) {
      const int g = base + lane;
      int cnt = 0;
      if (g < groups) cnt = (max(0, offsets[g + 1] - offsets[g]) + BM - 1) / BM;
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      const int excl = incl - cnt;
      const unsigned hit = __ballot_sync(kFull, t >= carry + excl && t < carry + incl);
      if (hit) {
        const int src = __ffs(hit) - 1;
        group = base + src;
        tile = t - carry - __shfl_sync(kFull, excl, src);
        break;
      }
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) {
      *s_group = group;
      *s_tile = tile;
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
namespace {

// stage `kt` of x's rows [row0, row_end) and of w[g]'s columns [n0, n0 + 128)
// into one ring slot: x as a swizzled [BM][64] tile, w as 4 warp tiles [64][32]
template <int BM>
__device__ __forceinline__ void load_stage_bf16(unsigned xs, unsigned ws,
                                                const __nv_bfloat16* __restrict__ x,
                                                const __nv_bfloat16* __restrict__ wg, int row0,
                                                int row_end, int n0, int k0, int k, int n) {
  constexpr int kXChunks = BM * (kBK / 8);
#pragma unroll
  for (int it = 0; it < (kXChunks + kThreads - 1) / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (kXChunks % kThreads != 0 && i >= kXChunks) break;
    const int r = i / (kBK / 8), c = i % (kBK / 8);
    const int row = row0 + r, kc = k0 + 8 * c;
    const bool ok = row < row_end && kc < k;
    hopper::cp_async16(xs + hopper::swz<kBK>(r, c),
                       x + (ok ? (long long)row * k + kc : 0), ok);
  }
  constexpr int kWChunks = kBK * (kBN / 8);
#pragma unroll
  for (int it = 0; it < kWChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int kr = i / (kBN / 8), cc = i % (kBN / 8);
    const int krow = k0 + kr, col = n0 + 8 * cc;
    const bool ok = krow < k && col < n;
    const unsigned dst = ws + (cc / 4) * (kBK * 32 * 2) + hopper::swz<32>(kr, cc % 4);
    hopper::cp_async16(dst, wg + (ok ? (long long)krow * n + col : 0), ok);
  }
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ w, const int* __restrict__ offsets,
                           __nv_bfloat16* __restrict__ out, int rows, int k, int n, int groups) {
  constexpr int RT = BM / 16;
  constexpr int kXBytes = BM * kBK * 2, kWBytes = kBK * kBN * 2;
  constexpr int kStageBytes = kXBytes + kWBytes;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_group, s_tile;

  find_tile<BM>(offsets, groups, blockIdx.x, &s_group, &s_tile);
  const int g = s_group;
  if (g < 0) return;
  const int row0 = offsets[g] + s_tile * BM;
  const int row_end = min(offsets[g + 1], rows);
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* wg = w + (long long)g * k * n;
  const unsigned base = hopper::smem_addr(smem);

  float acc[RT][4][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rt][j][e] = 0.f;

  const int ktiles = (k + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles)
      load_stage_bf16<BM>(base + s * kStageBytes, base + s * kStageBytes + kXBytes, x, wg, row0,
                          row_end, n0, s * kBK, k, n);
    hopper::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    hopper::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed; every warp is done with stage kt - 1
    const int next = kt + kStages - 1;
    if (next < ktiles) {
      const int slot = next % kStages;
      load_stage_bf16<BM>(base + slot * kStageBytes, base + slot * kStageBytes + kXBytes, x, wg,
                          row0, row_end, n0, next * kBK, k, n);
    }
    hopper::cp_async_commit();
    const unsigned xs = base + (kt % kStages) * kStageBytes;
    const unsigned wt = xs + kXBytes + warp * (kBK * 32 * 2);
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      unsigned a[kBK / 16][4];
      hopper::load_a<kBK>(a, xs, 16 * rt, lane);
      hopper::product_am<32, kBK / 16>(acc[rt], a, wt, lane);
    }
  }
  hopper::cp_async_wait<0>();

  // element e of fragment j: row lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 16 * rt + lane / 4 + 8 * h;
        const int col = n0 + 32 * warp + 8 * j + 2 * (lane % 4);
        if (row < row_end && col < n)  // n is even: col + 1 < n too
          store_bf16x2(out + (long long)row * n + col, acc[rt][j][2 * h], acc[rt][j][2 * h + 1]);
      }
}

template <int BM>
int launch_bf16(const void* x, const void* w, const void* offsets, void* out, int rows, int k,
                int n, int groups, cudaStream_t st) {
  constexpr int smem = kStages * (BM * kBK * 2 + kBK * kBN * 2);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(grouped_matmul_bf16_kernel<BM>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  grouped_matmul_bf16_kernel<BM><<<grid_of(rows, n, groups, BM), kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const int*>(offsets), static_cast<__nv_bfloat16*>(out), rows, k, n, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gmm

// x [rows, k] bf16 (rows sorted by group), w [groups, k, n] bf16, offsets
// [groups + 1] int32, out [rows, n] bf16; k and n multiples of 8, every
// pointer 16-byte aligned; tile_rows 16 or 64.
extern "C" int grouped_matmul_bf16(const void* x, const void* w, const void* offsets, void* out,
                                   int rows, int k, int n, int groups, int tile_rows,
                                   void* stream) {
  if (gmm::bad_shape(rows, k, n, groups, tile_rows, 8, 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_rows == 16) return gmm::launch_bf16<16>(x, w, offsets, out, rows, k, n, groups, st);
  return gmm::launch_bf16<64>(x, w, offsets, out, rows, k, n, groups, st);
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
