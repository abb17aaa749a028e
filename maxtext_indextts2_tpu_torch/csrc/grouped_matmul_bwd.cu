// The backward of the grouped product y[r] = x[r] @ w[g(r)] (grouped_matmul.cu)
// for Hopper (sm_90a), bf16 operands, float32 sums, bf16 results:
//   grouped_matmul_dgrad: dx[r, :] = dy[r, :] @ w[g(r)]^T        dx [R, K]
//   grouped_matmul_wgrad: dw[g]    = x[rows of g]^T @ dy[rows of g]  dw [G, K, N]
// x [R, K] with rows sorted by group, dy [R, N], w [G, K, N], offsets [G + 1]
// int32 on the device (group g holds rows [offsets[g], offsets[g + 1])).
//
// Replaces no Pallas kernel: these are the two products of the transpose of
// `jax.lax.ragged_dot(x, w, group_sizes, preferred_element_type=float32)`
// that XLA derives for the JAX package's MoE training step
// (maxtext_indextts2_tpu/models/moe.py:268-281, RoutedMoE._sparse_experts
// under jax.value_and_grad). Its jaxpr rounds both results to bf16 after
// float32 sums of exact products, which is what these kernels do. Without
// them the port would loop over the experts with a product each (the group
// sizes read back to the host) or train through the dense einsum route (E / k
// times the products).
//
// What bounds them on this card: at the training shapes (tens of thousands of
// rows over up to 128 experts) dgrad is the forward's problem with the weight
// read transposed: operations, 2 R K N on the tensor cores, or the weights'
// bytes when the groups hold few rows. wgrad writes all of dw (G K N bf16,
// every expert, empty ones as zeros) and reads x and dy: bytes, unless the
// groups are large.
//
// What the designs do about it. dgrad has the forward's structure: the grid
// at its bound, ceil(R / BM) + G row tiles by ceil(K / 128) column tiles, each
// block's (group, row tile) found from `offsets` by a warp scan (spare blocks
// exit), dy's rows and w[g]'s rows (the columns of dx) streamed through a
// 3-stage `cp.async` ring. w is read where it lies: a stage holds 128 rows of
// w[g] (128 columns of dx) by 64 of N, and since N is contiguous in a row of
// w that tile is already the column-major B operand of `mma.sync`: plain
// `ldmatrix` reads it, and no transposed copy of the experts is made.
// wgrad: a block owns (group, 64 rows of K, 128 columns of N) and walks its
// group's rows 64 at a time through the same kind of ring; the A operand is
// x^T, read from x's [rows][K] tile by `ldmatrix.trans`, the B operand dy's
// [rows][N] tile as in the forward. The blocks of one group run together
// (blockIdx.y is the group), so its rows are read from the L2 after the first
// block. An empty group writes zeros. Every sum runs in a fixed order: two
// launches give the same bits. Nothing is read back to the host. `wgmma`, TMA
// and splitting a large group's rows over blocks are later work (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace gmm_bwd {

constexpr int kThreads = 128;  // 4 warps, 32 columns each
constexpr int kBN = 128;       // columns of the result a block
constexpr int kBK = 64;        // the reduction a stage
constexpr int kStages = 3;
constexpr unsigned kFull = 0xffffffffu;

// as grouped_matmul.cu's find_tile: the (group, row tile) of row-tile block
// `t`, or group -1 for a spare block
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

// ---- dgrad

// stage `kt`: dy's rows [row0, row_end) x N [n0, n0 + 64) as a swizzled
// [BM][64] tile, and w[g]'s rows [c0, c0 + 128) x the same N as 4 warp tiles
// [32][64] (row j of warp tile i: column c0 + 32 i + j of dx)
template <int BM>
__device__ __forceinline__ void dgrad_stage(unsigned as, unsigned bs,
                                            const __nv_bfloat16* __restrict__ dy,
                                            const __nv_bfloat16* __restrict__ wg, int row0,
                                            int row_end, int c0, int n0, int k, int n) {
  constexpr int kAChunks = BM * (kBK / 8);
#pragma unroll
  for (int it = 0; it < (kAChunks + kThreads - 1) / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (kAChunks % kThreads != 0 && i >= kAChunks) break;
    const int r = i / (kBK / 8), c = i % (kBK / 8);
    const int row = row0 + r, nc = n0 + 8 * c;
    const bool ok = row < row_end && nc < n;
    hopper::cp_async16(as + hopper::swz<kBK>(r, c), dy + (ok ? (long long)row * n + nc : 0), ok);
  }
  constexpr int kBChunks = kBN * (kBK / 8);
#pragma unroll
  for (int it = 0; it < kBChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / (kBK / 8), c = i % (kBK / 8);
    const int col = c0 + r, nc = n0 + 8 * c;
    const bool ok = col < k && nc < n;
    const unsigned dst = bs + (r / 32) * (32 * kBK * 2) + hopper::swz<kBK>(r % 32, c);
    hopper::cp_async16(dst, wg + (ok ? (long long)col * n + nc : 0), ok);
  }
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
dgrad_kernel(const __nv_bfloat16* __restrict__ dy, const __nv_bfloat16* __restrict__ w,
             const int* __restrict__ offsets, __nv_bfloat16* __restrict__ dx, int rows, int k,
             int n, int groups) {
  constexpr int RT = BM / 16;
  constexpr int kABytes = BM * kBK * 2, kBBytes = kBN * kBK * 2;
  constexpr int kStageBytes = kABytes + kBBytes;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_group, s_tile;

  find_tile<BM>(offsets, groups, blockIdx.x, &s_group, &s_tile);
  const int g = s_group;
  if (g < 0) return;
  const int row0 = offsets[g] + s_tile * BM;
  const int row_end = min(offsets[g + 1], rows);
  const int c0 = blockIdx.y * kBN;
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

  const int ntiles = (n + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles)
      dgrad_stage<BM>(base + s * kStageBytes, base + s * kStageBytes + kABytes, dy, wg, row0,
                      row_end, c0, s * kBK, k, n);
    hopper::cp_async_commit();
  }
  for (int nt = 0; nt < ntiles; ++nt) {
    hopper::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage nt has landed; every warp is done with stage nt - 1
    const int next = nt + kStages - 1;
    if (next < ntiles) {
      const int slot = next % kStages;
      dgrad_stage<BM>(base + slot * kStageBytes, base + slot * kStageBytes + kABytes, dy, wg,
                      row0, row_end, c0, next * kBK, k, n);
    }
    hopper::cp_async_commit();
    const unsigned as = base + (nt % kStages) * kStageBytes;
    const unsigned bt = as + kABytes + warp * (32 * kBK * 2);
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      unsigned a[kBK / 16][4];
      hopper::load_a<kBK>(a, as, 16 * rt, lane);
      // acc[rt] += A [16 x 64] B^T, B the warp's [32][64] tile of w's rows
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned b[4];
          hopper::ldsm_x4(bt + hopper::swz<kBK>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                                2 * kk + ((lane >> 3) & 1)),
                          b);
          hopper::mma_bf16(acc[rt][2 * np], a[kk], b[0], b[1]);
          hopper::mma_bf16(acc[rt][2 * np + 1], a[kk], b[2], b[3]);
        }
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
        const int col = c0 + 32 * warp + 8 * j + 2 * (lane % 4);
        if (row < row_end && col < k)  // k is even: col + 1 < k too
          store_bf16x2(dx + (long long)row * k + col, acc[rt][j][2 * h], acc[rt][j][2 * h + 1]);
      }
}

// ---- wgrad

constexpr int kWM = 64;  // rows of K (of dw) a block
constexpr int kWR = 64;  // the group's rows a stage

// stage: x's rows [r0, r_end) x K [k0, k0 + 64) as a swizzled [64][64] tile
// (read transposed by ldmatrix.trans: the A operand x^T), dy's rows x N [n0,
// n0 + 128) as 4 warp tiles [64][32]
__device__ __forceinline__ void wgrad_stage(unsigned as, unsigned bs,
                                            const __nv_bfloat16* __restrict__ x,
                                            const __nv_bfloat16* __restrict__ dy, int r0,
                                            int r_end, int k0, int n0, int k, int n) {
  constexpr int kAChunks = kWR * (kWM / 8);
#pragma unroll
  for (int it = 0; it < kAChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / (kWM / 8), c = i % (kWM / 8);
    const int row = r0 + r, kc = k0 + 8 * c;
    const bool ok = row < r_end && kc < k;
    hopper::cp_async16(as + hopper::swz<kWM>(r, c), x + (ok ? (long long)row * k + kc : 0), ok);
  }
  constexpr int kBChunks = kWR * (kBN / 8);
#pragma unroll
  for (int it = 0; it < kBChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / (kBN / 8), cc = i % (kBN / 8);
    const int row = r0 + r, col = n0 + 8 * cc;
    const bool ok = row < r_end && col < n;
    const unsigned dst = bs + (cc / 4) * (kWR * 32 * 2) + hopper::swz<32>(r, cc % 4);
    hopper::cp_async16(dst, dy + (ok ? (long long)row * n + col : 0), ok);
  }
}

__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
             const int* __restrict__ offsets, __nv_bfloat16* __restrict__ dw, int rows, int k,
             int n, int groups) {
  constexpr int RT = kWM / 16;
  constexpr int kABytes = kWR * kWM * 2, kBBytes = kWR * kBN * 2;
  constexpr int kStageBytes = kABytes + kBBytes;
  extern __shared__ __align__(128) unsigned char smem[];

  const int g = blockIdx.y;
  const int ntile_n = (n + kBN - 1) / kBN;
  const int k0 = (blockIdx.x / ntile_n) * kWM, n0 = (blockIdx.x % ntile_n) * kBN;
  const int r_begin = min(max(offsets[g], 0), rows);
  const int r_end = min(max(offsets[g + 1], r_begin), rows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned base = hopper::smem_addr(smem);

  float acc[RT][4][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rt][j][e] = 0.f;

  const int rtiles = (r_end - r_begin + kWR - 1) / kWR;  // 0 for an empty group
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < rtiles)
      wgrad_stage(base + s * kStageBytes, base + s * kStageBytes + kABytes, x, dy,
                  r_begin + s * kWR, r_end, k0, n0, k, n);
    hopper::cp_async_commit();
  }
  for (int t = 0; t < rtiles; ++t) {
    hopper::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t has landed; every warp is done with stage t - 1
    const int next = t + kStages - 1;
    if (next < rtiles) {
      const int slot = next % kStages;
      wgrad_stage(base + slot * kStageBytes, base + slot * kStageBytes + kABytes, x, dy,
                  r_begin + next * kWR, r_end, k0, n0, k, n);
    }
    hopper::cp_async_commit();
    const unsigned as = base + (t % kStages) * kStageBytes;
    const unsigned bt = as + kABytes + warp * (kWR * 32 * 2);
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      // A = x^T rows [16 rt, 16 rt + 16) of the tile's K, by the stage's rows:
      // matrix i of the x4 load covers K + 8 (i % 2) and rows + 8 (i / 2)
      unsigned a[kWR / 16][4];
#pragma unroll
      for (int kk = 0; kk < kWR / 16; ++kk)
        hopper::ldsm_x4_t(as + hopper::swz<kWM>(16 * kk + ((lane >> 4) << 3) + (lane & 7),
                                                2 * rt + ((lane >> 3) & 1)),
                          a[kk]);
      hopper::product_am<32, kWR / 16>(acc[rt], a, bt, lane);
    }
  }
  hopper::cp_async_wait<0>();

#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kr = k0 + 16 * rt + lane / 4 + 8 * h;
        const int col = n0 + 32 * warp + 8 * j + 2 * (lane % 4);
        if (kr < k && col < n)  // n is even: col + 1 < n too
          store_bf16x2(dw + ((long long)g * k + kr) * n + col, acc[rt][j][2 * h],
                       acc[rt][j][2 * h + 1]);
      }
}

template <typename Kernel>
int configure(Kernel kernel, int smem, bool& configured) {
  if (configured) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  configured = true;
  return 0;
}

template <int BM>
int launch_dgrad(const void* dy, const void* w, const void* offsets, void* dx, int rows, int k,
                 int n, int groups, cudaStream_t st) {
  constexpr int smem = kStages * (BM * kBK * 2 + kBN * kBK * 2);
  static bool configured = false;
  if (int err = configure(dgrad_kernel<BM>, smem, configured)) return err;
  const dim3 grid(static_cast<unsigned>((rows + BM - 1) / BM + groups),
                  static_cast<unsigned>((k + kBN - 1) / kBN), 1);
  dgrad_kernel<BM><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(w),
      static_cast<const int*>(offsets), static_cast<__nv_bfloat16*>(dx), rows, k, n, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gmm_bwd

// dy [rows, n] bf16 (rows sorted by group), w [groups, k, n] bf16, offsets
// [groups + 1] int32, dx [rows, k] bf16; k and n multiples of 8, every
// pointer 16-byte aligned. 64 rows of dx a block: a training step's groups
// hold hundreds of rows each, and a short group's tile is bounded by its rows.
extern "C" int grouped_matmul_dgrad(const void* dy, const void* w, const void* offsets,
                                    void* dx, int rows, int k, int n, int groups,
                                    void* stream) {
  if (rows <= 0 || k <= 0 || n <= 0 || groups <= 0 || k % 8 || n % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  return gmm_bwd::launch_dgrad<64>(dy, w, offsets, dx, rows, k, n, groups,
                                   static_cast<cudaStream_t>(stream));
}

// x [rows, k] bf16 (rows sorted by group), dy [rows, n] bf16, offsets
// [groups + 1] int32, dw [groups, k, n] bf16 (every group written, an empty
// one as zeros); k and n multiples of 8, every pointer 16-byte aligned.
extern "C" int grouped_matmul_wgrad(const void* x, const void* dy, const void* offsets,
                                    void* dw, int rows, int k, int n, int groups,
                                    void* stream) {
  using namespace gmm_bwd;
  if (rows < 0 || k <= 0 || n <= 0 || groups <= 0 || k % 8 || n % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int smem = kStages * (kWR * kWM * 2 + kWR * kBN * 2);
  static bool configured = false;
  if (int err = configure(wgrad_kernel, smem, configured)) return err;
  const dim3 grid(static_cast<unsigned>(((k + kWM - 1) / kWM) * ((n + kBN - 1) / kBN)),
                  static_cast<unsigned>(groups), 1);
  wgrad_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
      static_cast<const int*>(offsets), static_cast<__nv_bfloat16*>(dw), rows, k, n, groups);
  return static_cast<int>(cudaGetLastError());
}
