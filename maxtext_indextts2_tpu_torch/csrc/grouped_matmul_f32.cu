// The grouped product and its backward on float32 operands, on the CUDA
// cores (float32 FMA, float32 sums, a float32 result):
//   mode 0, forward: y[r]  = x[r] @ w[g(r)]                   y  [R, N]
//   mode 1, dgrad:   dx[r] = dy[r] @ w[g(r)]^T                dx [R, K]
//   mode 2, wgrad:   dw[g] = x[rows of g]^T @ dy[rows of g]   dw [G, K, N]
// with rows sorted by group and offsets [G + 1] int32 read on the device, as
// grouped_matmul.cu and grouped_matmul_bwd.cu take them.
//
// Replaces no Pallas kernel: `jax.lax.ragged_dot(x, w, group_sizes,
// preferred_element_type=float32)` on float32 operands and the two products
// of its transpose, which XLA computes for the JAX package's MoE layer
// (maxtext_indextts2_tpu/models/moe.py:268-281) when its experts run in
// float32: exact float32 products summed in float32, no TF32 (the port keeps
// TF32 off, infer/engine.set_cuda_numerics). Without it a float32 MoE on the
// card had to take the dense einsum route (every expert on every token).
//
// What bounds it on this card: 2 R K N float32 FMA operations on the CUDA
// cores (67 TFLOP/s on an H100 SXM). What the design does about it: float32
// MoE steps are parity checks and small models, not the training recipe
// (bf16), so this is the simple kernel: a 64 x 64 tile of the result a
// block of 256 threads, 4 x 4 a thread, the reduction 16 at a time through
// shared memory. The forward and dgrad walk
// row tiles of 64 found from `offsets` by a warp scan (grouped_matmul.cu's
// find_tile; spare blocks exit); wgrad's blocks are (group, tile of K x N)
// and walk the group's rows. Each output's sum runs in one fixed order: two
// launches give the same bits. An empty group's dw is zeros.
#include <cuda_runtime.h>

namespace gmm_f32 {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // a block's tile of the result: 64 x 64
constexpr int kRed = 16;   // the reduction a shared-memory step
constexpr unsigned kFull = 0xffffffffu;

// the (group, 64-row tile) of row-tile block `t`, or group -1 for a spare block
__device__ __forceinline__ void find_tile(const int* __restrict__ offsets, int groups, int t,
                                          int* s_group, int* s_tile) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int carry = 0, group = -1, tile = 0;
    for (int base = 0; base < groups; base += 32) {
      const int g = base + lane;
      int cnt = 0;
      if (g < groups) cnt = (max(0, offsets[g + 1] - offsets[g]) + kTile - 1) / kTile;
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

// out[m, c] = sum over red in [0, red_n) of A(m, red) B(red, c), m < m_n, c < c_n:
// A(m, red) = a[m * a_m + red * a_r], B(red, c) = b[red * b_r + c * b_c],
// out[m, c] at out[m * o_m + c]
__device__ __forceinline__ void tile_product(const float* __restrict__ a, long long a_m,
                                             long long a_r, const float* __restrict__ b,
                                             long long b_r, long long b_c, float* __restrict__ out,
                                             long long o_m, int m_n, int c_n, int red_n) {
  __shared__ float as[kRed][kTile + 1], bs[kRed][kTile + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  // each loads 4 of A's and 4 of B's 16 x 64 elements, the contiguous
  // dimension of each operand across neighbouring threads
  const bool a_red_fast = a_r == 1, b_red_fast = b_r == 1;
  for (int r0 = 0; r0 < red_n; r0 += kRed) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int ar = a_red_fast ? e % kRed : e / kTile, am = a_red_fast ? e / kRed : e % kTile;
      const int br = b_red_fast ? e % kRed : e / kTile, bc = b_red_fast ? e / kRed : e % kTile;
      as[ar][am] = (am < m_n && r0 + ar < red_n) ? a[am * a_m + (r0 + ar) * a_r] : 0.f;
      bs[br][bc] = (bc < c_n && r0 + br < red_n) ? b[(r0 + br) * b_r + bc * b_c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kRed; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = as[kk][ty + 16 * i];
        bv[i] = bs[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = ty + 16 * i, c = tx + 16 * j;
      if (m < m_n && c < c_n) out[m * o_m + c] = acc[i][j];
    }
}

// mode 0 / 1: blockIdx.x a row tile (group, 64 rows), blockIdx.y 64 columns
__global__ void __launch_bounds__(kThreads)
rows_kernel(const float* __restrict__ a, const float* __restrict__ w,
            const int* __restrict__ offsets, float* __restrict__ out, int rows, int k, int n,
            int groups, int mode) {
  __shared__ int s_group, s_tile;
  find_tile(offsets, groups, blockIdx.x, &s_group, &s_tile);
  const int g = s_group;
  if (g < 0) return;
  const int row0 = offsets[g] + s_tile * kTile;
  const int m_n = min(kTile, min(offsets[g + 1], rows) - row0);
  const int c0 = blockIdx.y * kTile;
  const float* wg = w + static_cast<long long>(g) * k * n;
  if (mode == 0) {  // x [R, K] @ w[g] [K, N]
    if (c0 >= n) return;
    tile_product(a + static_cast<long long>(row0) * k, k, 1, wg + c0, n, 1,
                 out + static_cast<long long>(row0) * n + c0, n, m_n, min(kTile, n - c0), k);
  } else {  // dy [R, N] @ w[g]^T: B(red, c) = w[g][c, red]
    if (c0 >= k) return;
    tile_product(a + static_cast<long long>(row0) * n, n, 1, wg + static_cast<long long>(c0) * n,
                 1, n, out + static_cast<long long>(row0) * k + c0, k, m_n, min(kTile, k - c0),
                 n);
  }
}

// mode 2: blockIdx.x a 64 x 64 tile of dw[g] [K, N], blockIdx.y the group
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
             const int* __restrict__ offsets, float* __restrict__ dw, int rows, int k, int n) {
  const int g = blockIdx.y;
  const int ntile_n = (n + kTile - 1) / kTile;
  const int k0 = (blockIdx.x / ntile_n) * kTile, n0 = (blockIdx.x % ntile_n) * kTile;
  const int r_begin = min(max(offsets[g], 0), rows);
  const int r_end = min(max(offsets[g + 1], r_begin), rows);
  // A(m, red) = x[r_begin + red, k0 + m], B(red, c) = dy[r_begin + red, n0 + c]
  tile_product(x + static_cast<long long>(r_begin) * k + k0, 1, k,
               dy + static_cast<long long>(r_begin) * n + n0, n, 1,
               dw + (static_cast<long long>(g) * k + k0) * n + n0, n, min(kTile, k - k0),
               min(kTile, n - n0), r_end - r_begin);
}

}  // namespace gmm_f32

// mode 0: a = x [rows, k], b = w [groups, k, n], out = y [rows, n]
// mode 1: a = dy [rows, n], b = w [groups, k, n], out = dx [rows, k]
// mode 2: a = x [rows, k], b = dy [rows, n], out = dw [groups, k, n]
// float32 throughout, offsets [groups + 1] int32, every tensor contiguous.
extern "C" int grouped_matmul_f32(const void* a, const void* b, const void* offsets, void* out,
                                  int rows, int k, int n, int groups, int mode, void* stream) {
  using namespace gmm_f32;
  if (rows < 0 || k <= 0 || n <= 0 || groups <= 0 || mode < 0 || mode > 2 ||
      (rows == 0 && mode != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  const int* offs = static_cast<const int*>(offsets);
  float* fo = static_cast<float*>(out);
  if (mode == 2) {
    const dim3 grid(static_cast<unsigned>(((k + kTile - 1) / kTile) * ((n + kTile - 1) / kTile)),
                    static_cast<unsigned>(groups), 1);
    wgrad_kernel<<<grid, kThreads, 0, st>>>(fa, fb, offs, fo, rows, k, n);
  } else {
    const int cols = mode == 0 ? n : k;
    const dim3 grid(static_cast<unsigned>((rows + kTile - 1) / kTile + groups),
                    static_cast<unsigned>((cols + kTile - 1) / kTile), 1);
    rows_kernel<<<grid, kThreads, 0, st>>>(fa, fb, offs, fo, rows, k, n, groups, mode);
  }
  return static_cast<int>(cudaGetLastError());
}
