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
// float32: exact float32 products summed in float32, no TF32 in any form (the
// port keeps TF32 off, infer/engine.set_cuda_numerics). Without it a float32
// MoE on the card had to take the dense einsum route (every expert on every
// token).
//
// What bounds it on this card: 2 R K N float32 FMA operations on the CUDA
// cores (67 TFLOP/s on an H100 SXM); wgrad also writes every expert's dw
// (805 MB at qwen3-30b-a3b's shapes). What the design does about it: a
// register-tiled GEMM. A block computes a BM x 128 tile of the result, each
// thread 8 x 8 of it (8 consecutive rows, two runs of 4 columns 64 apart),
// from shared memory that holds both operands reduction-major ([BK of the
// reduction][BM or 128]), so that one 16-byte read gives a thread 4 of its
// rows or columns: 4 shared-memory reads serve 64 FMAs. The operands stream
// through a double-buffered `cp.async` ring, BK of the reduction a stage (16
// in the forward, 8 in dgrad and wgrad): 16-byte copies where the operand's
// rows run along M or N (w in the forward, x and dy in wgrad), 4-byte copies
// into the transposed place where they run along the reduction (x in the
// forward, dy and w in dgrad); zeros past every edge. The forward and dgrad
// walk row tiles of a group found from `offsets` by a warp scan (spare blocks
// exit), BM 64 or 128 rows as the host's plan picks from the rows a group
// holds on average (ops/grouped_matmul.py `f32_tile_rows`: qwen3's parity
// step holds 64 +- 8). A warp whose 16 rows lie past the group's end skips the
// products, and a group's last tile of 16 rows or fewer, which would hold a
// block for the whole reduction with one warp at work, maps every warp onto
// its rows, a quarter of the columns each. wgrad's blocks are (group, 128 x
// 128 tile of K x N) and walk the group's rows, its whole reduction, in one
// block. Each output's sum runs over the reduction in order, one FMA at a
// time: two launches give the same bits. An empty group's dw is zeros.
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace gmm_f32 {

constexpr int kBN = 128;  // columns of the result a block
// the reduction a stage: 16 in the forward, 8 in dgrad and wgrad (set from the
// device time of both on an H100)
constexpr int kFwdBK = 16, kBwdBK = 8;
constexpr int kPad = 4;   // floats past each shared row: 16-byte rows, banks spread
constexpr unsigned kFull = 0xffffffffu;

// the (group, BM-row tile) of row-tile block `t`, or group -1 for a spare block
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

// stage `red0` of an operand tile into s [BK][ROWS + kPad] (element (red, m)
// at s[red][m]), zeros past red_n and m_n. RED: the operand's element (red, m)
// lies at src[m * ld + red] (4-byte copies, consecutive threads along the
// reduction); else at src[red * ld + m] (16-byte copies of 4 m where `vec`,
// else 4-byte ones)
template <int BK, int ROWS, int THREADS, bool RED>
__device__ __forceinline__ void load_operand(float (*s)[ROWS + kPad], const float* __restrict__ src,
                                             long long ld, int red0, int red_n, int m_n,
                                             bool vec) {
  constexpr int kElems = BK * ROWS, kChunks = kElems / 4;
  static_assert(kChunks % THREADS == 0, "every thread copies as many elements");
  if (RED) {
#pragma unroll
    for (int it = 0; it < kElems / THREADS; ++it) {
      const int e = threadIdx.x + it * THREADS;
      const int red = e % BK, m = e / BK;
      const bool ok = red0 + red < red_n && m < m_n;
      hopper::cp_async4(hopper::smem_addr(&s[red][m]), src + (ok ? m * ld + red0 + red : 0), ok);
    }
  } else if (vec) {
#pragma unroll
    for (int it = 0; it < kChunks / THREADS; ++it) {
      const int e = threadIdx.x + it * THREADS;
      const int red = e / (ROWS / 4), m = 4 * (e % (ROWS / 4));
      const bool ok = red0 + red < red_n && m < m_n;  // m_n % 4 == 0 where vec
      hopper::cp_async16(hopper::smem_addr(&s[red][m]),
                         src + (ok ? (red0 + red) * ld + m : 0), ok);
    }
  } else {
#pragma unroll
    for (int it = 0; it < kElems / THREADS; ++it) {
      const int e = threadIdx.x + it * THREADS;
      const int red = e / ROWS, m = e % ROWS;
      const bool ok = red0 + red < red_n && m < m_n;
      hopper::cp_async4(hopper::smem_addr(&s[red][m]), src + (ok ? (red0 + red) * ld + m : 0), ok);
    }
  }
}

// out[m, c] = sum over red in [0, red_n) of A(m, red) B(red, c), m < m_n, c <
// c_n, by 2 BM threads. A tile of more than 16 rows: warp w takes rows [16 w,
// 16 w + 16), lane l of it rows 16 w + 8 (l / 16) .. + 7 and columns
// 4 (l % 16) .. + 3 and 64 + those, 8 x 8 sums; a warp whose rows lie past
// m_n skips the products. A short tile (m_n <= 16, a group's last few rows):
// every warp takes the 16 rows, warp w columns [32 w, 32 w + 32) (lane l rows
// 8 (l / 16) .. + 7, columns 32 w + 2 (l % 16) and the next), so that it costs
// a quarter of a full one. A(m, red) at a[m * lda + red] (A_RED) or a[red *
// lda + m], B(red, c) at b[c * ldb + red] (B_RED) or b[red * ldb + c], out[m,
// c] at out[m * ldo + c]. `vec`: lda, ldb, ldo and the tile's edges multiples
// of 4 floats, every base 16-byte aligned
template <int BM, int BK, bool A_RED, bool B_RED>
__device__ __forceinline__ void tile_product(const float* __restrict__ a, long long lda,
                                             const float* __restrict__ b, long long ldb,
                                             float* __restrict__ out, long long ldo, int m_n,
                                             int c_n, int red_n, bool vec) {
  constexpr int kThreads = 2 * BM;
  __shared__ __align__(16) float as[2][BK][BM + kPad];
  __shared__ __align__(16) float bs[2][BK][kBN + kPad];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool short_tile = m_n <= 16;
  const int r0 = short_tile ? 8 * (lane / 16) : 16 * warp + 8 * (lane / 16);
  const int tn = lane % 16, c2 = 32 * warp + 2 * tn;  // c2: a short tile's columns
  const bool active = short_tile ? 32 * warp < c_n : 16 * warp < m_n;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nst = (red_n + BK - 1) / BK;
  if (nst > 0) {
    load_operand<BK, BM, kThreads, A_RED>(as[0], a, lda, 0, red_n, m_n, vec);
    load_operand<BK, kBN, kThreads, B_RED>(bs[0], b, ldb, 0, red_n, c_n, vec);
  }
  hopper::cp_async_commit();
  for (int st = 0; st < nst; ++st) {
    if (st + 1 < nst) {
      const int nb = (st + 1) & 1;
      load_operand<BK, BM, kThreads, A_RED>(as[nb], a, lda, (st + 1) * BK, red_n, m_n, vec);
      load_operand<BK, kBN, kThreads, B_RED>(bs[nb], b, ldb, (st + 1) * BK, red_n, c_n, vec);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();  // stage st has landed
    const int cb = st & 1;
    if (active && !short_tile) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&as[cb][kk][r0]);
        const float4 a1 = *reinterpret_cast<const float4*>(&as[cb][kk][r0 + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[cb][kk][4 * tn]);
        const float4 b1 = *reinterpret_cast<const float4*>(&bs[cb][kk][64 + 4 * tn]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    } else if (active) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&as[cb][kk][r0]);
        const float4 a1 = *reinterpret_cast<const float4*>(&as[cb][kk][r0 + 4]);
        const float2 bb = *reinterpret_cast<const float2*>(&bs[cb][kk][c2]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][0] = fmaf(av[i], bb.x, acc[i][0]);
          acc[i][1] = fmaf(av[i], bb.y, acc[i][1]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before it is loaded again
  }
  hopper::cp_async_wait<0>();

  if (short_tile) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = r0 + i;
      if (m >= m_n || !active) break;
      float* row = out + m * ldo;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (c2 + j < c_n) row[c2 + j] = acc[i][j];
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = r0 + i;
    if (m >= m_n) break;
    float* row = out + m * ldo;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 64 * h + 4 * tn;
      if (vec) {
        if (c < c_n)
          *reinterpret_cast<float4*>(row + c) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < c_n) row[c + j] = acc[i][4 * h + j];
      }
    }
  }
}

// mode 0 / 1: blockIdx.x a row tile (group, BM rows), blockIdx.y 128 columns;
// no register cap (capped at 128 a thread, ptxas spills the 8 x 8 sums)
template <int BM, bool kDgrad>
__global__ void __launch_bounds__(2 * BM)
rows_kernel(const float* __restrict__ a, const float* __restrict__ w,
            const int* __restrict__ offsets, float* __restrict__ out, int rows, int k, int n,
            int groups, bool vec) {
  __shared__ int s_group, s_tile;
  find_tile<BM>(offsets, groups, blockIdx.x, &s_group, &s_tile);
  const int g = s_group;
  if (g < 0) return;
  const int row0 = offsets[g] + s_tile * BM;
  const int m_n = min(BM, min(offsets[g + 1], rows) - row0);
  const int c0 = blockIdx.y * kBN;
  const float* wg = w + static_cast<long long>(g) * k * n;
  if (!kDgrad) {  // x [R, K] @ w[g] [K, N]: A(m, red) = x[row0 + m, red],
                  // B(red, c) = w[g][red, c0 + c]
    if (c0 >= n) return;
    tile_product<BM, kFwdBK, true, false>(a + static_cast<long long>(row0) * k, k, wg + c0, n,
                                  out + static_cast<long long>(row0) * n + c0, n, m_n,
                                  min(kBN, n - c0), k, vec);
  } else {  // dy [R, N] @ w[g]^T: B(red, c) = w[g][c0 + c, red]
    if (c0 >= k) return;
    tile_product<BM, kBwdBK, true, true>(a + static_cast<long long>(row0) * n, n,
                                 wg + static_cast<long long>(c0) * n, n,
                                 out + static_cast<long long>(row0) * k + c0, k, m_n,
                                 min(kBN, k - c0), n, vec);
  }
}

// mode 2: blockIdx.x a 128 x 128 tile of dw[g] [K, N], blockIdx.y the group
__global__ void __launch_bounds__(256, 2)
wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
             const int* __restrict__ offsets, float* __restrict__ dw, int rows, int k, int n,
             bool vec) {
  const int g = blockIdx.y;
  const int ntile_n = (n + kBN - 1) / kBN;
  const int k0 = (blockIdx.x / ntile_n) * 128, n0 = (blockIdx.x % ntile_n) * kBN;
  const int r_begin = min(max(offsets[g], 0), rows);
  const int r_end = min(max(offsets[g + 1], r_begin), rows);
  // A(m, red) = x[r_begin + red, k0 + m], B(red, c) = dy[r_begin + red, n0 + c]
  tile_product<128, kBwdBK, false, false>(x + static_cast<long long>(r_begin) * k + k0, k,
                                  dy + static_cast<long long>(r_begin) * n + n0, n,
                                  dw + (static_cast<long long>(g) * k + k0) * n + n0, n,
                                  min(128, k - k0), min(kBN, n - n0), r_end - r_begin, vec);
}

}  // namespace gmm_f32

// mode 0: a = x [rows, k], b = w [groups, k, n], out = y [rows, n]
// mode 1: a = dy [rows, n], b = w [groups, k, n], out = dx [rows, k]
// mode 2: a = x [rows, k], b = dy [rows, n], out = dw [groups, k, n]
// float32 throughout, offsets [groups + 1] int32, every tensor contiguous and
// 16-byte aligned; tile_rows (modes 0 and 1): 64 or 128 rows of the result a
// block (ops/grouped_matmul.py `f32_tile_rows`).
extern "C" int grouped_matmul_f32(const void* a, const void* b, const void* offsets, void* out,
                                  int rows, int k, int n, int groups, int mode, int tile_rows,
                                  void* stream) {
  using namespace gmm_f32;
  if (rows < 0 || k <= 0 || n <= 0 || groups <= 0 || mode < 0 || mode > 2 ||
      (rows == 0 && mode != 2) || (mode != 2 && tile_rows != 64 && tile_rows != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  const int* offs = static_cast<const int*>(offsets);
  float* fo = static_cast<float*>(out);
  const bool vec = k % 4 == 0 && n % 4 == 0;
  if (mode == 2) {
    const dim3 grid(static_cast<unsigned>(((k + 127) / 128) * ((n + kBN - 1) / kBN)),
                    static_cast<unsigned>(groups), 1);
    wgrad_kernel<<<grid, 256, 0, st>>>(fa, fb, offs, fo, rows, k, n, vec);
    return static_cast<int>(cudaGetLastError());
  }
  const int cols = mode == 0 ? n : k;
  const dim3 grid(static_cast<unsigned>((rows + tile_rows - 1) / tile_rows + groups),
                  static_cast<unsigned>((cols + kBN - 1) / kBN), 1);
  if (tile_rows == 64) {
    if (mode == 0)
      rows_kernel<64, false><<<grid, 128, 0, st>>>(fa, fb, offs, fo, rows, k, n, groups, vec);
    else
      rows_kernel<64, true><<<grid, 128, 0, st>>>(fa, fb, offs, fo, rows, k, n, groups, vec);
  } else if (mode == 0) {
    rows_kernel<128, false><<<grid, 256, 0, st>>>(fa, fb, offs, fo, rows, k, n, groups, vec);
  } else {
    rows_kernel<128, true><<<grid, 256, 0, st>>>(fa, fb, offs, fo, rows, k, n, groups, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
