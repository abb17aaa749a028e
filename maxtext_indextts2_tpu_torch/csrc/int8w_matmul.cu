// The int8-weight product of int8w_serve decoding for Hopper (sm_90a):
//   y[m, n] = T( sum_k x[m, k] * T(T(q[k, n]) * T(s[n])) )  (+ T(bias[n]), rounded again)
// x [M, K] in T (bfloat16 or float32), q [K, N] int8 row-major, s [N] float32,
// products and sums in float32, y [M, N] in T.
//
// Replaces no Pallas kernel: it is the counterpart of the product XLA fuses in
// the JAX package's `DenseGeneral._serve_quantized`
// (maxtext_indextts2_tpu/models/layers.py:168-174), where the dequantisation
// `kernel.astype(bf16) * scale.astype(bf16)` is folded into the dot's read of
// the int8 kernel. Without it each decode step would write a bf16 copy of
// every weight and read it back (about 9 bytes moved a weight against the
// int8 kernel's 1), and int8w_serve would decode slower than bf16 serving.
//
// What bounds it on this card: bytes at decode shapes -- the int8 kernel is
// read once (K * N bytes) and x and y are small (M <= the slots, or the
// speculative verify span). What the design does about it: it keeps enough
// weight bytes in flight on every SM, dequantises each weight once, and ends
// in one launch.
//
// bfloat16 (the tensor-core kernel): a block covers 128 columns and 16, 32 or
// 64 rows of y (4 warps, 32 columns each; more rows take more blocks, which
// share each weight tile in the L2). Its K range streams through a ring of
// kTcStages stages of 128 K rows: the raw int8 weight tile [128][128] (16 KB)
// and x's rows, both by 16-byte `cp.async` (zero fill past K and N), so three
// stages are in flight while one is multiplied. The weight tile stays int8 in
// shared memory (its 16-byte chunks swizzled so that a warp's fragment loads
// hit 32 distinct banks); each lane dequantises the bytes of its own `mma.sync`
// m16n8k16 B fragments straight from it, with the JAX package's rounding
// points: bf16(q * bf16(s)), one float32 product (exact: 8 by 8 significant
// bits) rounded once. The code's float comes from its bits (2^23 + (q + 128)
// as a float's bit pattern, less 2^23 + 128): no int-to-float conversion,
// whose quarter rate would bound the kernel. A lane's four 4-byte loads of a
// 16-K step give it 4 columns x 4 rows: its fragment j covers the warp's
// columns 4 (lane / 4) + j, a permutation of the columns that the epilogue
// undoes. Where the column tiles alone would leave SMs idle (a decode layer of
// 2048 columns has 16 tiles of 128), the K axis is split over a thread-block
// cluster of `splits` blocks (grid z, cluster dims (1, 1, splits), up to 8):
// each block writes its float32 partial tile to its shared memory, and after
// cluster.sync() each block sums its share of the tile over the cluster's
// blocks in rank order through distributed shared memory, rounds, adds the
// bias and stores it; a last cluster.sync() keeps the partials alive until
// every peer has read them. No partial tensor in device memory, no second
// launch, no atomics: two launches give the same bits.
//
// float32 x (no bf16 tensor-core operand) takes a CUDA-core kernel: a warp a
// 128-column row slice, R x 4 accumulators a lane, the warps' sums added in
// warp order in shared memory, then the same cluster merge (its sums equal,
// bit for bit, a sum of split partials in split order).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "mma_bf16.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kCols = 128;      // columns of y a block: 4 a lane of a warp
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStage = 256;     // K rows a stage (x's rows staged in shared memory)
constexpr int kWarpRows = kStage / kWarps;  // K rows a warp takes of a stage
constexpr int kUnroll = 4;      // weight rows a lane loads before it multiplies
constexpr int kMaxSplits = 8;   // the portable cluster size

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }

// v rounded to T and read back as float32
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// y's element from its float32 sum: rounded to T, then the bias added and
// rounded again (the JAX package adds the bias to the rounded product)
template <typename T>
__device__ __forceinline__ T epilogue(float acc, const T* __restrict__ bias, int col) {
  if (bias == nullptr) return from_float<T>(acc);
  return from_float<T>(round_to<T>(acc) + to_float(bias[col]));
}

// four int8 weights of row `row` at columns col .. col + 3 (zeros past N or
// past the split's rows), as one 4-byte load where the row allows it
__device__ __forceinline__ unsigned load4(const int8_t* __restrict__ q, long long row, int col,
                                          int n, bool in_rows, bool vec) {
  if (!in_rows) return 0u;
  const int8_t* p = q + row * n + col;
  if (vec && col + 4 <= n) return __ldg(reinterpret_cast<const unsigned*>(p));
  unsigned v = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (col + j < n) v |= static_cast<unsigned>(static_cast<uint8_t>(__ldg(p + j))) << (8 * j);
  return v;
}

// y's rows [m0, m0 + ROWS) x columns [n0, n0 + 128) from this block's float32
// tile [ROWS][128] in shared memory (this split's sums), by THREADS threads.
// One split: the tile is final. A cluster of splits: each block sums its share
// of the tile over the cluster's blocks in rank order (distributed shared
// memory), then rounds, adds the bias and stores.
template <typename T, int ROWS, int THREADS>
__device__ __forceinline__ void merge_store(float* tile, int m0, int n0, int m, int n,
                                            const T* __restrict__ bias, T* __restrict__ out) {
  constexpr int kElems = ROWS * kCols;
  if (gridDim.z == 1) {
    __syncthreads();  // the tile is whole
    for (int i = threadIdx.x; i < kElems; i += THREADS) {
      const int row = m0 + i / kCols, col = n0 + i % kCols;
      if (row < m && col < n) out[(long long)row * n + col] = epilogue<T>(tile[i], bias, col);
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cluster.sync();  // every block's tile is whole
  // 4 neighbouring elements a thread, the splits' loads issued together
  constexpr int kQuads = kElems / 4;
  const int per = (kQuads + splits - 1) / splits;
  const int lo = rank * per, hi = min(kQuads, lo + per);
  const float4* peer[kMaxSplits];
#pragma unroll
  for (int q = 0; q < kMaxSplits; ++q)
    peer[q] = reinterpret_cast<const float4*>(cluster.map_shared_rank(tile, q < splits ? q : 0));
  for (int i = lo + static_cast<int>(threadIdx.x); i < hi; i += THREADS) {
    float4 part[kMaxSplits];
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      if (q < splits) part[q] = peer[q][i];
    float acc[4] = {part[0].x, part[0].y, part[0].z, part[0].w};
#pragma unroll
    for (int q = 1; q < kMaxSplits; ++q)
      if (q < splits) {
        acc[0] += part[q].x;
        acc[1] += part[q].y;
        acc[2] += part[q].z;
        acc[3] += part[q].w;
      }
    const int row = m0 + (4 * i) / kCols, col = n0 + (4 * i) % kCols;
    if (row >= m) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < n) out[(long long)row * n + col + e] = epilogue<T>(acc[e], bias, col + e);
  }
  cluster.sync();  // no block leaves (and frees its tile) while a peer reads it
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
int8w_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ scale, const T* __restrict__ bias,
                    T* __restrict__ out, int m, int k, int n, int k_per_split) {
  __shared__ __align__(16) float xs[R][kStage];
  __shared__ __align__(16) float red[R][kCols];

  const int row_tiles = (m + R - 1) / R;
  const int m0 = (blockIdx.x % row_tiles) * R;  // neighbouring blocks share weight columns
  const int n0 = (blockIdx.x / row_tiles) * kCols;
  const int split = blockIdx.z;
  const int k_begin = split * k_per_split;
  const int k_end = min(k, k_begin + k_per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = n0 + lane * 4;
  const bool vec = (n % 4 == 0) && ((reinterpret_cast<uintptr_t>(q) & 3u) == 0);

  float s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = col + j < n ? round_to<T>(scale[col + j]) : 0.f;
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kStage) {
    __syncthreads();  // the previous stage's x is read
    for (int i = threadIdx.x; i < R * kStage; i += kThreads) {
      const int r = i / kStage, kk = i % kStage;
      const int row = m0 + r, kr = k0 + kk;
      xs[r][kk] = (row < m && kr < k_end) ? to_float(x[(long long)row * k + kr]) : 0.f;
    }
    __syncthreads();
    const int kw = warp * kWarpRows;
#pragma unroll 1
    for (int kk = 0; kk < kWarpRows; kk += kUnroll) {
      const long long kr = k0 + kw + kk;
      unsigned raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) raw[u] = load4(q, kr + u, col, n, kr + u < k_end, vec);
      float w[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float code = static_cast<float>(static_cast<int8_t>(raw[u] >> (8 * j)));
          w[u][j] = round_to<T>(round_to<T>(code) * s[j]);
        }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs[r][kw + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[r][j] = fmaf(xv.x, w[0][j], acc[r][j]);
          acc[r][j] = fmaf(xv.y, w[1][j], acc[r][j]);
          acc[r][j] = fmaf(xv.z, w[2][j], acc[r][j]);
          acc[r][j] = fmaf(xv.w, w[3][j], acc[r][j]);
        }
      }
    }
  }

  // the warps' sums, added in warp order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          red[r][lane * 4 + j] = w == 0 ? acc[r][j] : red[r][lane * 4 + j] + acc[r][j];
    }
    __syncthreads();
  }
  merge_store<T, R, kThreads>(&red[0][0], m0, n0, m, n, bias, out);
}

// ---- bfloat16: the tensor-core kernel

constexpr int kTcWarps = 4;                 // 32 columns of y each
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcDepth = 128;               // K rows a stage
constexpr int kTcStages = 4;                // stages in the ring
constexpr int kQBytes = kTcDepth * kCols;   // the int8 weight tile of a stage, 16 KB

template <int RT>
struct TcShape {
  static constexpr int kRows = 16 * RT;                 // rows of y a block
  static constexpr int kXBytes = kRows * kTcDepth * 2;  // x's rows of a stage
  static constexpr int kStageBytes = kQBytes + kXBytes;
  static constexpr int kSmem = kTcStages * kStageBytes;  // 80 / 96 / 128 KB
};

// byte offset of 16-byte chunk c of row r of the int8 weight tile [128][128]:
// chunk c ^ 2 ((r / 2) % 4), so that the four rows a warp's fragment load
// touches (2 (lane % 4) + e) land on four different chunk pairs
__device__ __forceinline__ unsigned q_swz(int r, int c) {
  return static_cast<unsigned>(r * kCols + ((c ^ (((r >> 1) & 3) << 1)) << 4));
}

// stage kt's copies: x's rows [m0, m0 + 16 RT) x K [k0, k0 + 128) as a
// swizzled [16 RT][128] bf16 tile, the weights' K rows [k0, k0 + 128) x
// columns [n0, n0 + 128) as the swizzled int8 tile; zeros past m, k_end, N.
// kVec: 16-byte cp.async (k % 8 == 0, n % 16 == 0, aligned operands); else
// plain element loads stored to shared memory (odd shapes only)
template <int RT, bool kVec>
__device__ __forceinline__ void tc_load_stage(unsigned xs, unsigned qs, unsigned char* qs_ptr,
                                              unsigned char* xs_ptr,
                                              const __nv_bfloat16* __restrict__ x,
                                              const int8_t* __restrict__ q, int m0, int n0,
                                              int k0, int k_end, int m, int k, int n) {
  constexpr int kXChunks = TcShape<RT>::kRows * (kTcDepth / 8);
  constexpr int kQChunks = kTcDepth * (kCols / 16);
  if (kVec) {
#pragma unroll
    for (int it = 0; it < kXChunks / kTcThreads; ++it) {
      const int i = threadIdx.x + it * kTcThreads;
      const int r = i / (kTcDepth / 8), c = i % (kTcDepth / 8);
      const int row = m0 + r, kc = k0 + 8 * c;
      const bool ok = row < m && kc < k_end;
      hopper::cp_async16(xs + hopper::swz<kTcDepth>(r, c),
                         x + (ok ? (long long)row * k + kc : 0), ok);
    }
#pragma unroll
    for (int it = 0; it < kQChunks / kTcThreads; ++it) {
      const int i = threadIdx.x + it * kTcThreads;
      const int r = i / (kCols / 16), c = i % (kCols / 16);
      const int krow = k0 + r, col = n0 + 16 * c;
      const bool ok = krow < k_end && col < n;
      hopper::cp_async16(qs + q_swz(r, c), q + (ok ? (long long)krow * n + col : 0), ok);
    }
    return;
  }
  // element loads, one 16-byte chunk at a time (few registers: odd shapes only)
#pragma unroll 1
  for (int i = threadIdx.x; i < kXChunks; i += kTcThreads) {
    const int r = i / (kTcDepth / 8), c = i % (kTcDepth / 8);
    const int row = m0 + r, kc = k0 + 8 * c;
    unsigned w4[4];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const unsigned v = row < m && kc + e < k_end
                             ? static_cast<unsigned>(__bfloat16_as_ushort(
                                   x[(long long)row * k + kc + e]))
                             : 0u;
      w4[e / 2] = e % 2 ? w4[e / 2] | (v << 16) : v;
    }
    *reinterpret_cast<uint4*>(xs_ptr + hopper::swz<kTcDepth>(r, c)) =
        make_uint4(w4[0], w4[1], w4[2], w4[3]);
  }
#pragma unroll 1
  for (int i = threadIdx.x; i < kQChunks; i += kTcThreads) {
    const int r = i / (kCols / 16), c = i % (kCols / 16);
    const int krow = k0 + r, col = n0 + 16 * c;
    unsigned b[4];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const unsigned v = krow < k_end && col + j < n
                             ? static_cast<unsigned>(static_cast<uint8_t>(
                                   q[(long long)krow * n + col + j]))
                             : 0u;
      b[j / 4] = j % 4 ? b[j / 4] | (v << (8 * (j % 4))) : v;
    }
    *reinterpret_cast<uint4*>(qs_ptr + q_swz(r, c)) = make_uint4(b[0], b[1], b[2], b[3]);
  }
}

// T(T(q) * T(s)) for byte j of a word of int8 codes already XORed with 0x80808080
__device__ __forceinline__ float dequant(unsigned biased, int j, float s) {
  return (__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + j)) - 8388736.0f) * s;
}

template <int RT, bool kVec>  // m16 row tiles a block: 16 RT rows of x
__global__ void __launch_bounds__(kTcThreads)
int8w_matmul_tc_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                       const float* __restrict__ scale, const __nv_bfloat16* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, int m, int k, int n, int k_per_split) {
  using S = TcShape<RT>;
  extern __shared__ __align__(128) unsigned char smem[];

  const int row_tiles = (m + S::kRows - 1) / S::kRows;
  const int m0 = (blockIdx.x % row_tiles) * S::kRows;  // neighbouring blocks share weight columns
  const int n0 = (blockIdx.x / row_tiles) * kCols;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(k, k_begin + k_per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tq = lane % 4;
  const unsigned base = hopper::smem_addr(smem);

  float acc[RT][4][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rt][j][e] = 0.f;

  const int ktiles = (k_end - k_begin + kTcDepth - 1) / kTcDepth;
  auto load = [&](int kt) {
    const int slot = kt % kTcStages;
    unsigned char* st = smem + slot * S::kStageBytes;
    tc_load_stage<RT, kVec>(base + slot * S::kStageBytes + kQBytes, base + slot * S::kStageBytes,
                            st, st + kQBytes, x, q, m0, n0, k_begin + kt * kTcDepth, k_end, m, k,
                            n);
  };
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < ktiles) load(s);
    hopper::cp_async_commit();
  }
  // T(s) of this lane's columns 32 warp + 4 gid + j, read while the first
  // stages are in flight
  float sc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + 32 * warp + 4 * gid + j;
    sc[j] = col < n ? round_to<__nv_bfloat16>(scale[col]) : 0.f;
  }
  // the lane's word of the warp's 32 columns in a 16-byte chunk: columns 4 gid .. 4 gid + 3
  const int chunk = 2 * warp + gid / 4, word = 4 * (gid % 4);
  for (int kt = 0; kt < ktiles; ++kt) {
    hopper::cp_async_wait<kTcStages - 2>();
    __syncthreads();  // stage kt has landed; every warp is done with stage kt - 1
    if (kt + kTcStages - 1 < ktiles) load(kt + kTcStages - 1);
    hopper::cp_async_commit();
    const unsigned char* qp = smem + (kt % kTcStages) * S::kStageBytes;
    const unsigned xs = base + (kt % kTcStages) * S::kStageBytes + kQBytes;
#pragma unroll
    for (int kk = 0; kk < kTcDepth / 16; ++kk) {
      // rows 16 kk + 2 tq + {0, 1, 8, 9}: the k values of this lane's B fragments
      unsigned raw[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * kk + 2 * tq + (e & 1) + 8 * (e >> 1);
        raw[e] = *reinterpret_cast<const unsigned*>(qp + q_swz(r, chunk) + word) ^
                 0x80808080u;  // each byte q + 128
      }
      unsigned b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j][0] = hopper::pack_bf16(dequant(raw[0], j, sc[j]), dequant(raw[1], j, sc[j]));
        b[j][1] = hopper::pack_bf16(dequant(raw[2], j, sc[j]), dequant(raw[3], j, sc[j]));
      }
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        unsigned a[4];
        hopper::ldsm_x4(xs + hopper::swz<kTcDepth>(16 * rt + (lane & 15), 2 * kk + (lane >> 4)),
                        a);
#pragma unroll
        for (int j = 0; j < 4; ++j) hopper::mma_bf16(acc[rt][j], a, b[j][0], b[j][1]);
      }
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it holds the partial tile next

  // element e of fragment j: row 16 rt + lane / 4 + 8 (e / 2), the fragment's
  // column 2 tq + e % 2, which is the warp's column 4 (2 tq + e % 2) + j
  float* tile = reinterpret_cast<float*>(smem);  // [16 RT][128]
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * rt + gid + 8 * (e / 2);
        const int c = 32 * warp + 4 * (2 * tq + e % 2) + j;
        tile[r * kCols + c] = acc[rt][j][e];
      }
  merge_store<__nv_bfloat16, S::kRows, kTcThreads>(tile, m0, n0, m, n, bias, out);
}

// the launch: grid (row tiles x column tiles, 1, splits), clusters of
// `splits` blocks along z when splits > 1
template <typename Kernel, typename... Args>
int launch_split(Kernel kernel, long long tiles, int threads, int smem, int splits,
                 cudaStream_t st, Args... args) {
  if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles), 1, static_cast<unsigned>(splits));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = static_cast<unsigned>(splits);
  cfg.attrs = &attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // no split: a plain launch, no cluster barriers
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_f32(const void* x, const void* q, const void* scale, const void* bias, void* out,
               int m, int k, int n, int splits, int k_per_split, cudaStream_t st) {
  const long long tiles = static_cast<long long>((m + R - 1) / R) * ((n + kCols - 1) / kCols);
  return launch_split(int8w_matmul_kernel<float, R>, tiles, kThreads, 0, splits, st,
                      static_cast<const float*>(x), static_cast<const int8_t*>(q),
                      static_cast<const float*>(scale), static_cast<const float*>(bias),
                      static_cast<float*>(out), m, k, n, k_per_split);
}

template <int RT, bool kVec>
int launch_tc(const void* x, const void* q, const void* scale, const void* bias, void* out,
              int m, int k, int n, int splits, int k_per_split, cudaStream_t st) {
  using S = TcShape<RT>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(int8w_matmul_tc_kernel<RT, kVec>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long tiles =
      static_cast<long long>((m + S::kRows - 1) / S::kRows) * ((n + kCols - 1) / kCols);
  return launch_split(int8w_matmul_tc_kernel<RT, kVec>, tiles, kTcThreads, S::kSmem, splits, st,
                      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
                      static_cast<const float*>(scale), static_cast<const __nv_bfloat16*>(bias),
                      static_cast<__nv_bfloat16*>(out), m, k, n, k_per_split);
}

template <int RT>
int launch_tc_rows(const void* x, const void* q, const void* scale, const void* bias, void* out,
                   int m, int k, int n, int splits, int k_per_split, cudaStream_t st) {
  const bool vec = k % 8 == 0 && n % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15u) == 0 &&
                   (reinterpret_cast<uintptr_t>(q) & 15u) == 0;
  if (vec) return launch_tc<RT, true>(x, q, scale, bias, out, m, k, n, splits, k_per_split, st);
  return launch_tc<RT, false>(x, q, scale, bias, out, m, k, n, splits, k_per_split, st);
}

}  // namespace

// is_bf16: 1 for bfloat16 x / bias / y, 0 for float32. The K axis is split
// over a cluster of `splits` blocks (1..8), each k_per_split rows of K (a
// multiple of 256, every split non-empty: (splits - 1) * k_per_split < K <=
// splits * k_per_split). bias may be null. bfloat16 takes the tensor-core
// kernel (16 rows a block for M <= 16, 32 for M <= 32, else 64), float32 the
// CUDA-core one (8 rows a block for M <= 8, else 16).
extern "C" int int8w_matmul(const void* x, const void* q, const void* scale, const void* bias,
                            void* out, int m, int k, int n, int splits, int k_per_split,
                            int is_bf16, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || splits <= 0 || splits > kMaxSplits || k_per_split <= 0 ||
      k_per_split % kStage != 0 || static_cast<long long>(splits) * k_per_split < k ||
      static_cast<long long>(splits - 1) * k_per_split >= k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    if (m <= 8) return launch_f32<8>(x, q, scale, bias, out, m, k, n, splits, k_per_split, st);
    return launch_f32<16>(x, q, scale, bias, out, m, k, n, splits, k_per_split, st);
  }
  if (m <= 16) return launch_tc_rows<1>(x, q, scale, bias, out, m, k, n, splits, k_per_split, st);
  if (m <= 32) return launch_tc_rows<2>(x, q, scale, bias, out, m, k, n, splits, k_per_split, st);
  return launch_tc_rows<4>(x, q, scale, bias, out, m, k, n, splits, k_per_split, st);
}
