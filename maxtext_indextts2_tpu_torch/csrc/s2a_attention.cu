// s2a_attention for Hopper (sm_90a): non-causal softmax(q k^T) v of the S2A
// denoiser's sampler, every key < S valid, the scale already folded into q.
//
//   q, k, v  [B, S, N, D] float32 or bfloat16, strides over B, S and N (the
//            last axis contiguous; bfloat16: 16-byte-aligned starts, strides
//            multiples of 8): q, k and v can be views of the projection's
//            [B, S, 3 * N * D] output, nothing is transposed
//   out      [B, S, N, D] contiguous, q's type
//
// Replaces the TPU kernel `s2a_attention` (maxtext_indextts2_tpu/ops/s2a_attention.py,
// both of its tilings, "heads" and "bn"). That kernel keeps the whole [S, S]
// matrix of one (batch, head) in VMEM per grid step, pads S to a multiple of
// 128 and masks the tail, and (in its "bn" tiling) works on [B, N, S, D]
// copies made with swapaxes. None of that is carried over: this kernel masks
// key >= S itself and reads the operands where they lie.
//
// What it computes, in this order (the TPU kernel's rounding points): logits
// in float32; the row max and the row sum of exp(s - max) in float32; the
// probabilities exp(s - max) / sum, a division, rounded to v's type; the PV
// product accumulated in float32 and rounded to q's type.
//
// What bounds it on this card: per (batch, head) it does 4 S^2 D flops
// against (3 + 1) S D elements moved, S / 2 flops per bfloat16 byte. At the
// batched shape S = 768 that is 384, over the ~295 where the tensor cores
// and not the memory are the limit: operations bound it. At the `synthesize`
// shape S = 405, B = 1 bytes bound it (~1 us) and the work is too small to fill
// the card: 7 query tiles of 64 rows x 16 heads are 112 blocks on 132 SMs, each
// walking every key twice, so the time is the latency of one block's chain of
// tiles, not a rate.
// What the design does about it: the bfloat16 kernel (`attention_mma_kernel`)
// runs both products on the tensor cores, as warp-level `mma.sync.m16n8k16` bf16
// products with float32 sums (mma_bf16.cuh); a bf16 product is exact, so the
// float32 sums keep every rounding point above. A block is 4 warps in one of two
// shapes, picked by the wrapper from the grid it would give:
// - 64 query rows, each warp 16 rows against every key: the shape for a grid
//   that fills the card (the batched [8, 768]);
// - 16 query rows, the 4 warps each taking a 16-key slice of every 64-key tile
//   and merging at the end: a quarter of the chain of steps per warp and 4x the
//   warps in flight, for a small S and B (at [1, 405, 16, 64] on an H100, 0.022
//   ms against 0.038 for 64-row blocks).
// The query tile and two stages of 64-key K (and V) tiles go to shared memory by
// `cp.async`, 16-byte chunks swizzled against bank conflicts; the Q fragments
// are loaded once and kept in registers. One loop walks the key tiles twice,
// the next tile always in flight:
// - pass 1: S = Q K^T into float32 C fragments, the thread's running max and
//   rescaled sum of exp(s - max) over its keys in float32, merged at the end over
//   the quad of threads that hold a row and then over the slices;
// - pass 2: the same products again (the same fragments in the same order give
//   the same s), p = exp(s - max) / sum as an IEEE division, rounded to bf16
//   straight into the A fragments of P V (the C layout of m16n8k16 is its A
//   layout), V the B operand by `ldmatrix.trans`, O summed in float32 fragments
//   (the slices' sums added in slice order) and rounded once.
// What keeps it from the bound is not measured (`ncu` does not run there); at
// D = 64 the float32 softmax between the products (two expf and an IEEE
// division an element) is more work on the CUDA cores than the products are on
// the tensor cores.
// bf16 rows are copied 16 bytes at a time: the wrapper checks 16-byte-aligned
// starts and strides that are multiples of 8 elements and raises otherwise.
// The float32 kernel (`attention_kernel`) keeps the first design: one block of
// 256 threads per (64-query tile, head, batch row), the query tile in shared
// memory as float32, keys and values streamed through shared memory in tiles of
// 64 rows, the same two passes with float32 products on the CUDA cores (no
// TF32), each thread 4 queries x 4 keys of logits and 4 queries x D/16 columns
// of the output, the running max and sum merged across the 16 threads of a row
// by warp shuffles. Any S >= 1 works; rows and keys past S are zero-filled and
// never written or counted. Not built with --use_fast_math: the division and
// expf are IEEE-accurate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"

namespace s2a {

constexpr int kTile = 64;      // queries per block and keys per shared-memory tile
constexpr int kLanes = 16;     // threads across a tile's columns
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = kTile / kLanes;  // queries (and keys) per thread: 4

template <typename T> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};

struct Strides {
  long long b, s, n;  // in elements; the last axis has stride 1
};

// rows [r0, r0 + kTile) of one (batch, head) slice into shared memory as
// float32, rows at or past S as zeros; `pitch` floats per shared row
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const T* base, long long s_stride,
                                          int r0, int S) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D, row = r0 + r;
    dst[r * pitch + c] = row < S ? Elem<T>::to_f(base[(long long)row * s_stride + c]) : 0.f;
  }
}

// the float32 logits of the thread's 4 x 4 (query, key) pairs of one tile
template <int D>
__device__ __forceinline__ void logits(const float* Qs, const float* Ks, int ty, int tx,
                                       float (&acc)[kRows][kRows]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[kRows], b[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) a[i] = Qs[(ty + kLanes * i) * DP + d];
#pragma unroll
    for (int j = 0; j < kRows; ++j) b[j] = Ks[(tx + kLanes * j) * DP + d];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <typename T, int D>
constexpr int shared_bytes() {
  // Qs, Ks [kTile][D + 1], Vs [kTile][D], Ps [kTile][kTile + 1], all float32
  return (2 * kTile * (D + 1) + kTile * D + kTile * (kTile + 1)) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int S, int N, Strides qs, Strides ks, Strides vs) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1, PP = kTile + 1, DC = D / kLanes;
  float* Qs = smem;
  float* Ks = Qs + kTile * DP;
  float* Vs = Ks + kTile * DP;
  float* Ps = Vs + kTile * D;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const T* qb = q + b * qs.b + h * qs.n;
  const T* kb = k + b * ks.b + h * ks.n;
  const T* vb = v + b * vs.b + h * vs.n;
  const int tiles = (S + kTile - 1) / kTile;

  load_tile<T, D>(Qs, DP, qb, qs.s, q0, S);

  // pass 1: row max and sum of exp(s - max), thread-local over the keys
  // tx + 16 j of every tile, then merged across the row's 16 threads
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) m[i] = -INFINITY, l[i] = 0.f;
  float acc[kRows][kRows];
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the tile before is read (and, the first time, Qs written)
    load_tile<T, D>(Ks, DP, kb, ks.s, k0, S);
    __syncthreads();
    logits<D>(Qs, Ks, ty, tx, acc);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (k0 + tx + kLanes * j >= S) continue;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float s = acc[i][j];
        if (s > m[i]) {
          l[i] = l[i] * expf(m[i] - s) + 1.f;
          m[i] = s;
        } else {
          l[i] += expf(s - m[i]);
        }
      }
    }
  }
  // the 16 threads of a row are 16 neighbouring lanes of one warp
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float mn = fmaxf(m[i], mo);
      l[i] = mn == -INFINITY ? 0.f : l[i] * expf(m[i] - mn) + lo * expf(mo - mn);
      m[i] = mn;
    }
  }

  // pass 2: probabilities rounded to v's type, P V accumulated in float32
  float o[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) o[i][c] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // Ks, Vs and Ps of the tile before are read
    load_tile<T, D>(Ks, DP, kb, ks.s, k0, S);
    load_tile<T, D>(Vs, D, vb, vs.s, k0, S);
    __syncthreads();
    logits<D>(Qs, Ks, ty, tx, acc);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const bool valid = k0 + tx + kLanes * j < S;
        Ps[(ty + kLanes * i) * PP + tx + kLanes * j] =
            valid ? Elem<T>::round(expf(acc[i][j] - m[i]) / l[i]) : 0.f;
      }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float p[kRows], w[DC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = Ps[(ty + kLanes * i) * PP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) w[c] = Vs[kk * D + tx + kLanes * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) o[i][c] = fmaf(p[i], w[c], o[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kLanes * i;
    if (row >= S) continue;
    T* dst = out + (((long long)b * S + row) * N + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) dst[tx + kLanes * c] = Elem<T>::from_f(o[i][c]);
  }
}

// ------------------------------------------------ bfloat16, on the tensor cores
using hopper::bf16;
constexpr int kMmaKeys = 64;      // keys of a tile (a pipeline stage)
constexpr int kMmaThreads = 128;  // 4 warps

template <int D, int QW>
constexpr int mma_bytes() {  // Qs [16 QW][D], Ks[2], Vs[2] [kMmaKeys][D], bf16
  return (16 * QW + 4 * kMmaKeys) * D * 2;
}

// grid (N, B, query tiles of 16 QW rows), 4 warps (QW = 4 or 1): warp w owns
// query rows 16 (w % QW) + lane / 4 (+ 8) and, of every 64-key tile, slice w / QW
// of the KS = 4 / QW slices of KT = 64 / KS keys. Iterations [0, tiles) are pass
// 1 (K only), [tiles, 2 tiles) pass 2 (K and V); the tile of the next iteration
// loads during this one (two stages: more would cost blocks an SM at small S,
// and lose more than they gain). With KS > 1 the slices' max and sum are merged
// after pass 1 (every slice then holds the row's), and their P V sums after pass
// 2, in slice order.
template <int D, int QW>
__global__ void __launch_bounds__(kMmaThreads)
attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, int S, int N,
                     Strides qs, Strides ks, Strides vs) {
  using namespace hopper;
  constexpr int KS = 4 / QW, KT = kMmaKeys / KS, QROWS = 16 * QW, TILE = kMmaKeys * D * 2;
  extern __shared__ __align__(16) unsigned char smem_u8[];
  __shared__ float stat_s[KS][2][QROWS];  // the slices' row max and sum
  const unsigned Qs = smem_addr(smem_u8), Ks = Qs + QROWS * D * 2, Vs = Ks + 2 * TILE;

  const int h = blockIdx.x, b = blockIdx.y, q0 = blockIdx.z * QROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane % 4;
  const int wq = warp % QW, slice = warp / QW, r0 = wq * 16 + lane / 4;
  const bf16* kb = k + b * ks.b + h * ks.n;
  const bf16* vb = v + b * vs.b + h * vs.n;
  const int tiles = (S + kMmaKeys - 1) / kMmaKeys;
  const unsigned koff = slice * KT * D * 2;  // the slice's first key row in a tile

  auto load = [&](int it, int st) {
    const int k0 = (it < tiles ? it : it - tiles) * kMmaKeys;
    load_tile_async<D, kMmaKeys, kMmaThreads>(Ks + st * TILE, kb, ks.s, k0, S);
    if (it >= tiles)
      load_tile_async<D, kMmaKeys, kMmaThreads>(Vs + st * TILE, vb, vs.s, k0, S);
  };
  load_tile_async<D, QROWS, kMmaThreads>(Qs, q + b * qs.b + h * qs.n, qs.s, q0, S);
  load(0, 0);
  cp_async_commit();

  unsigned qf[D / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // (m, l) <- the merge of (m, l) and (mo, lo): max and rescaled sum
  auto merge = [](float& m, float& l, float mo, float lo) {
    const float mn = fmaxf(m, mo);  // -inf only where neither has a key yet
    l = mn == -INFINITY ? 0.f : l * expf(m - mn) + lo * expf(mo - mn);
    m = mn;
  };
  for (int it = 0, st = 0; it < 2 * tiles; ++it, st ^= 1) {
    if (it + 1 < 2 * tiles) load(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q and this iteration's tile have landed
    __syncthreads();
    if (it == 0) load_a<D>(qf, Qs, wq * 16, lane);
    const int t = it < tiles ? it : it - tiles;
    const int k_rows = min(kMmaKeys, S - t * kMmaKeys) - slice * KT;  // the slice's keys < S
    // s[j][e]: (row r0 + 8 (e / 2), key 8 j + 2 t4 + e % 2 of the slice)
    float s[KT / 8][4];
    product_abt<D, KT / 8>(s, qf, Ks + st * TILE + koff, lane);
    if (it < tiles) {
      // pass 1: the thread's max and sum of exp(s - max) over its keys < S
      float mc[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * t4 + (e & 1) < k_rows) mc[e >> 1] = fmaxf(mc[e >> 1], s[j][e]);
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * t4 + (e & 1) < k_rows)
            ls[e >> 1] += expf(s[j][e] - fmaxf(m[e >> 1], mc[e >> 1]));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mn = fmaxf(m[i], mc[i]);  // -inf only where the thread has no key yet
        l[i] = mn == -INFINITY ? 0.f : l[i] * expf(m[i] - mn) + ls[i];
        m[i] = mn;
      }
      if (it == tiles - 1) {
#pragma unroll
        for (int off = 1; off < 4; off *= 2)  // the row's four threads
#pragma unroll
          for (int i = 0; i < 2; ++i)
            merge(m[i], l[i], __shfl_xor_sync(0xffffffffu, m[i], off),
                  __shfl_xor_sync(0xffffffffu, l[i], off));
        if constexpr (KS > 1) {  // the slices, in order: every slice gets the same
          if (t4 == 0)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              stat_s[slice][0][r0 + 8 * i] = m[i];
              stat_s[slice][1][r0 + 8 * i] = l[i];
            }
          __syncthreads();
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            m[i] = -INFINITY;
            l[i] = 0.f;
#pragma unroll
            for (int g = 0; g < KS; ++g)
              merge(m[i], l[i], stat_s[g][0][r0 + 8 * i], stat_s[g][1][r0 + 8 * i]);
          }
        }
      }
    } else {
      // pass 2: p = exp(s - max) / sum, rounded to bf16 into the A fragments of P V
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = 8 * j + 2 * t4 + (e & 1) < k_rows
                        ? expf(s[j][e] - m[e >> 1]) / l[e >> 1] : 0.f;
      unsigned pa[KT / 16][4];
      c_to_a<KT / 16>(s, pa);
      product_am<D, KT / 16>(acc, pa, Vs + st * TILE + koff, lane);
    }
    __syncthreads();  // every read of this stage is done before it is loaded again
  }
  cp_async_wait<0>();

  if constexpr (KS > 1) {
    // the slices' P V sums, added in slice order by slice 0 (the K and V stages
    // are free now: every copy has landed and every read is done)
    float* part = reinterpret_cast<float*>(smem_u8 + QROWS * D * 2);
    static_assert((KS - 1) * QROWS * D * 4 <= 4 * TILE, "the partial sums fit the stages");
    auto at = [&](int g, int n, int e) {
      return ((((g - 1) * QW + wq) * (D / 8) + n) * 4 + e) * 32 + lane;
    };
    if (slice > 0)
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[at(slice, n, e)] = acc[n][e];
    __syncthreads();
    if (slice > 0) return;
#pragma unroll
    for (int g = 1; g < KS; ++g)
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += part[at(g, n, e)];
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= S) continue;
    bf16* dst = out + (((long long)b * S + row) * N + h) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

template <int D, int QW>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B, int S, int N,
               Strides qs, Strides ks, Strides vs, cudaStream_t stream) {
  constexpr int bytes = mma_bytes<D, QW>();
  const int q_tiles = (S + 16 * QW - 1) / (16 * QW);
  if (q_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = attention_mma_kernel<D, QW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(N, B, q_tiles), kMmaThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), S, N, qs, ks, vs);
  return static_cast<int>(cudaGetLastError());
}

// rows: query rows of a block, 64 (4 query warps, every key) or 16 (4 key slices)
template <int D>
int launch_mma_rows(const void* q, const void* k, const void* v, void* out, int B, int S, int N,
                    int rows, Strides qs, Strides ks, Strides vs, cudaStream_t stream) {
  switch (rows) {
    case 16: return launch_mma<D, 1>(q, k, v, out, B, S, N, qs, ks, vs, stream);
    case 64: return launch_mma<D, 4>(q, k, v, out, B, S, N, qs, ks, vs, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int N,
           Strides qs, Strides ks, Strides vs, cudaStream_t stream) {
  constexpr int bytes = shared_bytes<T, D>();
  auto kernel = attention_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kTile - 1) / kTile, N, B);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                            static_cast<const T*>(v), static_cast<T*>(out), S, N,
                                            qs, ks, vs);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* out, int B, int S, int N,
                  int D, int rows, Strides qs, Strides ks, Strides vs, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_mma_rows<32>(q, k, v, out, B, S, N, rows, qs, ks, vs, stream);
    case 64: return launch_mma_rows<64>(q, k, v, out, B, S, N, rows, qs, ks, vs, stream);
    case 128: return launch_mma_rows<128>(q, k, v, out, B, S, N, rows, qs, ks, vs, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int B, int S, int N, int D,
               Strides qs, Strides ks, Strides vs, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, B, S, N, qs, ks, vs, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, N, qs, ks, vs, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, N, qs, ks, vs, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace s2a

// dtype: 0 float32, 1 bfloat16. Strides in elements (batch, sequence, head).
// rows: query rows of a block of the bfloat16 kernel (16 or 64; float32 takes 64).
extern "C" int s2a_attention(const void* q, const void* k, const void* v, void* out, int B, int S,
                             int N, int D, long long qsb, long long qss, long long qsn,
                             long long ksb, long long kss, long long ksn, long long vsb,
                             long long vss, long long vsn, int dtype, int rows, void* stream) {
  if (B < 1 || S < 1 || N < 1 || N > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const s2a::Strides qs{qsb, qss, qsn}, ks{ksb, kss, ksn}, vs{vsb, vss, vsn};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return s2a::dispatch_d<float>(q, k, v, out, B, S, N, D, qs, ks, vs, st);
  if (dtype == 1) return s2a::dispatch_bf16(q, k, v, out, B, S, N, D, rows, qs, ks, vs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
