// Flash attention for Hopper (sm_90a): the training attention of the LM, its
// forward (K9) and its two backward kernels (K10: dq; K11: dk and dv).
//
//   q            [B, Sq, H, D]    float32 or bfloat16, any strides over B, S and H (bf16:
//                                 16-byte-aligned rows, strides multiples of 8)
//   k, v         [B, Skv, Hkv, D] (the last axis contiguous): the model's projection
//                                 outputs are read where they lie, nothing is transposed
//   q_pos, q_seg [B, Sq] int32, kv_pos, kv_seg [B, Skv] int32, contiguous
//   o, do, dq    like q; dk, dv like k; lse, delta [B, H, Sq] float32, contiguous
//
// Replaces the TPU kernels `_flash_fwd` (K9) and the two kernels of `_flash_bwd`
// (`_bwd_dq_kernel`, K10; `_bwd_dkv_kernel`, K11) of
// maxtext_indextts2_tpu/ops/flash_attention.py. They compute what those compute:
//
//   s    = (q k^T) * scale, then cap * tanh(s / cap) when cap > 0, then masked
//   mask = q_seg == kv_seg and q_seg != 0, and kv_pos <= q_pos (causal), and
//          kv_pos > q_pos - window (sliding), and q_pos // chunk == kv_pos // chunk
//   masked logits are -0.7 * FLT_MAX (not -inf), set after the soft cap
//   K9:  o = softmax(s) v, lse = logsumexp(s); a fully masked row gives o = 0 and
//        lse = -inf
//   K10: dq = (p * (do v^T - delta) * (1 - tanh^2) * scale) k,  p = exp(s - lse)
//   K11: dv = p^T do, dk = ds^T q, summed over the q heads of each GQA group
//
// with the TPU kernels' rounding points: logits, running max and sum and every
// accumulator in float32; in K9 the unnormalised probabilities exp(s - m) are
// rounded to v's type before the PV product, the output to q's type; in K10 ds
// is rounded to k's type before ds k; K11 keeps p and ds in float32 (q, do and
// v enter its products exactly; in bf16 p and ds enter as hi + lo, see below)
// and rounds dk, dv to k's and v's types once, at the end.
// The mask of a tile pair is decided from the tiles' min and max positions and
// segment ids (as `_block_class_inkernel` does), never from their index:
// positions need not increase (a context-parallel reorder permutes them). Empty
// pairs are skipped (half the work of a causal mask); full pairs skip the
// element mask. A fully masked row never evaluates exp(mask - lse): its p is 0.
//
// What the TPU design does and this one does not: the TPU walks one grid
// dimension in order and carries the online-softmax state and the dq / dk / dv
// sums in VMEM scratch from one grid step to the next, stores the running
// statistics (block_q, 128)-wide for its vector layout and uses blocks of up to
// 512 x 512. Here one block owns one output tile and walks the other axis in a
// loop: K9 and K10 a 64-query tile of one (batch, head), looping over 64-key
// tiles; K11 a 64-key tile of one (batch, kv head), looping over the group's q
// heads and every query tile, so that dk and dv are summed in registers and
// written once, without atomics: a step is deterministic.
//
// What bounds it on this card: at the training shape (S = 2048, D = 128, bf16)
// a causal K9 call does 2 * 2 * S^2 / 2 * D flops per (batch, head) against
// ~3 S D elements moved (q and o of the head, its share of k and v): ~700 flops
// a byte, far past the ~295 where the tensor cores and not the memory are the
// limit, so operations bound all three kernels (0.070 ms for K9 at 989 TFLOP/s
// over a batch of 4 x 16 heads).
// What the design does about it: the bfloat16 K9, K10 and K11 (`fwd_mma_kernel`,
// `dq_mma_kernel`, `dkv_mma_kernel`) run their products on the tensor cores, as
// warp-level `mma.sync.m16n8k16` bf16 products with float32 sums (mma_bf16.cuh), 4
// warps a block, 16 rows (K9 and K10: queries, K11: keys) a warp:
// - Tiles go to shared memory as bf16 by `cp.async` (16 bytes a copy, zero-filled
//   past S) in two stages: the next non-empty tile loads while this one computes.
//   Rows are cut in 16-byte chunks XOR-swizzled by the row's low 3 bits, so the
//   8 rows of one `ldmatrix` hit 8 different bank groups. Operands come by
//   `ldmatrix` (`.trans` for the B operand of P V, dS K, P^T dO and dS^T Q: nothing
//   is transposed in memory).
// - Every tile of the other axis is classified once, at the start of a block
//   (the 4 warps share them), into a byte array in shared memory; the loop
//   skips empty pairs and prefetches the next non-empty tile. A full pair skips
//   the element mask (one branch a tile pair, JAX's `masked` flag).
// - K9: the Q fragments are loaded once. S = Q K^T lands in float32 C fragments;
//   scale, cap and mask are applied in registers; the online softmax reduces a
//   row over the quad of threads that hold it; l sums the float32 p; only then
//   is p rounded to bf16, straight into the A fragments of P V (the C layout of
//   m16n8k16 is its A layout: no trip through shared memory). Query tiles start
//   in reverse (`blockIdx.z`), so the causal mask's heaviest tiles go first.
// - K10: S = Q K^T and dP = dO V^T land in float32 C fragments, a 64-key tile at
//   a time; p = exp(s_capped - lse) (0 where masked, from the row's lse and delta
//   held in registers) and ds = p (dp - delta) (1 - tanh^2) scale are float32;
//   ds is rounded to bf16 straight into the A fragments of dS K, where JAX rounds
//   it to k's type, with K the B operand by `ldmatrix.trans`; dQ is summed in
//   float32 fragments and rounded to q's type once. Because ds is rounded to bf16,
//   the low bits of s decide which way it rounds, and a flip of a large ds moves a
//   dq row by a step of that ds. A tensor-core chain aligns its addends to the
//   accumulator and truncates, and s sums to hundreds where the logits are
//   peaked, while an absolute error in s is a relative error in p: so S is summed
//   to nearest in float32 (each 16-product partial from zero on the tensor cores,
//   the partials added on the CUDA cores). Chained, the peaked-logits case read
//   0.048 against the 2**-5 check; to nearest, 0.022. dP (|dp| ~ 10) stays one
//   chain: summing it to nearest too gained nothing on the worst case and
//   spilled. Register budget: dQ of a warp's 16 rows x D is D / 2 floats a thread
//   (64 at D = 128); the Q fragments are read from shared memory 16 columns at a
//   time and the dO fragments once a step, instead of being held; at D = 128 a
//   key tile is walked in two steps of 32 keys, one after the other, so that S
//   and dP take 16 floats each. Query tiles start in reverse, as in K9.
// - K11: S^T = K Q^T and dP^T = V dO^T take bf16 operands (exact products); p and
//   ds are float32 in registers. dV += P^T dO and dK += dS^T Q must not round p
//   or ds to bf16, so each is split in two bf16 terms, hi = bf16(x) and
//   lo = bf16(x - hi) (x - hi is exact in float32), and both products go into the
//   same float32 sum: hi + lo is x to within 2^-17 |x|, no rounding point worth
//   the name and far inside the card's 2**-5 check. That is 6 products a tile
//   pair instead of 4. Register budget: dK and dV of a warp's 16 keys x D are D
//   floats a thread (128 at D = 128); 32-query steps keep S^T and dP^T at 32
//   more, and the K and V fragments are read from shared memory again every
//   step, so nothing spills (64-query steps would need 64 registers more).
//   Key tiles start at the first (the heaviest under a causal mask).
// - bf16 rows are copied 16 bytes at a time: the wrapper checks 16-byte-aligned
//   starts and strides that are multiples of 8 elements and raises otherwise.
// What keeps them from the bound is not measured (`ncu` does not run on that
// machine); the candidates are the float32 softmax between the products (expf,
// the mask, the hi/lo split) on the CUDA cores and `mma.sync`'s rate, below
// `wgmma`'s (a later step). The float32 instantiations keep the first design:
// float32 tiles in shared memory padded by one against bank conflicts, scalar
// fmaf products on the CUDA cores (float32 keeps float32 products: no TF32), each
// thread 4 x 4 logits (rows ty + 16 i, columns tx + 16 j) and 4 rows x D / 16
// columns of its accumulators. Any S >= 1 works; rows and keys past S are
// zero-filled, masked and never written. Not built with --use_fast_math:
// divisions, expf, logf and tanhf are IEEE-accurate.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace flash {

using namespace hopper;

constexpr float kMaskValue = -0.7f * 3.402823466e+38f;  // DEFAULT_MASK_VALUE
constexpr int kTile = 64;      // rows of every tile (queries and keys)
constexpr int kLanes = 16;     // threads across a tile's columns
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = kTile / kLanes;  // 4 rows (and columns) a thread

template <typename T> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};

struct Strides {
  long long b, s, n;  // in elements; the last axis has stride 1
};

struct Problem {
  int B, H, Hkv, Sq, Skv;
  const int *q_pos, *kv_pos, *q_seg, *kv_seg;
  int causal, window, chunk;
  float soft_cap, scale;
};

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ bool visible(const Problem& p, int qp, int kp, int qs, int ks) {
  bool m = (qs == ks) && (qs != 0);
  if (p.causal) m = m && (kp <= qp);
  if (p.window > 0) m = m && (kp > qp - p.window);
  if (p.chunk > 0) m = m && (floordiv(qp, p.chunk) == floordiv(kp, p.chunk));
  return m;
}

// min and max of positions and segment ids over the n valid rows of a tile
// (n >= 1), by one whole warp; lanes past n contribute nothing
struct TileStats {
  int pos_lo, pos_hi, seg_lo, seg_hi;
};

__device__ __forceinline__ TileStats tile_stats_warp(const int* pos, const int* seg, int n) {
  const int lane = threadIdx.x % 32;
  int plo = 0x7fffffff, phi = -0x7fffffff - 1, slo = 0x7fffffff, shi = -0x7fffffff - 1;
  for (int i = lane; i < n; i += 32) {
    plo = min(plo, pos[i]);
    phi = max(phi, pos[i]);
    slo = min(slo, seg[i]);
    shi = max(shi, seg[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    plo = min(plo, __shfl_xor_sync(0xffffffffu, plo, off));
    phi = max(phi, __shfl_xor_sync(0xffffffffu, phi, off));
    slo = min(slo, __shfl_xor_sync(0xffffffffu, slo, off));
    shi = max(shi, __shfl_xor_sync(0xffffffffu, shi, off));
  }
  return TileStats{plo, phi, slo, shi};
}

// 0: empty (skip), 1: full (every pair visible and in range), 2: partial;
// `_block_class_inkernel`'s rules over the tiles' valid rows
__device__ __forceinline__ int classify(const Problem& p, TileStats q, TileStats k,
                                        bool complete) {
  const bool uniform = (q.seg_lo == q.seg_hi) && (k.seg_lo == k.seg_hi);
  const bool seg_match = uniform && (q.seg_lo == k.seg_lo) && (q.seg_lo != 0);
  bool empty = (q.seg_hi < k.seg_lo) || (k.seg_hi < q.seg_lo) || (q.seg_hi == 0);
  bool full = seg_match && complete;
  if (p.causal) {
    empty = empty || (k.pos_lo > q.pos_hi);
    full = full && (k.pos_hi <= q.pos_lo);
  }
  if (p.window > 0) {
    empty = empty || (k.pos_hi <= q.pos_lo - p.window);
    full = full && (k.pos_lo > q.pos_hi - p.window);
  }
  if (p.chunk > 0) {
    const int c = p.chunk;
    empty = empty || (floordiv(q.pos_hi, c) < floordiv(k.pos_lo, c)) ||
            (floordiv(q.pos_lo, c) > floordiv(k.pos_hi, c));
    full = full && (floordiv(q.pos_lo, c) == floordiv(q.pos_hi, c)) &&
           (floordiv(k.pos_lo, c) == floordiv(k.pos_hi, c)) &&
           (floordiv(q.pos_lo, c) == floordiv(k.pos_lo, c));
  }
  return empty ? 0 : (full ? 1 : 2);
}

// rows [r0, r0 + kTile) of one (batch, head) slice into shared memory as
// float32, rows at or past `rows` as zeros; `pitch` floats per shared row
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const T* base, long long s_stride,
                                          int r0, int rows) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D, row = r0 + r;
    dst[r * pitch + c] = row < rows ? Elem<T>::to_f(base[(long long)row * s_stride + c]) : 0.f;
  }
}

// positions and segment ids of rows [r0, r0 + kTile) of batch row b (threads < kTile)
__device__ __forceinline__ void load_ids(int* pos_s, int* seg_s, const int* pos, const int* seg,
                                         int b, int r0, int rows) {
  const int r = threadIdx.x;
  if (r < kTile) {
    const int row = r0 + r;
    pos_s[r] = row < rows ? pos[(long long)b * rows + row] : 0;
    seg_s[r] = row < rows ? seg[(long long)b * rows + row] : 0;
  }
}

// acc[i][j] = sum_d A[(ty + 16 i)][d] * B[(tx + 16 j)][d], both [kTile][D + 1]
template <int D>
__device__ __forceinline__ void dots(const float* A, const float* Bm, int ty, int tx,
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
    for (int i = 0; i < kRows; ++i) a[i] = A[(ty + kLanes * i) * DP + d];
#pragma unroll
    for (int j = 0; j < kRows; ++j) b[j] = Bm[(tx + kLanes * j) * DP + d];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][c] += sum_kk P[(ty + 16 i)][kk] * M[kk][tx + 16 c]; P [kTile][kTile + 1],
// M rows `pitch` floats apart
template <int D>
__device__ __forceinline__ void accumulate(const float* P, const float* M, int pitch, int ty,
                                           int tx, float (&acc)[kRows][D / kLanes]) {
  constexpr int PP = kTile + 1, DC = D / kLanes;
#pragma unroll 4
  for (int kk = 0; kk < kTile; ++kk) {
    float a[kRows], w[DC];
#pragma unroll
    for (int i = 0; i < kRows; ++i) a[i] = P[(ty + kLanes * i) * PP + kk];
#pragma unroll
    for (int c = 0; c < DC; ++c) w[c] = M[kk * pitch + tx + kLanes * c];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(a[i], w[c], acc[i][c]);
  }
}

// the scaled, capped logit; `dcap` receives 1 - tanh^2 (1 without a cap)
__device__ __forceinline__ float cap_logit(const Problem& p, float s, float& dcap) {
  s = s * p.scale;
  if (p.soft_cap > 0.f) {
    const float th = tanhf(s / p.soft_cap);
    dcap = 1.f - th * th;
    return p.soft_cap * th;
  }
  dcap = 1.f;
  return s;
}

// shared memory of each kernel, in floats (positions, ids and statistics are static)
template <int D> constexpr int fwd_floats() {
  return 2 * kTile * (D + 1) + kTile * D + kTile * (kTile + 1);  // Qs, Ks, Vs, Ps
}
template <int D> constexpr int dq_floats() {
  return 4 * kTile * (D + 1) + kTile * (kTile + 1);  // Qs, dOs, Ks, Vs, DSs
}
template <int D> constexpr int dkv_floats() {
  return 4 * kTile * (D + 1) + 2 * kTile * (kTile + 1);  // Ks, Vs, Qs, dOs, Ps, DSs
}

// ---------------------------------------------------------------- K9: forward
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(Problem p, const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, Strides qs, Strides ks, Strides vs,
           Strides os) {
  extern __shared__ float smem[];
  __shared__ int qpos_s[kTile], qseg_s[kTile], kpos_s[kTile], kseg_s[kTile];
  __shared__ int cls_s;
  constexpr int DP = D + 1, PP = kTile + 1, DC = D / kLanes;
  float* Qs = smem;
  float* Ks = Qs + kTile * DP;
  float* Vs = Ks + kTile * DP;
  float* Ps = Vs + kTile * D;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const T* qb = q + b * qs.b + h * qs.n;
  const T* kb = k + b * ks.b + hk * ks.n;
  const T* vb = v + b * vs.b + hk * vs.n;
  const int q_rows = min(kTile, p.Sq - q0);

  load_tile<T, D>(Qs, DP, qb, qs.s, q0, p.Sq);
  load_ids(qpos_s, qseg_s, p.q_pos, p.q_seg, b, q0, p.Sq);
  __syncthreads();
  const TileStats qst = tile_stats_warp(qpos_s, qseg_s, q_rows);  // valid in warp 0

  float m[kRows], l[kRows], acc[kRows][DC], s[kRows][kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const int tiles = (p.Skv + kTile - 1) / kTile;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kTile, k_rows = min(kTile, p.Skv - k0);
    __syncthreads();  // every read of the tile before is done
    load_ids(kpos_s, kseg_s, p.kv_pos, p.kv_seg, b, k0, p.Skv);
    __syncthreads();
    if (threadIdx.x < 32) {
      const TileStats kst = tile_stats_warp(kpos_s, kseg_s, k_rows);
      if (threadIdx.x == 0) cls_s = classify(p, qst, kst, q_rows == kTile && k_rows == kTile);
    }
    __syncthreads();
    const int cls = cls_s;
    if (cls == 0) continue;
    load_tile<T, D>(Ks, DP, kb, ks.s, k0, p.Skv);
    load_tile<T, D>(Vs, D, vb, vs.s, k0, p.Skv);
    __syncthreads();
    dots<D>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kLanes * i;
      bool ok[kRows];
      float mc = -INFINITY;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int c = tx + kLanes * j;
        float dcap;
        s[i][j] = cap_logit(p, s[i][j], dcap);
        ok[j] = cls == 1 || (c < k_rows && r < q_rows &&
                             visible(p, qpos_s[r], kpos_s[c], qseg_s[r], kseg_s[c]));
        if (!ok[j]) s[i][j] = kMaskValue;
        // keys past Skv take no part in the max either (the TPU tile has none)
        if (c < k_rows) mc = fmaxf(mc, s[i][j]);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float mn = fmaxf(m[i], mc);  // finite: every processed tile has a key
      const float alpha = expf(m[i] - mn);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float pv = ok[j] ? expf(s[i][j] - mn) : 0.f;
        ls += pv;
        Ps[r * PP + tx + kLanes * j] = Elem<T>::round(pv);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2) ls += __shfl_xor_sync(0xffffffffu, ls, off);
      l[i] = l[i] * alpha + ls;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    accumulate<D>(Ps, Vs, D, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kLanes * i;
    if (row >= p.Sq) continue;
    const bool none = l[i] == 0.f;
    const float inv = none ? 1.f : l[i];
    T* dst = o + b * os.b + (long long)row * os.s + h * os.n;
#pragma unroll
    for (int c = 0; c < DC; ++c) dst[tx + kLanes * c] = Elem<T>::from_f(acc[i][c] / inv);
    if (tx == 0)
      lse[((long long)b * p.H + h) * p.Sq + row] = none ? -INFINITY : m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------- K10: dq
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(Problem p, const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ d_o, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, Strides qs, Strides ks,
          Strides vs, Strides dos, Strides dqs) {
  extern __shared__ float smem[];
  __shared__ int qpos_s[kTile], qseg_s[kTile], kpos_s[kTile], kseg_s[kTile];
  __shared__ float lse_s[kTile], delta_s[kTile];
  __shared__ int cls_s;
  constexpr int DP = D + 1, PP = kTile + 1, DC = D / kLanes;
  float* Qs = smem;
  float* dOs = Qs + kTile * DP;
  float* Ks = dOs + kTile * DP;
  float* Vs = Ks + kTile * DP;
  float* DSs = Vs + kTile * DP;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const T* kb = k + b * ks.b + hk * ks.n;
  const T* vb = v + b * vs.b + hk * vs.n;
  const int q_rows = min(kTile, p.Sq - q0);

  load_tile<T, D>(Qs, DP, q + b * qs.b + h * qs.n, qs.s, q0, p.Sq);
  load_tile<T, D>(dOs, DP, d_o + b * dos.b + h * dos.n, dos.s, q0, p.Sq);
  load_ids(qpos_s, qseg_s, p.q_pos, p.q_seg, b, q0, p.Sq);
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    const long long at = ((long long)b * p.H + h) * p.Sq + row;
    lse_s[threadIdx.x] = row < p.Sq ? lse[at] : 0.f;
    delta_s[threadIdx.x] = row < p.Sq ? delta[at] : 0.f;
  }
  __syncthreads();
  const TileStats qst = tile_stats_warp(qpos_s, qseg_s, q_rows);

  float acc[kRows][DC], s[kRows][kRows], dp[kRows][kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  const int tiles = (p.Skv + kTile - 1) / kTile;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kTile, k_rows = min(kTile, p.Skv - k0);
    __syncthreads();
    load_ids(kpos_s, kseg_s, p.kv_pos, p.kv_seg, b, k0, p.Skv);
    __syncthreads();
    if (threadIdx.x < 32) {
      const TileStats kst = tile_stats_warp(kpos_s, kseg_s, k_rows);
      if (threadIdx.x == 0) cls_s = classify(p, qst, kst, q_rows == kTile && k_rows == kTile);
    }
    __syncthreads();
    const int cls = cls_s;
    if (cls == 0) continue;
    load_tile<T, D>(Ks, DP, kb, ks.s, k0, p.Skv);
    load_tile<T, D>(Vs, DP, vb, vs.s, k0, p.Skv);
    __syncthreads();
    dots<D>(Qs, Ks, ty, tx, s);
    dots<D>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kLanes * i;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int c = tx + kLanes * j;
        float dcap;
        const float sc = cap_logit(p, s[i][j], dcap);
        const bool ok = cls == 1 || (c < k_rows && r < q_rows &&
                                     visible(p, qpos_s[r], kpos_s[c], qseg_s[r], kseg_s[c]));
        const float pv = ok ? expf(sc - lse_s[r]) : 0.f;
        float ds = pv * (dp[i][j] - delta_s[r]);
        ds = ds * dcap;
        ds = ds * p.scale;
        DSs[r * PP + c] = Elem<T>::round(ds);
      }
    }
    __syncthreads();
    accumulate<D>(DSs, Ks, DP, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kLanes * i;
    if (row >= p.Sq) continue;
    T* dst = dq + b * dqs.b + (long long)row * dqs.s + h * dqs.n;
#pragma unroll
    for (int c = 0; c < DC; ++c) dst[tx + kLanes * c] = Elem<T>::from_f(acc[i][c]);
  }
}

// ---------------------------------------------------------------- K11: dk, dv
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(Problem p, const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ d_o, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, Strides qs,
           Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs) {
  extern __shared__ float smem[];
  __shared__ int qpos_s[kTile], qseg_s[kTile], kpos_s[kTile], kseg_s[kTile];
  __shared__ float lse_s[kTile], delta_s[kTile];
  __shared__ int cls_s;
  __shared__ TileStats kst_s;
  constexpr int DP = D + 1, PP = kTile + 1, DC = D / kLanes;
  float* Ks = smem;
  float* Vs = Ks + kTile * DP;
  float* Qs = Vs + kTile * DP;
  float* dOs = Qs + kTile * DP;
  float* Ps = dOs + kTile * DP;
  float* DSs = Ps + kTile * PP;

  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.H / p.Hkv;
  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const int k_rows = min(kTile, p.Skv - k0);

  load_tile<T, D>(Ks, DP, k + b * ks.b + hk * ks.n, ks.s, k0, p.Skv);
  load_tile<T, D>(Vs, DP, v + b * vs.b + hk * vs.n, vs.s, k0, p.Skv);
  load_ids(kpos_s, kseg_s, p.kv_pos, p.kv_seg, b, k0, p.Skv);
  __syncthreads();
  if (threadIdx.x < 32) {
    const TileStats kst = tile_stats_warp(kpos_s, kseg_s, k_rows);
    if (threadIdx.x == 0) kst_s = kst;
  }

  float dk_acc[kRows][DC], dv_acc[kRows][DC], s[kRows][kRows], dp[kRows][kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  const int q_tiles = (p.Sq + kTile - 1) / kTile;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + b * qs.b + h * qs.n;
    const T* dob = d_o + b * dos.b + h * dos.n;
    for (int t = 0; t < q_tiles; ++t) {
      const int q0 = t * kTile, q_rows = min(kTile, p.Sq - q0);
      __syncthreads();  // every read of the tile before is done
      load_ids(qpos_s, qseg_s, p.q_pos, p.q_seg, b, q0, p.Sq);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        const long long at = ((long long)b * p.H + h) * p.Sq + row;
        lse_s[threadIdx.x] = row < p.Sq ? lse[at] : 0.f;
        delta_s[threadIdx.x] = row < p.Sq ? delta[at] : 0.f;
      }
      __syncthreads();
      if (threadIdx.x < 32) {
        const TileStats qst = tile_stats_warp(qpos_s, qseg_s, q_rows);
        if (threadIdx.x == 0)
          cls_s = classify(p, qst, kst_s, q_rows == kTile && k_rows == kTile);
      }
      __syncthreads();
      const int cls = cls_s;
      if (cls == 0) continue;
      load_tile<T, D>(Qs, DP, qb, qs.s, q0, p.Sq);
      load_tile<T, D>(dOs, DP, dob, dos.s, q0, p.Sq);
      __syncthreads();
      dots<D>(Ks, Qs, ty, tx, s);   // s[i][j]: key ty + 16 i, query tx + 16 j
      dots<D>(Vs, dOs, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int kr = ty + kLanes * i;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int qr = tx + kLanes * j;
          float dcap;
          const float sc = cap_logit(p, s[i][j], dcap);
          const bool ok = cls == 1 || (kr < k_rows && qr < q_rows &&
                                       visible(p, qpos_s[qr], kpos_s[kr], qseg_s[qr], kseg_s[kr]));
          const float pv = ok ? expf(sc - lse_s[qr]) : 0.f;
          float ds = pv * (dp[i][j] - delta_s[qr]);
          ds = ds * dcap;
          ds = ds * p.scale;
          Ps[kr * PP + qr] = pv;
          DSs[kr * PP + qr] = ds;
        }
      }
      __syncthreads();
      accumulate<D>(Ps, dOs, DP, ty, tx, dv_acc);
      accumulate<D>(DSs, Qs, DP, ty, tx, dk_acc);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = k0 + ty + kLanes * i;
    if (row >= p.Skv) continue;
    T* dkd = dk + b * dks.b + (long long)row * dks.s + hk * dks.n;
    T* dvd = dv + b * dvs.b + (long long)row * dvs.s + hk * dvs.n;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dkd[tx + kLanes * c] = Elem<T>::from_f(dk_acc[i][c]);
      dvd[tx + kLanes * c] = Elem<T>::from_f(dv_acc[i][c]);
    }
  }
}

// ------------------------------------- bf16 K9-K11 on the tensor cores
constexpr int kMmaThreads = 128;  // 4 warps, 16 rows each
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kFwdQ = 64;  // K9 and K10: query rows of a block
constexpr int kFwdK = 64;  // K9 and K10: keys of a tile
constexpr int kDkvK = 64;  // K11: keys of a block
constexpr int kDkvQ = 32;  // K11: query rows of a step

// x = hi + lo to within 2^-17 |x|: hi = bf16(x), lo = bf16(x - hi), x - hi exact
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi, unsigned& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<unsigned*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// elements [r0, r0 + ROWS) of a 4-byte row vector (ids, lse, delta), zeros at or past `rows`
template <int ROWS, typename U>
__device__ __forceinline__ void load_rows_async(U* dst, const U* src, int r0, int rows) {
  for (int i = threadIdx.x; i < ROWS; i += kMmaThreads) {
    const bool ok = r0 + i < rows;
    cp_async4(smem_addr(dst + i), src + (ok ? r0 + i : 0), ok);
  }
}

// acc[16 rows x D] += X[16 rows x kDkvQ] M[kDkvQ x D]: X float32 C fragments,
// each split into bf16 hi + lo A fragments; M a swizzled [kDkvQ][D] tile
template <int D>
__device__ __forceinline__ void accumulate_split(float (&acc)[D / 8][4],
                                                 const float (&x)[kDkvQ / 8][4], unsigned m,
                                                 int lane) {
#pragma unroll
  for (int kk = 0; kk < kDkvQ / 16; ++kk) {
    unsigned hi[4], lo[4];
    split_bf16(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
    split_bf16(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
    split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
    split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      unsigned bm[4];
      ldsm_x4_t(m + swz<D>(kk * 16 + (lane & 15), 2 * np + (lane >> 4)), bm);
      mma_bf16(acc[2 * np], hi, bm[0], bm[1]);
      mma_bf16(acc[2 * np + 1], hi, bm[2], bm[3]);
      mma_bf16(acc[2 * np], lo, bm[0], bm[1]);
      mma_bf16(acc[2 * np + 1], lo, bm[2], bm[3]);
    }
  }
}

template <int D> constexpr int fwd_mma_bytes() {  // Qs, Ks[2], Vs[2], key ids [2][2]
  return (kFwdQ + 4 * kFwdK) * D * 2 + 2 * 2 * kFwdK * 4;
}
template <int D> constexpr int dq_mma_bytes() {  // Qs, dOs, Ks[2], Vs[2], key ids [2][2]
  return (2 * kFwdQ + 4 * kFwdK) * D * 2 + 2 * 2 * kFwdK * 4;
}
template <int D> constexpr int dkv_mma_bytes() {  // Ks, Vs, Qs[2], dOs[2], query rows [2][4]
  return (2 * kDkvK + 4 * kDkvQ) * D * 2 + 2 * 4 * kDkvQ * 4;
}

// ------------------------------------------------------- K9, bf16: forward
// grid (H, B, query tiles); the thread's rows are warp * 16 + lane / 4 (+ 8)
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
fwd_mma_kernel(Problem p, const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
               Strides qs, Strides ks, Strides vs, Strides os) {
  extern __shared__ __align__(16) unsigned char smem_u8[];
  constexpr int TILE = kFwdK * D * 2;
  const unsigned Qs = smem_addr(smem_u8);
  const unsigned Ks = Qs + kFwdQ * D * 2, Vs = Ks + 2 * TILE;
  int* kpos_s = reinterpret_cast<int*>(smem_u8 + kFwdQ * D * 2 + 4 * TILE);  // [2][kFwdK]
  int* kseg_s = kpos_s + 2 * kFwdK;
  unsigned char* cls_s = reinterpret_cast<unsigned char*>(kseg_s + 2 * kFwdK);  // [key tiles]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kFwdQ;  // the heaviest causal tiles first
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane % 4;
  const bf16* kb = k + b * ks.b + hk * ks.n;
  const bf16* vb = v + b * vs.b + hk * vs.n;
  const int q_rows = min(kFwdQ, p.Sq - q0);
  const int* qpos = p.q_pos + (long long)b * p.Sq;
  const int* qseg = p.q_seg + (long long)b * p.Sq;
  const int* kpos = p.kv_pos + (long long)b * p.Skv;
  const int* kseg = p.kv_seg + (long long)b * p.Skv;

  load_tile_async<D, kFwdQ, kMmaThreads>(Qs, q + b * qs.b + h * qs.n, qs.s, q0, p.Sq);
  cp_async_commit();

  // classify every key tile against this query tile, the warps taking turns
  const int nkt = (p.Skv + kFwdK - 1) / kFwdK;
  const TileStats qst = tile_stats_warp(qpos + q0, qseg + q0, q_rows);
  for (int t = warp; t < nkt; t += kMmaWarps) {
    const int k0 = t * kFwdK, k_rows = min(kFwdK, p.Skv - k0);
    const TileStats kst = tile_stats_warp(kpos + k0, kseg + k0, k_rows);
    if (lane == 0) cls_s[t] = classify(p, qst, kst, q_rows == kFwdQ && k_rows == kFwdK);
  }
  int rpos[2], rseg[2];
  bool rok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + lane / 4 + 8 * i;
    rok[i] = r < q_rows;
    rpos[i] = rok[i] ? qpos[q0 + r] : 0;
    rseg[i] = rok[i] ? qseg[q0 + r] : 0;
  }
  __syncthreads();

  auto next_tile = [&](int t) {
    while (t < nkt && cls_s[t] == 0) ++t;
    return t;
  };
  auto load_kv = [&](int t, int st) {
    const int k0 = t * kFwdK;
    load_tile_async<D, kFwdK, kMmaThreads>(Ks + st * TILE, kb, ks.s, k0, p.Skv);
    load_tile_async<D, kFwdK, kMmaThreads>(Vs + st * TILE, vb, vs.s, k0, p.Skv);
    load_rows_async<kFwdK>(kpos_s + st * kFwdK, kpos, k0, p.Skv);
    load_rows_async<kFwdK>(kseg_s + st * kFwdK, kseg, k0, p.Skv);
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  unsigned qf[D / 16][4];
  int t = next_tile(0);
  if (t < nkt) load_kv(t, 0);
  cp_async_commit();
  for (int st = 0, first = 1; t < nkt; st ^= 1, first = 0) {
    const int nt = next_tile(t + 1);
    if (nt < nkt) load_kv(nt, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q and this tile have landed
    __syncthreads();
    if (first) load_a<D>(qf, Qs, warp * 16, lane);
    const unsigned Kt = Ks + st * TILE, Vt = Vs + st * TILE;
    const int* kp = kpos_s + st * kFwdK;
    const int* kg = kseg_s + st * kFwdK;
    const int k_rows = min(kFwdK, p.Skv - t * kFwdK), cls = cls_s[t];

    // S = Q K^T: 8-key column blocks j; this thread's (row, key) = (r_i, 8 j + 2 t4 + e % 2)
    float s[kFwdK / 8][4];
    product_abt<D, kFwdK / 8>(s, qf, Kt, lane);

    // scale, cap, mask (a full tile pair has none: one branch for the tile,
    // so the unmasked loop stays compact); keys past Skv take no part in the max
    unsigned vis_bits = ~0u;
    float mc[2] = {-INFINITY, -INFINITY};
    if (cls == 1) {
#pragma unroll
      for (int j = 0; j < kFwdK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dcap;
          s[j][e] = cap_logit(p, s[j][e], dcap);
          mc[e >> 1] = fmaxf(mc[e >> 1], s[j][e]);
        }
    } else {
      vis_bits = 0u;
#pragma unroll
      for (int j = 0; j < kFwdK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t4 + (e & 1), i = e >> 1;
          float dcap;
          float x = cap_logit(p, s[j][e], dcap);
          const bool vis = c < k_rows && rok[i] && visible(p, rpos[i], kp[c], rseg[i], kg[c]);
          if (!vis) x = c < k_rows ? kMaskValue : -INFINITY;
          s[j][e] = x;
          vis_bits |= vis ? (1u << (4 * j + e)) : 0u;
          mc[i] = fmaxf(mc[i], x);
        }
    }
    float mn[2], alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 1));
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 2));
      mn[i] = fmaxf(m[i], mc[i]);  // finite: every processed tile has a key
      alpha[i] = expf(m[i] - mn[i]);
    }
    // p = exp(s - m) in float32, summed into l in float32, then rounded to bf16
    // into the A fragments of P V: the kernel's one rounding of p
#pragma unroll
    for (int j = 0; j < kFwdK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = (vis_bits >> (4 * j + e)) & 1u ? expf(s[j][e] - mn[e >> 1]) : 0.f;
        ls[e >> 1] += pv;
        s[j][e] = pv;
      }
    unsigned pa[kFwdK / 16][4];
    c_to_a<kFwdK / 16>(s, pa);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = l[i] * alpha[i] + ls[i];  // this thread's share of the row; summed at the end
      m[i] = mn[i];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // O += P V: V's B fragments by ldmatrix.trans of its [key][d] rows
    product_am<D, kFwdK / 16>(acc, pa, Vt, lane);
    __syncthreads();  // every read of this stage is done before it is loaded again
    t = nt;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = q0 + warp * 16 + lane / 4 + 8 * i;
    if (row >= p.Sq) continue;
    const bool none = l[i] == 0.f;
    const float inv = none ? 1.f : l[i];
    bf16* dst = o + b * os.b + (long long)row * os.s + h * os.n + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * i] / inv, acc[n][2 * i + 1] / inv);
    if (t4 == 0)
      lse[((long long)b * p.H + h) * p.Sq + row] = none ? -INFINITY : m[i] + logf(l[i]);
  }
}

// ------------------------------------------------------------- K10, bf16: dq
// grid (H, B, query tiles); the thread's rows are warp * 16 + lane / 4 (+ 8)
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
dq_mma_kernel(Problem p, const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ d_o,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, Strides qs, Strides ks, Strides vs, Strides dos,
              Strides dqs) {
  extern __shared__ __align__(16) unsigned char smem_u8[];
  constexpr int QT = kFwdQ * D * 2, TILE = kFwdK * D * 2;
  constexpr int SK = D > 64 ? 32 : kFwdK;  // keys of a step: S, dP and dQ's 64 floats fit
  const unsigned Qs = smem_addr(smem_u8), dOs = Qs + QT, Ks = dOs + QT, Vs = Ks + 2 * TILE;
  int* kpos_s = reinterpret_cast<int*>(smem_u8 + 2 * QT + 4 * TILE);  // [2][kFwdK]
  int* kseg_s = kpos_s + 2 * kFwdK;
  unsigned char* cls_s = reinterpret_cast<unsigned char*>(kseg_s + 2 * kFwdK);  // [key tiles]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kFwdQ;  // the heaviest causal tiles first
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane % 4;
  const bf16* kb = k + b * ks.b + hk * ks.n;
  const bf16* vb = v + b * vs.b + hk * vs.n;
  const int q_rows = min(kFwdQ, p.Sq - q0);
  const int* qpos = p.q_pos + (long long)b * p.Sq;
  const int* qseg = p.q_seg + (long long)b * p.Sq;
  const int* kpos = p.kv_pos + (long long)b * p.Skv;
  const int* kseg = p.kv_seg + (long long)b * p.Skv;

  load_tile_async<D, kFwdQ, kMmaThreads>(Qs, q + b * qs.b + h * qs.n, qs.s, q0, p.Sq);
  load_tile_async<D, kFwdQ, kMmaThreads>(dOs, d_o + b * dos.b + h * dos.n, dos.s, q0, p.Sq);
  cp_async_commit();

  // classify every key tile against this query tile, the warps taking turns
  const int nkt = (p.Skv + kFwdK - 1) / kFwdK;
  const TileStats qst = tile_stats_warp(qpos + q0, qseg + q0, q_rows);
  for (int t = warp; t < nkt; t += kMmaWarps) {
    const int k0 = t * kFwdK, k_rows = min(kFwdK, p.Skv - k0);
    const TileStats kst = tile_stats_warp(kpos + k0, kseg + k0, k_rows);
    if (lane == 0) cls_s[t] = classify(p, qst, kst, q_rows == kFwdQ && k_rows == kFwdK);
  }
  // the thread's two rows: position, segment, lse and delta stay in registers
  int rpos[2], rseg[2];
  bool rok[2];
  float rlse[2], rdelta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + lane / 4 + 8 * i;
    const long long at = ((long long)b * p.H + h) * p.Sq + q0 + r;
    rok[i] = r < q_rows;
    rpos[i] = rok[i] ? qpos[q0 + r] : 0;
    rseg[i] = rok[i] ? qseg[q0 + r] : 0;
    rlse[i] = rok[i] ? lse[at] : 0.f;
    rdelta[i] = rok[i] ? delta[at] : 0.f;
  }
  __syncthreads();

  auto next_tile = [&](int t) {
    while (t < nkt && cls_s[t] == 0) ++t;
    return t;
  };
  auto load_kv = [&](int t, int st) {
    const int k0 = t * kFwdK;
    load_tile_async<D, kFwdK, kMmaThreads>(Ks + st * TILE, kb, ks.s, k0, p.Skv);
    load_tile_async<D, kFwdK, kMmaThreads>(Vs + st * TILE, vb, vs.s, k0, p.Skv);
    load_rows_async<kFwdK>(kpos_s + st * kFwdK, kpos, k0, p.Skv);
    load_rows_async<kFwdK>(kseg_s + st * kFwdK, kseg, k0, p.Skv);
  };

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  int t = next_tile(0);
  if (t < nkt) load_kv(t, 0);
  cp_async_commit();
  for (int st = 0; t < nkt; st ^= 1) {
    const int nt = next_tile(t + 1);
    if (nt < nkt) load_kv(nt, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO and this tile have landed
    __syncthreads();
    const unsigned Kt = Ks + st * TILE, Vt = Vs + st * TILE;
    const int* kp = kpos_s + st * kFwdK;
    const int* kg = kseg_s + st * kFwdK;
    const int k_rows = min(kFwdK, p.Skv - t * kFwdK), cls = cls_s[t];

    // the tile in steps of SK keys, one after the other (registers, see the note)
#pragma unroll 1
    for (int k0 = 0; k0 < kFwdK; k0 += SK) {
      const unsigned koff = k0 * D * 2;
      // S = Q K^T (summed in float32 to nearest over D: ds is rounded to bf16
      // from it), then dP = dO V^T: (row, key) = (r_i, k0 + 8 j + 2 t4 + e % 2);
      // the Q and dO fragments are read again for every step
      float s[SK / 8][4], dp[SK / 8][4];
      product_abt_rn<D, SK / 8>(s, Qs, warp * 16, Kt + koff, lane);
      {
        unsigned a[D / 16][4];
        load_a<D>(a, dOs, warp * 16, lane);
        product_abt<D, SK / 8>(dp, a, Vt + koff, lane);
      }
      // p = exp(s_capped - lse) where visible (else 0, never exp(mask - lse)) and
      // ds = p (dp - delta) (1 - tanh^2) scale, float32, in place of s; the mask
      // is worked out only for a partial tile pair
      unsigned vis_bits = ~0u;
      if (cls != 1) {
        vis_bits = 0u;
#pragma unroll
        for (int j = 0; j < SK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = k0 + 8 * j + 2 * t4 + (e & 1), i = e >> 1;
            const bool ok = c < k_rows && rok[i] && visible(p, rpos[i], kp[c], rseg[i], kg[c]);
            vis_bits |= ok ? (1u << (4 * j + e)) : 0u;
          }
      }
#pragma unroll
      for (int j = 0; j < SK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dcap;
          const float sc = cap_logit(p, s[j][e], dcap);
          const float pv = (vis_bits >> (4 * j + e)) & 1u ? expf(sc - rlse[e >> 1]) : 0.f;
          float ds = pv * (dp[j][e] - rdelta[e >> 1]);
          ds = ds * dcap;
          ds = ds * p.scale;
          s[j][e] = ds;
        }
      // dQ += dS K: ds rounded to bf16 into the A fragments (the kernel's one
      // rounding of ds), K's B fragments by ldmatrix.trans of its [key][d] rows
      unsigned da[SK / 16][4];
      c_to_a<SK / 16>(s, da);
      product_am<D, SK / 16>(acc, da, Kt + koff, lane);
    }
    __syncthreads();  // every read of this stage is done before it is loaded again
    t = nt;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + lane / 4 + 8 * i;
    if (row >= p.Sq) continue;
    bf16* dst = dq + b * dqs.b + (long long)row * dqs.s + h * dqs.n + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// ------------------------------------------------------ K11, bf16: dk, dv
// grid (Hkv, B, key tiles); the thread's keys are warp * 16 + lane / 4 (+ 8)
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
dkv_mma_kernel(Problem p, const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ d_o,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, Strides qs, Strides ks, Strides vs,
               Strides dos, Strides dks, Strides dvs) {
  extern __shared__ __align__(16) unsigned char smem_u8[];
  constexpr int KT = kDkvK * D * 2, QT = kDkvQ * D * 2;
  const unsigned Ks = smem_addr(smem_u8), Vs = Ks + KT, Qs = Ks + 2 * KT, dOs = Qs + 2 * QT;
  float* lse_s = reinterpret_cast<float*>(smem_u8 + 2 * KT + 4 * QT);  // [2][kDkvQ] each
  float* delta_s = lse_s + 2 * kDkvQ;
  int* qpos_s = reinterpret_cast<int*>(delta_s + 2 * kDkvQ);
  int* qseg_s = qpos_s + 2 * kDkvQ;
  unsigned char* cls_s = reinterpret_cast<unsigned char*>(qseg_s + 2 * kDkvQ);  // [q tiles]

  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kDkvK;
  const int group = p.H / p.Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane % 4;
  const int k_rows = min(kDkvK, p.Skv - k0);
  const int* qpos = p.q_pos + (long long)b * p.Sq;
  const int* qseg = p.q_seg + (long long)b * p.Sq;
  const int* kpos = p.kv_pos + (long long)b * p.Skv;
  const int* kseg = p.kv_seg + (long long)b * p.Skv;

  load_tile_async<D, kDkvK, kMmaThreads>(Ks, k + b * ks.b + hk * ks.n, ks.s, k0, p.Skv);
  load_tile_async<D, kDkvK, kMmaThreads>(Vs, v + b * vs.b + hk * vs.n, vs.s, k0, p.Skv);
  cp_async_commit();

  // classify every query tile against this key tile, the warps taking turns
  const int nqt = (p.Sq + kDkvQ - 1) / kDkvQ;
  const TileStats kst = tile_stats_warp(kpos + k0, kseg + k0, k_rows);
  for (int t = warp; t < nqt; t += kMmaWarps) {
    const int q0 = t * kDkvQ, q_rows = min(kDkvQ, p.Sq - q0);
    const TileStats qst = tile_stats_warp(qpos + q0, qseg + q0, q_rows);
    if (lane == 0) cls_s[t] = classify(p, qst, kst, q_rows == kDkvQ && k_rows == kDkvK);
  }
  int rpos[2], rseg[2];
  bool rok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + lane / 4 + 8 * i;
    rok[i] = r < k_rows;
    rpos[i] = rok[i] ? kpos[k0 + r] : 0;
    rseg[i] = rok[i] ? kseg[k0 + r] : 0;
  }
  __syncthreads();

  // steps: (q head of the group, query tile), the empty ones skipped
  const int steps = group * nqt;
  auto next_step = [&](int it) {
    while (it < steps && cls_s[it % nqt] == 0) ++it;
    return it;
  };
  auto load_q = [&](int it, int st) {
    const int h = hk * group + it / nqt, q0 = (it % nqt) * kDkvQ;
    load_tile_async<D, kDkvQ, kMmaThreads>(Qs + st * QT, q + b * qs.b + h * qs.n, qs.s, q0,
                                           p.Sq);
    load_tile_async<D, kDkvQ, kMmaThreads>(dOs + st * QT, d_o + b * dos.b + h * dos.n, dos.s,
                                           q0, p.Sq);
    const long long at = ((long long)b * p.H + h) * p.Sq;
    load_rows_async<kDkvQ>(lse_s + st * kDkvQ, lse + at, q0, p.Sq);
    load_rows_async<kDkvQ>(delta_s + st * kDkvQ, delta + at, q0, p.Sq);
    load_rows_async<kDkvQ>(qpos_s + st * kDkvQ, qpos, q0, p.Sq);
    load_rows_async<kDkvQ>(qseg_s + st * kDkvQ, qseg, q0, p.Sq);
  };

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  int it = next_step(0);
  if (it < steps) load_q(it, 0);
  cp_async_commit();
  for (int st = 0; it < steps; st ^= 1) {
    const int nit = next_step(it + 1);
    if (nit < steps) load_q(nit, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // K, V and this step's rows have landed
    __syncthreads();
    const unsigned Qt = Qs + st * QT, dOt = dOs + st * QT;
    const float* ls = lse_s + st * kDkvQ;
    const float* dl = delta_s + st * kDkvQ;
    const int* qp = qpos_s + st * kDkvQ;
    const int* qg = qseg_s + st * kDkvQ;
    const int q_rows = min(kDkvQ, p.Sq - (it % nqt) * kDkvQ), cls = cls_s[it % nqt];

    // S^T = K Q^T and dP^T = V dO^T: (key, query) = (r_i, 8 j + 2 t4 + e % 2)
    float s[kDkvQ / 8][4], dp[kDkvQ / 8][4];
#pragma unroll
    for (int j = 0; j < kDkvQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned ka[4], va[4];
      ldsm_x4(Ks + swz<D>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)), ka);
      ldsm_x4(Vs + swz<D>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)), va);
#pragma unroll
      for (int np = 0; np < kDkvQ / 16; ++np) {
        unsigned bq[4], bd[4];
        const int r = np * 16 + (lane & 7) + ((lane >> 4) << 3), c = 2 * kk + ((lane >> 3) & 1);
        ldsm_x4(Qt + swz<D>(r, c), bq);
        ldsm_x4(dOt + swz<D>(r, c), bd);
        mma_bf16(s[2 * np], ka, bq[0], bq[1]);
        mma_bf16(s[2 * np + 1], ka, bq[2], bq[3]);
        mma_bf16(dp[2 * np], va, bd[0], bd[1]);
        mma_bf16(dp[2 * np + 1], va, bd[2], bd[3]);
      }
    }
    // p = exp(s - lse) where visible (else 0, never exp(mask - lse)) and
    // ds = p (dp - delta) (1 - tanh^2) scale, float32, in place of s and dp;
    // the mask is worked out only for a partial tile pair
    unsigned vis_bits = ~0u;
    if (cls != 1) {
      vis_bits = 0u;
#pragma unroll
      for (int j = 0; j < kDkvQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t4 + (e & 1), i = e >> 1;
          const bool ok = rok[i] && c < q_rows && visible(p, qp[c], rpos[i], qg[c], rseg[i]);
          vis_bits |= ok ? (1u << (4 * j + e)) : 0u;
        }
    }
#pragma unroll
    for (int j = 0; j < kDkvQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t4 + (e & 1);
        float dcap;
        const float sc = cap_logit(p, s[j][e], dcap);
        const float pv = (vis_bits >> (4 * j + e)) & 1u ? expf(sc - ls[c]) : 0.f;
        float ds = pv * (dp[j][e] - dl[c]);
        ds = ds * dcap;
        ds = ds * p.scale;
        s[j][e] = pv;
        dp[j][e] = ds;
      }
    // dV += P^T dO, then dK += dS^T Q (one at a time: fewer live registers),
    // p and ds each as bf16 hi + lo (neither is rounded to bf16); dO's and Q's
    // B fragments by ldmatrix.trans
    accumulate_split<D>(dv_acc, s, dOt, lane);
    accumulate_split<D>(dk_acc, dp, Qt, lane);
    __syncthreads();  // every read of this stage is done before it is loaded again
    it = nit;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + warp * 16 + lane / 4 + 8 * i;
    if (row >= p.Skv) continue;
    bf16* dkd = dk + b * dks.b + (long long)row * dks.s + hk * dks.n + 2 * t4;
    bf16* dvd = dv + b * dvs.b + (long long)row * dvs.s + hk * dvs.n + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkd + 8 * n) =
          __floats2bfloat162_rn(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvd + 8 * n) =
          __floats2bfloat162_rn(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------- launches

inline bool bad_problem(const Problem& p) {
  return p.B < 1 || p.H < 1 || p.Hkv < 1 || p.H % p.Hkv != 0 || p.Sq < 1 || p.Skv < 1 ||
         p.B > 65535 || p.H > 65535 || p.Hkv > 65535;
}

template <typename K>
inline int prepare(K kernel, int bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return static_cast<int>(err);
}

template <int D>
int launch_fwd_mma(const Problem& p, const void* q, const void* k, const void* v, void* o,
                   float* lse, Strides qs, Strides ks, Strides vs, Strides os, cudaStream_t st) {
  const int q_tiles = (p.Sq + kFwdQ - 1) / kFwdQ, k_tiles = (p.Skv + kFwdK - 1) / kFwdK;
  if (q_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fwd_mma_kernel<D>;
  const int bytes = fwd_mma_bytes<D>() + k_tiles;  // + one class byte a key tile
  if (int err = prepare(kernel, bytes)) return err;
  kernel<<<dim3(p.H, p.B, q_tiles), kMmaThreads, bytes, st>>>(
      p, static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, qs, ks, vs, os);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_mma(const Problem& p, const void* q, const void* k, const void* v, const void* d_o,
                  const float* lse, const float* delta, void* dq, Strides qs, Strides ks,
                  Strides vs, Strides dos, Strides dqs, cudaStream_t st) {
  const int q_tiles = (p.Sq + kFwdQ - 1) / kFwdQ, k_tiles = (p.Skv + kFwdK - 1) / kFwdK;
  if (q_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = dq_mma_kernel<D>;
  const int bytes = dq_mma_bytes<D>() + k_tiles;  // + one class byte a key tile
  if (int err = prepare(kernel, bytes)) return err;
  kernel<<<dim3(p.H, p.B, q_tiles), kMmaThreads, bytes, st>>>(
      p, static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(d_o), lse, delta, static_cast<bf16*>(dq), qs, ks, vs, dos, dqs);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_mma(const Problem& p, const void* q, const void* k, const void* v, const void* d_o,
                   const float* lse, const float* delta, void* dk, void* dv, Strides qs,
                   Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
                   cudaStream_t st) {
  const int k_tiles = (p.Skv + kDkvK - 1) / kDkvK, q_tiles = (p.Sq + kDkvQ - 1) / kDkvQ;
  if (k_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = dkv_mma_kernel<D>;
  const int bytes = dkv_mma_bytes<D>() + q_tiles;  // + one class byte a query tile
  if (int err = prepare(kernel, bytes)) return err;
  kernel<<<dim3(p.Hkv, p.B, k_tiles), kMmaThreads, bytes, st>>>(
      p, static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(d_o), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      qs, ks, vs, dos, dks, dvs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_fwd(const Problem& p, const void* q, const void* k, const void* v, void* o, float* lse,
               Strides qs, Strides ks, Strides vs, Strides os, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_fwd_mma<D>(p, q, k, v, o, lse, qs, ks, vs, os, st);
  } else {
    auto kernel = fwd_kernel<T, D>;
    if (int err = prepare(kernel, fwd_floats<D>() * 4)) return err;
    const dim3 grid((p.Sq + kTile - 1) / kTile, p.H, p.B);
    kernel<<<grid, kThreads, fwd_floats<D>() * 4, st>>>(
        p, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, qs, ks, vs, os);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int D>
int launch_dq(const Problem& p, const void* q, const void* k, const void* v, const void* d_o,
              const float* lse, const float* delta, void* dq, Strides qs, Strides ks, Strides vs,
              Strides dos, Strides dqs, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_dq_mma<D>(p, q, k, v, d_o, lse, delta, dq, qs, ks, vs, dos, dqs, st);
  } else {
    auto kernel = dq_kernel<T, D>;
    if (int err = prepare(kernel, dq_floats<D>() * 4)) return err;
    const dim3 grid((p.Sq + kTile - 1) / kTile, p.H, p.B);
    kernel<<<grid, kThreads, dq_floats<D>() * 4, st>>>(
        p, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(d_o), lse, delta, static_cast<T*>(dq), qs, ks, vs, dos, dqs);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int D>
int launch_dkv(const Problem& p, const void* q, const void* k, const void* v, const void* d_o,
               const float* lse, const float* delta, void* dk, void* dv, Strides qs, Strides ks,
               Strides vs, Strides dos, Strides dks, Strides dvs, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_dkv_mma<D>(p, q, k, v, d_o, lse, delta, dk, dv, qs, ks, vs, dos, dks, dvs, st);
  } else {
    auto kernel = dkv_kernel<T, D>;
    if (int err = prepare(kernel, dkv_floats<D>() * 4)) return err;
    const dim3 grid((p.Skv + kTile - 1) / kTile, p.Hkv, p.B);
    kernel<<<grid, kThreads, dkv_floats<D>() * 4, st>>>(
        p, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(d_o), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), qs,
        ks, vs, dos, dks, dvs);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace flash

// One set of plain C entry points per element type (flash_attention_{f32,bf16}.cu):
// strides in elements as (batch, sequence, head), the last axis contiguous.
#define FLASH_ENTRY_POINTS(SUFFIX, T)                                                          \
  static flash::Problem flash_problem_##SUFFIX(                                                \
      const int* q_pos, const int* kv_pos, const int* q_seg, const int* kv_seg, int B, int H, \
      int Hkv, int Sq, int Skv, int causal, int window, int chunk, float soft_cap,             \
      float scale) {                                                                           \
    return flash::Problem{B, H, Hkv, Sq, Skv, q_pos, kv_pos, q_seg, kv_seg,                  \
                          causal, window, chunk, soft_cap, scale};                            \
  }                                                                                            \
  extern "C" int flash_fwd_##SUFFIX(                                                           \
      const void* q, const void* k, const void* v, void* o, float* lse, const int* q_pos,      \
      const int* kv_pos, const int* q_seg, const int* kv_seg, int B, int H, int Hkv, int Sq,   \
      int Skv, int D, long long qsb, long long qss, long long qsn, long long ksb,              \
      long long kss, long long ksn, long long vsb, long long vss, long long vsn,              \
      long long osb, long long oss, long long osn, int causal, int window, int chunk,         \
      float soft_cap, float scale, void* stream) {                                             \
    const flash::Problem p = flash_problem_##SUFFIX(q_pos, kv_pos, q_seg, kv_seg, B, H, Hkv,  \
                                                    Sq, Skv, causal, window, chunk, soft_cap,  \
                                                    scale);                                    \
    if (flash::bad_problem(p)) return static_cast<int>(cudaErrorInvalidValue);                 \
    const flash::Strides qs{qsb, qss, qsn}, ks{ksb, kss, ksn}, vs{vsb, vss, vsn},              \
        os{osb, oss, osn};                                                                     \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                                       \
    if (D == 64) return flash::launch_fwd<T, 64>(p, q, k, v, o, lse, qs, ks, vs, os, st);      \
    if (D == 128) return flash::launch_fwd<T, 128>(p, q, k, v, o, lse, qs, ks, vs, os, st);    \
    return static_cast<int>(cudaErrorInvalidValue);                                            \
  }                                                                                            \
  extern "C" int flash_bwd_dq_##SUFFIX(                                                        \
      const void* q, const void* k, const void* v, const void* d_o, const float* lse,          \
      const float* delta, void* dq, const int* q_pos, const int* kv_pos, const int* q_seg,     \
      const int* kv_seg, int B, int H, int Hkv, int Sq, int Skv, int D, long long qsb,         \
      long long qss, long long qsn, long long ksb, long long kss, long long ksn,              \
      long long vsb, long long vss, long long vsn, long long dosb, long long doss,            \
      long long dosn, long long dqsb, long long dqss, long long dqsn, int causal, int window, \
      int chunk, float soft_cap, float scale, void* stream) {                                  \
    const flash::Problem p = flash_problem_##SUFFIX(q_pos, kv_pos, q_seg, kv_seg, B, H, Hkv,  \
                                                    Sq, Skv, causal, window, chunk, soft_cap,  \
                                                    scale);                                    \
    if (flash::bad_problem(p)) return static_cast<int>(cudaErrorInvalidValue);                 \
    const flash::Strides qs{qsb, qss, qsn}, ks{ksb, kss, ksn}, vs{vsb, vss, vsn},              \
        dos{dosb, doss, dosn}, dqs{dqsb, dqss, dqsn};                                          \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                                       \
    if (D == 64)                                                                               \
      return flash::launch_dq<T, 64>(p, q, k, v, d_o, lse, delta, dq, qs, ks, vs, dos, dqs,    \
                                     st);                                                      \
    if (D == 128)                                                                              \
      return flash::launch_dq<T, 128>(p, q, k, v, d_o, lse, delta, dq, qs, ks, vs, dos, dqs,   \
                                      st);                                                     \
    return static_cast<int>(cudaErrorInvalidValue);                                            \
  }                                                                                            \
  extern "C" int flash_bwd_dkv_##SUFFIX(                                                       \
      const void* q, const void* k, const void* v, const void* d_o, const float* lse,          \
      const float* delta, void* dk, void* dv, const int* q_pos, const int* kv_pos,             \
      const int* q_seg, const int* kv_seg, int B, int H, int Hkv, int Sq, int Skv, int D,     \
      long long qsb, long long qss, long long qsn, long long ksb, long long kss,              \
      long long ksn, long long vsb, long long vss, long long vsn, long long dosb,             \
      long long doss, long long dosn, long long dksb, long long dkss, long long dksn,         \
      long long dvsb, long long dvss, long long dvsn, int causal, int window, int chunk,      \
      float soft_cap, float scale, void* stream) {                                             \
    const flash::Problem p = flash_problem_##SUFFIX(q_pos, kv_pos, q_seg, kv_seg, B, H, Hkv,  \
                                                    Sq, Skv, causal, window, chunk, soft_cap,  \
                                                    scale);                                    \
    if (flash::bad_problem(p)) return static_cast<int>(cudaErrorInvalidValue);                 \
    const flash::Strides qs{qsb, qss, qsn}, ks{ksb, kss, ksn}, vs{vsb, vss, vsn},              \
        dos{dosb, doss, dosn}, dks{dksb, dkss, dksn}, dvs{dvsb, dvss, dvsn};                   \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                                       \
    if (D == 64)                                                                               \
      return flash::launch_dkv<T, 64>(p, q, k, v, d_o, lse, delta, dk, dv, qs, ks, vs, dos,    \
                                      dks, dvs, st);                                           \
    if (D == 128)                                                                              \
      return flash::launch_dkv<T, 128>(p, q, k, v, d_o, lse, delta, dk, dv, qs, ks, vs, dos,   \
                                       dks, dvs, st);                                          \
    return static_cast<int>(cudaErrorInvalidValue);                                            \
  }
