// Flash attention for Hopper (sm_90a): the training attention of the LM, its
// forward (K9) and its two backward kernels (K10: dq; K11: dk and dv).
//
//   q            [B, Sq, H, D]    float32 or bfloat16, any strides over B, S and H
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
// is rounded to k's type before ds k; K11 is float32 throughout (q, do and v
// read as float32) and dk, dv are rounded to k's and v's types once, at the end.
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
// 512 x 512. Here one block of 256 threads owns one output tile and walks the
// other axis in a loop: K9 and K10 a 64-query tile of one (batch, head), looping
// over 64-key tiles; K11 a 64-key tile of one (batch, kv head), looping over
// the group's q heads and every 64-query tile, so that dk and dv are summed in
// registers and written once, without atomics: a step is deterministic.
//
// What bounds it on this card: at the training shape (S = 2048, D = 128, bf16)
// a causal K9 call does 2 * 2 * S^2 / 2 * D flops per (batch, head) against
// ~3 S D elements moved (q and o of the head, its share of k and v): ~700 flops
// a byte, far past the ~295 where the tensor cores and not the memory are the
// limit, so operations bound all three kernels (0.070 ms for K9 at 989 TFLOP/s
// over a batch of 4 x 16 heads).
// What the design does about it: nothing yet beyond skipping empty tile pairs.
// The products run on the CUDA cores in float32 (a bf16 product is exact in
// float32, so the rounding points above hold), tiles in shared memory as
// float32 rows padded by one against bank conflicts, each thread 4 x 4 logits
// (rows ty + 16 i, columns tx + 16 j) and 4 rows x D / 16 columns of its
// accumulators. That is simple and right, and far from the tensor-core bound:
// PERF.md has its times beside the bound; `mma.sync` / `wgmma` fragments are the
// redesign. Any S >= 1 works; rows and keys past S are zero-filled, masked and
// never written. Not built with --use_fast_math: divisions, expf, logf and tanhf
// are IEEE-accurate.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace flash {

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
template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
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
// (n >= 1), by warp 0; lanes past n contribute nothing
struct TileStats {
  int pos_lo, pos_hi, seg_lo, seg_hi;
};

__device__ __forceinline__ TileStats tile_stats_warp(const int* pos, const int* seg, int n) {
  const int lane = threadIdx.x;
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

// ---------------------------------------------------------------- launches

inline bool bad_problem(const Problem& p) {
  return p.B < 1 || p.H < 1 || p.Hkv < 1 || p.H % p.Hkv != 0 || p.Sq < 1 || p.Skv < 1 ||
         p.B > 65535 || p.H > 65535 || p.Hkv > 65535;
}

template <typename K>
inline int prepare(K kernel, int floats) {
  const int bytes = floats * 4;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return static_cast<int>(err);
}

template <typename T, int D>
int launch_fwd(const Problem& p, const void* q, const void* k, const void* v, void* o, float* lse,
               Strides qs, Strides ks, Strides vs, Strides os, cudaStream_t st) {
  auto kernel = fwd_kernel<T, D>;
  if (int err = prepare(kernel, fwd_floats<D>())) return err;
  const dim3 grid((p.Sq + kTile - 1) / kTile, p.H, p.B);
  kernel<<<grid, kThreads, fwd_floats<D>() * 4, st>>>(
      p, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, qs, ks, vs, os);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const Problem& p, const void* q, const void* k, const void* v, const void* d_o,
              const float* lse, const float* delta, void* dq, Strides qs, Strides ks, Strides vs,
              Strides dos, Strides dqs, cudaStream_t st) {
  auto kernel = dq_kernel<T, D>;
  if (int err = prepare(kernel, dq_floats<D>())) return err;
  const dim3 grid((p.Sq + kTile - 1) / kTile, p.H, p.B);
  kernel<<<grid, kThreads, dq_floats<D>() * 4, st>>>(
      p, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(d_o), lse, delta, static_cast<T*>(dq), qs, ks, vs, dos, dqs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const Problem& p, const void* q, const void* k, const void* v, const void* d_o,
               const float* lse, const float* delta, void* dk, void* dv, Strides qs, Strides ks,
               Strides vs, Strides dos, Strides dks, Strides dvs, cudaStream_t st) {
  auto kernel = dkv_kernel<T, D>;
  if (int err = prepare(kernel, dkv_floats<D>())) return err;
  const dim3 grid((p.Skv + kTile - 1) / kTile, p.Hkv, p.B);
  kernel<<<grid, kThreads, dkv_floats<D>() * 4, st>>>(
      p, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(d_o), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), qs, ks,
      vs, dos, dks, dvs);
  return static_cast<int>(cudaGetLastError());
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
