// s2a_attention for Hopper (sm_90a): non-causal softmax(q k^T) v of the S2A
// denoiser's sampler, every key < S valid, the scale already folded into q.
//
//   q, k, v  [B, S, N, D] float32 or bfloat16, any strides over B, S and N
//            (the last axis contiguous): q, k and v can be views of the
//            projection's [B, S, 3 * N * D] output, nothing is transposed
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
// shape S ~ 400, B = 1 bytes bound it (~1 us), and the launch costs more
// than the work.
// What the design does about it: one block of 256 threads per (64-query tile,
// head, batch row), the query tile in shared memory as float32, keys and
// values streamed through shared memory in tiles of 64 rows. Two passes over
// the keys keep the rounding points above: the first keeps a running max and
// rescaled sum per query (merged across the 16 threads of a row by warp
// shuffles), the second recomputes each logit tile, writes the rounded
// probabilities to shared memory and accumulates P V in registers (each
// thread 4 queries x D/16 columns). The products run on the CUDA cores in
// float32: the first version is simple and right, it does not reach the
// tensor-core bound (PERF.md has its time beside the bound). Any S >= 1
// works; rows and keys past S are zero-filled and never written or counted.
// Not built with --use_fast_math: the division and expf are IEEE-accurate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int N,
           Strides qs, Strides ks, Strides vs, cudaStream_t stream) {
  constexpr int bytes = shared_bytes<T, D>();
  auto kernel = attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kTile - 1) / kTile, N, B);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                            static_cast<const T*>(v), static_cast<T*>(out), S, N,
                                            qs, ks, vs);
  return static_cast<int>(cudaGetLastError());
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
extern "C" int s2a_attention(const void* q, const void* k, const void* v, void* out, int B, int S,
                             int N, int D, long long qsb, long long qss, long long qsn,
                             long long ksb, long long kss, long long ksn, long long vsb,
                             long long vss, long long vsn, int dtype, void* stream) {
  if (B < 1 || S < 1 || N < 1 || N > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const s2a::Strides qs{qsb, qss, qsn}, ks{ksb, kss, ksn}, vs{vsb, vss, vsn};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return s2a::dispatch_d<float>(q, k, v, out, B, S, N, D, qs, ks, vs, st);
  if (dtype == 1) return s2a::dispatch_d<__nv_bfloat16>(q, k, v, out, B, S, N, D, qs, ks, vs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
