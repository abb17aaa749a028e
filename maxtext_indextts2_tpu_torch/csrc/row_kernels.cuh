// Row kernels of the S2A denoiser for Hopper (sm_90a): one pass over the rows
// of a [rows, D] float32 / bfloat16 tensor with a row reduction.
//
//   ada_rmsnorm:           out = x * rsqrt(mean(x^2) + 1e-6) * w[b]    (norm_rows_kernel)
//   ada_rmsnorm_quantize:  ada_rmsnorm's output (rounded to x's type),
//                          then row_quantize_int8                       (norm_rows_kernel)
//   row_quantize_int8:     s = max|x| / 127, q = rint(x / max(s, 1e-9)) (row_kernel, kQuant)
//   silu_mul_quantize:     g * sigmoid(g) * u in g's type, then kQuant  (row_kernel, kSiluQuant)
//
// Replaces the TPU kernels `ada_rmsnorm` (maxtext_indextts2_tpu/ops/ada_rmsnorm.py)
// and `row_quantize_int8`, `ada_rmsnorm_quantize`, `silu_mul_quantize`
// (maxtext_indextts2_tpu/ops/quant_kernels.py). Those cut the rows into blocks
// sized for the TPU's on-chip memory and need D % 128 == 0; none of that is
// carried over.
//
// What bounds it on this card: bytes. Each function does a handful of
// operations per element and a row reduction, so the least time is the input
// read once plus the output written once over the memory rate.
//
// What the design does about it.
// norm_rows_kernel (ada_rmsnorm, ada_rmsnorm_quantize): a warp owns a row and
// holds it in registers. Lane l loads the row's 16-byte chunks l, l + 32,
// l + 64, ... (coalesced, one load instruction a chunk), so x is read from
// device memory once; the sum of squares and the abs-max are five
// `__shfl_xor_sync` steps each; there is no shared memory and no barrier, and
// the normalized row never leaves the registers: ada_rmsnorm stores it,
// ada_rmsnorm_quantize quantizes it there and stores 8 (4) codes a chunk and
// the row's scale. A warp walks consecutive rows and one wave of warps covers
// the card (the wrapper sizes it from the occupancy calculator): the latency
// of a row's loads hides behind the other warps of its SM. (Loading the next
// row before this row's reductions was measured slower: the second row's
// registers cost warps an SM.) w[b], rounded to x's type, stays in registers
// while the rows of one batch entry pass and is read again (from the L2) only
// when the batch entry changes. Rows wider than one
// warp's registers (8 chunks a lane: D > 2048 bfloat16 / 1024 float32) are
// split over up to 8 warps of a block, which merge each reduction through one
// shared-memory exchange of one float a warp; rows wider still are walked in
// rounds of 8 warps' registers and read again from memory (the L2) for each
// pass. The launch shape (chunks a lane, warps a row, rows a warp) comes from
// static shapes only: ops/ada_rmsnorm.py `norm_row_shape`, `rows_per_worker`.
// row_kernel (row_quantize_int8, silu_mul_quantize): one thread block per row;
// each thread loads its elements with 16-byte loads when the rows are 16-byte
// aligned, with a scalar path for any other D, and keeps them in shared memory
// between the abs-max and the store.
//
// Arithmetic order is the contract (it decides the int8 codes): variance in
// float32, sum / D a division (only the order of the float32 sum of squares
// is free); the rsqrt factor rounded to x's type before it multiplies x, that
// product rounded, then times w rounded to x's type; the sigmoid in float32
// rounded to g's type, g * sig rounded, * u rounded; amax / 127 and
// y / max(s, 1e-9) are divisions; rounding is half-to-even. Each reduction
// runs in a fixed order, so two launches give bitwise-equal outputs. Not built
// with --use_fast_math.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rowk {

enum Mode { kQuant = 1, kSiluQuant = 3 };

constexpr float kEps = 1e-6f;
constexpr int kMaxSharedBytes = 227 * 1024;

template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int kVec = 4;  // elements per 16-byte load
  static __device__ __forceinline__ float to_f(float x) { return x; }
  // a float32 value rounded to T, as float32
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
  static __device__ __forceinline__ void load(const float* p, float (&a)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&a)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  }
};

template <> struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&a)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // bfloat16 is the high half of a float32
      a[2 * j] = __uint_as_float(w[j] << 16);
      a[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&a)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // the values are already bfloat16-exact
      w[j] = (__float_as_uint(a[2 * j]) >> 16) | (__float_as_uint(a[2 * j + 1]) & 0xffff0000u);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Sum or max (of non-negative values) over the block; every thread gets it.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, other) : v + other;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  __syncthreads();  // an earlier reduction may still be read
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < n_warps ? red[lane] : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, other) : v + other;
  }
  return v;
}

template <typename T>
__device__ __forceinline__ float silu_mul(float g, float u) {
  const float sig = Elem<T>::round(1.0f / (1.0f + expf(-g)));
  return Elem<T>::round(Elem<T>::round(g * sig) * u);
}

__device__ __forceinline__ int8_t quantize(float y, float denom) {
  return static_cast<int8_t>(__float2int_rn(y / denom));
}

// One block per row. x (and u for kSiluQuant) [rows, D]; q [rows, D] int8 and
// scales [rows]. `vec_ok`: D is a multiple of the vector width and every base
// is 16-byte aligned (8 / 4 bytes for q), so every row start is too.
template <typename T, int kMode>
__global__ void __launch_bounds__(256)
row_kernel(const T* __restrict__ x, const T* __restrict__ u, int8_t* __restrict__ q,
           float* __restrict__ scales, int d, int vec_ok) {
  constexpr int kVec = Elem<T>::kVec;
  extern __shared__ float row[];  // d floats: this row between the passes
  __shared__ float red[32];

  const long long r = blockIdx.x;
  const T* xr = x + r * d;
  const int n_vec = vec_ok ? d / kVec : 0;
  const int tail = n_vec * kVec;

  // pass 1: load (and activate), keep, and take the abs-max
  float acc = 0.0f;
  for (int v = threadIdx.x; v < n_vec; v += blockDim.x) {
    float a[kVec];
    Elem<T>::load(xr + v * kVec, a);
    if (kMode == kSiluQuant) {
      float b[kVec];
      Elem<T>::load(u + r * d + v * kVec, b);
#pragma unroll
      for (int j = 0; j < kVec; ++j) a[j] = silu_mul<T>(a[j], b[j]);
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      row[v * kVec + j] = a[j];
      acc = fmaxf(acc, fabsf(a[j]));
    }
  }
  for (int i = tail + threadIdx.x; i < d; i += blockDim.x) {
    float a = Elem<T>::to_f(xr[i]);
    if (kMode == kSiluQuant) a = silu_mul<T>(a, Elem<T>::to_f(u[r * d + i]));
    row[i] = a;
    acc = fmaxf(acc, fabsf(a));
  }
  const float amax = block_reduce<true>(acc, red);

  // last pass: quantize and store
  const float scale = amax / 127.0f;
  if (threadIdx.x == 0) scales[r] = scale;
  const float denom = fmaxf(scale, 1e-9f);
  int8_t* qr = q + r * d;
  for (int v = threadIdx.x; v < n_vec; v += blockDim.x) {
    uint32_t packed[kVec / 4];
#pragma unroll
    for (int j = 0; j < kVec / 4; ++j) {
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int8_t c = quantize(row[v * kVec + 4 * j + k], denom);
        word |= static_cast<uint32_t>(static_cast<uint8_t>(c)) << (8 * k);
      }
      packed[j] = word;
    }
    if (kVec == 8) {
      *reinterpret_cast<uint2*>(qr + v * kVec) = make_uint2(packed[0], packed[kVec / 4 - 1]);
    } else {
      *reinterpret_cast<uint32_t*>(qr + v * kVec) = packed[0];
    }
  }
  for (int i = tail + threadIdx.x; i < d; i += blockDim.x) qr[i] = quantize(row[i], denom);
}

inline bool aligned(const void* p, uintptr_t n) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

template <typename T, int kMode>
int launch(const void* x, const void* u, void* q, void* scales, long long rows, int d,
           void* stream) {
  if (rows <= 0 || rows > 2147483647LL || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = static_cast<size_t>(d) * sizeof(float);
  if (shared > static_cast<size_t>(kMaxSharedBytes)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = row_kernel<T, kMode>;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr int kVec = Elem<T>::kVec;
  const int vec_ok = d % kVec == 0 && aligned(x, 16) && aligned(u, 16) && aligned(q, kVec);
  const int per_thread = vec_ok ? kVec : 1;
  int threads = 32;
  while (threads < 256 && threads * per_thread < d) threads *= 2;
  kernel<<<static_cast<unsigned>(rows), threads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(u), static_cast<int8_t*>(q),
      static_cast<float*>(scales), d, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0: float32, 1: bfloat16
template <int kMode>
int dispatch(int dtype, const void* x, const void* u, void* q, void* scales, long long rows,
             int d, void* stream) {
  if (dtype == 0) return launch<float, kMode>(x, u, q, scales, rows, d, stream);
  if (dtype == 1) return launch<__nv_bfloat16, kMode>(x, u, q, scales, rows, d, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// norm_rows_kernel: ada_rmsnorm and ada_rmsnorm_quantize, a row in registers.

constexpr int kMaxChunks = 8;       // 16-byte chunks a lane holds: the register cap
constexpr int kMaxWarpsPerRow = 8;  // warps that split one row (one block)
constexpr int kWarpsPerBlock = 4;   // warps of a block when each owns its rows

// A 16-byte chunk of a row in registers, as four 32-bit words: 8 bfloat16
// (element 2i in the low half of word i, 2i + 1 in the high half) or 4 float32.
template <typename T> struct Chunk;

template <> struct Chunk<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ float get(const uint32_t (&c)[4], int e) {
    return __uint_as_float(c[e]);
  }
  static __device__ __forceinline__ void place(uint32_t (&c)[4], int e, uint32_t v) { c[e] = v; }
  static __device__ __forceinline__ uint32_t bits_of(const uint32_t (&c)[4], int e) { return c[e]; }
};

template <> struct Chunk<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float get(const uint32_t (&c)[4], int e) {
    return __uint_as_float((e & 1) ? (c[e >> 1] & 0xffff0000u) : (c[e >> 1] << 16));
  }
  static __device__ __forceinline__ void place(uint32_t (&c)[4], int e, uint32_t v) {
    c[e >> 1] |= (e & 1) ? (v << 16) : v;
  }
  static __device__ __forceinline__ uint32_t bits_of(const uint32_t (&c)[4], int e) {
    return (e & 1) ? c[e >> 1] >> 16 : c[e >> 1] & 0xffffu;
  }
};

// Where a thread's chunks lie in a row. With `vec` (D a multiple of the
// chunk's elements, 16-byte-aligned rows) chunk k is the row's 16-byte chunk
// base + t + k * stride; otherwise (any D, any alignment) element e of chunk
// k is the row's element base * kVec + t + (k * kVec + e) * stride, so that
// each scalar load of a warp still reads 32 neighbouring elements. `base` is
// the first chunk of a round (0 where the row fits the registers).
struct Place {
  int t, stride, base, n_chunks, d, vec;
  __device__ __forceinline__ int chunk(int k) const { return base + t + k * stride; }
  template <int kVec>
  __device__ __forceinline__ int element(int k, int e) const {
    return base * kVec + t + (k * kVec + e) * stride;
  }
};

// Two float32 values rounded to bfloat16 (to nearest even) in one instruction,
// packed as a word of a bfloat16 chunk.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The bits of one element at p, as they sit in a chunk's word.
__device__ __forceinline__ uint32_t load_bits(const float* p) { return __float_as_uint(__ldg(p)); }
__device__ __forceinline__ uint32_t load_bits(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

// This thread's chunks of a row into c; what lies past the row is zeros.
template <typename T, int kChunks>
__device__ __forceinline__ void load_chunks(uint32_t (&c)[kChunks][4], const T* row,
                                            const Place& p) {
  constexpr int kVec = Chunk<T>::kVec;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    c[k][0] = c[k][1] = c[k][2] = c[k][3] = 0u;
    if (p.vec) {
      if (p.chunk(k) >= p.n_chunks) continue;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + p.chunk(k) * kVec));
      c[k][0] = v.x; c[k][1] = v.y; c[k][2] = v.z; c[k][3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int i = p.element<kVec>(k, e);
        if (i < p.d) Chunk<T>::place(c[k], e, load_bits(row + i));
      }
    }
  }
}

// w's chunks rounded to T (W is T or float32).
template <typename T, typename W, int kChunks>
__device__ __forceinline__ void load_scale(uint32_t (&c)[kChunks][4], const W* row,
                                           const Place& p) {
  if constexpr (sizeof(T) == sizeof(W)) {
    load_chunks<T, kChunks>(c, row, p);
  } else {  // bfloat16 rows, float32 w: 8 floats a chunk, rounded in pairs
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.0f;
      if (p.vec) {
        if (p.chunk(k) < p.n_chunks) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(row + p.chunk(k) * 8));
          const float4 b = __ldg(reinterpret_cast<const float4*>(row + p.chunk(k) * 8 + 4));
          f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
          f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = p.element<8>(k, e);
          if (i < p.d) f[e] = __ldg(row + i);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) c[k][i] = pack_bf16x2(f[2 * i], f[2 * i + 1]);
    }
  }
}

// Four partial sums of squares a thread (element m of its chunks into
// acc[m % 4]), so that the chain of dependent adds is a quarter as long.
template <typename T, int kChunks>
__device__ __forceinline__ void sum_squares(const uint32_t (&c)[kChunks][4], float (&acc)[4]) {
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
#pragma unroll
    for (int e = 0; e < Chunk<T>::kVec; ++e) {
      const float v = Chunk<T>::get(c[k], e);
      acc[e & 3] = fmaf(v, v, acc[e & 3]);
    }
  }
}

// max(m, |y|) over this thread's chunks (the order of a max does not matter);
// bfloat16 pairs compare as bfloat16 pairs.
template <typename T, int kChunks>
__device__ __forceinline__ float abs_max(const uint32_t (&c)[kChunks][4], float m) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) m = fmaxf(m, fabsf(Chunk<T>::get(c[k], e)));
    }
    return m;
  } else {
    __nv_bfloat162 m2 = __floats2bfloat162_rn(0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        m2 = __hmax2(m2, __habs2(*reinterpret_cast<const __nv_bfloat162*>(&c[k][i])));
      }
    }
    return fmaxf(m, fmaxf(__low2float(m2), __high2float(m2)));
  }
}

// In place: x -> round_T(round_T(x * factor) * w), w already rounded to T.
template <typename T, int kChunks>
__device__ __forceinline__ void normalize(uint32_t (&c)[kChunks][4],
                                          const uint32_t (&w)[kChunks][4], float factor) {
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        c[k][i] = __float_as_uint(__fmul_rn(__fmul_rn(__uint_as_float(c[k][i]), factor),
                                            __uint_as_float(w[k][i])));
      } else {
        const uint32_t xf = pack_bf16x2(__uint_as_float(c[k][i] << 16) * factor,
                                        __uint_as_float(c[k][i] & 0xffff0000u) * factor);
        c[k][i] = pack_bf16x2(
            __uint_as_float(xf << 16) * __uint_as_float(w[k][i] << 16),
            __uint_as_float(xf & 0xffff0000u) * __uint_as_float(w[k][i] & 0xffff0000u));
      }
    }
  }
}

template <typename T, int kChunks>
__device__ __forceinline__ void store_chunks(T* row, const uint32_t (&c)[kChunks][4],
                                             const Place& p) {
  constexpr int kVec = Chunk<T>::kVec;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    if (p.vec) {
      if (p.chunk(k) < p.n_chunks) {
        *reinterpret_cast<uint4*>(row + p.chunk(k) * kVec) =
            make_uint4(c[k][0], c[k][1], c[k][2], c[k][3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int i = p.element<kVec>(k, e);
        if (i >= p.d) continue;
        if constexpr (sizeof(T) == 4) {
          reinterpret_cast<uint32_t*>(row)[i] = Chunk<T>::bits_of(c[k], e);
        } else {
          reinterpret_cast<unsigned short*>(row)[i] =
              static_cast<unsigned short>(Chunk<T>::bits_of(c[k], e));
        }
      }
    }
  }
}

// rint(v) as int8 bits in the low byte, half to even, for |v| < 2**22:
// adding 1.5 * 2**23 leaves a sum whose unit is 1, so the add's own rounding
// to nearest even rounds v, and the integer sits in the mantissa's low bits.
// Equal to __float2int_rn(v) on that range (|v| <= 127 here).
__device__ __forceinline__ uint32_t code_bits(float v) {
  return __float_as_uint(__fadd_rn(v, 12582912.0f));
}

// Four codes' low bytes packed into one word, first in the lowest byte.
__device__ __forceinline__ uint32_t pack_codes(uint32_t a, uint32_t b, uint32_t c, uint32_t e) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, e, 0x0040), 0x5410);
}

// The int8 codes of this thread's chunks: rint(y / denom), an IEEE division.
template <typename T, int kChunks>
__device__ __forceinline__ void store_codes(int8_t* row, const uint32_t (&c)[kChunks][4],
                                            float denom, const Place& p) {
  constexpr int kVec = Chunk<T>::kVec;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    if (p.vec && p.chunk(k) >= p.n_chunks) continue;
    uint32_t code[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) code[e] = code_bits(Chunk<T>::get(c[k], e) / denom);
    if (p.vec) {
      if constexpr (kVec == 8) {
        *reinterpret_cast<uint2*>(row + p.chunk(k) * 8) =
            make_uint2(pack_codes(code[0], code[1], code[2], code[3]),
                       pack_codes(code[4], code[5], code[6], code[7]));
      } else {
        *reinterpret_cast<uint32_t*>(row + p.chunk(k) * 4) =
            pack_codes(code[0], code[1], code[2], code[3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int i = p.element<kVec>(k, e);
        if (i < p.d) row[i] = static_cast<int8_t>(code[e] & 0xffu);
      }
    }
  }
}

// A row's sum or max: five xor-shuffle steps (every lane ends with the same
// bits), then, where warps split the row, one exchange of one float a warp
// through `slot`, read back in warp order. Each call site has its own slot
// for each of two consecutive rows, so one barrier a reduction is enough.
template <bool kMax>
__device__ __forceinline__ float row_reduce(float v, int warps_per_row, float* slot) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, other) : v + other;
  }
  if (warps_per_row == 1) return v;
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
  __syncthreads();
  v = slot[0];
  for (int i = 1; i < warps_per_row; ++i) v = kMax ? fmaxf(v, slot[i]) : v + slot[i];
  return v;
}

// x [rows, D] (T), w [rows / s_len, D] (W: T or float32); out [rows, D] (T)
// without kQuant, q [rows, D] int8 and scales [rows] float32 with it.
// A worker (a warp, or with warps_per_row > 1 a block of that many warps)
// takes rows_per_worker consecutive rows; thread t of a worker holds kChunks
// chunks of a row, where `Place` puts them. kRounds: the row is wider than
// that and is walked in rounds of kChunks chunks a thread, read from memory
// again for each pass. `vec`: D is a multiple of the chunk's elements and
// every base is 16-byte aligned (q: 8 / 4 bytes).
// The launch bound's blocks an SM: up to 4 chunks a lane, 3 of 256 threads,
// which caps registers at 85 so that an SM holds 6 blocks of 4 warps
// (uncapped, ptxas took 89-155 and ada_rmsnorm_quantize's main path was 8 %
// slower); 8 chunks, 1 (with no count, ptxas capped one instantiation at 64
// registers and spilled).
template <typename T, typename W, bool kQuantize, int kChunks, bool kRounds>
__global__ void __launch_bounds__(kMaxWarpsPerRow * 32, kChunks <= 4 ? 3 : 1)
norm_rows_kernel(const void* __restrict__ x_, const void* __restrict__ w_,
                 void* __restrict__ out_, int8_t* __restrict__ q, float* __restrict__ scales,
                 long long rows, int s_len, int d, int vec, int warps_per_row,
                 int rows_per_worker) {
  constexpr int kVec = Chunk<T>::kVec;
  const T* x = static_cast<const T*>(x_);
  const W* w = static_cast<const W*>(w_);
  T* out = static_cast<T*>(out_);
  __shared__ float red[2][2][kMaxWarpsPerRow];  // [sum | max][row parity][warp]

  const bool split = warps_per_row > 1;
  const int stride = 32 * warps_per_row;
  const int t = split ? threadIdx.x : (threadIdx.x & 31);
  const long long worker = split ? blockIdx.x
                                 : static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                                       (threadIdx.x >> 5);
  long long r = worker * rows_per_worker;
  const long long end = r + rows_per_worker < rows ? r + rows_per_worker : rows;
  if (r >= end) return;  // the whole worker (a split block returns as one)
  const int n_chunks = vec ? d / kVec : (d + kVec - 1) / kVec;
  long long b = r / s_len;
  long long next_b = (b + 1) * s_len;  // the first row of the next batch entry

  uint32_t cur[kChunks][4], wt[kChunks][4];
  Place p{t, stride, 0, n_chunks, d, vec};
  if constexpr (!kRounds) load_scale<T, W, kChunks>(wt, w + b * d, p);
  for (int par = 0; r < end; ++r, par ^= 1) {
    const T* xr = x + r * d;
    if constexpr (!kRounds) {
      load_chunks<T, kChunks>(cur, xr, p);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      sum_squares<T>(cur, acc);
      const float ss = row_reduce<false>((acc[0] + acc[1]) + (acc[2] + acc[3]), warps_per_row,
                                         red[0][par]);
      const float factor = Elem<T>::round(rsqrtf(ss / static_cast<float>(d) + kEps));
      normalize<T>(cur, wt, factor);
      if constexpr (kQuantize) {
        const float amax = row_reduce<true>(abs_max<T>(cur, 0.0f), warps_per_row, red[1][par]);
        const float scale = amax / 127.0f;
        if (t == 0) scales[r] = scale;
        store_codes<T>(q + r * d, cur, fmaxf(scale, 1e-9f), p);
      } else {
        store_chunks<T>(out + r * d, cur, p);
      }
    } else {  // a pass over memory (the L2) for each reduction and the store
      const W* wr = w + b * d;
      const int per_round = stride * kChunks;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (p.base = 0; p.base < n_chunks; p.base += per_round) {
        load_chunks<T, kChunks>(cur, xr, p);
        sum_squares<T>(cur, acc);
      }
      const float ss = row_reduce<false>((acc[0] + acc[1]) + (acc[2] + acc[3]), warps_per_row,
                                         red[0][par]);
      const float factor = Elem<T>::round(rsqrtf(ss / static_cast<float>(d) + kEps));
      float m = 0.0f;
      for (p.base = 0; p.base < n_chunks; p.base += per_round) {
        load_chunks<T, kChunks>(cur, xr, p);
        load_scale<T, W, kChunks>(wt, wr, p);
        normalize<T>(cur, wt, factor);
        if constexpr (kQuantize) {
          m = abs_max<T>(cur, m);
        } else {
          store_chunks<T>(out + r * d, cur, p);
        }
      }
      if constexpr (kQuantize) {
        const float amax = row_reduce<true>(m, warps_per_row, red[1][par]);
        const float scale = amax / 127.0f;
        if (t == 0) scales[r] = scale;
        const float denom = fmaxf(scale, 1e-9f);
        for (p.base = 0; p.base < n_chunks; p.base += per_round) {
          load_chunks<T, kChunks>(cur, xr, p);
          load_scale<T, W, kChunks>(wt, wr, p);
          normalize<T>(cur, wt, factor);
          store_codes<T>(q + r * d, cur, denom, p);
        }
      }
    }
    if (r + 1 == next_b) {  // the next row starts a batch entry: its w, loaded
      ++b;                  // where this row's registers are free again
      next_b += s_len;
      if constexpr (!kRounds) {
        if (r + 1 < end) load_scale<T, W, kChunks>(wt, w + b * d, p);
      }
    }
  }
}

using NormKernel = void (*)(const void*, const void*, void*, int8_t*, float*, long long, int, int,
                            int, int, int);

template <typename T, typename W, bool kQuantize>
NormKernel pick_norm_chunks(int chunks, int rounds) {
  if (rounds) return chunks == kMaxChunks ? norm_rows_kernel<T, W, kQuantize, kMaxChunks, true>
                                          : nullptr;
  switch (chunks) {
    case 1: return norm_rows_kernel<T, W, kQuantize, 1, false>;
    case 2: return norm_rows_kernel<T, W, kQuantize, 2, false>;
    case 4: return norm_rows_kernel<T, W, kQuantize, 4, false>;
    case 8: return norm_rows_kernel<T, W, kQuantize, 8, false>;
    default: return nullptr;
  }
}

// dtype 0: float32 (w float32), 1: bfloat16 (w float32 or bfloat16)
template <bool kQuantize>
NormKernel pick_norm(int dtype, int w_is_f32, int chunks, int rounds) {
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && w_is_f32) return pick_norm_chunks<float, float, kQuantize>(chunks, rounds);
  if (dtype == 1 && w_is_f32) return pick_norm_chunks<bf16, float, kQuantize>(chunks, rounds);
  if (dtype == 1) return pick_norm_chunks<bf16, bf16, kQuantize>(chunks, rounds);
  return nullptr;
}

inline int norm_threads(int warps_per_row) {
  return 32 * (warps_per_row == 1 ? kWarpsPerBlock : warps_per_row);
}

// Blocks of the instantiation an SM holds at once (CUDA's occupancy calculator).
template <bool kQuantize>
int norm_occupancy(int* blocks_per_sm, int dtype, int w_is_f32, int chunks, int warps_per_row,
                   int rounds, int* threads_per_block) {
  const NormKernel kernel = pick_norm<kQuantize>(dtype, w_is_f32, chunks, rounds);
  if (kernel == nullptr || warps_per_row < 1 || warps_per_row > kMaxWarpsPerRow) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *threads_per_block = norm_threads(warps_per_row);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, reinterpret_cast<const void*>(kernel), norm_threads(warps_per_row), 0));
}

template <bool kQuantize>
int launch_norm(const void* x, const void* w, void* out, void* q, void* scales, long long rows,
                int s_len, int d, int dtype, int w_is_f32, int chunks, int warps_per_row,
                int rows_per_worker, int rounds, void* stream) {
  const NormKernel kernel = pick_norm<kQuantize>(dtype, w_is_f32, chunks, rounds);
  const int vec_elems = dtype == 0 ? 4 : 8;
  if (kernel == nullptr || rows <= 0 || d <= 0 || s_len <= 0 || rows_per_worker <= 0 ||
      warps_per_row < 1 || warps_per_row > kMaxWarpsPerRow ||
      (!rounds && 32LL * warps_per_row * chunks * vec_elems < d)) {
    return static_cast<int>(cudaErrorInvalidValue);  // the row must fit the registers
  }
  const long long per_block =
      static_cast<long long>(warps_per_row == 1 ? kWarpsPerBlock : 1) * rows_per_worker;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = d % vec_elems == 0 && aligned(x, 16) && aligned(w, 16) && aligned(out, 16) &&
                  aligned(q, vec_elems);
  kernel<<<static_cast<unsigned>(blocks), norm_threads(warps_per_row), 0,
           static_cast<cudaStream_t>(stream)>>>(x, w, out, static_cast<int8_t*>(q),
                                                static_cast<float*>(scales), rows, s_len, d, vec,
                                                warps_per_row, rows_per_worker);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rowk
