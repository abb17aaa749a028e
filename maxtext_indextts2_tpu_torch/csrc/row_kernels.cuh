// Row kernels of the S2A denoiser for Hopper (sm_90a): one pass over the rows
// of a [rows, D] float32 / bfloat16 tensor with a row reduction.
//
//   kNorm       ada_rmsnorm:           out = x * rsqrt(mean(x^2) + 1e-6) * w[b]
//   kQuant      row_quantize_int8:     s = max|x| / 127, q = rint(x / max(s, 1e-9))
//   kNormQuant  ada_rmsnorm_quantize:  kNorm's output (rounded to x's type), then kQuant
//   kSiluQuant  silu_mul_quantize:     g * sigmoid(g) * u in g's type, then kQuant
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
// What the design does about it: one thread block per row; each thread loads
// its elements with 16-byte loads (neighbouring threads on neighbouring
// addresses) when the rows are 16-byte aligned, with a scalar path for any
// other D, and keeps them in shared memory between the reduction and the
// store, so the input is read from device memory once and the normalized /
// activated float tensor of the fused variants never exists there. Each
// thread re-reads only the shared-memory words it wrote itself, so the passes
// need no barrier beyond the block reductions (warp shuffles, then one
// shared-memory round). Scales are written as a compact [rows] float32 array.
//
// Arithmetic order is the contract (it decides the int8 codes): variance in
// float32, sum / D a division; the rsqrt factor rounded to x's type before it
// multiplies x, that product rounded, then times w rounded to x's type; the
// sigmoid in float32 rounded to g's type, g * sig rounded, * u rounded;
// amax / 127 and y / max(s, 1e-9) are divisions; rounding is half-to-even.
// Not built with --use_fast_math.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rowk {

enum Mode { kNorm = 0, kQuant = 1, kNormQuant = 2, kSiluQuant = 3 };

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

__device__ __forceinline__ float scale_at(const void* w, int w_is_f32, long long i) {
  return w_is_f32 ? static_cast<const float*>(w)[i]
                  : __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i]);
}

__device__ __forceinline__ int8_t quantize(float y, float denom) {
  return static_cast<int8_t>(__float2int_rn(y / denom));
}

// One block per row. x (and u for kSiluQuant) [rows, D]; w [rows / s_len, D];
// out [rows, D] for kNorm; q [rows, D] int8 and scales [rows] otherwise.
// `vec_ok`: D is a multiple of the vector width and every base is 16-byte
// aligned (8 / 4 bytes for q), so every row start is too.
template <typename T, int kMode>
__global__ void __launch_bounds__(256)
row_kernel(const T* __restrict__ x, const T* __restrict__ u, const void* __restrict__ w,
           int w_is_f32, T* __restrict__ out, int8_t* __restrict__ q,
           float* __restrict__ scales, int s_len, int d, int vec_ok) {
  constexpr int kVec = Elem<T>::kVec;
  constexpr bool kHasNorm = kMode == kNorm || kMode == kNormQuant;
  constexpr bool kHasQuant = kMode != kNorm;
  extern __shared__ float row[];  // d floats: this row between the passes
  __shared__ float red[32];

  const long long r = blockIdx.x;
  const T* xr = x + r * d;
  const int n_vec = vec_ok ? d / kVec : 0;
  const int tail = n_vec * kVec;

  // pass 1: load (and activate), keep, and reduce: sum of squares for the
  // norm, abs-max for the plain and silu quantizers
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
      acc = kHasNorm ? acc + a[j] * a[j] : fmaxf(acc, fabsf(a[j]));
    }
  }
  for (int i = tail + threadIdx.x; i < d; i += blockDim.x) {
    float a = Elem<T>::to_f(xr[i]);
    if (kMode == kSiluQuant) a = silu_mul<T>(a, Elem<T>::to_f(u[r * d + i]));
    row[i] = a;
    acc = kHasNorm ? acc + a * a : fmaxf(acc, fabsf(a));
  }

  float amax;
  if (kHasNorm) {
    const float var = block_reduce<false>(acc, red) / static_cast<float>(d);
    const float factor = Elem<T>::round(rsqrtf(var + kEps));
    const long long w0 = (r / s_len) * d;
    // pass 2: normalize and scale; store (kNorm) or keep and take the abs-max
    float m = 0.0f;
    for (int v = threadIdx.x; v < n_vec; v += blockDim.x) {
      float y[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int i = v * kVec + j;
        const float wv = Elem<T>::round(scale_at(w, w_is_f32, w0 + i));
        y[j] = Elem<T>::round(Elem<T>::round(row[i] * factor) * wv);
        if (kHasQuant) { row[i] = y[j]; m = fmaxf(m, fabsf(y[j])); }
      }
      if (!kHasQuant) Elem<T>::store(out + r * d + v * kVec, y);
    }
    for (int i = tail + threadIdx.x; i < d; i += blockDim.x) {
      const float wv = Elem<T>::round(scale_at(w, w_is_f32, w0 + i));
      const float y = Elem<T>::round(Elem<T>::round(row[i] * factor) * wv);
      if (kHasQuant) { row[i] = y; m = fmaxf(m, fabsf(y)); } else { out[r * d + i] = Elem<T>::from_f(y); }
    }
    if (!kHasQuant) return;
    amax = block_reduce<true>(m, red);
  } else {
    amax = block_reduce<true>(acc, red);
  }

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
int launch(const void* x, const void* u, const void* w, int w_is_f32, void* out, void* q,
           void* scales, long long rows, int s_len, int d, void* stream) {
  if (rows <= 0 || rows > 2147483647LL || d <= 0 || s_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shared = static_cast<size_t>(d) * sizeof(float);
  if (shared > static_cast<size_t>(kMaxSharedBytes)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = row_kernel<T, kMode>;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr int kVec = Elem<T>::kVec;
  const int vec_ok = d % kVec == 0 && aligned(x, 16) && aligned(u, 16) && aligned(out, 16) &&
                     aligned(q, kVec);
  const int per_thread = vec_ok ? kVec : 1;
  int threads = 32;
  while (threads < 256 && threads * per_thread < d) threads *= 2;
  kernel<<<static_cast<unsigned>(rows), threads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(u), w, w_is_f32, static_cast<T*>(out),
      static_cast<int8_t*>(q), static_cast<float*>(scales), s_len, d, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0: float32, 1: bfloat16
template <int kMode>
int dispatch(int dtype, const void* x, const void* u, const void* w, int w_is_f32, void* out,
             void* q, void* scales, long long rows, int s_len, int d, void* stream) {
  if (dtype == 0) {
    return launch<float, kMode>(x, u, w, w_is_f32, out, q, scales, rows, s_len, d, stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, kMode>(x, u, w, w_is_f32, out, q, scales, rows, s_len, d, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace rowk
