// In-place per-slot KV cache row update for Hopper (sm_90a):
//   cache[b, min(idx[b] + j, S - 1), :] = kv[b, j, :]   for j < K,
// touching only those rows.
//
// Replaces the TPU kernel `_kernel` / `inplace_row_update` of the JAX package
// (maxtext_indextts2_tpu/ops/inplace_update.py), which aliases the cache to
// its output so that only the target rows are written.
//
// What bounds it on this card: bytes, and at decode shapes mostly the launch
// itself -- one step moves B*K rows of `inner` elements (256 KB for 128 slots
// of 8x128 bf16), which the card's memory system moves in well under the
// time a launch takes. What the design does about it: nothing but the
// target rows is read or written (a framework scatter that rewrote the cache
// would move gigabytes), the copy uses 16-byte vector loads and stores over
// the flattened inner extent where the row starts are 16-byte aligned, with
// a scalar tail, and one launch covers every slot and span row
// (grid = (K, B)). The target row is clamped to S-1 in the kernel: an index
// past the cache is an illegal address on this card, not an error code.
//
// Two entry points: a byte copy for equal source and cache types (any
// element size), and a converting copy between float32 and bfloat16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ long long target_row(const int* idx, int b, int j, int s_len) {
  long long row = static_cast<long long>(idx[b]) + j;
  if (row < 0) row = 0;
  if (row > s_len - 1) row = s_len - 1;
  return row;
}

__global__ void __launch_bounds__(kThreads)
row_copy_bytes_kernel(uint8_t* __restrict__ cache, const uint8_t* __restrict__ kv,
                      const int* __restrict__ idx, int s_len, int k_span, long long row_bytes) {
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const long long row = target_row(idx, b, j, s_len);
  uint8_t* dst = cache + (static_cast<long long>(b) * s_len + row) * row_bytes;
  const uint8_t* src = kv + (static_cast<long long>(b) * k_span + j) * row_bytes;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15u) == 0) {
    const long long n16 = row_bytes / 16;
    const uint4* s16 = reinterpret_cast<const uint4*>(src);
    uint4* d16 = reinterpret_cast<uint4*>(dst);
    for (long long i = threadIdx.x; i < n16; i += kThreads) d16[i] = s16[i];
    done = n16 * 16;
  }
  for (long long i = done + threadIdx.x; i < row_bytes; i += kThreads) dst[i] = src[i];
}

template <typename Dst, typename Src> __device__ __forceinline__ Dst convert(Src x);
template <> __device__ __forceinline__ __nv_bfloat16 convert<__nv_bfloat16, float>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ float convert<float, __nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename Dst, typename Src>
__global__ void __launch_bounds__(kThreads)
row_copy_convert_kernel(Dst* __restrict__ cache, const Src* __restrict__ kv,
                        const int* __restrict__ idx, int s_len, int k_span, long long inner) {
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const long long row = target_row(idx, b, j, s_len);
  Dst* dst = cache + (static_cast<long long>(b) * s_len + row) * inner;
  const Src* src = kv + (static_cast<long long>(b) * k_span + j) * inner;
  for (long long i = threadIdx.x; i < inner; i += kThreads) dst[i] = convert<Dst, Src>(src[i]);
}

bool bad_grid(int b_sz, int s_len, int k_span) {
  return b_sz <= 0 || s_len <= 0 || k_span <= 0 || b_sz > 65535;
}

}  // namespace

// Equal element types: copies row_bytes bytes per (slot, span row).
extern "C" int inplace_row_update_bytes(void* cache, const void* kv, const int* idx, int b_sz,
                                        int s_len, int k_span, long long row_bytes,
                                        void* stream) {
  if (bad_grid(b_sz, s_len, k_span) || row_bytes <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  row_copy_bytes_kernel<<<dim3(k_span, b_sz), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(cache), static_cast<const uint8_t*>(kv), idx, s_len, k_span,
      row_bytes);
  return static_cast<int>(cudaGetLastError());
}

// Converting copy. direction 0: float32 rows into a bfloat16 cache;
// direction 1: bfloat16 rows into a float32 cache.
extern "C" int inplace_row_update_convert(void* cache, const void* kv, const int* idx, int b_sz,
                                          int s_len, int k_span, long long inner, int direction,
                                          void* stream) {
  if (bad_grid(b_sz, s_len, k_span) || inner <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(k_span, b_sz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (direction == 0) {
    row_copy_convert_kernel<__nv_bfloat16, float><<<grid, kThreads, 0, st>>>(
        static_cast<__nv_bfloat16*>(cache), static_cast<const float*>(kv), idx, s_len, k_span,
        inner);
  } else if (direction == 1) {
    row_copy_convert_kernel<float, __nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<float*>(cache), static_cast<const __nv_bfloat16*>(kv), idx, s_len, k_span,
        inner);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
