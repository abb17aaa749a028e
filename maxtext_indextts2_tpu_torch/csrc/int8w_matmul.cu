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
// speculative verify span). What the design does about it (bfloat16): a block
// of 4 warps covers 128 columns and up to 32 rows of y; each stage of 128 K
// rows, the block reads the weight tile coalesced (eight threads a 128-byte
// row, 16 bytes a load), dequantises it in registers with the JAX package's
// rounding points into a swizzled bf16 tile in shared memory, and each warp
// multiplies x's rows by its 32 columns on the tensor cores (`mma.sync`
// m16n8k16 bf16, float32 sums; mma_bf16.cuh). The next stage's weights are
// loaded into registers while the tensor cores work on this one. The K axis
// is split over `splits` blocks when the column tiles alone would leave SMs
// idle (a decode layer of 2048 columns has 16 tiles of 128), and a second pass
// sums the float32 partials in split order, rounds and adds the bias (one
// pass when splits == 1). Every sum runs in a fixed order: two launches give
// the same bits. float32 x (no bf16 tensor-core operand) takes a CUDA-core
// kernel: a warp a 128-column row slice, R x 4 accumulators a lane. TMA and
// `wgmma` are later work (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kCols = 128;      // columns of y a block: 4 a lane of a warp
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStage = 256;     // K rows a stage (x's rows staged in shared memory)
constexpr int kWarpRows = kStage / kWarps;  // K rows a warp takes of a stage
constexpr int kUnroll = 4;      // weight rows a lane loads before it multiplies

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

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
int8w_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ scale, const T* __restrict__ bias,
                    T* __restrict__ out, float* __restrict__ partial, int m, int k, int n,
                    int k_per_split) {
  __shared__ __align__(16) float xs[R][kStage];
  __shared__ float red[R][kCols];

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
  const bool final_pass = gridDim.z == 1;
  for (int i = threadIdx.x; i < R * kCols; i += kThreads) {
    const int r = i / kCols, c = i % kCols;
    const int row = m0 + r, cc = n0 + c;
    if (row >= m || cc >= n) continue;
    if (final_pass) {
      out[(long long)row * n + cc] = epilogue<T>(red[r][c], bias, cc);
    } else {
      partial[((long long)split * m + row) * n + cc] = red[r][c];
    }
  }
}

// ---- bfloat16: the tensor-core kernel

constexpr int kTcWarps = 4;                 // 32 columns of y each
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcDepth = 128;               // K rows a stage
constexpr int kTcLoads = kTcDepth * kCols / 16 / kTcThreads;  // 16-byte weight loads a thread

// the stage's weights in 16-byte loads: thread t takes columns 16 (t % 8) ..
// + 16 of rows t / 8 + 16 i, so that a warp's load covers 4 whole 128-byte
// rows (zeros past N or the split's rows)
constexpr int kTcPass = kTcThreads / (kCols / 16);  // rows one load of every thread covers

__device__ __forceinline__ void tc_load_weights(uint4 (&w)[kTcLoads], const int8_t* __restrict__ q,
                                                long long row0, int k_end, int col, int n,
                                                bool vec) {
#pragma unroll
  for (int i = 0; i < kTcLoads; ++i) {
    const long long row = row0 + kTcPass * i;
    if (row >= k_end || col >= n) {
      w[i] = make_uint4(0u, 0u, 0u, 0u);
    } else if (vec) {
      w[i] = __ldg(reinterpret_cast<const uint4*>(q + row * n + col));
    } else {
      unsigned b[4] = {0u, 0u, 0u, 0u};
      for (int j = 0; j < 16 && col + j < n; ++j)
        b[j / 4] |= static_cast<unsigned>(static_cast<uint8_t>(q[row * n + col + j]))
                    << (8 * (j % 4));
      w[i] = make_uint4(b[0], b[1], b[2], b[3]);
    }
  }
}

template <int RT>  // m16 row tiles a block: 16 RT rows of x
__global__ void __launch_bounds__(kTcThreads)
int8w_matmul_tc_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                       const float* __restrict__ scale, const __nv_bfloat16* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int m,
                       int k, int n, int k_per_split) {
  constexpr int kRowsTc = 16 * RT;
  // x's rows [kRowsTc][kTcDepth] and the dequantised weights as 4 warp tiles
  // [kTcDepth][32]
  __shared__ __align__(128) unsigned char xs[kRowsTc * kTcDepth * 2];
  __shared__ __align__(128) unsigned char ws[kTcWarps][kTcDepth * 32 * 2];

  const int row_tiles = (m + kRowsTc - 1) / kRowsTc;
  const int m0 = (blockIdx.x % row_tiles) * kRowsTc;  // neighbouring blocks share weight columns
  const int n0 = (blockIdx.x / row_tiles) * kCols;
  const int split = blockIdx.z;
  const int k_begin = split * k_per_split;
  const int k_end = min(k, k_begin + k_per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool q_vec = (n % 16 == 0) && ((reinterpret_cast<uintptr_t>(q) & 15u) == 0);
  const bool x_vec = (k % 8 == 0) && ((reinterpret_cast<uintptr_t>(x) & 15u) == 0);
  const int w_row = threadIdx.x / (kCols / 16), w_col = (threadIdx.x % (kCols / 16)) * 16;

  float sc[16];  // T(s) of this thread's 16 columns
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + w_col + j;
    sc[j] = col < n ? round_to<__nv_bfloat16>(scale[col]) : 0.f;
  }
  float acc[RT][4][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rt][j][e] = 0.f;

  uint4 wr[kTcLoads];
  tc_load_weights(wr, q, (long long)k_begin + w_row, k_end, n0 + w_col, n, q_vec);
  const unsigned xs_addr = hopper::smem_addr(xs);
  for (int k0 = k_begin; k0 < k_end; k0 += kTcDepth) {
    __syncthreads();  // the previous stage's tiles are read
    // x's rows of this stage: 16-byte chunks of 8 k values
    for (int i = threadIdx.x; i < kRowsTc * (kTcDepth / 8); i += kTcThreads) {
      const int r = i / (kTcDepth / 8), c = i % (kTcDepth / 8);
      const int row = m0 + r, kr = k0 + 8 * c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < m) {
        if (x_vec && kr + 8 <= k_end) {
          v = __ldg(reinterpret_cast<const uint4*>(x + (long long)row * k + kr));
        } else {
          __nv_bfloat16 e8[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            e8[e] = kr + e < k_end ? x[(long long)row * k + kr + e] : __float2bfloat16_rn(0.f);
          v = *reinterpret_cast<const uint4*>(e8);
        }
      }
      *reinterpret_cast<uint4*>(xs + hopper::swz<kTcDepth>(r, c)) = v;
    }
    // the weights loaded last stage, dequantised: T(T(q) * T(s)) as bf16. A
    // code is exact in bf16 and its product with T(s) exact in float32, so
    // this is one float32 product rounded to bf16. The code's float comes from
    // its bits (2^23 + (q + 128) as a float's bit pattern, less 2^23 + 128): no
    // int-to-float conversion, whose quarter rate would bound the kernel.
#pragma unroll
    for (int i = 0; i < kTcLoads; ++i) {
      const unsigned* words = reinterpret_cast<const unsigned*>(&wr[i]);
      float code[16];
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) {
        const unsigned biased = words[wi] ^ 0x80808080u;  // each byte q + 128
#pragma unroll
        for (int j = 0; j < 4; ++j)
          code[4 * wi + j] =
              __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + j)) - 8388736.0f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // two chunks of 8 columns
        const int cl = w_col + 8 * h;  // the block's column of the chunk
        unsigned packed[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          packed[e] = hopper::pack_bf16(code[8 * h + 2 * e] * sc[8 * h + 2 * e],
                                        code[8 * h + 2 * e + 1] * sc[8 * h + 2 * e + 1]);
        *reinterpret_cast<uint4*>(
            &ws[cl / 32][hopper::swz<32>(w_row + kTcPass * i, (cl % 32) / 8)]) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
    }
    __syncthreads();
    const int k_next = k0 + kTcDepth;
    if (k_next < k_end) {  // in flight while the tensor cores work on this stage
      tc_load_weights(wr, q, (long long)k_next + w_row, k_end, n0 + w_col, n, q_vec);
    }
    const unsigned wt = hopper::smem_addr(ws[warp]);
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      unsigned a[kTcDepth / 16][4];
      hopper::load_a<kTcDepth>(a, xs_addr, 16 * rt, lane);
      hopper::product_am<32, kTcDepth / 16>(acc[rt], a, wt, lane);
    }
  }

  // element e of fragment j: row lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2
  const bool final_pass = gridDim.z == 1;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + 16 * rt + lane / 4 + 8 * (e / 2);
        const int col = n0 + 32 * warp + 8 * j + 2 * (lane % 4) + e % 2;
        if (row >= m || col >= n) continue;
        if (final_pass) {
          out[(long long)row * n + col] = epilogue<__nv_bfloat16>(acc[rt][j][e], bias, col);
        } else {
          partial[((long long)split * m + row) * n + col] = acc[rt][j][e];
        }
      }
}

// y from the splits' float32 partials, summed in split order
template <typename T>
__global__ void __launch_bounds__(kThreads)
int8w_reduce_kernel(const float* __restrict__ partial, const T* __restrict__ bias,
                    T* __restrict__ out, long long mn, int n, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= mn) return;
  float acc = partial[i];
  for (int s = 1; s < splits; ++s) acc += partial[s * mn + i];
  out[i] = epilogue<T>(acc, bias, static_cast<int>(i % n));
}

template <typename T, int R>
int launch(const void* x, const void* q, const void* scale, const void* bias, void* out,
           void* partial, int m, int k, int n, int splits, int k_per_split, cudaStream_t st) {
  const long long tiles = static_cast<long long>((m + R - 1) / R) * ((n + kCols - 1) / kCols);
  if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  int8w_matmul_kernel<T, R><<<dim3(static_cast<unsigned>(tiles), 1, splits), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<const T*>(bias), static_cast<T*>(out), static_cast<float*>(partial), m, k, n,
      k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long mn = static_cast<long long>(m) * n;
  int8w_reduce_kernel<T><<<static_cast<unsigned>((mn + kThreads - 1) / kThreads), kThreads, 0,
                           st>>>(static_cast<const float*>(partial), static_cast<const T*>(bias),
                                 static_cast<T*>(out), mn, n, splits);
  return static_cast<int>(cudaGetLastError());
}

int launch_rows_f32(const void* x, const void* q, const void* scale, const void* bias,
                    void* out, void* partial, int m, int k, int n, int splits, int k_per_split,
                    cudaStream_t st) {
  if (m <= 8) return launch<float, 8>(x, q, scale, bias, out, partial, m, k, n, splits,
                                      k_per_split, st);
  return launch<float, 16>(x, q, scale, bias, out, partial, m, k, n, splits, k_per_split, st);
}

template <int RT>
int launch_tc(const void* x, const void* q, const void* scale, const void* bias, void* out,
              void* partial, int m, int k, int n, int splits, int k_per_split, cudaStream_t st) {
  const long long tiles =
      static_cast<long long>((m + 16 * RT - 1) / (16 * RT)) * ((n + kCols - 1) / kCols);
  if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  int8w_matmul_tc_kernel<RT><<<dim3(static_cast<unsigned>(tiles), 1, splits), kTcThreads, 0,
                               st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(partial), m, k, n, k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long mn = static_cast<long long>(m) * n;
  int8w_reduce_kernel<__nv_bfloat16><<<static_cast<unsigned>((mn + kThreads - 1) / kThreads),
                                       kThreads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), mn, n, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// is_bf16: 1 for bfloat16 x / bias / y, 0 for float32. partial: float32
// [splits, M, N] scratch (unused, may be null, when splits == 1). k_per_split:
// a multiple of 256 with splits * k_per_split >= K. bias may be null.
// bfloat16 takes the tensor-core kernel (16 rows a block for M <= 16, else
// 32), float32 the CUDA-core one (8 rows a block for M <= 8, else 16).
extern "C" int int8w_matmul(const void* x, const void* q, const void* scale, const void* bias,
                            void* out, void* partial, int m, int k, int n, int splits,
                            int k_per_split, int is_bf16, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || splits <= 0 || splits > 65535 || k_per_split <= 0 ||
      k_per_split % kStage != 0 || static_cast<long long>(splits) * k_per_split < k ||
      (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    return launch_rows_f32(x, q, scale, bias, out, partial, m, k, n, splits, k_per_split, st);
  }
  if (m <= 16) return launch_tc<1>(x, q, scale, bias, out, partial, m, k, n, splits, k_per_split,
                                   st);
  return launch_tc<2>(x, q, scale, bias, out, partial, m, k, n, splits, k_per_split, st);
}
