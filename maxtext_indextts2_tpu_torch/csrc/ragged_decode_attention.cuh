// Ragged decode attention for Hopper (sm_90a): one query token per slot, GQA,
// over each slot's first lengths[b] cache rows.
//
// Replaces the TPU kernel `_kernel_v2` / `ragged_decode_attention_v2` of the
// JAX package (maxtext_indextts2_tpu/ops/ragged_decode_attention.py) and, by
// the same function, the v1 kernel `_kernel` / `ragged_decode_attention`.
//
// What bounds it on this card: bytes. Per slot and kv head the kernel reads
// len*d K and len*d V elements once and does 4*group*len*d flops on them,
// i.e. 2*group flops per bf16 byte (group = nq/nkv, 2 for tts-1b): far below
// the ~295 flop/byte at which the tensor cores, not HBM, become the limit.
//
// What the design does about it: every K/V row inside [lo, hi) is read
// exactly once, in 16-byte (f32, bf16) or 8-byte (int8) vector loads along d;
// all `group` query heads of one kv head live in one block, so that head's
// K/V is read once for the whole group; rows outside the slot's valid range
// (or outside its sliding window) are never touched, so an empty slot costs
// one block launch and no traffic. The math is done in float32 registers:
// no tensor cores, no shared-memory staging, no split over the KV axis --
// those are for a later change; this kernel is the simple one that is right.
//
// Layout: grid = (nkv, B), block = 128 threads = 4 warps. A row of d
// elements is covered by TPR = min(32, d/EPT0) neighbouring lanes (EPT0 = 8
// elements for bf16/int8, 4 for f32), each holding EPT = d/TPR elements of q
// (per query head), of the K/V row and of the accumulator. A warp therefore
// works on 32/TPR rows at a time, a block on NG = 4*32/TPR, and each such
// lane group walks rows lo+gid, lo+gid+NG, ... in tiles of UNROLL rows with
// its own online-softmax state (m, l, acc) per query head. At the end the
// states are merged: across the lane groups of a warp with shuffles, across
// the four warps through shared memory.
//
// Numerics: scores are scaled by 1/sqrt(d) (times k_scale[b,row,h] for int8
// K); running max, sum and accumulator are float32; probabilities stay
// float32 for the PV product (the TPU kernel rounds them to v's dtype; the
// plain PyTorch version beside the wrapper keeps float32 like this kernel);
// v_scale multiplies the probabilities after they were summed into l; the
// result is acc / max(l, 1e-30) in the output dtype. A slot with length 0
// (or an empty window) gets zeros -- never NaN, and row 0 is never read.
//
// Where a row lies is a template argument (`Rows`): DenseRows below for the
// [B, S, nkv, D] cache of this kernel, PagedRows (paged_decode_attention.cuh)
// for the page pools of K4. Everything else is the same kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rda {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr float kNegInf = -1e30f;

template <typename T> struct KvTraits;
template <> struct KvTraits<float> { static constexpr int ept0 = 4; };
template <> struct KvTraits<__nv_bfloat16> { static constexpr int ept0 = 8; };
template <> struct KvTraits<int8_t> { static constexpr int ept0 = 8; };

// Load N consecutive elements (N*sizeof(T) is a multiple of the vector width
// and the address is aligned to it) and widen them to float.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
    out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p + i));
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // a bf16 is the high half of the float with the same value
      out[i + 2 * j] = __uint_as_float(w[j] << 16);
      out[i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

template <int N>
__device__ __forceinline__ void load_row(const int8_t* p, float (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p + i));
    const uint32_t w[2] = {raw.x, raw.y};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        out[i + 4 * j + b] =
            static_cast<float>(static_cast<int8_t>((w[j] >> (8 * b)) & 0xffu));
      }
    }
  }
}

// Row `row` of slot b of a [B, S, nkv, D] cache is buffer row b*S + row. A
// buffer row holds nkv*D elements; the scale of (buffer row, h) is at
// buffer_row*nkv + h.
struct DenseRows {
  int s_len;
  __device__ __forceinline__ size_t operator()(int b, int row) const {
    return static_cast<size_t>(b) * s_len + row;
  }
};

__device__ __forceinline__ float load_q(const void* q, size_t i, bool is_bf16) {
  return is_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(q)[i])
                 : reinterpret_cast<const float*>(q)[i];
}

__device__ __forceinline__ void store_out(void* o, size_t i, float v, bool is_bf16) {
  if (is_bf16) {
    reinterpret_cast<__nv_bfloat16*>(o)[i] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<float*>(o)[i] = v;
  }
}

// D: head dim; KV: cache element type; GP: query heads per kv head, padded
// to a power of two (heads g >= group are skipped at run time); Rows: the
// buffer row of (slot, cache row). Lengths are clamped to [0, max_len].
template <int D, typename KV, int GP, typename Rows>
__global__ void __launch_bounds__(kThreads)
ragged_decode_kernel(const void* __restrict__ q,            // [B, nq, D] f32|bf16
                     const KV* __restrict__ k,              // buffer rows of nkv*D
                     const KV* __restrict__ v,
                     const int* __restrict__ lengths,       // [B]
                     const float* __restrict__ k_scale,     // [buffer rows, nkv] or null
                     const float* __restrict__ v_scale,
                     void* __restrict__ out,                // [B, nq, D] f32|bf16
                     Rows rows, int max_len, int nkv, int group, int sliding_window,
                     float scale, int q_is_bf16, int out_is_bf16) {
  constexpr int EPT0 = KvTraits<KV>::ept0;
  constexpr int TPR = (D / EPT0 > 32) ? 32 : D / EPT0;  // lanes per row
  constexpr int EPT = D / TPR;                          // elements per lane
  constexpr int RPW = 32 / TPR;                         // rows per warp at a time
  constexpr int NG = kWarps * RPW;                      // lane groups per block

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int sub = lane % TPR;                  // which slice of the row
  const int gid = warp * RPW + lane / TPR;     // lane group within the block
  const int nq = nkv * group;

  int length = lengths[b];
  length = length < 0 ? 0 : (length > max_len ? max_len : length);
  const int hi = length;
  int lo = 0;
  if (sliding_window > 0) lo = length - sliding_window > 0 ? length - sliding_window : 0;

  const size_t q_base = (static_cast<size_t>(b) * nq + static_cast<size_t>(h) * group) * D;

  if (hi <= lo) {  // empty slot: zeros, and no K/V row is read
    for (int i = tid; i < group * D; i += kThreads) {
      store_out(out, q_base + i, 0.0f, out_is_bf16);
    }
    return;
  }

  float qf[GP][EPT];
  float acc[GP][EPT];
  float m[GP], l[GP];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      acc[g][e] = 0.0f;
      qf[g][e] = (g < group)
                     ? load_q(q, q_base + static_cast<size_t>(g) * D + sub * EPT + e, q_is_bf16) * scale
                     : 0.0f;
    }
  }

  const size_t row_stride = static_cast<size_t>(nkv) * D;  // elements between rows
  const size_t kv_col = static_cast<size_t>(h) * D + sub * EPT;  // within a buffer row
  const bool quantized = k_scale != nullptr;

  const int n_rows = hi - lo;
  const int n_iter = (n_rows + NG * kUnroll - 1) / (NG * kUnroll);  // uniform per block
  for (int it = 0; it < n_iter; ++it) {
    float kf[kUnroll][EPT];
    float vf[kUnroll][EPT];
    float ks[kUnroll], vs[kUnroll];
    bool ok[kUnroll];
    // issue all loads of the tile first: 2*kUnroll independent vector loads
    // per lane are in flight before the first one is used
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = lo + (it * kUnroll + u) * NG + gid;
      ok[u] = row < hi;
      ks[u] = 1.0f;
      vs[u] = 1.0f;
      if (ok[u]) {
        const size_t buf_row = rows(b, row);
        const size_t off = buf_row * row_stride + kv_col;
        load_row<EPT>(k + off, kf[u]);
        load_row<EPT>(v + off, vf[u]);
        if (quantized) {
          ks[u] = __ldg(k_scale + buf_row * nkv + h);
          vs[u] = __ldg(v_scale + buf_row * nkv + h);
        }
      } else {
#pragma unroll
        for (int e = 0; e < EPT; ++e) { kf[u][e] = 0.0f; vf[u][e] = 0.0f; }
      }
    }

#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (g < group) {
        float s[kUnroll];
        float m_tile = kNegInf;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float part = 0.0f;
#pragma unroll
          for (int e = 0; e < EPT; ++e) part = fmaf(qf[g][e], kf[u][e], part);
#pragma unroll
          for (int off = TPR / 2; off > 0; off >>= 1) {
            part += __shfl_xor_sync(0xffffffffu, part, off);
          }
          s[u] = ok[u] ? part * ks[u] : kNegInf;
          m_tile = fmaxf(m_tile, s[u]);
        }
        const float m_new = fmaxf(m[g], m_tile);
        const float alpha = expf(m[g] - m_new);  // 1 when nothing was valid yet
        float p[kUnroll];
        float p_sum = 0.0f;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          p[u] = ok[u] ? expf(s[u] - m_new) : 0.0f;
          p_sum += p[u];
          p[u] *= vs[u];  // v scale folds in AFTER l has summed the true p
        }
        l[g] = l[g] * alpha + p_sum;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          float a = acc[g][e] * alpha;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) a = fmaf(p[u], vf[u][e], a);
          acc[g][e] = a;
        }
      }
    }
  }

  // merge the lane groups of this warp (lanes with equal `sub`)
#pragma unroll
  for (int off = TPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (g < group) {
        const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
        const float m_new = fmaxf(m[g], m_o);
        const float c_self = expf(m[g] - m_new);
        const float c_o = expf(m_o - m_new);
        l[g] = l[g] * c_self + l_o * c_o;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          const float a_o = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
          acc[g][e] = acc[g][e] * c_self + a_o * c_o;
        }
      }
    }
  }

  // merge the warps through shared memory
  __shared__ float sm_m[kWarps][GP];
  __shared__ float sm_l[kWarps][GP];
  __shared__ float sm_acc[kWarps][GP][D];
  if (lane < TPR) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (g < group) {
        if (lane == 0) { sm_m[warp][g] = m[g]; sm_l[warp][g] = l[g]; }
#pragma unroll
        for (int e = 0; e < EPT; ++e) sm_acc[warp][g][sub * EPT + e] = acc[g][e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < group * D; i += kThreads) {
    const int g = i / D;
    const int e = i - g * D;
    float m_tot = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_tot = fmaxf(m_tot, sm_m[w][g]);
    float l_tot = 0.0f, a_tot = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - m_tot);
      l_tot += sm_l[w][g] * c;
      a_tot += sm_acc[w][g][e] * c;
    }
    store_out(out, q_base + i, a_tot / fmaxf(l_tot, 1e-30f), out_is_bf16);
  }
}

template <int D, typename KV, int GP, typename Rows>
inline cudaError_t launch_one(const void* q, const void* k, const void* v, const int* lengths,
                              const float* k_scale, const float* v_scale, void* out, int b_sz,
                              Rows rows, int max_len, int nkv, int group, int sliding_window,
                              float scale, int q_is_bf16, int out_is_bf16, cudaStream_t stream) {
  const dim3 grid(nkv, b_sz);
  ragged_decode_kernel<D, KV, GP, Rows><<<grid, kThreads, 0, stream>>>(
      q, static_cast<const KV*>(k), static_cast<const KV*>(v), lengths, k_scale, v_scale, out,
      rows, max_len, nkv, group, sliding_window, scale, q_is_bf16, out_is_bf16);
  return cudaGetLastError();
}

template <int D, typename KV, typename Rows>
inline cudaError_t launch_group(const void* q, const void* k, const void* v, const int* lengths,
                                const float* k_scale, const float* v_scale, void* out, int b_sz,
                                Rows rows, int max_len, int nkv, int group, int sliding_window,
                                float scale, int q_is_bf16, int out_is_bf16,
                                cudaStream_t stream) {
#define RDA_ARGS q, k, v, lengths, k_scale, v_scale, out, b_sz, rows, max_len, nkv, group, \
                 sliding_window, scale, q_is_bf16, out_is_bf16, stream
  if (group == 1) return launch_one<D, KV, 1>(RDA_ARGS);
  if (group == 2) return launch_one<D, KV, 2>(RDA_ARGS);
  if (group <= 4) return launch_one<D, KV, 4>(RDA_ARGS);
  if (group <= 8) return launch_one<D, KV, 8>(RDA_ARGS);
  return cudaErrorInvalidValue;
#undef RDA_ARGS
}

// Dispatches on head_dim and group for any row layout. Returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for a shape no
// instantiation takes). Does not synchronise and allocates nothing.
template <typename KV, typename Rows>
inline int launch_rows(const void* q, const void* k, const void* v, const int* lengths,
                       const float* k_scale, const float* v_scale, void* out, int b_sz,
                       Rows rows, int max_len, int nkv, int group, int head_dim,
                       int sliding_window, float scale, int q_is_bf16, int out_is_bf16,
                       void* stream) {
  if (b_sz <= 0 || nkv <= 0 || b_sz > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RDA_ARGS q, k, v, lengths, k_scale, v_scale, out, b_sz, rows, max_len, nkv, group, \
                 sliding_window, scale, q_is_bf16, out_is_bf16, st
  switch (head_dim) {
    case 32: return static_cast<int>(launch_group<32, KV>(RDA_ARGS));
    case 64: return static_cast<int>(launch_group<64, KV>(RDA_ARGS));
    case 128: return static_cast<int>(launch_group<128, KV>(RDA_ARGS));
    case 256: return static_cast<int>(launch_group<256, KV>(RDA_ARGS));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RDA_ARGS
}

// One entry per cache element type, over a [B, S, nkv, D] cache.
template <typename KV>
inline int launch(const void* q, const void* k, const void* v, const int* lengths,
                  const float* k_scale, const float* v_scale, void* out, int b_sz, int s_len,
                  int nkv, int group, int head_dim, int sliding_window, float scale,
                  int q_is_bf16, int out_is_bf16, void* stream) {
  return launch_rows<KV>(q, k, v, lengths, k_scale, v_scale, out, b_sz, DenseRows{s_len},
                         s_len, nkv, group, head_dim, sliding_window, scale, q_is_bf16,
                         out_is_bf16, stream);
}

}  // namespace rda
