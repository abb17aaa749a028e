// Ragged decode attention for Hopper (sm_90a): one query token per slot, GQA,
// over each slot's first lengths[b] cache rows.
//
// Replaces the TPU kernel `_kernel_v2` / `ragged_decode_attention_v2` of the
// JAX package (maxtext_indextts2_tpu/ops/ragged_decode_attention.py) and, by
// the same function, the v1 kernel `_kernel` / `ragged_decode_attention`.
// With `PagedRows` (paged_decode_attention.cuh) it is also K4.
//
// What bounds it on this card: bytes. Per slot and kv head the kernel reads
// len*d K and len*d V elements once and does 4*group*len*d flops on them,
// i.e. 2*group flops per bf16 byte (group = nq/nkv, 2 for tts-1b): far below
// the ~295 flop/byte at which the tensor cores, not HBM, become the limit.
// So the kernel has to keep enough bytes in flight, on every SM, for as long
// as the call lasts -- and a decode batch is uneven: the longest slot sets
// the time if its rows are walked by one block.
//
// What the design does about it:
// - The KV axis is split across a thread-block cluster. The grid is
//   (nkv, B, C) with cluster dims (1, 1, C), C in 1..8 chosen by the wrapper
//   from static shapes only -- slots x kv heads, the cache's max length (or
//   a shorter sliding window) and how many blocks of this instantiation the
//   card holds -- never from the lengths (so the call needs no device-to-host
//   copy and a CUDA graph can capture it): the grid stays within one wave of
//   resident blocks, with at least 2 blocks a pair where the rows allow. The
//   C blocks of a cluster share one (slot, kv head); block r takes the rows
//   [lo + r*ceil(n/C), ...) of the slot's n valid rows, worked out on the
//   device from the clamped length (and window): an even split whatever the
//   slot's length. More blocks than one wave cost more than they save: every
//   block pays a fixed chain (the length, the first tile's round trip, two
//   cluster barriers), and on an H100 at 32 slots C = 8 (2048 blocks, ~3
//   waves) took 0.024 ms where C = 2 takes 0.016. A cluster of 1 is a plain
//   launch that skips the cluster barriers and the DSMEM pass.
// - Inside a block, rows arrive through a ring of kStages tiles in shared
//   memory, filled by 16-byte cp.async (int8 scales by 4-byte ones): kStages-1
//   tiles are in flight while one is computed. A ring in shared memory, not
//   register double-buffering: the copies hold no registers, so the widest
//   instantiations (group 8, float32 or int8) stay at <= 246 registers with
//   no spill. Two stages of 4-row lane-group tiles (32 rows at d = 128 bf16,
//   16 KB a stage) measured fastest among 2, 3, 4 and 6 stages of 2- and
//   4-row tiles: a deeper ring costs resident blocks, and a block of the
//   serving path holds about 4 tiles of rows in all. The compute layout is
//   the one that worked before: TPR = min(32, d/EPT0) neighbouring lanes
//   share a row (16-byte reads along d), each lane group takes kUnroll rows
//   of a tile, all `group` query heads of the kv head live in registers so
//   each K/V row is read once for the whole group, and the softmax is
//   float32 and online.
// - The partial results are merged in distributed shared memory in the same
//   launch: lane groups by shuffles, warps through the block's shared memory
//   into one (m, l, acc[group][d]) a block, then cluster.sync(); each block
//   combines the C partials of its share of the group*d outputs through
//   map_shared_rank, in rank order, and a last cluster.sync() keeps every
//   block's shared memory alive until its peers have read it. No global
//   scratch, no atomics, no second kernel: one launch a call, and the result
//   is bitwise the same from launch to launch.
// - Rows outside the slot's valid range (or outside its sliding window) are
//   never read; an empty slot or window costs the cluster one launch, writes
//   zeros, and reads no row and no page.
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
// for the page pools of K4. A copy thread walks its rows with a `Rows::Cursor`
// that steps by a fixed count of rows. Everything else is the same kernel.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "mma_bf16.cuh"

namespace rda {

namespace cg = cooperative_groups;
using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::smem_addr;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;      // rows a lane group takes from each tile
constexpr int kStages = 2;      // tiles in the ring: kStages - 1 in flight during a compute
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr float kNegInf = -1e30f;

template <typename T> struct KvTraits;
template <> struct KvTraits<float> { static constexpr int ept0 = 4; };
template <> struct KvTraits<__nv_bfloat16> { static constexpr int ept0 = 8; };
template <> struct KvTraits<int8_t> { static constexpr int ept0 = 8; };

// Sizes of one instantiation. A row of D elements is covered by TPR lanes
// holding EPT elements each; a warp holds RPW rows at a time, the block NG; a
// tile is NG * kUnroll rows of K, the same of V (and their int8 scales). The
// copies of a tile go in 16-byte pieces, CHUNKS a row, COPY_ROWS rows a round.
template <int D, typename KV, int GP>
struct Shape {
  static constexpr int TPR = (D / KvTraits<KV>::ept0 > 32) ? 32 : D / KvTraits<KV>::ept0;
  static constexpr int EPT = D / TPR;
  static constexpr int RPW = 32 / TPR;
  static constexpr int NG = kWarps * RPW;
  static constexpr int TILE = NG * kUnroll;
  static constexpr int ROW_BYTES = D * static_cast<int>(sizeof(KV));
  static constexpr int CHUNKS = ROW_BYTES / 16;
  static constexpr int COPY_ROWS = kThreads / CHUNKS;
  static constexpr int ROUNDS = TILE / COPY_ROWS;
  static constexpr bool SCALED = std::is_same<KV, int8_t>::value;
  static constexpr int STAGE_BYTES = 2 * TILE * ROW_BYTES + (SCALED ? 2 * TILE * 4 : 0);
  // after the loop the ring's memory holds the merge: the warps' partials
  // [kWarps][GP] m, l and [kWarps][GP][D] acc, then the block's [GP] m, l and
  // [GP][D] acc, which the cluster's other blocks read
  static constexpr int WARP_FLOATS = kWarps * GP * (D + 2);
  static constexpr int BLOCK_FLOATS = GP * (D + 2);
  static constexpr int RING_BYTES = kStages * STAGE_BYTES;
  static constexpr int MERGE_BYTES = (WARP_FLOATS + BLOCK_FLOATS) * 4;
  static constexpr int BYTES = RING_BYTES > MERGE_BYTES ? RING_BYTES : MERGE_BYTES;
  static_assert(ROW_BYTES % 16 == 0 && kThreads % CHUNKS == 0 && TILE % COPY_ROWS == 0,
                "rows of 16-byte pieces that the block's copy rounds tile evenly");
};

// N consecutive elements of a row in shared memory (16-byte aligned for
// float / bf16, 8-byte for int8), widened to float.
template <int N>
__device__ __forceinline__ void widen(const float* p, float (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void widen(const __nv_bfloat16* p, float (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + i);
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
__device__ __forceinline__ void widen(const int8_t* p, float (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p + i);
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
  struct Cursor {
    long long buf_row;
    int step;
    __device__ __forceinline__ long long row() { return buf_row; }
    __device__ __forceinline__ void advance() { buf_row += step; }
  };
  // the cursor at cache row `row` of slot b, stepping `step` rows at a time
  __device__ __forceinline__ Cursor at(int b, int row, int step) const {
    return Cursor{static_cast<long long>(b) * s_len + row, step};
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
// Launched as clusters of gridDim.z blocks along z (launch_one below).
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
  using S = Shape<D, KV, GP>;
  constexpr int TPR = S::TPR, EPT = S::EPT, NG = S::NG, TILE = S::TILE;
  extern __shared__ __align__(16) unsigned char smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_cta = static_cast<int>(cluster.num_blocks());
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int sub = lane % TPR;                  // which slice of the row
  const int gid = warp * S::RPW + lane / TPR;  // lane group within the block
  const int nq = nkv * group;
  const size_t q_base = (static_cast<size_t>(b) * nq + static_cast<size_t>(h) * group) * D;

  // this block's share of the kv head's group*D outputs
  const int n_out = group * D;
  const int share = (n_out + n_cta - 1) / n_cta;
  const int out_lo = rank * share;
  const int out_hi = min(n_out, out_lo + share);

  int length = __ldg(lengths + b);
  length = length < 0 ? 0 : (length > max_len ? max_len : length);
  const int hi = length;
  int lo = 0;
  if (sliding_window > 0) lo = length - sliding_window > 0 ? length - sliding_window : 0;

  if (hi <= lo) {  // empty slot, the same for the whole cluster: zeros, no row read
    for (int i = out_lo + tid; i < out_hi; i += kThreads) {
      store_out(out, q_base + i, 0.0f, out_is_bf16);
    }
    return;
  }

  // this block's rows [r0, r1): an even split of [lo, hi) over the cluster
  const int per = (hi - lo + n_cta - 1) / n_cta;
  const int r0 = min(hi, lo + rank * per);
  const int r1 = min(hi, r0 + per);
  const int n_tiles = (r1 - r0 + TILE - 1) / TILE;

  // copies: thread -> (16-byte piece, row) of each round; its rows step by
  // COPY_ROWS, tile after tile, so one cursor walks them
  const int c_piece = tid % S::CHUNKS;
  const int c_row = tid / S::CHUNKS;
  auto cursor = rows.at(b, r0 + c_row, S::COPY_ROWS);
  const size_t row_stride = static_cast<size_t>(nkv) * D;  // elements between buffer rows
  const size_t col = static_cast<size_t>(h) * D + c_piece * (16 / sizeof(KV));
  auto issue = [&](int t) {
    unsigned char* st = smem + (t % kStages) * S::STAGE_BYTES;
#pragma unroll
    for (int r = 0; r < S::ROUNDS; ++r) {
      const int j = r * S::COPY_ROWS + c_row;
      const bool ok = r0 + t * TILE + j < r1;
      const long long buf = ok ? cursor.row() : 0;
      const size_t off = static_cast<size_t>(buf) * row_stride + col;
      cp_async16(smem_addr(st + j * S::ROW_BYTES + c_piece * 16), k + off, ok);
      cp_async16(smem_addr(st + (TILE + j) * S::ROW_BYTES + c_piece * 16), v + off, ok);
      if constexpr (S::SCALED) {
        if (c_piece == 0) {
          float* sc = reinterpret_cast<float*>(st + 2 * TILE * S::ROW_BYTES);
          const size_t si = static_cast<size_t>(buf) * nkv + h;
          cp_async4(smem_addr(sc + j), k_scale + si, ok);
          cp_async4(smem_addr(sc + TILE + j), v_scale + si, ok);
        }
      }
      cursor.advance();
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) {
      issue(t);
    } else {
      cp_async_commit();  // an empty group keeps the wait count below uniform
    }
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

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed (this thread's copies) ...
    __syncthreads();               // ... and everyone's; tile t-1's stage is free
    if (t + kStages - 1 < n_tiles) {
      issue(t + kStages - 1);
    } else {
      cp_async_commit();
    }
    const unsigned char* st = smem + (t % kStages) * S::STAGE_BYTES;
    const int row0 = r0 + t * TILE;
    float kf[kUnroll][EPT];
    float vf[kUnroll][EPT];
    float ks[kUnroll], vs[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = u * NG + gid;  // neighbouring lane groups on neighbouring rows
      ok[u] = row0 + j < r1;       // rows past r1 are zeros in the ring, and masked here
      widen<EPT>(reinterpret_cast<const KV*>(st + j * S::ROW_BYTES) + sub * EPT, kf[u]);
      widen<EPT>(reinterpret_cast<const KV*>(st + (TILE + j) * S::ROW_BYTES) + sub * EPT, vf[u]);
      ks[u] = 1.0f;
      vs[u] = 1.0f;
      if constexpr (S::SCALED) {
        const float* sc = reinterpret_cast<const float*>(st + 2 * TILE * S::ROW_BYTES);
        ks[u] = sc[j];
        vs[u] = sc[TILE + j];
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
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the merge below reuses its memory

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

  // merge the warps through shared memory into the block's partial
  float* w_m = reinterpret_cast<float*>(smem);  // [kWarps][GP]
  float* w_l = w_m + kWarps * GP;               // [kWarps][GP]
  float* w_acc = w_l + kWarps * GP;             // [kWarps][GP][D]
  float* blk = w_acc + kWarps * GP * D;         // m [GP], l [GP], acc [GP][D]
  if (lane < TPR) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (g < group) {
        if (lane == 0) {
          w_m[warp * GP + g] = m[g];
          w_l[warp * GP + g] = l[g];
        }
#pragma unroll
        for (int e = 0; e < EPT; ++e) w_acc[(warp * GP + g) * D + sub * EPT + e] = acc[g][e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < n_out; i += kThreads) {
    const int g = i / D;
    const int e = i - g * D;
    float m_tot = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_tot = fmaxf(m_tot, w_m[w * GP + g]);
    float l_tot = 0.0f, a_tot = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(w_m[w * GP + g] - m_tot);
      l_tot += w_l[w * GP + g] * c;
      a_tot += w_acc[(w * GP + g) * D + e] * c;
    }
    if (n_cta == 1) {  // no peers (a launch without clusters): the block's result is final
      store_out(out, q_base + i, a_tot / fmaxf(l_tot, 1e-30f), out_is_bf16);
      continue;
    }
    blk[2 * GP + i] = a_tot;
    if (e == 0) {
      blk[g] = m_tot;
      blk[GP + g] = l_tot;
    }
  }
  if (n_cta == 1) return;

  // merge the cluster's partials in distributed shared memory: this block
  // combines its share of the outputs over the blocks of the cluster, in rank
  // order (so every launch sums in the same order)
  cluster.sync();
  for (int i = out_lo + tid; i < out_hi; i += kThreads) {
    const int g = i / D;
    float mc[kMaxCluster], lc[kMaxCluster], ac[kMaxCluster];
    float m_tot = kNegInf;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      if (c < n_cta) {
        const float* peer = cluster.map_shared_rank(blk, c);
        mc[c] = peer[g];
        lc[c] = peer[GP + g];
        ac[c] = peer[2 * GP + i];
        m_tot = fmaxf(m_tot, mc[c]);
      }
    }
    float l_tot = 0.0f, a_tot = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      if (c < n_cta) {
        const float w = expf(mc[c] - m_tot);
        l_tot += lc[c] * w;
        a_tot += ac[c] * w;
      }
    }
    store_out(out, q_base + i, a_tot / fmaxf(l_tot, 1e-30f), out_is_bf16);
  }
  cluster.sync();  // no block leaves (and frees its shared memory) while a peer reads it
}

// An instantiation whose ring needs more than 48 KB of shared memory may take
// it once the function's attribute allows it. The attribute belongs to the
// function on a device, not to a launch, so it is set once a device: a launch
// captured into a CUDA graph then makes no call but the launch itself.
constexpr int kMaxDevices = 64;

template <int D, typename KV, int GP, typename Rows>
inline cudaError_t allow_shared_memory() {
  using S = Shape<D, KV, GP>;
  if (S::BYTES <= 48 * 1024) return cudaSuccess;
  static std::atomic<bool> allowed[kMaxDevices];  // static storage: all false
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && allowed[device].load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(ragged_decode_kernel<D, KV, GP, Rows>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err == cudaSuccess && device < kMaxDevices) {
    allowed[device].store(true, std::memory_order_release);
  }
  return err;
}

// The launch configuration of one instantiation: grid (nkv, B, cluster), the
// cluster along z (none for a cluster of 1), the ring's dynamic shared memory.
template <int D, typename KV, int GP, typename Rows>
inline cudaError_t configure(int b_sz, int nkv, int cluster, cudaStream_t stream,
                             cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  using S = Shape<D, KV, GP>;
  const cudaError_t err = allow_shared_memory<D, KV, GP, Rows>();
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(nkv, b_sz, cluster);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = S::BYTES;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = cluster;
  cfg->attrs = attr;
  cfg->numAttrs = cluster > 1 ? 1 : 0;  // one block a pair: a plain launch, no cluster barriers
  return cudaSuccess;
}

template <int D, typename KV, int GP, typename Rows>
inline cudaError_t launch_one(const void* q, const void* k, const void* v, const int* lengths,
                              const float* k_scale, const float* v_scale, void* out, int b_sz,
                              Rows rows, int max_len, int nkv, int group, int sliding_window,
                              float scale, int q_is_bf16, int out_is_bf16, int cluster,
                              cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<D, KV, GP, Rows>(b_sz, nkv, cluster, stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, ragged_decode_kernel<D, KV, GP, Rows>, q,
                           static_cast<const KV*>(k), static_cast<const KV*>(v), lengths, k_scale,
                           v_scale, out, rows, max_len, nkv, group, sliding_window, scale,
                           q_is_bf16, out_is_bf16);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Calls f(D, GP) with the instantiation's head dim and padded group as
// std::integral_constant; cudaErrorInvalidValue for a shape none takes.
template <typename F>
inline cudaError_t dispatch(int head_dim, int group, F&& f) {
  auto by_group = [&](auto d) -> cudaError_t {
    if (group == 1) return f(d, std::integral_constant<int, 1>{});
    if (group == 2) return f(d, std::integral_constant<int, 2>{});
    if (group >= 3 && group <= 4) return f(d, std::integral_constant<int, 4>{});
    if (group >= 5 && group <= 8) return f(d, std::integral_constant<int, 8>{});
    return cudaErrorInvalidValue;
  };
  switch (head_dim) {
    case 32: return by_group(std::integral_constant<int, 32>{});
    case 64: return by_group(std::integral_constant<int, 64>{});
    case 128: return by_group(std::integral_constant<int, 128>{});
    case 256: return by_group(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

inline bool bad_cluster(int cluster) { return cluster < 1 || cluster > kMaxCluster; }

// Dispatches on head_dim and group for any row layout. Returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for a shape no
// instantiation takes, or a cluster size outside 1..8). A refused cluster
// launch returns its error: there is no other grid to fall back to. Does not
// synchronise and allocates nothing.
template <typename KV, typename Rows>
inline int launch_rows(const void* q, const void* k, const void* v, const int* lengths,
                       const float* k_scale, const float* v_scale, void* out, int b_sz,
                       Rows rows, int max_len, int nkv, int group, int head_dim,
                       int sliding_window, float scale, int q_is_bf16, int out_is_bf16,
                       int cluster, void* stream) {
  if (b_sz <= 0 || nkv <= 0 || b_sz > 65535 || bad_cluster(cluster)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(head_dim, group, [&](auto d, auto gp) {
    return launch_one<decltype(d)::value, KV, decltype(gp)::value, Rows>(
        q, k, v, lengths, k_scale, v_scale, out, b_sz, rows, max_len, nkv, group,
        sliding_window, scale, q_is_bf16, out_is_bf16, cluster, st);
  }));
}

// Occupancy of one instantiation on this card: the blocks an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and the clusters of
// `cluster` blocks the card holds at once (cudaOccupancyMaxActiveClusters; 0:
// such a cluster fits no GPC and its launch would be refused). The wrapper
// sizes the cluster from the first; no launch reads either.
template <typename KV, typename Rows>
inline int occupancy(int head_dim, int group, int cluster, int* blocks_per_sm,
                     int* max_clusters) {
  if (bad_cluster(cluster)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(head_dim, group, [&](auto d, auto gp) {
    constexpr int kD = decltype(d)::value, kGP = decltype(gp)::value;
    auto kernel = ragged_decode_kernel<kD, KV, kGP, Rows>;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = configure<kD, KV, kGP, Rows>(1, 1, cluster, nullptr, &cfg, &attr);
    if (err != cudaSuccess) return err;
    cfg.numAttrs = 1;  // the query takes the cluster attribute also for a cluster of 1
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads,
                                                        Shape<kD, KV, kGP>::BYTES);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  }));
}

// One entry per cache element type, over a [B, S, nkv, D] cache.
template <typename KV>
inline int launch(const void* q, const void* k, const void* v, const int* lengths,
                  const float* k_scale, const float* v_scale, void* out, int b_sz, int s_len,
                  int nkv, int group, int head_dim, int sliding_window, float scale,
                  int q_is_bf16, int out_is_bf16, int cluster, void* stream) {
  return launch_rows<KV>(q, k, v, lengths, k_scale, v_scale, out, b_sz, DenseRows{s_len},
                         s_len, nkv, group, head_dim, sliding_window, scale, q_is_bf16,
                         out_is_bf16, cluster, stream);
}

}  // namespace rda
