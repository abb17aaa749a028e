// Paged decode attention (K4) for Hopper (sm_90a): one query token per slot,
// GQA, over each slot's first lengths[b] cache rows, with the rows read from
// page pools through the slot's page map.
//
// Replaces the TPU kernel `_kernel_paged` / `paged_decode_attention_v2` of the
// JAX package (maxtext_indextts2_tpu/ops/ragged_decode_attention.py).
//
// What bounds it on this card: bytes, as for the ragged kernel (K1): each
// valid K/V row is read once and feeds 2*group flops per bf16 byte, far below
// the ~295 flop/byte at which the tensor cores become the limit. The page map
// adds 4 bytes a page.
//
// What the design does about it: it IS the ragged kernel of
// ragged_decode_attention.cuh -- the slot's rows split across a cluster of up
// to 8 blocks, each block's rows streamed through a cp.async ring in shared
// memory, the partials merged in distributed shared memory in the same launch
// -- instantiated with PagedRows below for the row address: cache row r of
// slot b lies at page page_map[b, r / tpp], offset r % tpp, and a page holds
// tpp rows of nkv*D elements, so the in-page stride is that of K1's
// [B, S, nkv, D]. The page map is read once a page, not once a row: a copy
// thread's cursor keeps (page index, offset) and the page's id, steps by a
// fixed count of rows with a counter (one carry, no `/` or `%` a row), and
// reads the map only when it enters a new page -- a few pages a block on the
// serving path. The one division a cursor needs at its start is a shift
// and a mask where tpp is a power of two (the wrapper passes log2(tpp), -1
// otherwise); any tpp >= 1 works. Lengths are clamped to tpp * max_pages (as
// the TPU kernel's wrapper does) and page ids to [0, num_pages): a bad map
// reads a wrong page, never an illegal address.
// What is not carried over: the Mosaic q pre-expansion to [nq, nkv*d] with
// its diagonal extraction, and the DMA double buffer with its parity: both
// are TPU tiling. Differences kept from K1's port: a slot of length 0 gets
// zeros and reads no page (the TPU kernel walks the null page and returns
// the mean of its V rows); probabilities stay float32 for the PV product.
#pragma once

#include "ragged_decode_attention.cuh"

namespace rda {

struct PagedRows {
  const int* page_map;  // [B, max_pages] int32
  int max_pages;
  int tpp;
  int tpp_shift;  // log2(tpp) where tpp is a power of two, else -1
  int num_pages;
  struct Cursor {
    const int* map;  // the slot's row of the page map
    int tpp, num_pages;
    int page, off;         // page index within the slot, row within the page
    int q_step, r_step;    // a step of rows = q_step pages + r_step rows
    int loaded, pid;       // the page index whose id is in pid (-1: none yet)
    __device__ __forceinline__ long long row() {
      if (page != loaded) {  // a new page: read its id once
        int p = __ldg(map + page);
        pid = p < 0 ? 0 : (p >= num_pages ? num_pages - 1 : p);
        loaded = page;
      }
      return static_cast<long long>(pid) * tpp + off;
    }
    __device__ __forceinline__ void advance() {
      off += r_step;
      page += q_step;
      if (off >= tpp) {
        off -= tpp;
        ++page;
      }
    }
  };
  __device__ __forceinline__ Cursor at(int b, int row, int step) const {
    Cursor c;
    c.map = page_map + static_cast<size_t>(b) * max_pages;
    c.tpp = tpp;
    c.num_pages = num_pages;
    if (tpp_shift >= 0) {
      c.page = row >> tpp_shift;
      c.off = row & (tpp - 1);
      c.q_step = step >> tpp_shift;
      c.r_step = step & (tpp - 1);
    } else {
      c.page = row / tpp;
      c.off = row - c.page * tpp;
      c.q_step = step / tpp;
      c.r_step = step - c.q_step * tpp;
    }
    c.loaded = -1;
    c.pid = 0;
    return c;
  }
};

inline bool bad_pages(int num_pages, int tpp, int tpp_shift, int max_pages) {
  return num_pages <= 0 || tpp <= 0 || max_pages <= 0 ||
         static_cast<long long>(tpp) * max_pages > 0x7fffffffLL ||
         (tpp_shift >= 0 && (tpp_shift > 30 || (1 << tpp_shift) != tpp));
}

// Pools [num_pages, tpp, nkv, D] of a float type; q and out [B, nq, D].
template <typename KV>
inline int launch_paged(const void* q, const void* k_pages, const void* v_pages,
                        const int* page_map, const int* lengths, void* out, int b_sz,
                        int num_pages, int tpp, int tpp_shift, int max_pages, int nkv, int group,
                        int head_dim, float scale, int q_is_bf16, int out_is_bf16, int cluster,
                        void* stream) {
  if (bad_pages(num_pages, tpp, tpp_shift, max_pages)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_rows<KV>(q, k_pages, v_pages, lengths, nullptr, nullptr, out, b_sz,
                         PagedRows{page_map, max_pages, tpp, tpp_shift, num_pages},
                         tpp * max_pages, nkv, group, head_dim, 0, scale, q_is_bf16,
                         out_is_bf16, cluster, stream);
}

}  // namespace rda
