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
// ragged_decode_attention.cuh (grid (nkv, B), 128 threads, all `group` query
// heads of a kv head in one block so each K/V row is read once, 16-byte
// loads along d, float32 online softmax), instantiated with PagedRows below
// for the row address: cache row r of slot b lies at page
// page_map[b, r / tpp], offset r % tpp, and a page holds tpp rows of nkv*D
// elements, so the in-page stride is that of K1's [B, S, nkv, D]. The page
// id is read through the read-only cache once per row; neighbouring rows of
// a page stay neighbours in memory, so the loads of a page are as contiguous
// as K1's. Any tpp >= 1 works (the TPU kernel's page is its block; here the
// block walks rows and a page is only an address). Lengths are clamped to
// tpp * max_pages (as the TPU kernel's wrapper does) and page ids to
// [0, num_pages): a bad map reads a wrong page, never an illegal address.
// What is not carried over: the Mosaic q pre-expansion to [nq, nkv*d] with
// its diagonal extraction, and the DMA double buffer with its parity: both
// are TPU tiling. Differences kept from K1's port: a slot of length 0 gets
// zeros and reads no page (the TPU kernel walks the null page and returns
// the mean of its V rows); probabilities stay float32 for the PV product.
// No tensor cores, no split over the KV axis: the simple kernel that is right.
#pragma once

#include "ragged_decode_attention.cuh"

namespace rda {

struct PagedRows {
  const int* page_map;  // [B, max_pages] int32
  int max_pages;
  int tpp;
  int num_pages;
  __device__ __forceinline__ size_t operator()(int b, int row) const {
    int page = __ldg(page_map + static_cast<size_t>(b) * max_pages + row / tpp);
    page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
    return static_cast<size_t>(page) * tpp + row % tpp;
  }
};

// Pools [num_pages, tpp, nkv, D] of a float type; q and out [B, nq, D].
template <typename KV>
inline int launch_paged(const void* q, const void* k_pages, const void* v_pages,
                        const int* page_map, const int* lengths, void* out, int b_sz,
                        int num_pages, int tpp, int max_pages, int nkv, int group,
                        int head_dim, float scale, int q_is_bf16, int out_is_bf16,
                        void* stream) {
  if (num_pages <= 0 || tpp <= 0 || max_pages <= 0 ||
      static_cast<long long>(tpp) * max_pages > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_rows<KV>(q, k_pages, v_pages, lengths, nullptr, nullptr, out, b_sz,
                         PagedRows{page_map, max_pages, tpp, num_pages}, tpp * max_pages, nkv,
                         group, head_dim, 0, scale, q_is_bf16, out_is_bf16, stream);
}

}  // namespace rda
