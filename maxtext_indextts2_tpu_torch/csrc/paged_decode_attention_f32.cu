// Paged decode attention (K4), float pools: the instantiations of the kernel in
// paged_decode_attention.cuh (see the note there) behind one plain C entry
// point. One source per element type so the two build in parallel.
#include "paged_decode_attention.cuh"

extern "C" int paged_decode_attention_f32(const void* q, const void* k_pages,
                                           const void* v_pages, const int* page_map,
                                           const int* lengths, void* out, int b_sz,
                                           int num_pages, int tpp, int max_pages, int nkv,
                                           int group, int head_dim, float scale, int q_is_bf16,
                                           int out_is_bf16, void* stream) {
  return rda::launch_paged<float>(q, k_pages, v_pages, page_map, lengths, out, b_sz, num_pages,
                                tpp, max_pages, nkv, group, head_dim, scale, q_is_bf16,
                                out_is_bf16, stream);
}
