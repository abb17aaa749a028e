// Ragged decode attention, int8_t K/V cache: the instantiations of the kernel in
// ragged_decode_attention.cuh (see the note there) behind one plain C entry
// point. One source per cache element type so the three build in parallel.
#include "ragged_decode_attention.cuh"

extern "C" int ragged_decode_attention_int8(const void* q, const void* k, const void* v,
                                           const int* lengths, const float* k_scale,
                                           const float* v_scale, void* out, int b_sz, int s_len,
                                           int nkv, int group, int head_dim, int sliding_window,
                                           float scale, int q_is_bf16, int out_is_bf16,
                                           int cluster, void* stream) {
  return rda::launch<int8_t>(q, k, v, lengths, k_scale, v_scale, out, b_sz, s_len, nkv, group,
                         head_dim, sliding_window, scale, q_is_bf16, out_is_bf16, cluster,
                         stream);
}

// Occupancy of the kernel at (head_dim, group) on this card: the blocks an SM
// holds, and the clusters of `cluster` blocks the card holds at once.
extern "C" int ragged_decode_attention_int8_occupancy(int* blocks_per_sm, int head_dim, int group,
                                                      int cluster, int* max_clusters) {
  return rda::occupancy<int8_t, rda::DenseRows>(head_dim, group, cluster, blocks_per_sm,
                                                max_clusters);
}
