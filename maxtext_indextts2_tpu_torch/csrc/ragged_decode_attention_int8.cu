// Ragged decode attention, int8_t K/V cache: the instantiations of the kernel in
// ragged_decode_attention.cuh (see the note there) behind one plain C entry
// point. One source per cache element type so the three build in parallel.
#include "ragged_decode_attention.cuh"

extern "C" int ragged_decode_attention_int8(const void* q, const void* k, const void* v,
                                           const int* lengths, const float* k_scale,
                                           const float* v_scale, void* out, int b_sz, int s_len,
                                           int nkv, int group, int head_dim, int sliding_window,
                                           float scale, int q_is_bf16, int out_is_bf16,
                                           void* stream) {
  return rda::launch<int8_t>(q, k, v, lengths, k_scale, v_scale, out, b_sz, s_len, nkv, group,
                         head_dim, sliding_window, scale, q_is_bf16, out_is_bf16, stream);
}
