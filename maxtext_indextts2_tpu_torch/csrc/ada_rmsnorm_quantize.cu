// ada_rmsnorm_quantize (see row_kernels.cuh): ada_rmsnorm fused into the row
// quantizer, rowk::norm_rows_kernel with quantization; the normalized float
// tensor is never written.
// Replaces the TPU kernel `ada_rmsnorm_quantize` of maxtext_indextts2_tpu/ops/quant_kernels.py.
#include "row_kernels.cuh"

extern "C" int ada_rmsnorm_quantize(const void* x, const void* w, void* q, void* scales,
                                    long long rows, int s_len, int d, int dtype, int w_is_f32,
                                    int chunks, int warps_per_row, int rows_per_worker,
                                    int rounds, void* stream) {
  return rowk::launch_norm<true>(x, w, nullptr, q, scales, rows, s_len, d, dtype, w_is_f32,
                                 chunks, warps_per_row, rows_per_worker, rounds, stream);
}

extern "C" int ada_rmsnorm_quantize_occupancy(int* blocks_per_sm, int dtype, int w_is_f32,
                                              int chunks, int warps_per_row, int rounds,
                                              int* threads_per_block) {
  return rowk::norm_occupancy<true>(blocks_per_sm, dtype, w_is_f32, chunks, warps_per_row,
                                    rounds, threads_per_block);
}
