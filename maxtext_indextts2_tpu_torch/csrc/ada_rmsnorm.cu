// ada_rmsnorm (see row_kernels.cuh): out = x * rsqrt(mean(x^2) + 1e-6) * w[b],
// rowk::norm_rows_kernel without quantization.
// Replaces the TPU kernel `ada_rmsnorm` of maxtext_indextts2_tpu/ops/ada_rmsnorm.py.
#include "row_kernels.cuh"

extern "C" int ada_rmsnorm(const void* x, const void* w, void* out, long long rows, int s_len,
                           int d, int dtype, int w_is_f32, int chunks, int warps_per_row,
                           int rows_per_worker, int rounds, void* stream) {
  return rowk::launch_norm<false>(x, w, out, nullptr, nullptr, rows, s_len, d, dtype, w_is_f32,
                                  chunks, warps_per_row, rows_per_worker, rounds, stream);
}

extern "C" int ada_rmsnorm_occupancy(int* blocks_per_sm, int dtype, int w_is_f32, int chunks,
                                     int warps_per_row, int rounds, int* threads_per_block) {
  return rowk::norm_occupancy<false>(blocks_per_sm, dtype, w_is_f32, chunks, warps_per_row,
                                     rounds, threads_per_block);
}
