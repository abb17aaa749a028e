// ada_rmsnorm (see row_kernels.cuh): out = x * rsqrt(mean(x^2) + 1e-6) * w[b].
// Replaces the TPU kernel `ada_rmsnorm` of maxtext_indextts2_tpu/ops/ada_rmsnorm.py.
#include "row_kernels.cuh"

extern "C" int ada_rmsnorm(const void* x, const void* w, void* out, long long rows, int s_len,
                           int d, int dtype, int w_is_f32, void* stream) {
  return rowk::dispatch<rowk::kNorm>(dtype, x, nullptr, w, w_is_f32, out, nullptr, nullptr,
                                     rows, s_len, d, stream);
}
