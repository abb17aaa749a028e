// ada_rmsnorm_quantize (see row_kernels.cuh): ada_rmsnorm fused into the row
// quantizer; the normalized float tensor is never written.
// Replaces the TPU kernel `ada_rmsnorm_quantize` of maxtext_indextts2_tpu/ops/quant_kernels.py.
#include "row_kernels.cuh"

extern "C" int ada_rmsnorm_quantize(const void* x, const void* w, void* q, void* scales,
                                    long long rows, int s_len, int d, int dtype, int w_is_f32,
                                    void* stream) {
  return rowk::dispatch<rowk::kNormQuant>(dtype, x, nullptr, w, w_is_f32, nullptr, q, scales,
                                          rows, s_len, d, stream);
}
