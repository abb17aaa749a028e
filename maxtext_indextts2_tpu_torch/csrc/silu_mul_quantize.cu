// silu_mul_quantize (see row_kernels.cuh): silu(g) * u fused into the row
// quantizer; the [.., K] float product is never written.
// Replaces the TPU kernel `silu_mul_quantize` of maxtext_indextts2_tpu/ops/quant_kernels.py.
#include "row_kernels.cuh"

extern "C" int silu_mul_quantize(const void* g, const void* u, void* q, void* scales,
                                 long long rows, int d, int dtype, void* stream) {
  return rowk::dispatch<rowk::kSiluQuant>(dtype, g, u, nullptr, 0, nullptr, q, scales, rows, 1,
                                          d, stream);
}
