// row_quantize_int8 (see row_kernels.cuh): per-row absmax int8 quantization.
// Replaces the TPU kernel `row_quantize_int8` of maxtext_indextts2_tpu/ops/quant_kernels.py.
#include "row_kernels.cuh"

extern "C" int row_quantize_int8(const void* x, void* q, void* scales, long long rows, int d,
                                 int dtype, void* stream) {
  return rowk::dispatch<rowk::kQuant>(dtype, x, nullptr, q, scales, rows, d, stream);
}
