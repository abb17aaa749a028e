"""``tools/profile_train.py`` groups the profiler's events by kernel: every
instantiation of the flash-attention kernels of ``csrc/flash_attention.cuh``
(the float32 ones on the CUDA cores, the bfloat16 K9, K10 and K11 on the
tensor cores; the bfloat16 ``dq_kernel``, K10's first design, is kept as a
name that must still map) maps to the wrapper that launches it, and nothing
else does.
The names are the demangled ones ``torch.profiler`` reports."""

import pytest

from maxtext_indextts2_tpu_torch.tools.profile_train import flash_kernel_name, kernel_category

_ARGS = {
    "fwd": "(flash::Problem, {t} const*, {t} const*, {t} const*, {t}*, float*, flash::Strides, "
           "flash::Strides, flash::Strides, flash::Strides)",
    "dq": "(flash::Problem, {t} const*, {t} const*, {t} const*, {t} const*, float const*, "
          "float const*, {t}*, flash::Strides, flash::Strides, flash::Strides, flash::Strides, "
          "flash::Strides)",
    "dkv": "(flash::Problem, {t} const*, {t} const*, {t} const*, {t} const*, float const*, "
           "float const*, {t}*, {t}*, flash::Strides, flash::Strides, flash::Strides, "
           "flash::Strides, flash::Strides, flash::Strides)",
}
_WRAPPER = {"fwd": "flash_fwd", "dq": "flash_bwd_dq", "dkv": "flash_bwd_dkv"}
_BF16 = "__nv_bfloat16"


def _instantiations():
    for d in (64, 128):
        for kind in ("fwd", "dq", "dkv"):
            yield f"void flash::{kind}_kernel<float, {d}>" + _ARGS[kind].format(t="float"), \
                _WRAPPER[kind]
        yield f"void flash::fwd_mma_kernel<{d}>" + _ARGS["fwd"].format(t=_BF16), "flash_fwd"
        yield f"void flash::dq_kernel<{_BF16}, {d}>" + _ARGS["dq"].format(t=_BF16), \
            "flash_bwd_dq"
        yield f"void flash::dq_mma_kernel<{d}>" + _ARGS["dq"].format(t=_BF16), "flash_bwd_dq"
        yield f"void flash::dkv_mma_kernel<{d}>" + _ARGS["dkv"].format(t=_BF16), \
            "flash_bwd_dkv"


@pytest.mark.parametrize("event,wrapper", list(_instantiations()),
                         ids=[name.split("(")[0][5:] for name, _ in _instantiations()])
def test_every_flash_instantiation_maps_to_its_wrapper(event, wrapper):
    assert flash_kernel_name(event) == wrapper
    assert kernel_category(event) == "flash_attention (K9-K11)"


@pytest.mark.parametrize("event,category", [
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "matrix products (cuBLAS)"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>",
     "elementwise and reductions"),
    ("Memcpy DtoD (Device -> Device)", "copies"),
    ("void flash::unknown_kernel<128>(flash::Problem)", "elementwise and reductions"),
])
def test_other_events_are_not_flash_kernels(event, category):
    assert flash_kernel_name(event) is None
    assert kernel_category(event) == category
