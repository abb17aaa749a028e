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


@pytest.mark.parametrize("event,wrapper", [
    ("void rowk::norm_rows_kernel<float, float, false, 8, false>(void const*)", "ada_rmsnorm"),
    ("void rowk::norm_rows_kernel<__nv_bfloat16, float, true, 4, false>(void const*)",
     "ada_rmsnorm_quantize"),
    ("void flash::fwd_kernel<float, 64>(flash::Problem)", "flash_fwd"),
])
def test_the_s2a_step_maps_its_row_and_flash_kernels(event, wrapper):
    """The S2A step runs K5 (float32 rows) and, on its sequence-flash route,
    the float32 K9-K11 at D = 64: each event maps to its wrapper and group."""
    from maxtext_indextts2_tpu_torch.tools.profile_train import own_kernel_name

    assert own_kernel_name(event) == wrapper
    assert kernel_category(event) == ("flash_attention (K9-K11)" if "flash::" in event
                                      else "row kernels (K5-K8)")


def test_profile_train_refuses_an_unknown_model_and_needs_the_card(monkeypatch):
    import torch

    from maxtext_indextts2_tpu_torch.tools import profile_train

    with pytest.raises(SystemExit, match="model must be one of"):
        profile_train.main(["model=vocoder"])
    with pytest.raises(SystemExit, match="unknown option"):
        profile_train.main(["route=flash"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        profile_train.main(["model=s2a", "seq_flash=true"])
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        profile_train.main(["model=codec"])


@pytest.mark.parametrize("event,group", [
    ("sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nhwckrsc_nhwc_tilesize128x128x32",
     "convolutions (cuDNN)"),
    ("sm80_xmma_wgrad_implicit_gemm_indexed_f32f32_f32f32_f32_nhwckrsc_nhwc",
     "convolutions (cuDNN)"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, float>",
     "convolutions (cuDNN)"),
    ("void conv2d_grouped_direct_kernel<false, true, false, false, 0, 1, 1, float>",
     "convolutions (cuDNN)"),
    ("regular_fft_factor=1920::fft_fwd_kernel", "FFT (cuFFT)"),
    ("void vector_fft_r2c<unsigned int, float, 960>", "FFT (cuFFT)"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x16", "matrix products (cuBLAS)"),
    ("Memcpy DtoD (Device -> Device)", "copies"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::sin_kernel_cuda>",
     "elementwise and reductions"),
])
def test_the_codec_step_groups_convolutions_ffts_and_products(event, group):
    from maxtext_indextts2_tpu_torch.tools.profile_train import codec_category

    assert codec_category(event) == group
