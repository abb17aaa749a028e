"""``tools/profile_train.py model=moe`` groups the MoE step's grouped products
apart: every kernel of ``csrc/grouped_matmul.cu``, ``grouped_matmul_bwd.cu``,
``grouped_wgmma.cuh`` and ``grouped_matmul_f32.cu`` maps to the wrapper that launches it and to a
group of its own, and nothing else does. The names are the demangled ones
``torch.profiler`` reports (the backward kernels' parameters are the tensor
maps the host builds)."""

import pytest

from maxtext_indextts2_tpu_torch.tools import profile_train

_MAPS = "(CUtensorMap, CUtensorMap, CUtensorMap, int const*, "


@pytest.mark.parametrize("event,wrapper", [
    ("void gmm::(anonymous namespace)::grouped_matmul_bf16_kernel<64>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, int const*, __nv_bfloat16*, int, int, int, int)",
     "grouped_matmul_bf16"),
    ("void gmm::(anonymous namespace)::grouped_matmul_int8_kernel<16, false>(signed char const*, "
     "signed char const*, int const*, float const*, float const*, void*, int, int, int, int)",
     "grouped_matmul_int8"),
    ("gmm_bwd::dgrad_kernel" + _MAPS + "__nv_bfloat16*, int, int, int, int)",
     "grouped_matmul_dgrad"),
    ("gmm_bwd::wgrad_kernel" + _MAPS + "int, int, int, int)", "grouped_matmul_wgrad"),
    # an older checkout's mma.sync dgrad (a template on its row tile) maps too
    ("void gmm_bwd::dgrad_kernel<64>(__nv_bfloat16 const*, __nv_bfloat16 const*, int const*, "
     "__nv_bfloat16*, int, int, int, int)", "grouped_matmul_dgrad"),
    # the redesigned forward: the few-rows weight stream and the persistent
    # wgmma kernel, whose dgrad instantiation is the backward's
    ("void gmm::grouped_matmul_bf16_few_rows_kernel<4>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, int const*, __nv_bfloat16*, int, int, int, int, int)",
     "grouped_matmul_bf16"),
    ("void gmm_wg::rows_kernel<true>" + _MAPS + "__nv_bfloat16*, int, int, int, int)",
     "grouped_matmul_bf16"),
    ("void gmm_wg::rows_kernel<false>" + _MAPS + "__nv_bfloat16*, int, int, int, int)",
     "grouped_matmul_dgrad"),
    ("gmm_f32::rows_kernel(float const*, float const*, int const*, float*, int, int, int, int, "
     "int)", "grouped_matmul_f32 (forward and dgrad)"),
    # the redesigned int8 kernels (the few-rows weight stream, the persistent
    # many-rows kernel) and float32 row-tile kernels (a template on the tile)
    ("void gmm::grouped_matmul_int8_few_rows_kernel<3>(signed char const*, signed char const*, "
     "int const*, float const*, float const*, void*, int, int, int, int, int)",
     "grouped_matmul_int8"),
    ("gmm::grouped_matmul_int8_rows_kernel(signed char const*, signed char const*, int const*, "
     "float const*, float const*, void*, int, int, int, int)", "grouped_matmul_int8"),
    ("void gmm_f32::rows_kernel<64, true>(float const*, float const*, int const*, float*, int, "
     "int, int, int, bool)", "grouped_matmul_f32 (forward and dgrad)"),
    ("gmm_f32::wgrad_kernel(float const*, float const*, int const*, float*, int, int, int)",
     "grouped_matmul_f32_wgrad"),
])
def test_every_grouped_kernel_maps_to_its_wrapper_and_group(event, wrapper):
    assert profile_train.grouped_kernel_name(event) == wrapper
    assert profile_train.own_kernel_name(event) == wrapper
    assert profile_train.moe_category(event) == f"grouped: {wrapper}"


@pytest.mark.parametrize("event,group", [
    ("void flash::dkv_mma_kernel<128>(flash::Problem)", "flash_attention (K9-K11)"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "matrix products (cuBLAS)"),
    ("Memcpy DtoD (Device -> Device)", "copies"),
    ("void at::native::(anonymous namespace)::sort_kernel<long>", "elementwise and reductions"),
])
def test_the_moe_step_groups_everything_else_as_the_lm_step(event, group):
    assert profile_train.grouped_kernel_name(event) is None
    assert profile_train.moe_category(event) == group


def test_model_moe_parses_and_needs_the_card(monkeypatch):
    import torch

    assert profile_train.STEPS["moe"] is profile_train.moe_step
    assert profile_train.CATEGORIES["moe"] is profile_train.moe_category
    with pytest.raises(SystemExit, match="unknown option"):
        profile_train.main(["model=moe", "experts=8"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        profile_train.main(["model=moe", "layers=2", "batch=4", "remat=full"])


def test_moe_recipe_is_chip_smokes_moe_train():
    """The tool's recipe is the moe_train phase's, layers, batch and remat
    given apart (their defaults: 2, 4 and full, as there)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    want = set(chip_smoke.MOE_TRAIN_ARGS) - {"base_num_decoder_layers=2",
                                             "per_device_batch_size=4", "remat_policy=full"}
    want = {a for a in want if not a.startswith("steps=")}
    assert set(profile_train.MOE_ARGS) == want
