"""Serving a scan-stacked config (``scan_layers=true serve_unroll_layers=false``).

The JAX engine serves such a config with its scanned model; the port's model
is always unrolled and keeps the stacked layout at the edges: it reads
stacked and unrolled checkpoints alike and writes the engine's own
checkpoints stacked (``tools/quantize_checkpoint.py``). Its greedy streams
equal the JAX scanned engine's token for token, from either checkpoint
layout (the counterparts of the JAX package's
``test_serve_unroll_scanned_checkpoint_parity`` and
``test_serve_unrolled_trained_checkpoint``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.infer.engine import Engine as JaxEngine
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.tools import quantize_checkpoint
from maxtext_indextts2_tpu_torch.train import checkpointing
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_to_jax
from torch_port_helpers import TINY_TTS, configs, jax_tree, numpy_weights, prompt

SCANNED = ["scan_layers=true", "serve_unroll_layers=false"]


@pytest.fixture(scope="module")
def setup():
    cfg, jcfg = configs([], slots=2)
    weights = numpy_weights(cfg, seed=3)
    jeng = JaxEngine(dataclasses.replace(jcfg, scan_layers=True, serve_unroll_layers=False),
                     params=jax_tree(weights, scan_layers=True))
    assert jeng.cfg.scan_layers  # the JAX engine serves its scanned model
    p = prompt(5, 7)
    return weights, p, jeng.generate_stream(p, 10)


def _scanned_engine(extra=()):
    eng = Engine(load_config(TINY_TTS + SCANNED + ["per_device_batch_size=2"] + list(extra)),
                 device="cpu")
    assert eng.scanned_layout and not eng.cfg.scan_layers
    return eng


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked_checkpoint",
                                                       "unrolled_checkpoint"])
def test_scanned_engine_equals_the_jax_scanned_engine(setup, tmp_path, stacked):
    weights, p, want = setup
    params = {k: torch.from_numpy(v) for k, v in weights.items()}
    if stacked:
        params = checkpointing.stack_unrolled_params(params)
    path = str(tmp_path / "ckpt")
    checkpointing.save_params_only(path, params)
    assert checkpointing.params_checkpoint_is_scanned(path) is stacked
    eng = _scanned_engine()
    eng.load_params(path)
    got = eng.generate_stream(p, 10)
    assert got == want and len(set(got)) > 2


def test_stacked_names_are_the_jax_scanned_tree(setup):
    weights, _, _ = setup
    params = {k: torch.from_numpy(v) for k, v in weights.items()}
    stacked = checkpointing.stack_unrolled_params(params)
    flat = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{path}{k}.")
            else:
                flat[f"{path}{k}"] = v

    walk(params_to_jax(params, scan_layers=True), "")
    assert set(stacked) == set(flat)
    for name, t in stacked.items():
        np.testing.assert_array_equal(t.numpy(), flat[name])
    back = checkpointing.unroll_scanned_params(stacked)
    assert set(back) == set(params)
    assert all(torch.equal(back[k], params[k]) for k in params)


def test_checkpoint_params_follow_the_engine_layout(setup):
    weights, _, _ = setup
    eng = _scanned_engine()
    eng.set_params({k: torch.from_numpy(v) for k, v in weights.items()})
    assert checkpointing.names_are_scanned(eng.checkpoint_params()) is True
    assert checkpointing.names_are_scanned(eng.params) is False
    unrolled = Engine(load_config(TINY_TTS + ["scan_layers=true", "per_device_batch_size=2"]),
                      device="cpu")
    assert not unrolled.scanned_layout
    unrolled.set_params({k: torch.from_numpy(v) for k, v in weights.items()})
    assert unrolled.checkpoint_params() is unrolled.params


def test_a_quantized_checkpoint_of_a_scanned_engine_is_stacked(setup, tmp_path):
    """``tools/quantize_checkpoint.py`` writes an ``int8w_serve`` checkpoint
    from a scanned-config engine with the stacked names (the JAX tool writes
    the scanned engine's tree); a scanned ``checkpoint_is_quantized`` engine
    serves it as the engine that quantized on the fly does."""
    weights, p, _ = setup
    src = str(tmp_path / "float")
    checkpointing.save_params_only(src, checkpointing.stack_unrolled_params(
        {k: torch.from_numpy(v) for k, v in weights.items()}))
    out = str(tmp_path / "int8")
    args = TINY_TTS + SCANNED + ["per_device_batch_size=2", f"load_parameters_path={src}"]
    quantize_checkpoint.run(args + [f"save_path={out}"], device="cpu")
    assert checkpointing.params_checkpoint_is_scanned(out) is True
    saved = checkpointing.load_params_only(out)
    assert any(k.startswith("decoder.layers.") and k.endswith("kernel_scale") for k in saved)
    fly = _scanned_engine(["quantization=int8w_serve", f"load_parameters_path={src}"])
    fly.load_params()
    served = _scanned_engine(["quantization=int8w_serve", "checkpoint_is_quantized=true",
                              f"load_parameters_path={out}"])
    served.load_params()
    assert served.generate_stream(p, 8) == fly.generate_stream(p, 8)


def test_paged_serving_still_refuses_a_scanned_config():
    with pytest.raises(ValueError, match="scan_layers=false"):
        _scanned_engine(["paged_attention=true", "pagedattn_tokens_per_page=4",
                         "pagedattn_num_pages=40"])
