"""Shared set-up for the tests that hold the PyTorch package against the
JAX package: one tiny model configuration for both, and weights made from a
numpy seed in the PyTorch package's state-dict layout and carried to the JAX
package's tree by ``utils/param_bridge.py``.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import torch

from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.infer.engine import Engine as JaxEngine
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.models import Transformer
from maxtext_indextts2_tpu_torch.models.layers import DenseGeneral
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_to_jax

# tiny shapes: one thread is enough, and the cores stay free for the other test workers
torch.set_num_threads(1)

# the shapes the JAX package's own ragged-decode engine tests use, as an
# audio LM (qk-norm block)
TINY_TTS = [
    "decoder_block=tts", "base_emb_dim=128", "base_mlp_dim=256",
    "base_num_decoder_layers=2", "base_num_query_heads=4", "base_num_kv_heads=2",
    "head_dim=32", "vocab_size=512", "max_target_length=64",
    "max_prefill_predict_length=16", "decode_sampling_strategy=greedy",
    "dtype=float32", "scan_layers=false",
]
JAX_DEVICES = 8  # the test harness gives JAX eight CPU devices


def configs(extra=(), slots=4):
    """(PyTorch config, JAX config) with the same model and slot count."""
    args = TINY_TTS + list(extra)
    cfg = load_config(args + [f"per_device_batch_size={slots}"])
    jcfg = jax_load_config(args + [f"per_device_batch_size={slots / JAX_DEVICES}"])
    assert int(jcfg.per_device_batch_size * jcfg.num_devices) == slots
    return cfg, jcfg


def numpy_weights(cfg, seed=0):
    """A state dict of numpy arrays for ``Transformer(cfg)``: kernels normal
    with variance 1/fan_in, norm scales around 1, embedding normal."""
    rng = np.random.default_rng(seed)
    model = Transformer(cfg, device="cpu")
    fan_in = {f"{name}.kernel": math.prod(mod.in_shape)
              for name, mod in model.named_modules() if isinstance(mod, DenseGeneral)}
    out = {}
    for name, p in model.state_dict().items():
        shape = tuple(p.shape)
        if name.endswith("scale"):
            w = 1.0 + 0.1 * rng.normal(size=shape)
        elif name in fan_in:
            w = rng.normal(size=shape) / math.sqrt(fan_in[name])
        else:  # embedding table, biases
            w = rng.normal(size=shape)
        out[name] = w.astype(np.float32)
    return out


def jax_tree(weights, scan_layers=False):
    """The same weights as the JAX package's parameter tree (jnp leaves)."""
    def to_jnp(node):
        if isinstance(node, dict):
            return {k: to_jnp(v) for k, v in node.items()}
        return jnp.asarray(node)

    return to_jnp(params_to_jax(weights, scan_layers=scan_layers))


def engine_pair(extra=(), slots=4, seed=0):
    """(PyTorch engine on the CPU, JAX engine) holding the same weights."""
    cfg, jcfg = configs(extra, slots)
    weights = numpy_weights(cfg, seed)
    eng = Engine(cfg, device="cpu")
    eng.set_params({k: torch.from_numpy(v) for k, v in weights.items()})
    jeng = JaxEngine(dataclasses.replace(jcfg, scan_layers=False), params=jax_tree(weights))
    return eng, jeng


def prompt(seed, n, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, size=n).astype(np.int32)
