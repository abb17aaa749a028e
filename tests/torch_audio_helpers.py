"""Shared set-up for the tests that hold the PyTorch package's TTS back end
(S2A sampler, RVQ, codec decoder, pipeline) against the JAX package: one
tiny configuration for both, weights made from a numpy seed in the PyTorch
package's state-dict layout and carried to the JAX package's tree by
``utils/param_bridge.py``, and JAX's sampler noise handed to the PyTorch
sampler draw by draw.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from maxtext_indextts2_tpu.audio import s2a as jax_s2a
from maxtext_indextts2_tpu.audio.acoustic import AcousticCodec as JaxAcousticCodec
from maxtext_indextts2_tpu.ops import s2a_attention as jax_s2a_attention
from maxtext_indextts2_tpu_torch.audio import s2a as s2a_lib
from maxtext_indextts2_tpu_torch.audio.acoustic import AcousticCodec
from maxtext_indextts2_tpu_torch.audio.pipeline import build_serving_s2a
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_to_jax

# tiny shapes: one thread is enough, and the cores stay free for the other test workers
torch.set_num_threads(1)

TINY = dict(num_quantizers=3, hidden_size=128, num_layers=2, num_heads=4, codebook_size=64,
            cond_codebook_size=96)
TINY_CODEC = dict(d_model=32, latent_dim=64, num_quantizers=3, codebook_size=64,
                  vocos_dim=64, vocos_intermediate_dim=128, vocos_num_layers=2)
MODES = ["float32", "bfloat16", "int8", "int8_offline"]


def to_jnp(node):
    if isinstance(node, dict):
        return {k: to_jnp(v) for k, v in node.items()}
    return jnp.asarray(node)


def to_numpy_tree(tree):
    """A JAX tree with numpy leaves (bfloat16 as ml_dtypes arrays)."""
    return jax.tree.map(np.asarray, tree)


def s2a_weights(seed=0, **overrides):
    """A float state dict of numpy arrays for the tiny ``S2AModel``: dense
    kernels normal with variance 1/fan_in, the norms' conditioning weights
    small but not zero (so the conditioning path is exercised), their biases
    around 1, embeddings and logit heads wide enough that logits spread."""
    rng = np.random.default_rng(seed)
    model = s2a_lib.S2AModel(s2a_lib.S2AConfig(**{**TINY, **overrides}), device="cpu")
    out = {}
    for name, p in model.state_dict().items():
        shape = tuple(p.shape)
        if "to_weight.kernel" in name:
            w = 0.05 * rng.normal(size=shape)
        elif "to_weight.bias" in name:
            w = 1.0 + 0.1 * rng.normal(size=shape)
        elif name.endswith(".kernel"):
            w = rng.normal(size=shape) / np.sqrt(shape[0])
        elif name.endswith(".bias") or name == "to_logits_b":
            w = 0.1 * rng.normal(size=shape)
        elif name == "to_logits_w":
            w = 0.3 * rng.normal(size=shape)
        else:  # token / cond / layer / mask embeddings
            w = 0.5 * rng.normal(size=shape)
        out[name] = w.astype(np.float32)
    return out


def s2a_pair(mode, weights=None, **overrides):
    """(PyTorch S2AModel on the CPU, JAX S2AModel, JAX params) serving the
    same float weights in ``mode``, each converted by its own package in the
    order of ``build_tiny_pipeline``."""
    weights = weights if weights is not None else s2a_weights(**overrides)
    kw = {**TINY, **overrides}
    tmodel = build_serving_s2a(
        s2a_lib.S2AConfig(**kw), mode,
        float_params={k: torch.from_numpy(v) for k, v in weights.items()}, device="cpu")
    jcfg = jax_s2a.serving_s2a_config(jax_s2a.S2AConfig(**kw), mode)
    jmodel = jax_s2a.S2AModel(jcfg)
    params = {"params": to_jnp(params_to_jax(weights))}
    if jcfg.int8_matmul == "offline":
        t = 16
        init_args = (jnp.zeros((1, t, kw["num_quantizers"]), jnp.int32),
                     jnp.ones((1, t), jnp.int32), jnp.zeros((1, t), jnp.int32),
                     jax.random.PRNGKey(0))
        params = jax_s2a.quantize_s2a_params(params, jmodel, init_args)
    if jcfg.int8_matmul:
        params = jax_s2a.cast_denoiser_params(params)
    return tmodel, jmodel, params


class _TPUView:
    """``jax`` as the JAX package's ``audio/s2a.py`` sees it, reporting a TPU
    backend: its opt-in branches are chosen by backend and environment."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


def use_jax_s2a_attention_kernel(monkeypatch):
    """Make the JAX package's S2A denoiser take its ``s2a_attention`` branch
    (the Pallas kernel, in interpret mode on the CPU) wherever every key is
    valid, as the PyTorch package always does: ``MTT_S2A_FLASH=1`` and a TPU
    backend as that module sees it, with its other TPU-only kernels
    (``MTT_FUSED_QUANT``, ``MTT_FUSED_ADALN``) left off."""
    monkeypatch.setenv("MTT_S2A_FLASH", "1")
    monkeypatch.setenv("MTT_FUSED_QUANT", "0")
    monkeypatch.setenv("MTT_FUSED_ADALN", "0")
    monkeypatch.setattr(jax_s2a, "jax", _TPUView())
    monkeypatch.setattr(jax_s2a_attention, "s2a_attention", functools.partial(
        jax_s2a_attention.s2a_attention, interpret=True))


def jax_noise(rng):
    """The uniforms ``S2AModel.reverse_diffusion`` of the JAX package draws
    from ``rng``, as the callable the PyTorch sampler takes: keys
    ``fold_in(fold_in(rng, layer * 1000), step)``, then ``fold_in(key, draw)``."""
    def noise(layer, step, draw, shape):
        key = jax.random.fold_in(jax.random.fold_in(rng, layer * 1000), step)
        u = jax.random.uniform(jax.random.fold_in(key, draw), shape, minval=1e-9, maxval=1.0)
        return torch.from_numpy(np.array(u))
    return noise


def codec_weights(seed=0, **kwargs):
    """A state dict of numpy arrays for the PyTorch ``AcousticCodec`` (decode
    side): seeded normal kernels, norm scales / snake alphas around 1."""
    rng = np.random.default_rng(seed)
    model = AcousticCodec(**{**TINY_CODEC, **kwargs}, device="cpu")
    out = {}
    for name, p in model.state_dict().items():
        shape = tuple(p.shape)
        if name.endswith(("scale", "alpha")):
            w = 1.0 + 0.1 * rng.normal(size=shape)
        elif name.endswith("gamma"):
            w = 0.5 + 0.1 * rng.normal(size=shape)
        elif name.endswith("kernel"):
            w = rng.normal(size=shape) / np.sqrt(max(1, int(np.prod(shape[:-1]))))
        elif name.endswith("bias"):
            w = 0.1 * rng.normal(size=shape)
        else:  # codebooks
            w = rng.normal(size=shape)
        out[name] = w.astype(np.float32)
    return out


def codec_pair(seed=0, **kwargs):
    """(PyTorch AcousticCodec on the CPU, JAX AcousticCodec, JAX params), the
    same numpy weights on both sides, encoder and decoder."""
    kw = {**TINY_CODEC, **kwargs}
    weights = codec_weights(seed, **kwargs)
    tcodec = AcousticCodec(**kw, device="cpu").eval()
    tcodec.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    jcodec = JaxAcousticCodec(**kw)
    params = {"params": to_jnp(params_to_jax(weights))}
    return tcodec, jcodec, params


def seeded_state(model, seed=0):
    """A state dict of numpy arrays for any of the audio modules: kernels
    normal with variance 1 / fan-in (``[.., in, out]`` layouts: all axes but
    the last), scales, snake alphas and the tap's ``stat_std`` around 1, layer
    scales around 0.5, biases and ``stat_mean`` small, codebooks and distance
    embeddings standard normal."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in model.state_dict().items():
        shape = tuple(p.shape)
        if name.endswith(("scale", "alpha", "stat_std")):
            w = 1.0 + 0.1 * rng.normal(size=shape)
        elif name.endswith("gamma"):
            w = 0.5 + 0.1 * rng.normal(size=shape)
        elif name.endswith("kernel"):
            w = rng.normal(size=shape) / np.sqrt(max(1, int(np.prod(shape[:-1]))))
        elif name.endswith(("bias", "stat_mean")):
            w = 0.1 * rng.normal(size=shape)
        else:  # codebooks, distance embeddings
            w = rng.normal(size=shape)
        out[name] = w.astype(np.float32)
    return out


def load_seeded(model, seed=0):
    """``model`` with :func:`seeded_state` loaded; returns (model, the numpy
    state dict)."""
    state = seeded_state(model, seed)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model.eval(), state
