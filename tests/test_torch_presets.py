"""The model presets: ``model_name=<preset>`` builds the same model in both
packages.

The port keeps byte copies of the JAX package's ``configs/models/*.yml``
(``tests/test_torch_port_hygiene.py`` holds each one equal). A preset the
port can build gives the JAX package's configuration values and parameter
shapes: the dense families and, since ROADMAP item 6's serving part, MoE,
MLA, gpt3 and llama4 text; ``deepseek-v3`` with its ``mtp_num_layers``
since item 6's MTP and MoE training part (its MTP layer trains only; serving
skips it). A preset never falls back to the default model.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.models import Transformer as JaxTransformer
from maxtext_indextts2_tpu_torch import config as port_config
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.models import Transformer
from maxtext_indextts2_tpu_torch.utils.param_bridge import _flat_from_jax

torch.set_num_threads(1)

PRESETS = os.path.join(os.path.dirname(port_config.__file__), "configs", "models")
BUILT = ["llama3-8b", "qwen3-8b", "gemma2-2b", "mistral-7b"]
ITEM_6 = sorted(n[:-4] for n in os.listdir(PRESETS)
                if n.startswith(("deepseek-", "mixtral-", "qwen3-30b-a3b", "llama4-", "gpt3-")))
# the item-6 presets the chip run serves (gpt3-52k and gpt3-6b's head dims
# differ; deepseek-v2-lite has leading dense layers and shared experts)
ITEM_6_SHAPES = ["qwen3-30b-a3b", "deepseek-v2-lite", "mixtral-8x7b", "gpt3-6b",
                 "llama4-scout-17b-16e"]
SMALL = ["max_target_length=16", "max_prefill_predict_length=8"]
# widths, depth, heads, vocabulary, norms and RoPE: what a preset sets and what it derives
DERIVED = ("decoder_block", "emb_dim", "mlp_dim", "num_decoder_layers", "num_query_heads",
           "num_kv_heads", "head_dim", "vocab_size", "normalization_layer_epsilon",
           "rope_max_timescale", "logits_via_embedding", "mlp_activations")


def _preset_keys(name):
    with open(os.path.join(PRESETS, f"{name}.yml")) as fh:
        return set(port_config.parse_flat_yaml(fh.read()))


def test_the_item_6_presets_are_the_twelve_families_not_ported():
    assert len(ITEM_6) == 12 and len(os.listdir(PRESETS)) == 38


@pytest.mark.parametrize("name", BUILT)
def test_model_name_gives_the_jax_packages_config(name):
    cfg = load_config([f"model_name={name}"])
    jcfg = jax_load_config([f"model_name={name}"])
    keys = _preset_keys(name) | set(DERIVED)
    got = {k: getattr(cfg, k) for k in sorted(keys)}
    want = {k: getattr(jcfg, k) for k in sorted(keys)}
    assert got == want
    assert cfg.decoder_block == name.split("-")[0].split(".")[0]


def test_llama3_8b_is_not_the_default_model():
    cfg = load_config(["model_name=llama3-8b"])
    assert (cfg.decoder_block, cfg.emb_dim, cfg.num_decoder_layers, cfg.vocab_size) == (
        "llama3", 4096, 32, 128256)


def _jax_shapes(name):
    """The JAX model's parameter shapes under the port's names: an abstract
    init (no weights made), its scan-stacked layers split by the bridge."""
    import flax.linen as nn

    jcfg = jax_load_config([f"model_name={name}", "scan_layers=true"] + SMALL)
    model = JaxTransformer(cfg=jcfg)
    dummy = jnp.zeros((1, jcfg.max_prefill_predict_length), jnp.int32)
    abstract = nn.meta.unbox(jax.eval_shape(
        lambda r: model.init(r, dummy, dummy, dummy)["params"], jax.random.PRNGKey(0)))
    # zero-stride views: shaped leaves that hold one byte each
    leaves = jax.tree.map(
        lambda s: np.lib.stride_tricks.as_strided(np.zeros(1, np.int8), s.shape,
                                                  (0,) * len(s.shape)), abstract)
    return {k: tuple(v.shape) for k, v in _flat_from_jax(leaves).items()}


@pytest.mark.parametrize("name", BUILT)
def test_preset_parameter_shapes_equal_the_jax_abstract_init(name):
    model = Transformer(load_config([f"model_name={name}"] + SMALL), device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = _jax_shapes(name)
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) > 10 ** 9


@pytest.mark.parametrize("name", ITEM_6)
def test_item_6_presets_refuse_when_built(name):
    """Each item-6 preset builds (on ``meta``), ``deepseek-v3`` with its MTP
    layer (ROADMAP item 6's training part), and none refuses any more."""
    cfg = load_config([f"model_name={name}"] + SMALL)
    assert cfg.decoder_block == jax_load_config([f"model_name={name}"]).decoder_block
    assert cfg.decoder_block != "llama2"
    model = Transformer(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) > 10 ** 4
    assert hasattr(model, "mtp_1") == (cfg.mtp_num_layers > 0)


@pytest.mark.parametrize("name", ITEM_6_SHAPES)
def test_item_6_preset_shapes_equal_the_jax_abstract_init(name):
    model = Transformer(load_config([f"model_name={name}"] + SMALL), device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == _jax_shapes(name)
    assert sum(int(np.prod(s)) for s in got.values()) > 5 * 10 ** 9


@pytest.mark.parametrize("name", ITEM_6_SHAPES)
def test_item_6_preset_config_equals_the_jax_packages(name):
    cfg = load_config([f"model_name={name}"])
    jcfg = jax_load_config([f"model_name={name}"])
    keys = _preset_keys(name) | set(DERIVED) | {
        "num_experts", "num_experts_per_tok", "moe_mlp_dim", "shared_experts",
        "first_num_dense_layers", "kv_lora_rank", "q_lora_rank", "use_positional_embedding",
        "chunk_attn_window_size", "routed_score_func", "normalize_topk_weights",
        "moe_weight_on_input"}
    keys.discard("model_name")
    assert {k: getattr(cfg, k) for k in sorted(keys)} == {k: getattr(jcfg, k)
                                                          for k in sorted(keys)}


def test_an_unknown_model_name_falls_through_as_in_the_jax_package():
    """A fault of the reference, kept: a ``model_name`` with no preset file
    gives the default model in both packages (ROADMAP queue 3)."""
    cfg = load_config(["model_name=no-such-model"])
    jcfg = jax_load_config(["model_name=no-such-model"])
    assert (cfg.decoder_block, cfg.emb_dim, cfg.num_decoder_layers) == (
        jcfg.decoder_block, jcfg.emb_dim, jcfg.num_decoder_layers)
