"""HF (and paxml) checkpoint converters of the item-6 families
(``utils/ckpt_conversion.py``) against the JAX package's.

For each family a tiny state dict under the HF names (or a paxml getter) is
made here from a numpy seed; it goes through the port's converter and the JAX
package's, and ``param_bridge.params_from_jax`` of the JAX tree (scan-stacked
there) must equal the port's state dict BITWISE: both converters transpose,
reshape and stack the same float32 tensors. The converted weights load into
the port's ``Engine`` (every name and shape of the model) and decode; mixtral
also goes back to the HF names, bitwise. ``load_paxml_gpt3_checkpoint`` reads
a paxml directory of zarr arrays through ``tensorstore``, imported inside the
function: where the package is missing the call raises ``ImportError``, as
the JAX package's does.
"""

import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.utils import ckpt_conversion as jcc
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.utils import ckpt_conversion as cc
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_from_jax

torch.set_num_threads(1)

E, NQ, NKV, HD, V, M = 64, 4, 2, 16, 256, 96
BASE = [f"base_emb_dim={E}", f"base_num_query_heads={NQ}", f"base_num_kv_heads={NKV}",
        f"head_dim={HD}", f"vocab_size={V}", "max_target_length=32", "dtype=float32",
        "weight_dtype=float32", "per_device_batch_size=1", "decode_sampling_strategy=greedy",
        "max_prefill_predict_length=16"]
MLA = ["kv_lora_rank=24", "qk_nope_head_dim=16", "qk_rope_head_dim=8", "v_head_dim=16"]
FAMILIES = {
    "mixtral": BASE + ["decoder_block=mixtral", "base_num_decoder_layers=2", "num_experts=4",
                       "num_experts_per_tok=2", f"base_mlp_dim={M}"],
    "qwen3_moe": BASE + ["decoder_block=qwen3", "base_num_decoder_layers=2", "num_experts=4",
                         "num_experts_per_tok=2", f"moe_mlp_dim={M}"],
    "deepseek": BASE + ["decoder_block=deepseek", "base_num_decoder_layers=2", "num_experts=1",
                        f"base_mlp_dim={M}"] + MLA,
    "deepseek_q_lora": BASE + ["decoder_block=deepseek", "base_num_decoder_layers=2",
                               "num_experts=1", f"base_mlp_dim={M}", "q_lora_rank=20"] + MLA,
    "gpt2": BASE + ["decoder_block=gpt3", "base_num_decoder_layers=2", f"base_mlp_dim={M}",
                    f"base_num_kv_heads={NQ}"],
    "paxml_gpt3": BASE + ["decoder_block=gpt3", "base_num_decoder_layers=2",
                          f"base_mlp_dim={M}", f"base_num_kv_heads={NQ}"],
    "llama4": BASE + ["decoder_block=llama4", "base_num_decoder_layers=4", "num_experts=4",
                      "num_experts_per_tok=1", f"moe_mlp_dim={M}", "chunk_attn_window_size=8"],
}
CONVERTER = {"mixtral": "convert_hf_mixtral_to_framework",
             "qwen3_moe": "convert_hf_qwen3_moe_to_framework",
             "deepseek": "convert_hf_deepseek_to_framework",
             "deepseek_q_lora": "convert_hf_deepseek_to_framework",
             "gpt2": "convert_hf_gpt2_to_framework",
             "paxml_gpt3": "convert_paxml_gpt3_to_framework",
             "llama4": "convert_hf_llama4_to_framework"}


class _Draw:
    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.sd = {}

    def __call__(self, name, *shape, scale=None):
        w = self.rng.normal(size=shape) * (scale if scale is not None
                                           else 1.0 / np.sqrt(shape[-1]))
        self.sd[name] = torch.from_numpy(w.astype(np.float32))


def _attention(d, h):
    d(h + "self_attn.q_proj.weight", NQ * HD, E)
    d(h + "self_attn.k_proj.weight", NKV * HD, E)
    d(h + "self_attn.v_proj.weight", NKV * HD, E)
    d(h + "self_attn.o_proj.weight", E, NQ * HD)


def _norms(d, h):
    d(h + "input_layernorm.weight", E, scale=0.1)
    d(h + "post_attention_layernorm.weight", E, scale=0.1)


def hf_state_dict(family: str, cfg, seed=0) -> dict:
    d = _Draw(seed)
    if family == "gpt2":
        d("transformer.wte.weight", V, E)
        d("transformer.wpe.weight", cfg.max_target_length, E)
        for i in range(cfg.num_decoder_layers):
            h = f"transformer.h.{i}."
            d(h + "attn.c_attn.weight", E, 3 * E)
            d(h + "attn.c_attn.bias", 3 * E, scale=0.1)
            d(h + "attn.c_proj.weight", E, E)
            d(h + "attn.c_proj.bias", E, scale=0.1)
            d(h + "mlp.c_fc.weight", E, M)
            d(h + "mlp.c_fc.bias", M, scale=0.1)
            d(h + "mlp.c_proj.weight", M, E)
            d(h + "mlp.c_proj.bias", E, scale=0.1)
            for ln in ("ln_1", "ln_2"):
                d(f"{h}{ln}.weight", E, scale=0.1)
                d(f"{h}{ln}.bias", E, scale=0.1)
        d("transformer.ln_f.weight", E, scale=0.1)
        d("transformer.ln_f.bias", E, scale=0.1)
        return d.sd
    d("model.embed_tokens.weight", V, E)
    d("model.norm.weight", E, scale=0.1)
    d("lm_head.weight", V, E)
    for i in range(cfg.num_decoder_layers):
        h = f"model.layers.{i}."
        _norms(d, h)
        if family.startswith("deepseek"):
            r, n = cfg.kv_lora_rank, cfg.num_query_heads
            d_qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            d(h + "self_attn.kv_a_proj_with_mqa.weight", r + cfg.qk_rope_head_dim, E)
            d(h + "self_attn.kv_a_layernorm.weight", r, scale=0.1)
            d(h + "self_attn.kv_b_proj.weight", n * (cfg.qk_nope_head_dim + cfg.v_head_dim), r)
            d(h + "self_attn.o_proj.weight", E, n * cfg.v_head_dim)
            if cfg.q_lora_rank > 0:
                d(h + "self_attn.q_a_proj.weight", cfg.q_lora_rank, E)
                d(h + "self_attn.q_a_layernorm.weight", cfg.q_lora_rank, scale=0.1)
                d(h + "self_attn.q_b_proj.weight", n * d_qk, cfg.q_lora_rank)
            else:
                d(h + "self_attn.q_proj.weight", n * d_qk, E)
            for proj, shape in (("gate_proj", (M, E)), ("up_proj", (M, E)),
                                ("down_proj", (E, M))):
                d(f"{h}mlp.{proj}.weight", *shape)
            continue
        _attention(d, h)
        x = cfg.num_experts
        if family == "mixtral":
            d(h + "block_sparse_moe.gate.weight", x, E)
            for e in range(x):
                ep = f"{h}block_sparse_moe.experts.{e}."
                d(ep + "w1.weight", M, E)
                d(ep + "w3.weight", M, E)
                d(ep + "w2.weight", E, M)
        elif family == "qwen3_moe":
            d(h + "self_attn.q_norm.weight", HD, scale=0.1)
            d(h + "self_attn.k_norm.weight", HD, scale=0.1)
            d(h + "mlp.gate.weight", x, E)
            for e in range(x):
                for proj, shape in (("gate_proj", (M, E)), ("up_proj", (M, E)),
                                    ("down_proj", (E, M))):
                    d(f"{h}mlp.experts.{e}.{proj}.weight", *shape)
        elif family == "llama4":
            ff = h + "feed_forward."
            d(ff + "router.weight", x, E)
            d(ff + "experts.gate_up_proj", x, E, 2 * M)
            d(ff + "experts.down_proj", x, M, E)
            for proj, shape in (("gate_proj", (M, E)), ("up_proj", (M, E)),
                                ("down_proj", (E, M))):
                d(f"{ff}shared_expert.{proj}.weight", *shape)
    return d.sd


def paxml_getter(cfg, seed=0):
    """A dict-backed paxml ``get`` (every layer variable with a leading layer axis)."""
    rng = np.random.default_rng(seed)
    L, n, hd = cfg.num_decoder_layers, cfg.num_query_heads, cfg.head_dim
    P, X = ".params.lm", ".params.lm.transformer.repeat.sub.x_layers_0"
    shapes = {
        f"{X}.self_attention.combined_qkv.w": (L, 3, E, n, hd),
        f"{X}.self_attention.combined_qkv.b": (L, 3, n, hd),
        f"{X}.self_attention.post.w": (L, E, n, hd),
        f"{X}.self_attention.post.b": (L, E),
        f"{X}.ff_layer.ffn_layer1.linear.w": (L, E, M),
        f"{X}.ff_layer.ffn_layer1.bias.b": (L, M),
        f"{X}.ff_layer.ffn_layer2.linear.w": (L, M, E),
        f"{X}.ff_layer.ffn_layer2.bias.b": (L, E),
        f"{X}.layer_norm.scale": (L, E), f"{X}.layer_norm.bias": (L, E),
        f"{X}.ff_layer.layer_norm.scale": (L, E), f"{X}.ff_layer.layer_norm.bias": (L, E),
        f"{P}.softmax.logits_ffn.linear.w": (E, V),
        f"{P}.position_emb.emb_var": (cfg.max_target_length, E),
        f"{P}.final_ln.scale": (E,), f"{P}.final_ln.bias": (E,),
    }
    values = {k: (0.1 * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
    return values.__getitem__


def _convert_both(family):
    args = FAMILIES[family]
    cfg, jcfg = load_config(args), jax_load_config(args)
    src = paxml_getter(cfg) if family == "paxml_gpt3" else hf_state_dict(family, cfg)
    got = getattr(cc, CONVERTER[family])(src, cfg)
    tree = getattr(jcc, CONVERTER[family])(src, jcfg)
    want = params_from_jax({k: v for k, v in tree["params"].items()})
    return cfg, got, want


@pytest.mark.parametrize("family", list(FAMILIES))
def test_import_equals_the_jax_converter_bitwise(family):
    _, got, want = _convert_both(family)
    assert sorted(got) == sorted(want)
    for name in got:
        assert got[name].dtype == want[name].dtype == torch.float32, name
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("family", list(FAMILIES))
def test_converted_weights_serve(family):
    """Every name and shape of the model, and a finite greedy stream."""
    cfg, got, _ = _convert_both(family)
    eng = Engine(cfg, device="cpu")
    eng.set_params(got)
    stream = eng.generate_stream(np.arange(3, 9, dtype=np.int32), 5)
    assert len(stream) == 5 and all(0 <= t < cfg.vocab_size for t in stream)


def test_mixtral_round_trip_is_bitwise():
    args = FAMILIES["mixtral"]
    cfg, jcfg = load_config(args), jax_load_config(args)
    sd = hf_state_dict("mixtral", cfg, seed=4)
    back = cc.convert_framework_to_hf_mixtral(cc.convert_hf_mixtral_to_framework(sd, cfg), cfg)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    # the JAX package's export of its own import gives the same tensors
    jback = jcc.convert_framework_to_hf_mixtral(jcc.convert_hf_mixtral_to_framework(sd, jcfg),
                                                jcfg)
    assert all(np.array_equal(np.asarray(jback[k]), back[k].numpy()) for k in sd)


def test_load_paxml_gpt3_checkpoint_reads_zarr_variables(tmp_path):
    """A paxml ``state`` directory written here (one zarr array a variable,
    ``mdl_vars<dotted name>``) loads through both packages to the same
    tensors. Where ``tensorstore`` is missing the loader raises ImportError."""
    ts = pytest.importorskip("tensorstore")
    args = FAMILIES["paxml_gpt3"]
    cfg = load_config(args)
    get = paxml_getter(cfg, seed=2)
    for name in get.__self__:
        arr = get(name)
        spec = {"driver": "zarr", "kvstore": {"driver": "file",
                                              "path": str(tmp_path / f"mdl_vars{name}")}}
        store = ts.open(spec, create=True, dtype=arr.dtype.name, shape=arr.shape).result()
        store.write(arr).result()
    got = cc.load_paxml_gpt3_checkpoint(str(tmp_path), cfg)
    want = params_from_jax(jcc.load_paxml_gpt3_checkpoint(str(tmp_path),
                                                          jax_load_config(args))["params"])
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in got)


def test_quantize_checkpoint_quantizes_experts_per_expert_channel(tmp_path):
    """``tools/quantize_checkpoint.py`` on an MoE model: int8 experts with one
    float32 scale an (expert, output channel), as the JAX package's
    ``quantize_params_for_serving``; the quantized checkpoint serves the same
    stream as the engine that quantized on load."""
    from maxtext_indextts2_tpu_torch.tools import quantize_checkpoint
    from maxtext_indextts2_tpu_torch.train import checkpointing

    args = FAMILIES["qwen3_moe"]
    out = quantize_checkpoint.run(args + [f"save_path={tmp_path}/q"], device="cpu")
    params = checkpointing.load_params_only(f"{tmp_path}/q")
    wi = params["decoder.layers_0.moe_0.wi_0"]
    scale = params["decoder.layers_0.moe_0.wi_0_scale"]
    assert wi.dtype == torch.int8 and tuple(scale.shape) == (4, 1, M)
    assert scale.dtype == torch.float32 and 0.5 < out["value"] < 1.0
    served = Engine(load_config(args + ["quantization=int8w_serve",
                                        "checkpoint_is_quantized=true"]), device="cpu")
    served.load_params(f"{tmp_path}/q")
    fresh = Engine(load_config(args + ["quantization=int8w_serve"]), device="cpu")
    fresh.load_params()
    prompt = np.arange(3, 10, dtype=np.int32)
    assert served.generate_stream(prompt, 6) == fresh.generate_stream(prompt, 6)
