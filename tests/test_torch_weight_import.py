"""HF <-> PyTorch-package LM weight conversion (``utils/ckpt_conversion.py``)
against the JAX package's converters and the HF torch forward.

For tiny ``LlamaForCausalLM``, ``Qwen3ForCausalLM``, ``MistralForCausalLM``,
``GemmaForCausalLM``, ``Gemma2ForCausalLM`` and ``Gemma3ForCausalLM`` built
here from a seed:

- the port's state dict is BITWISE equal to ``param_bridge.params_from_jax``
  of the JAX converter's output (both are transposes and reshapes of the same
  float32 tensors);
- the port's logits match HF's: the same argmax everywhere and atol 2e-3, the
  JAX package's own bar (float32, two to six layers, another summation
  order);
- the export gives the HF state dict back bitwise;
- the CLI runs both ways through files; the vision towers' converters are ported.
"""

import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.utils import ckpt_conversion as jcc
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.models import Transformer
from maxtext_indextts2_tpu_torch.train import checkpointing
from maxtext_indextts2_tpu_torch.utils import ckpt_conversion as cc
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_from_jax

torch.set_num_threads(1)

SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, max_position_embeddings=128,
             rope_theta=10000.0)
BASE = ["base_emb_dim=64", "base_mlp_dim=128", "base_num_query_heads=4",
        "base_num_kv_heads=2", "head_dim=16", "vocab_size=256", "max_target_length=32",
        "dtype=float32", "weight_dtype=float32"]
GEMMA = ["logits_via_embedding=true", "normalize_embedding_logits=false",
         "mlp_activations=[gelu,linear]"]

# family -> (HF classes, HF config kwargs, config keys, layers, tied, converter names)
FAMILIES = {
    "llama": ("LlamaConfig", "LlamaForCausalLM",
              dict(num_hidden_layers=2, rms_norm_eps=1e-6, tie_word_embeddings=False),
              ["decoder_block=llama2"], 2, False,
              ("convert_hf_llama_to_framework", "convert_framework_to_hf_llama")),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM",
              dict(num_hidden_layers=2, tie_word_embeddings=False),
              ["decoder_block=qwen3"], 2, False,
              ("convert_hf_llama_to_framework", "convert_framework_to_hf_llama")),
    "mistral": ("MistralConfig", "MistralForCausalLM",
                dict(num_hidden_layers=2, sliding_window=8, tie_word_embeddings=False),
                ["decoder_block=mistral", "sliding_window_size=8",
                 "rope_max_timescale=10000"], 2, False,
                ("convert_hf_llama_to_framework", "convert_framework_to_hf_llama")),
    "gemma": ("GemmaConfig", "GemmaForCausalLM",
              dict(num_hidden_layers=3, hidden_act="gelu_pytorch_tanh",
                   tie_word_embeddings=True),
              ["decoder_block=gemma"], 3, True,
              ("convert_hf_gemma_to_framework", "convert_framework_to_hf_llama")),
    "gemma2": ("Gemma2Config", "Gemma2ForCausalLM",
               dict(num_hidden_layers=4, query_pre_attn_scalar=16, sliding_window=8,
                    attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
                    tie_word_embeddings=True),
               ["decoder_block=gemma2", "sliding_window_size=8", "attn_logits_soft_cap=50.0",
                "final_logits_soft_cap=30.0", "query_pre_attn_scalar=16", *GEMMA], 4, True,
               ("convert_hf_gemma2_to_framework", "convert_framework_to_hf_gemma2")),
    "gemma3": ("Gemma3TextConfig", "Gemma3ForCausalLM",
               dict(num_hidden_layers=6, query_pre_attn_scalar=16, sliding_window=8,
                    rope_local_base_freq=10000.0, tie_word_embeddings=True,
                    attn_logit_softcapping=None, final_logit_softcapping=None,
                    rope_scaling=None),
               ["decoder_block=gemma3", "sliding_window_size=8", "query_pre_attn_scalar=16",
                *GEMMA], 6, True,
               ("convert_hf_gemma3_to_framework", "convert_framework_to_hf_gemma3")),
}


def _family(name, seed=0):
    cfg_cls, model_cls, kwargs, keys, layers, tied, convs = FAMILIES[name]
    torch.manual_seed(seed)
    hf = getattr(transformers, model_cls)(getattr(transformers, cfg_cls)(**SMALL, **kwargs)).eval()
    args = BASE + keys + [f"base_num_decoder_layers={layers}"]
    cfg = load_config(args)
    jcfg = jax_load_config(args + ["attention=dot_product"])
    return hf, cfg, jcfg, tied, convs


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _assert_state_dicts_equal(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", list(FAMILIES))
def test_import_equals_the_jax_converter_bitwise(name):
    hf, cfg, jcfg, _, (to_fw, _) = _family(name)
    got = getattr(cc, to_fw)(hf.state_dict(), cfg)
    jax_out = getattr(jcc, to_fw)(hf.state_dict(), jcfg)
    _assert_state_dicts_equal(got, params_from_jax(_numpy_tree(jax_out), cfg))
    # and it is this package's model's own state dict, name for name
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(got, strict=True)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_logits_match_the_hf_forward(name):
    hf, cfg, _, _, (to_fw, _) = _family(name)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(getattr(cc, to_fw)(hf.state_dict(), cfg))
    tokens = np.random.default_rng(0).integers(0, 256, size=(2, 16)).astype(np.int64)
    with torch.no_grad():
        ref = hf(torch.from_numpy(tokens)).logits.numpy()
        ours = model(torch.from_numpy(tokens.astype(np.int32)),
                     torch.arange(16, dtype=torch.int32).expand(2, 16),
                     torch.ones((2, 16), dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(ref.argmax(-1), ours.argmax(-1))
    assert np.abs(ref - ours).max() < 2e-3


@pytest.mark.parametrize("name", list(FAMILIES))
def test_export_gives_the_hf_state_dict_back_bitwise(name):
    hf, cfg, jcfg, tied, (to_fw, to_hf) = _family(name, seed=2)
    params = getattr(cc, to_fw)(hf.state_dict(), cfg)
    sd = getattr(cc, to_hf)(params, cfg)
    ref = {k: v for k, v in hf.state_dict().items() if "rotary" not in k}
    if tied:
        ref.pop("lm_head.weight", None)
    _assert_state_dicts_equal(sd, ref)
    # the JAX package's export of the same weights agrees
    jax_sd = getattr(jcc, to_hf)(getattr(jcc, to_fw)(hf.state_dict(), jcfg), jcfg)
    assert set(jax_sd) == set(sd)
    for k, v in jax_sd.items():
        np.testing.assert_array_equal(np.asarray(v), sd[k].numpy(), err_msg=k)


def test_vocab_padding_and_trimming_round_trip():
    hf, cfg, _, _, _ = _family("llama")
    cfg = load_config(BASE + ["decoder_block=llama2", "base_num_decoder_layers=2",
                              "vocab_size=384"])
    params = cc.convert_hf_llama_to_framework(hf.state_dict(), cfg)
    assert params["token_embedder.embedding"].shape == (384, 64)
    assert params["logits_dense.kernel"].shape == (64, 384)
    assert not params["token_embedder.embedding"][256:].any()
    sd = cc.convert_framework_to_hf_llama(params, cfg, hf_vocab_size=256)
    _assert_state_dicts_equal(sd, {k: v for k, v in hf.state_dict().items()})


def test_export_keeps_the_dtype_and_reads_tensors_on_any_device():
    hf, cfg, _, _, _ = _family("qwen3")
    params = {k: v.to(torch.bfloat16) for k, v in
              cc.convert_hf_llama_to_framework(hf.state_dict(), cfg).items()}
    sd = cc.convert_framework_to_hf_llama(params, cfg)
    assert {v.dtype for v in sd.values()} == {torch.bfloat16}
    back = cc.convert_hf_llama_to_framework(sd, cfg)
    assert {v.dtype for v in back.values()} == {torch.float32}  # the import makes float32
    _assert_state_dicts_equal({k: v.to(torch.bfloat16) for k, v in back.items()}, params)


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "pytorch_model_bin"])
def test_cli_converts_both_ways_through_files(tmp_path, safe, capsys):
    hf, cfg, _, _, _ = _family("qwen3", seed=3)
    hf.save_pretrained(tmp_path / "hf", safe_serialization=safe)
    keys = BASE + ["decoder_block=qwen3", "base_num_decoder_layers=2"]
    cc.main(["--hf_path", str(tmp_path / "hf"), "--out_path", str(tmp_path / "ckpt"), *keys])
    assert "converted" in capsys.readouterr().out
    restored = checkpointing.load_params_only(str(tmp_path / "ckpt"))
    _assert_state_dicts_equal(dict(restored),
                              cc.convert_hf_llama_to_framework(hf.state_dict(), cfg))
    cc.main(["--direction", "to_hf", "--ckpt_path", str(tmp_path / "ckpt"),
             "--out_path", str(tmp_path / "export"), *keys])
    exported = torch.load(tmp_path / "export" / "pytorch_model.bin", weights_only=True)
    _assert_state_dicts_equal(exported, dict(hf.state_dict()))
    # config.json is written where transformers is installed, and the directory loads
    assert os.path.exists(tmp_path / "export" / "config.json")
    loaded = transformers.AutoModelForCausalLM.from_pretrained(tmp_path / "export").eval()
    tokens = torch.arange(12)[None]
    with torch.no_grad():
        np.testing.assert_allclose(loaded(tokens).logits.numpy(), hf(tokens).logits.numpy(),
                                   atol=1e-5)


def test_a_converted_checkpoint_serves_the_stream_of_set_params(tmp_path):
    """A tts (qk-norm) model crosses as the qwen3 family: HF names ->
    params-only checkpoint -> ``Engine.load_params`` decodes the same greedy
    stream as the engine the weights came from."""
    args = ["maxtext_indextts2_tpu_torch/configs/tiny_tts.yml", "decode_sampling_strategy=greedy",
            "dtype=float32", "per_device_batch_size=2", "max_prefill_predict_length=16"]
    cfg = load_config(args)
    src = Engine(cfg, device="cpu")
    src.load_params()
    hf_dir = tmp_path / "hf"
    os.makedirs(hf_dir)
    torch.save(cc.convert_framework_to_hf_llama(src.params, cfg), hf_dir / "pytorch_model.bin")
    cc.main(["--hf_path", str(hf_dir), "--out_path", str(tmp_path / "ckpt"), *args,
             "decoder_block=qwen3"])
    eng = Engine(cfg, device="cpu")
    eng.load_params(str(tmp_path / "ckpt"))
    prompt = np.arange(3, 12, dtype=np.int32)
    assert eng.generate_stream(prompt, 8) == src.generate_stream(prompt, 8)


@pytest.mark.parametrize("block", ["mixtral", "deepseek", "gpt3", "gpt3_paxml", "llama4",
                                   "qwen3_moe"])
def test_other_families_raise_naming_item_6(block):
    """The item-6 families are ported (their parity:
    ``tests/test_torch_family_converters.py``): each direction gives the
    port's converter of the JAX table's name, or, where the JAX package has
    none (every export but mixtral's), the JAX package's ``ValueError``."""
    for direction in ("to_framework", "to_hf"):
        name = cc._CONVERTERS[block][0 if direction == "to_framework" else 1]
        if name is None:
            with pytest.raises(ValueError, match=f"{block} has no {direction} converter yet"):
                cc.get_converter(block, direction)
            with pytest.raises(ValueError, match=f"{block} has no {direction} converter yet"):
                jcc.get_converter(block, direction)
        else:
            assert cc.get_converter(block, direction) is getattr(cc, name)


VISION_CONVERTERS = ("convert_hf_siglip_to_framework", "convert_hf_gemma3_multimodal",
                     "convert_hf_llama4_vision_to_framework", "convert_hf_llama4_multimodal")


@pytest.mark.parametrize("name", [
    "convert_hf_mixtral_to_framework", "convert_framework_to_hf_mixtral",
    "convert_hf_deepseek_to_framework", "convert_hf_gpt2_to_framework",
    "convert_paxml_gpt3_to_framework", "load_paxml_gpt3_checkpoint",
    "convert_hf_llama4_to_framework", "convert_hf_qwen3_moe_to_framework",
    "convert_hf_siglip_to_framework", "convert_hf_gemma3_multimodal",
    "convert_hf_llama4_vision_to_framework", "convert_hf_llama4_multimodal"])
def test_item_6_converters_raise_when_called(name):
    """Every item-6 converter is the port's own, the vision towers' too
    since item 6's vision part (none is a refusal any more; their outputs
    against the JAX converters': tests/test_torch_vision.py). Called on an
    empty state dict (and no config), a vision converter fails on the first
    missing key or on the missing config."""
    import inspect

    assert hasattr(jcc, name)  # the JAX package has each of them
    assert "_unsupported" not in inspect.getsource(getattr(cc, name))
    if name in VISION_CONVERTERS:
        with pytest.raises((KeyError, AttributeError)):
            getattr(cc, name)({}, None) if name.endswith("framework") else \
                getattr(cc, name)({}, None, 1)


def test_converter_table_mirrors_the_jax_package():
    assert cc._CONVERTERS == jcc._CONVERTERS
    assert "tts" not in cc._CONVERTERS
    with pytest.raises(ValueError, match="no converters"):
        cc.get_converter("nope")
    assert cc.get_converter("gemma", "to_hf") is cc.convert_framework_to_hf_llama


@pytest.mark.parametrize("block", ["llama2", "mistral", "qwen3", "gemma2", "gemma3", "tts"])
def test_hf_config_for_equals_the_jax_package(block):
    args = ["base_emb_dim=64", "base_mlp_dim=128", "base_num_decoder_layers=2",
            "base_num_query_heads=4", "base_num_kv_heads=2", "head_dim=16", "vocab_size=256",
            "max_target_length=128", f"decoder_block={block}"]
    got = cc.hf_config_for(load_config(args))
    want = jcc.hf_config_for(jax_load_config(args))
    if want is None:
        assert got is None
    else:
        assert type(got) is type(want) and got.to_dict() == want.to_dict()
