"""Vision in the PyTorch package against the JAX package, on the CPU.

* ``models/vision.py``: the ViT encoder (pooled and projected, and the raw
  tower), the Gemma 3 projector and the Llama 4 tower, each on the JAX
  package's initial weights carried by ``utils/param_bridge``; the fusion of
  image soft tokens (the cases of the JAX package's ``tests/test_model.py``).
* ``utils/multimodal.py``: preprocessing (the resize, tiling, normalization),
  token insertion and fusion, the family helpers (``tests/test_utils.py``).
* The four vision converters, run as the JAX package's
  ``tests/test_ckpt_conversion.py`` runs them, against ``transformers``' own
  models and against the JAX converters' output on the same HF state dict.
* ``Engine.prefill`` with vision embeddings: its logits and the greedy
  stream that follows, against the JAX engine.

Inputs and weights come from numpy seeds (``transformers``' models from
``torch.manual_seed``). Tolerances: float32 against JAX, 2e-5 relative to the
largest |value| (other summation orders; 1e-5 absolute for preprocessed
pixels: the resize sums its float32 products in another order);
against ``transformers``, the JAX tests' own (2e-4 on the SigLIP tower, 2e-5
on Llama 4's, 2e-3 and equal argmax on the multimodal logits); converters'
outputs, equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.infer.engine import Engine as JaxEngine
from maxtext_indextts2_tpu.models import vision as jvision
from maxtext_indextts2_tpu.utils import ckpt_conversion as jcc
from maxtext_indextts2_tpu.utils import multimodal as jmm
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.models import Transformer
from maxtext_indextts2_tpu_torch.models import vision
from maxtext_indextts2_tpu_torch.utils import ckpt_conversion as cc
from maxtext_indextts2_tpu_torch.utils import multimodal as mm
from maxtext_indextts2_tpu_torch.utils.param_bridge import (
    params_from_jax,
    params_to_jax,
    tree_to_state_dict,
)
from torch_port_helpers import JAX_DEVICES, TINY_TTS, jax_tree, numpy_weights

TOL = 2e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("output_dim,pool", [(16, 2), (0, 1)], ids=["projected", "raw_tower"])
def test_vision_encoder_matches_jax_on_its_initial_weights(output_dim, pool):
    jcfg = jvision.VisionConfig(image_size=28, patch_size=7, hidden_size=32, num_layers=2,
                                num_heads=4, mlp_dim=64, output_dim=output_dim,
                                pool_stride=pool, dtype=jnp.float32)
    imgs = np.random.default_rng(0).normal(size=(2, 28, 28, 3)).astype(np.float32)
    enc = jvision.VisionEncoder(jcfg)
    params = enc.init(jax.random.PRNGKey(1), jnp.asarray(imgs))
    want = enc.apply(params, jnp.asarray(imgs))
    tcfg = vision.VisionConfig(image_size=28, patch_size=7, hidden_size=32, num_layers=2,
                               num_heads=4, mlp_dim=64, output_dim=output_dim,
                               pool_stride=pool, dtype=torch.float32)
    ours = vision.VisionEncoder(tcfg)
    ours.load_state_dict(tree_to_state_dict(_np_tree(params)), strict=True)
    got = ours(torch.from_numpy(imgs))
    assert tuple(got.shape) == want.shape == ((2, 4, 16) if output_dim else (2, 16, 32))
    _close(got, want)
    # and back: the port's state dict is the JAX tree
    back = params_to_jax(dict(ours.named_parameters()))
    for path, leaf in jax.tree_util.tree_leaves_with_path(_np_tree(params["params"])):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


def test_vision_encoder_bf16_matches_jax_within_bf16_steps():
    """bfloat16: every Dense and the patch product in bfloat16, the
    LayerNorms in float32, as the JAX modules do; the two frameworks round
    bfloat16 products in other places: within 2**-5 of the largest |value|."""
    kw = dict(image_size=28, patch_size=7, hidden_size=32, num_layers=2, num_heads=4,
              mlp_dim=64, output_dim=16, pool_stride=2)
    imgs = np.random.default_rng(1).normal(size=(2, 28, 28, 3)).astype(np.float32)
    enc = jvision.VisionEncoder(jvision.VisionConfig(**kw, dtype=jnp.bfloat16))
    params = enc.init(jax.random.PRNGKey(2), jnp.asarray(imgs))
    want = enc.apply(params, jnp.asarray(imgs))
    ours = vision.VisionEncoder(vision.VisionConfig(**kw, dtype=torch.bfloat16))
    ours.load_state_dict(tree_to_state_dict(_np_tree(params)), strict=True)
    got = ours(torch.from_numpy(imgs))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, want, tol=2.0 ** -5)


def test_merge_vision_embeddings_fills_placeholders_in_order():
    out = torch.arange(1 * 4 * 16, dtype=torch.float32).reshape(1, 4, 16) + 1
    tok_emb = torch.zeros((1, 6, 16))
    tokens = torch.tensor([[5, 99, 99, 7, 99, 8]])
    fused = vision.merge_vision_embeddings(tok_emb, out, tokens, image_token_id=99)
    want = jvision.merge_vision_embeddings(jnp.asarray(tok_emb.numpy()), jnp.asarray(out.numpy()),
                                           jnp.asarray(tokens.numpy()), 99)
    np.testing.assert_array_equal(fused.numpy(), np.asarray(want))
    assert torch.equal(fused[0, 1], out[0, 0]) and torch.equal(fused[0, 4], out[0, 2])
    assert (fused[0, 0] == 0).all()


def test_gemma3_projector_and_llama4_tower_match_jax():
    rng = np.random.default_rng(2)
    tower = rng.normal(size=(2, 16, 32)).astype(np.float32)
    jproj = jvision.Gemma3MultiModalProjector(vision_hidden=32, text_hidden=24,
                                              patches_per_side=4, tokens_per_side=2)
    pp = _np_tree(jproj.init(jax.random.PRNGKey(0), jnp.asarray(tower)))
    pp["params"]["mm_input_projection"] = rng.normal(size=(32, 24)).astype(np.float32)
    pp["params"]["mm_soft_emb_norm"]["scale"] = rng.normal(size=(32,)).astype(np.float32)
    proj = vision.Gemma3MultiModalProjector(32, 24, 4, 2)
    proj.load_state_dict(tree_to_state_dict(pp), strict=True)
    _close(proj(torch.from_numpy(tower)), jproj.apply(pp, jnp.asarray(tower)))

    kw = dict(image_size=16, patch_size=8, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, projector_input_dim=48, projector_output_dim=40,
              pixel_shuffle_ratio=0.5)
    imgs = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    jenc = jvision.Llama4VisionEncoder(**kw)
    ep = _np_tree(jenc.init(jax.random.PRNGKey(1), jnp.asarray(imgs)))
    enc = vision.Llama4VisionEncoder(**kw)
    enc.load_state_dict(tree_to_state_dict(ep), strict=True)
    want = jenc.apply(ep, jnp.asarray(imgs))
    got = enc(torch.from_numpy(imgs))
    assert tuple(got.shape) == want.shape == (2, 1, 40)
    _close(got, want)


@pytest.mark.parametrize("shape,out", [((48, 64), (16, 16)), ((20, 30), (56, 40)),
                                       ((448, 896), (896, 896)), ((97, 61), (336, 336))])
def test_resize_matches_jax_image_resize(shape, out):
    img = np.random.default_rng(3).uniform(size=shape + (3,)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), out + (3,), method="bilinear"))
    np.testing.assert_allclose(mm.resize_bilinear(img, *out), want, rtol=0, atol=1e-5)


def test_multimodal_preprocess_and_fuse_match_jax():
    img = (np.arange(48 * 64 * 3).reshape(48, 64, 3) % 255).astype(np.uint8)
    for tiles in (1, 2):
        cfg = mm.ImagePreprocessConfig(image_size=16, num_tiles=tiles)
        got = mm.preprocess_image(img, cfg)
        want = np.asarray(jmm.preprocess_image(img, jmm.ImagePreprocessConfig(
            image_size=16, num_tiles=tiles)))
        assert got.shape == want.shape == ((1, 16, 16, 3) if tiles == 1 else (5, 16, 16, 3))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    toks, mask = mm.insert_image_tokens(np.array([5, 99, 7], np.int32), image_placeholder_id=99,
                                        tokens_per_image=3, image_token_id=42, max_length=8)
    assert toks.tolist() == [5, 42, 42, 42, 7, 0, 0, 0]
    assert mask.tolist() == [False, True, True, True, False, False, False, False]
    jtoks, jmask = jmm.insert_image_tokens(np.array([5, 99, 7], np.int32), 99, 3, 42, 8)
    np.testing.assert_array_equal(toks, jtoks)
    np.testing.assert_array_equal(mask, jmask)
    vis = np.arange(12, dtype=np.float32).reshape(1, 3, 4) + 1.0
    fused = mm.fuse_vision_embeddings(torch.zeros((1, 8, 4)), torch.from_numpy(vis),
                                      torch.from_numpy(mask)[None])
    want = jmm.fuse_vision_embeddings(jnp.zeros((1, 8, 4)), jnp.asarray(vis),
                                      jnp.asarray(mask)[None])
    np.testing.assert_array_equal(fused.numpy(), np.asarray(want))


def test_multimodal_family_utils_match_jax():
    assert mm.supported_tile_grids(4) == jmm.supported_tile_grids(4)
    assert mm.supported_tile_grids() == jmm.supported_tile_grids()
    for h, w in ((336, 1344), (672, 672), (448, 896), (1000, 300), (50, 60)):
        assert mm.best_tile_grid(h, w) == jmm.best_tile_grid(h, w)
        assert mm.best_tile_grid(h, w, max_tiles=4) == jmm.best_tile_grid(h, w, max_tiles=4)
    img = np.random.default_rng(0).integers(0, 255, (448, 896, 3), np.uint8)
    g = mm.preprocess_image_gemma3(img)
    assert g.shape == (1, 896, 896, 3)
    np.testing.assert_allclose(g, np.asarray(jmm.preprocess_image_gemma3(img)), rtol=0,
                               atol=1e-5)
    tiles, ar = mm.preprocess_image_llama4(img)
    jtiles, jar = jmm.preprocess_image_llama4(img)
    assert ar == jar and tiles.shape == jtiles.shape
    np.testing.assert_allclose(tiles, np.asarray(jtiles), rtol=0, atol=1e-5)
    for fam, ratio in (("gemma3", (1, 1)), ("llama4", (1, 1)), ("llama4", (2, 2))):
        assert mm.tokens_for_image(fam, ratio) == jmm.tokens_for_image(fam, ratio)
    for fam in ("gemma3", "llama4"):
        p = "what is in <image>?"
        assert mm.format_vision_prompt(p, fam) == jmm.format_vision_prompt(p, fam)
    with pytest.raises(ValueError, match="unknown multimodal family"):
        mm.tokens_for_image("nope")


# ---------------------------------------------------------------- converters
SIGLIP = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
              image_size=28, patch_size=14, layer_norm_eps=1e-6)
L4_VISION = dict(hidden_size=32, intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4, image_size=16, patch_size=8, pixel_shuffle_ratio=0.5,
                 projector_input_dim=64, projector_output_dim=64, vision_output_dim=64,
                 rope_theta=10000, projector_dropout=0.0)


def _flat_jax(tree):
    return tree_to_state_dict(_np_tree(tree))


def _assert_same_dicts(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)


def _pixels(n, size, seed=0):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def test_siglip_converter_matches_transformers_and_the_jax_converter():
    from transformers import SiglipVisionConfig, SiglipVisionModel

    torch.manual_seed(0)
    hf = SiglipVisionModel(SiglipVisionConfig(**SIGLIP, hidden_act="gelu_pytorch_tanh")).eval()
    sd = cc.convert_hf_siglip_to_framework(hf.state_dict(), num_layers=2)
    _assert_same_dicts(sd, _flat_jax(jcc.convert_hf_siglip_to_framework(hf.state_dict(), 2)))
    enc = vision.VisionEncoder(vision.VisionConfig(
        image_size=28, patch_size=14, hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128,
        output_dim=0, pool_stride=1, dtype=torch.float32))
    enc.load_state_dict(sd, strict=True)
    imgs = _pixels(2, 28)
    with torch.no_grad():
        ref = hf(pixel_values=torch.from_numpy(imgs.transpose(0, 3, 1, 2))).last_hidden_state
        got = enc(torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-4)


def test_llama4_vision_converter_matches_transformers_and_the_jax_converter():
    from transformers import Llama4VisionConfig
    from transformers.models.llama4.modeling_llama4 import Llama4VisionModel

    torch.manual_seed(0)
    hf = Llama4VisionModel(Llama4VisionConfig(**L4_VISION)).eval()
    sd = cc.convert_hf_llama4_vision_to_framework(hf.state_dict(), 2)
    _assert_same_dicts(sd, _flat_jax(jcc.convert_hf_llama4_vision_to_framework(
        hf.state_dict(), 2)))
    enc = vision.Llama4VisionEncoder(image_size=16, patch_size=8, hidden_size=32, num_layers=2,
                                     num_heads=4, intermediate_size=128, projector_input_dim=64,
                                     projector_output_dim=64, pixel_shuffle_ratio=0.5)
    enc.load_state_dict(sd, strict=True)
    imgs = _pixels(2, 16)
    with torch.no_grad():
        ref = hf(pixel_values=torch.from_numpy(imgs.transpose(0, 3, 1, 2))).last_hidden_state
        got = enc(torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5)


def _logits(cfg, text_sd, tokens, soft):
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(text_sd, strict=True)
    pos = torch.arange(tokens.shape[1], dtype=torch.int32)[None].expand(tokens.shape[0], -1)
    with torch.no_grad():
        return model(torch.from_numpy(tokens), pos, torch.ones(tokens.shape, dtype=torch.int32),
                     vision_embeddings=soft).numpy()


def test_gemma3_multimodal_converter_logits_match_transformers():
    from transformers import (
        Gemma3Config,
        Gemma3ForConditionalGeneration,
        Gemma3TextConfig,
        SiglipVisionConfig,
    )

    tc = Gemma3TextConfig(
        vocab_size=260, hidden_size=64, intermediate_size=128, num_hidden_layers=6,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, max_position_embeddings=128,
        rope_theta=10000.0, rope_local_base_freq=10000.0, sliding_window=8,
        query_pre_attn_scalar=16, attn_logit_softcapping=None, final_logit_softcapping=None,
        tie_word_embeddings=True)
    hf_cfg = Gemma3Config(text_config=tc, vision_config=SiglipVisionConfig(**SIGLIP),
                          mm_tokens_per_image=1, image_token_index=259, boi_token_index=257,
                          eoi_token_index=258)
    torch.manual_seed(0)
    hf = Gemma3ForConditionalGeneration(hf_cfg).eval()
    args = ["decoder_block=gemma3", "base_emb_dim=64", "base_mlp_dim=128",
            "base_num_decoder_layers=6", "base_num_query_heads=4", "base_num_kv_heads=2",
            "head_dim=16", "vocab_size=260", "max_target_length=32", "sliding_window_size=8",
            "query_pre_attn_scalar=16", "image_token_id=259", "dtype=float32",
            "weight_dtype=float32", "attention=dot_product"]
    cfg = load_config(args)
    text, vis, proj = cc.convert_hf_gemma3_multimodal(hf.state_dict(), cfg, vision_num_layers=2)
    jtext, jvis, jproj = jcc.convert_hf_gemma3_multimodal(hf.state_dict(), jax_load_config(args),
                                                          vision_num_layers=2)
    _assert_same_dicts(vis, _flat_jax(jvis))
    _assert_same_dicts(proj, _flat_jax(jproj))
    _assert_same_dicts(text, params_from_jax(_np_tree(jtext)))

    imgs = _pixels(2, 28)
    tokens = np.random.default_rng(0).integers(0, 256, size=(2, 12)).astype(np.int32)
    tokens[:, 3] = 259
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(tokens.astype(np.int64)),
                 pixel_values=torch.from_numpy(imgs.transpose(0, 3, 1, 2))).logits.numpy()
        enc = vision.VisionEncoder(vision.VisionConfig(
            image_size=28, patch_size=14, hidden_size=64, num_layers=2, num_heads=4,
            mlp_dim=128, output_dim=0, pool_stride=1, dtype=torch.float32))
        enc.load_state_dict(vis, strict=True)
        projector = vision.Gemma3MultiModalProjector(64, 64, patches_per_side=2,
                                                     tokens_per_side=1, eps=1e-6)
        projector.load_state_dict(proj, strict=True)
        soft = projector(enc(torch.from_numpy(imgs)))
    ours = _logits(cfg, text, tokens, soft)
    np.testing.assert_array_equal(ref.argmax(-1), ours.argmax(-1))
    assert np.abs(ref - ours).max() < 2e-3


def test_llama4_multimodal_converter_logits_match_transformers():
    from transformers import (
        Llama4Config,
        Llama4ForConditionalGeneration,
        Llama4TextConfig,
        Llama4VisionConfig,
    )

    tc = Llama4TextConfig(
        vocab_size=260, hidden_size=64, intermediate_size=128, intermediate_size_mlp=160,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        num_local_experts=4, num_experts_per_tok=1, interleave_moe_layer_step=1,
        attention_chunk_size=8, rope_theta=10000.0, use_qk_norm=True,
        attn_temperature_tuning=True, attention_bias=False, tie_word_embeddings=False,
        rope_scaling=None, max_position_embeddings=128)
    hf_cfg = Llama4Config(text_config=tc, vision_config=Llama4VisionConfig(**L4_VISION),
                          image_token_index=259, boi_token_index=257, eoi_token_index=258)
    torch.manual_seed(0)
    hf = Llama4ForConditionalGeneration(hf_cfg).eval()
    args = ["decoder_block=llama4", "base_emb_dim=64", "base_mlp_dim=160", "moe_mlp_dim=128",
            "base_num_decoder_layers=4", "base_num_query_heads=4", "base_num_kv_heads=2",
            "head_dim=16", "vocab_size=260", "max_target_length=32",
            "chunk_attn_window_size=8", "num_experts=4", "num_experts_per_tok=1",
            "sparse_matmul=false", "rope_max_timescale=10000",
            "normalization_layer_epsilon=1e-5", "image_token_id=259", "dtype=float32",
            "weight_dtype=float32", "attention=dot_product"]
    cfg = load_config(args)
    text, vis, proj = cc.convert_hf_llama4_multimodal(hf.state_dict(), cfg, vision_num_layers=2)
    _, jvis, jproj = jcc.convert_hf_llama4_multimodal(hf.state_dict(), jax_load_config(args),
                                                      vision_num_layers=2)
    _assert_same_dicts(vis, _flat_jax(jvis))
    _assert_same_dicts(proj, _flat_jax(jproj))

    imgs = _pixels(2, 16)
    tokens = np.random.default_rng(0).integers(0, 256, size=(2, 12)).astype(np.int32)
    tokens[:, 3] = 259
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(tokens.astype(np.int64)),
                 pixel_values=torch.from_numpy(imgs.transpose(0, 3, 1, 2))).logits.numpy()
        enc = vision.Llama4VisionEncoder(image_size=16, patch_size=8, hidden_size=32,
                                         num_layers=2, num_heads=4, intermediate_size=128,
                                         projector_input_dim=64, projector_output_dim=64,
                                         pixel_shuffle_ratio=0.5)
        enc.load_state_dict(vis, strict=True)
        soft = enc(torch.from_numpy(imgs)) @ proj["kernel"]
    ours = _logits(cfg, text, tokens, soft)
    np.testing.assert_array_equal(ref.argmax(-1), ours.argmax(-1))
    assert np.abs(ref - ours).max() < 2e-3


# ------------------------------------------------------------ vision serving
IMAGE_TOKEN = 500


def test_engine_prefill_with_vision_embeddings_matches_the_jax_engine():
    """A prompt with 6 image placeholders, the soft tokens fused at prefill;
    then 6 greedy decode steps from the slot: the prefill's last logits
    within 2e-5 of the largest |logit|, the streams equal."""
    args = TINY_TTS + [f"image_token_id={IMAGE_TOKEN}"]
    cfg = load_config(args + ["per_device_batch_size=2"])
    jcfg = jax_load_config(args + [f"per_device_batch_size={2 / JAX_DEVICES}"])
    weights = numpy_weights(cfg, seed=31)
    eng = Engine(cfg, device="cpu")
    eng.set_params({k: torch.from_numpy(v) for k, v in weights.items()})
    jeng = JaxEngine(dataclasses.replace(jcfg, scan_layers=False), params=jax_tree(weights))
    rng = np.random.default_rng(4)
    p = rng.integers(1, 400, size=14).astype(np.int32)
    p[3:9] = IMAGE_TOKEN
    soft = rng.normal(size=(1, 6, cfg.emb_dim)).astype(np.float32)
    prefix, first = eng.prefill(p, len(p), vision_embeddings=soft)
    jprefix, jfirst = jeng.prefill(p, len(p), vision_embeddings=soft)
    _close(prefix["logits"], jprefix["logits"])
    plain, _ = eng.prefill(p, len(p))  # the soft tokens change the prompt
    assert not torch.allclose(plain["logits"], prefix["logits"])
    assert int(first[0]) == int(np.asarray(jfirst)[0])
    state = eng.insert(prefix, eng.init_decode_state(), 1)
    jstate = jeng.insert(jprefix, jeng.init_decode_state(), 1)
    state, toks = eng.generate_n(state, 6)
    jstate, jtoks = jeng.generate_n(jstate, 6)
    np.testing.assert_array_equal(np.asarray(toks.cpu())[:, 1], np.asarray(jtoks)[:, 1])
