"""Reference (MaskGCT / HF w2v-BERT) audio checkpoints into the PyTorch
package: ``audio/torch_ckpt.py``, ``conformer.params_from_hf``, the semantic
tokenizer's loaders and ``TTSPipeline.load_torch_audio_weights``, against the
JAX package's converters on seeded reference-named state dicts.

The state dicts are written from seeded modules by
``tools/reference_state_dicts.py`` (weight-norm pairs in both key styles). The
converters of both packages are numpy transposes, reshapes and a float64
weight-norm fold, so their outputs must be BITWISE equal (after
``param_bridge``), and the export followed by the import must give the
module's own weights back bitwise. Module outputs: ids and codes exactly
equal; float32 outputs within the tolerances of the module parity tests
(codec decoder: 1e-4 of the largest sample; one S2A denoiser forward: atol
1e-4 on O(1) values, two layers summed in another order; conformer against
HF: atol 2e-5, rtol 1e-4, the JAX package's own bar).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_audio_helpers as h
from maxtext_indextts2_tpu.audio import conformer as jax_conformer
from maxtext_indextts2_tpu.audio import s2a as jax_s2a
from maxtext_indextts2_tpu.audio import torch_ckpt as jtc
from maxtext_indextts2_tpu.audio.acoustic import AcousticCodec as JaxAcousticCodec
from maxtext_indextts2_tpu.audio.repcodec import RepCodec as JaxRepCodec
from maxtext_indextts2_tpu.audio.semantic_tokenizer import SemanticTokenizer as JaxTokenizer
from maxtext_indextts2_tpu_torch.audio import conformer
from maxtext_indextts2_tpu_torch.audio import torch_ckpt as tc
from maxtext_indextts2_tpu_torch.audio.acoustic import AcousticCodec, CodecDecoder
from maxtext_indextts2_tpu_torch.audio.repcodec import RepCodec
from maxtext_indextts2_tpu_torch.audio.s2a import S2AConfig, S2AModel
from maxtext_indextts2_tpu_torch.audio.semantic_tokenizer import SemanticTokenizer
from maxtext_indextts2_tpu_torch.tools import reference_state_dicts as rsd
from maxtext_indextts2_tpu_torch.utils.param_bridge import (
    semantic_tokenizer_params_from_jax, tree_to_state_dict,
)

STYLES = ["legacy", "parametrize", None]
TINY_REPCODEC = dict(codebook_size=64, vocos_dim=32, vocos_intermediate_dim=64,
                     vocos_num_layers=2)
TINY_CONFORMER = dict(input_dim=160, hidden_size=64, num_layers=2, num_heads=4,
                      intermediate_size=128, output_layer=2)
# a tap below the depth: only the layers up to the tap are built and exported
TAP_BELOW_DEPTH = {**TINY_CONFORMER, "num_layers": 3}
CONV_DECODER = dict(in_channels=64, num_quantizers=3, codebook_size=64,
                    use_vocos=False, upsample_initial_channel=32, up_ratios=(2, 3))


def _jax_sd(tree):
    """The JAX converter's ``{"params": ...}`` as a flat state dict."""
    return tree_to_state_dict(jax.tree.map(np.asarray, tree))


def _equal(got, want, keys=None):
    """Bitwise equal on ``keys`` (default: every name, and the same names)."""
    if keys is None:
        assert set(got) == set(want), sorted(set(got) ^ set(want))
        keys = sorted(want)
    for k in keys:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def _seeded(module, seed):
    return h.load_seeded(module, seed)[0]


# ------------------------------------------------------------------ weight norm
@pytest.mark.parametrize("style", ["legacy", "parametrize"])
def test_fold_weight_norm_equals_the_jax_package(style):
    rng = np.random.default_rng(0)
    keys = {"legacy": ("a.weight_g", "a.weight_v"),
            "parametrize": ("a.parametrizations.weight.original0",
                            "a.parametrizations.weight.original1")}[style]
    sd = {keys[0]: torch.from_numpy(rng.uniform(0.5, 2, (6, 1, 1)).astype(np.float32)),
          keys[1]: torch.from_numpy(rng.normal(size=(6, 4, 3)).astype(np.float32)),
          "a.bias": torch.zeros(6)}
    got, want = tc.fold_weight_norm(tc._np(sd)), jtc.fold_weight_norm(jtc._np(sd))
    assert set(got) == set(want) == {"a.weight", "a.bias"}
    assert got["a.weight"].dtype == np.float32
    np.testing.assert_array_equal(got["a.weight"], want["a.weight"])


# ------------------------------------------------------------------ converters
@pytest.mark.parametrize("style", STYLES)
def test_repcodec_converter_equals_jax_and_inverts_the_export(style):
    module = _seeded(RepCodec(hidden_size=64, **TINY_REPCODEC, device="cpu"), 1)
    ref = rsd.repcodec_state_dict(module, weight_norm=style)
    got = tc.repcodec_params_from_torch(ref)
    _equal(got, _jax_sd(jtc.repcodec_params_from_torch(ref)))
    _equal(got, module.state_dict())
    assert tc.repcodec_kwargs_from_torch(ref) == jtc.repcodec_kwargs_from_torch(ref) == dict(
        hidden_size=64, codebook_dim=8, num_quantizers=1, **TINY_REPCODEC)


@pytest.mark.parametrize("style", STYLES)
def test_codec_converters_equal_jax_and_invert_the_export(style):
    codec = _seeded(AcousticCodec(**h.TINY_CODEC, device="cpu"), 2)
    enc_ref = rsd.codec_encoder_state_dict(codec.encoder, weight_norm=style)
    got = tc.codec_encoder_params_from_torch(enc_ref)
    _equal(got, _jax_sd(jtc.codec_encoder_params_from_torch(enc_ref)))
    _equal(got, codec.encoder.state_dict())
    assert tc.codec_encoder_kwargs_from_torch(enc_ref) == jtc.codec_encoder_kwargs_from_torch(
        enc_ref) == dict(d_model=32, strides=(3, 4, 5, 8), out_channels=64)

    dec_ref = rsd.codec_decoder_state_dict(codec.decoder, weight_norm=style)
    assert not any(k.startswith("head") for k in dec_ref)  # the reference has no head
    got = tc.codec_decoder_params_from_torch(dec_ref)
    _equal(got, _jax_sd(jtc.codec_decoder_params_from_torch(dec_ref)))
    _equal(got, {k: v for k, v in codec.decoder.state_dict().items()
                 if not k.startswith("head.")})
    assert tc.codec_decoder_kwargs_from_torch(dec_ref) == jtc.codec_decoder_kwargs_from_torch(
        dec_ref)


@pytest.mark.parametrize("style", STYLES)
def test_conv_decoder_variant_converts_like_jax(style):
    decoder = _seeded(CodecDecoder(**CONV_DECODER, device="cpu"), 3)
    ref = rsd.codec_decoder_state_dict(decoder, weight_norm=style)
    got = tc.codec_decoder_params_from_torch(ref)
    _equal(got, _jax_sd(jtc.codec_decoder_params_from_torch(ref)))
    _equal(got, decoder.state_dict())
    kwargs = tc.codec_decoder_kwargs_from_torch(ref)
    assert kwargs == jtc.codec_decoder_kwargs_from_torch(ref)
    assert kwargs["up_ratios"] == (2, 3) and kwargs["use_vocos"] is False


def test_s2a_and_diffllama_converters_equal_jax_and_invert_the_export():
    weights = h.s2a_weights(seed=4)
    ref = rsd.s2a_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    got = tc.s2a_params_from_torch(ref)
    _equal(got, _jax_sd(jtc.s2a_params_from_torch(ref)))
    _equal(got, {k: torch.from_numpy(v) for k, v in weights.items()})
    assert tc.s2a_kwargs_from_torch(ref) == jtc.s2a_kwargs_from_torch(ref) == {
        k: v for k, v in h.TINY.items() if k != "num_heads"}
    # the DiffLlama alone, under its own prefix
    diff = {k[len("diff_estimator."):]: v for k, v in ref.items()
            if k.startswith("diff_estimator.")}
    got = tc.diffllama_params_from_torch(diff)
    _equal(got, _jax_sd(jtc.diffllama_params_from_torch(diff)))
    _equal(got, {k[len("denoiser."):]: v for k, v in tc.s2a_params_from_torch(ref).items()
                 if k.startswith("denoiser.")})


def test_an_int8_served_s2a_is_not_exported():
    model = S2AModel(dataclasses.replace(S2AConfig(**h.TINY), int8_matmul="offline"),
                     device="cpu")
    with pytest.raises(ValueError, match="float weights"):
        rsd.s2a_state_dict(model)


# ------------------------------------------------------------------ module outputs
def test_converted_repcodec_gives_jax_ids():
    module = _seeded(RepCodec(hidden_size=64, **TINY_REPCODEC, device="cpu"), 5)
    ref = rsd.repcodec_state_dict(module)
    ours = RepCodec(hidden_size=64, **TINY_REPCODEC, device="cpu").eval()
    ours.load_state_dict(tc.repcodec_params_from_torch(ref))
    jmodel = JaxRepCodec(hidden_size=64, **TINY_REPCODEC)
    feats = np.random.default_rng(6).normal(size=(2, 40, 64)).astype(np.float32)
    want = jmodel.apply(jtc.repcodec_params_from_torch(ref), jnp.asarray(feats),
                        method=jmodel.quantize)
    np.testing.assert_array_equal(ours.quantize(torch.from_numpy(feats)).numpy(),
                                  np.asarray(want))


def test_converted_codec_decoder_gives_the_jax_waveform():
    codec = _seeded(AcousticCodec(**h.TINY_CODEC, device="cpu"), 7)
    ref = rsd.codec_decoder_state_dict(codec.decoder)
    ours = AcousticCodec(**h.TINY_CODEC, device="cpu").eval()
    ours.load_state_dict(codec.state_dict())  # the head: the reference has none
    with torch.no_grad():
        for p in ours.decoder.quantizer.parameters():
            p.zero_()
    ours.decoder.load_state_dict(tc.codec_decoder_params_from_torch(ref), strict=False)
    jcodec = JaxAcousticCodec(**h.TINY_CODEC)
    params = jax.tree.map(jnp.asarray, {"params": {
        "decoder": {**jax.tree.map(np.asarray, jtc.codec_decoder_params_from_torch(ref))["params"],
                    "head": {"out": {"kernel": codec.decoder.head.out.kernel.detach().numpy(),
                                     "bias": codec.decoder.head.out.bias.detach().numpy()}}}}})
    idx = np.random.default_rng(8).integers(0, h.TINY_CODEC["codebook_size"], size=(3, 2, 6))
    want = np.asarray(jcodec.apply(params, jnp.asarray(idx), method=jcodec.detokenize))
    got = ours.detokenize(torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_converted_s2a_denoiser_matches_jax():
    ref = rsd.s2a_state_dict({k: torch.from_numpy(v) for k, v in h.s2a_weights(9).items()})
    ours = S2AModel(S2AConfig(**h.TINY), device="cpu").eval()
    ours.load_state_dict(tc.s2a_params_from_torch(ref))
    jmodel = jax_s2a.S2AModel(jax_s2a.S2AConfig(**h.TINY))
    params = jtc.s2a_params_from_torch(ref)
    rng = np.random.default_rng(10)
    hid = h.TINY["hidden_size"]
    x = rng.normal(size=(2, 12, hid)).astype(np.float32)
    cond = rng.normal(size=(2, 12, hid)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    mask = np.ones((2, 12), np.int32)
    want = jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond),
                        jnp.asarray(mask), method=lambda m, *a: m.denoiser(*a))
    with torch.no_grad():
        got = ours.denoiser(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond),
                            torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


# ------------------------------------------------------------------ w2v-BERT (HF)
def _tiny_hf_w2vbert():
    tf = pytest.importorskip("transformers")
    hf_cfg = tf.Wav2Vec2BertConfig(
        hidden_size=32, num_hidden_layers=3, num_attention_heads=2, intermediate_size=48,
        feature_projection_input_dim=20, conv_depthwise_kernel_size=31,
        position_embeddings_type="relative_key", left_max_position_embeddings=64,
        right_max_position_embeddings=8, hidden_dropout=0.0, attention_dropout=0.0,
        feat_proj_dropout=0.0, conformer_conv_dropout=0.0)
    torch.manual_seed(0)
    return tf.Wav2Vec2BertModel(hf_cfg).eval()


@pytest.mark.parametrize("tap", [3, 2])
def test_conformer_from_hf_matches_hf_and_the_jax_converter(tap):
    hf = _tiny_hf_w2vbert()
    sd = hf.state_dict()
    cfg = conformer.config_from_hf_state_dict(sd, output_layer=tap)
    jcfg = jax_conformer.config_from_hf_state_dict(sd, output_layer=tap)
    assert {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"} \
        == {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    rng = np.random.default_rng(1)
    mean = rng.normal(size=32).astype(np.float32)
    std = rng.uniform(0.5, 2.0, size=32).astype(np.float32)
    got = conformer.params_from_hf(sd, cfg, mean, std)
    want = _jax_sd(jax_conformer.params_from_hf(sd, jcfg, mean, std))
    # the port builds the layers up to the tap only
    assert set(got) <= set(want) and f"encoder.layers_{tap}.final_layer_norm.scale" not in got
    _equal(got, {k: want[k] for k in got}, keys=sorted(got))
    enc = conformer.SemanticEncoder(cfg, device="cpu").eval()
    enc.load_state_dict(got)
    feats = rng.standard_normal((2, 25, 20)).astype(np.float32)
    with torch.no_grad():
        ref = hf(torch.from_numpy(feats), output_hidden_states=True).hidden_states[tap]
        ours = enc(torch.from_numpy(feats))
    np.testing.assert_allclose(ours.numpy(), ((ref - torch.from_numpy(mean))
                                              / torch.from_numpy(std)).numpy(),
                               atol=2e-5, rtol=1e-4)


def test_w2vbert_export_loads_into_the_hf_model_and_imports_back_bitwise():
    hf = _tiny_hf_w2vbert()
    cfg = conformer.config_from_hf_state_dict(hf.state_dict())
    enc = _seeded(conformer.SemanticEncoder(cfg, device="cpu"), 12)
    exported = rsd.hf_w2vbert_state_dict(enc)
    hf_sd = hf.state_dict()
    assert all(hf_sd[k].shape == v.shape for k, v in exported.items())
    missing, unexpected = hf.load_state_dict(exported, strict=False)
    assert not unexpected and not any("encoder.layers" in k and "pos" not in k
                                      and "embed_positions" not in k for k in missing)
    stats = rsd.semantic_stats(enc)
    std = np.sqrt(stats["var"].numpy())
    np.testing.assert_array_equal(std, enc.stat_std.detach().numpy())  # sqrt(fl(s * s)) == s
    _equal(conformer.params_from_hf(exported, cfg, stats["mean"].numpy(), std), enc.state_dict())
    feats = np.random.default_rng(13).standard_normal((1, 21, 20)).astype(np.float32)
    with torch.no_grad():
        ref = hf(torch.from_numpy(feats), output_hidden_states=True).hidden_states[3]
        ours = enc.encoder(torch.from_numpy(feats))
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=2e-5, rtol=1e-4)


def test_hf_loader_refuses_an_incomplete_checkpoint():
    hf = _tiny_hf_w2vbert()
    cfg = conformer.ConformerConfig(input_dim=20, hidden_size=32, num_layers=4, num_heads=2,
                                    intermediate_size=48, output_layer=4)
    with pytest.raises(ValueError, match="incomplete checkpoint"):
        conformer.params_from_hf(hf.state_dict(), cfg)


# ------------------------------------------------------------------ semantic tokenizer
def _tokenizer_sources(seed=14, encoder=TINY_CONFORMER):
    src = _seeded(SemanticTokenizer(conformer.ConformerConfig(**encoder), TINY_REPCODEC,
                                    device="cpu"), seed)
    return src, (rsd.hf_w2vbert_state_dict(src.encoder), rsd.repcodec_state_dict(src.repcodec),
                 rsd.semantic_stats(src.encoder))


def test_semantic_tokenizer_loaders_equal_the_jax_package():
    src, (enc_sd, rep_sd, stats) = _tokenizer_sources()
    tok = SemanticTokenizer(conformer.ConformerConfig(**TINY_CONFORMER), TINY_REPCODEC,
                            device="cpu", seed=99)
    tok.load_torch_weights(enc_sd, rep_sd, stats)
    _equal(tok.state_dict(), src.state_dict())
    jtok = JaxTokenizer(jax_conformer.ConformerConfig(**TINY_CONFORMER), TINY_REPCODEC)
    jtok.load_torch_weights({k: v.numpy() for k, v in enc_sd.items()}, rep_sd,
                            {k: v.numpy() for k, v in stats.items()})
    want = semantic_tokenizer_params_from_jax(jax.tree.map(np.asarray, jtok.params))
    _equal({k: v for k, v in tok.state_dict().items()}, {k: want[k] for k in tok.state_dict()},
           keys=sorted(tok.state_dict()))
    wav = 0.1 * np.random.default_rng(15).standard_normal((1, 16_000)).astype(np.float32)
    got, _ = tok.tokenize(wav)
    ids, _ = jtok.tokenize(wav)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ids))


def test_semantic_tokenizer_loads_each_artifact_alone():
    src, (enc_sd, rep_sd, stats) = _tokenizer_sources(16, TAP_BELOW_DEPTH)
    assert "encoder.layers.2.final_layer_norm.weight" not in enc_sd
    tok = SemanticTokenizer(conformer.ConformerConfig(**TAP_BELOW_DEPTH), TINY_REPCODEC,
                            device="cpu", seed=98)
    before = {k: v.clone() for k, v in tok.state_dict().items()}
    tok.load_torch_repcodec(rep_sd)
    _equal({k: v for k, v in tok.state_dict().items() if k.startswith("repcodec.")},
           {k: v for k, v in src.state_dict().items() if k.startswith("repcodec.")})
    assert torch.equal(tok.encoder.stat_std, before["encoder.stat_std"])
    tok.set_stats(stats)
    assert torch.equal(tok.encoder.stat_std, src.encoder.stat_std)
    assert torch.equal(tok.encoder.stat_mean, src.encoder.stat_mean)
    # encoder weights without statistics: identity statistics, as in the JAX package
    tok.load_hf_encoder(enc_sd)
    assert torch.equal(tok.encoder.stat_std, torch.ones(64))
    _equal({k: v for k, v in tok.state_dict().items() if k.startswith("encoder.encoder.")},
           {k: v for k, v in src.state_dict().items() if k.startswith("encoder.encoder.")})
