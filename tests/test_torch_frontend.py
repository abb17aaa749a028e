"""The audio frontend of the PyTorch package against the JAX package, on the
CPU in float32 at a tiny size: the SeamlessM4T features, the w2v-BERT
conformer, RepCodec, the semantic tokenizer as a whole, the codec encoder and
``tokenize``, and the residual VQ's encode side. Weights come from a numpy
seed and reach the JAX trees through ``utils/param_bridge.py``.

Tolerances, and why: the features pass a float32 FFT, a log and a
per-utterance normalisation computed in another summation order: atol 1e-4
plus rtol 1e-4 on values up to ~4 (a mel bin near its floor has its float32
FFT difference magnified by the log). Conformer and codec latents sum in another order in
every product and convolution: atol 1e-4 on unit-scale outputs (the encoder
latents relative to their largest value). Token ids are argmaxes of those
values and must be IDENTICAL.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_audio_helpers as h
from maxtext_indextts2_tpu.audio import conformer as jax_conformer
from maxtext_indextts2_tpu.audio.acoustic import AcousticCodec as JaxAcousticCodec
from maxtext_indextts2_tpu.audio import mel as jax_mel
from maxtext_indextts2_tpu.audio.quantize import ResidualVQ as JaxResidualVQ
from maxtext_indextts2_tpu.audio.repcodec import RepCodec as JaxRepCodec
from maxtext_indextts2_tpu.audio.semantic_tokenizer import SemanticTokenizer as JaxTokenizer
from maxtext_indextts2_tpu_torch.audio import conformer, mel
from maxtext_indextts2_tpu_torch.audio.acoustic import AcousticCodec
from maxtext_indextts2_tpu_torch.audio.quantize import ResidualVQ
from maxtext_indextts2_tpu_torch.audio.repcodec import RepCodec
from maxtext_indextts2_tpu_torch.audio.semantic_tokenizer import SemanticTokenizer
from maxtext_indextts2_tpu_torch.utils.param_bridge import (
    codec_params_from_jax, params_to_jax, semantic_tokenizer_params_from_jax,
)

# tiny shapes: one thread is enough, and the cores stay free for the other test workers
torch.set_num_threads(1)

ATOL_FEATS, RTOL_FEATS = 1e-4, 1e-4
ATOL_HIDDEN = 1e-4

# a conformer with the published kernel width, distances and a tap below its depth
TINY_CONFORMER = dict(input_dim=160, hidden_size=64, num_layers=3, num_heads=4,
                      intermediate_size=128, output_layer=2)
TINY_REPCODEC = dict(codebook_size=64, vocos_dim=32, vocos_intermediate_dim=64,
                     vocos_num_layers=2)


def _wavs(seed, lengths, scale=0.1):
    """Rows of seeded noise with a tone, zero-padded to the longest."""
    rng = np.random.default_rng(seed)
    out = np.zeros((len(lengths), max(lengths)), np.float32)
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16_000.0
        out[i, :n] = scale * (rng.standard_normal(n) + np.sin(2 * np.pi * (150 + 40 * i) * t))
    return out


def _jax_conformer_cfg():
    return jax_conformer.ConformerConfig(**TINY_CONFORMER)


def _semantic_encoder(seed=0):
    enc = conformer.SemanticEncoder(conformer.ConformerConfig(**TINY_CONFORMER), device="cpu")
    return h.load_seeded(enc, seed)


# ------------------------------------------------------------------ features
@pytest.mark.parametrize("with_lengths", [False, True], ids=["full_rows", "true_lengths"])
def test_w2vbert_features_match_jax(with_lengths):
    lengths = [16_000, 11_000, 4_321] if with_lengths else [9_000, 9_000]
    wav = _wavs(1, lengths)
    lens = np.asarray(lengths, np.int32) if with_lengths else None
    want, want_len = jax_mel.w2vbert_features(
        jnp.asarray(wav), None if lens is None else jnp.asarray(lens))
    got, got_len = mel.w2vbert_features(
        torch.from_numpy(wav), None if lens is None else torch.from_numpy(lens))
    assert got.shape == want.shape and got.shape[-1] == 160
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_FEATS, rtol=RTOL_FEATS)
    if with_lengths:  # padded frames are zeros (frame n may stack one valid and one pad)
        for i, n in enumerate(got_len.tolist()):
            assert (got[i, n + 1:] == 0).all() and got[i, :n].abs().max() > 0.5


def test_mel_filterbank_and_spectrogram_match_jax():
    for kw in (dict(), dict(mel_space_triangles=True), dict(n_mels=100, n_fft=1024,
                                                            sample_rate=24_000, fmin=0.0)):
        np.testing.assert_array_equal(mel.mel_filterbank(**kw), jax_mel.mel_filterbank(**kw))
    wav = _wavs(2, [24_000, 24_000])
    want = jax_mel.mel_spectrogram(jnp.asarray(wav))
    got = mel.mel_spectrogram(torch.from_numpy(wav))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_FEATS, rtol=RTOL_FEATS)


# ------------------------------------------------------------------ conformer
def test_conformer_with_a_pad_mask_matches_jax():
    enc, state = _semantic_encoder(3)
    # only the layers below the tap exist, in both packages
    assert hasattr(enc.encoder, "layers_1") and not hasattr(enc.encoder, "layers_2")
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(3, 50, 160)).astype(np.float32)
    lens = np.array([50, 33, 1])
    pad = np.arange(50)[None, :] < lens[:, None]
    jenc = jax_conformer.SemanticEncoder(_jax_conformer_cfg())
    params = {"params": h.to_jnp(params_to_jax(state))}
    want = np.asarray(jenc.apply(params, jnp.asarray(feats), jnp.asarray(pad)))
    got = enc(torch.from_numpy(feats), torch.from_numpy(pad)).detach().numpy()
    assert got.shape == (3, 50, 64)
    np.testing.assert_allclose(got[pad], want[pad], atol=ATOL_HIDDEN, rtol=0)
    # the conv module's depthwise convolution is causal: a change at frame 40
    # leaves the frames before it as they were
    conv = enc.encoder.layers_0.conv_module
    x = torch.from_numpy(rng.normal(size=(1, 50, 64)).astype(np.float32))
    x2 = x.clone()
    x2[0, 40:] += torch.from_numpy(rng.normal(size=(10, 64)).astype(np.float32))
    a, b = conv(x, None).detach(), conv(x2, None).detach()
    assert torch.equal(a[0, :40], b[0, :40]) and (a - b)[0, 40:].abs().max() > 1e-2


def test_conformer_checkpoint_loaders_wait_for_weight_import():
    for call in (lambda: conformer.params_from_hf({}, conformer.ConformerConfig()),
                 lambda: conformer.config_from_hf_state_dict({})):
        with pytest.raises(NotImplementedError, match="port queue: 4"):
            call()


# ------------------------------------------------------------------ quantizers
def test_residual_vq_encode_matches_jax():
    rvq = ResidualVQ(32, 4, 64, 8, device="cpu")
    rvq, state = h.load_seeded(rvq, 5)
    jrvq = JaxResidualVQ(input_dim=32, num_quantizers=4, codebook_size=64, codebook_dim=8)
    params = {"params": h.to_jnp(params_to_jax(state))}
    x = np.random.default_rng(6).normal(size=(2, 37, 32)).astype(np.float32)
    want_q, want_idx = jrvq.apply(params, jnp.asarray(x), method=jrvq.quantize)
    got_q, got_idx = rvq.quantize(torch.from_numpy(x))
    assert got_idx.shape == (4, 2, 37)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got_q.detach().numpy(), np.asarray(want_q), atol=ATOL_HIDDEN,
                               rtol=0)
    # fewer stages: the first n of the full chain
    _, two = rvq.quantize(torch.from_numpy(x), n_quantizers=2)
    assert torch.equal(two, got_idx[:2])
    assert len(np.unique(got_idx.numpy())) > 20


def test_repcodec_ids_match_jax():
    codec = RepCodec(hidden_size=64, **TINY_REPCODEC, device="cpu")
    codec, state = h.load_seeded(codec, 7)
    jcodec = JaxRepCodec(hidden_size=64, **TINY_REPCODEC)
    params = {"params": h.to_jnp(params_to_jax(state))}
    feats = np.random.default_rng(8).normal(size=(2, 45, 64)).astype(np.float32)
    want = np.asarray(jcodec.apply(params, jnp.asarray(feats), method=jcodec.quantize))
    got = codec.quantize(torch.from_numpy(feats))
    assert got.shape == (2, 45)
    np.testing.assert_array_equal(got.numpy(), want)
    emb = codec.vq2emb(got)
    jemb = jcodec.apply(params, jnp.asarray(want), method=jcodec.vq2emb)
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(jemb), atol=ATOL_HIDDEN, rtol=0)
    with pytest.raises(NotImplementedError, match="port queue: 4"):
        codec(torch.from_numpy(feats))


def _tokenizer_pair(seed=9):
    tok = SemanticTokenizer(conformer.ConformerConfig(**TINY_CONFORMER), TINY_REPCODEC,
                            device="cpu")
    tok, state = h.load_seeded(tok, seed)
    jtok = JaxTokenizer(_jax_conformer_cfg(), TINY_REPCODEC)
    tree = params_to_jax(state)
    jtok.params = {"encoder": {"params": h.to_jnp(tree["encoder"])},
                   "repcodec": {"params": h.to_jnp(tree["repcodec"])}}
    return tok, jtok


def test_semantic_tokenizer_ids_and_lengths_match_jax():
    tok, jtok = _tokenizer_pair()
    lengths = [16_000, 12_345, 8_000]
    wav = _wavs(10, lengths)
    want, want_len = jtok.tokenize(wav, np.asarray(lengths, np.int32))
    got, got_len = tok.tokenize(wav, lengths)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got.shape == np.asarray(want).shape == (3, 49)
    for i, n in enumerate(got_len.tolist()):
        np.testing.assert_array_equal(got[i, :n].numpy(), np.asarray(want)[i, :n])
    assert len(np.unique(got[0].numpy())) > 5
    # one row, no lengths given: the whole row
    one, one_len = tok.tokenize(wav[0])
    assert int(one_len[0]) == 49 and torch.equal(one[0], got[0])


def test_semantic_tokenizer_tree_crosses_from_jax_and_is_seeded():
    tok, jtok = _tokenizer_pair(11)
    state = semantic_tokenizer_params_from_jax(jax.tree.map(np.asarray, jtok.params))
    assert set(state) == set(tok.state_dict())
    for k, v in tok.state_dict().items():
        assert torch.equal(v, state[k]), k
    depthwise = state["encoder.encoder.layers_0.conv_module.depthwise_conv.kernel"]
    assert depthwise.shape == (31, 1, 64)  # flax [k, in / groups, out], groups = channels
    assert {"encoder.stat_mean", "encoder.stat_std"} <= set(state)
    a = SemanticTokenizer(conformer.ConformerConfig(**TINY_CONFORMER), TINY_REPCODEC,
                          device="cpu", seed=3)
    b = SemanticTokenizer(conformer.ConformerConfig(**TINY_CONFORMER), TINY_REPCODEC,
                          device="cpu")
    assert not torch.equal(a.repcodec.enc_proj.kernel, b.repcodec.enc_proj.kernel)
    b.init_params(3)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                  b.state_dict().values()))
    for call in (lambda: a.load_hf_encoder({}), lambda: a.load_torch_repcodec({}),
                 lambda: a.load_torch_weights({}, {}), lambda: a.set_stats({})):
        with pytest.raises(NotImplementedError, match="port queue: 4"):
            call()


# ------------------------------------------------------------------ codec encoder
def test_codec_encoder_latents_and_tokenize_match_jax():
    tcodec, jcodec, params = h.codec_pair(seed=12)
    rng = np.random.default_rng(13)
    wav = (0.1 * rng.standard_normal((2, 480 * 7))).astype(np.float32)
    want_lat = np.asarray(jcodec.apply(params, jnp.asarray(wav),
                                       method=lambda m, w: m.encoder(w)))
    got_lat = tcodec.encoder(torch.from_numpy(wav)).detach().numpy()
    assert got_lat.shape == (2, 7, h.TINY_CODEC["latent_dim"])
    np.testing.assert_allclose(got_lat, want_lat, atol=ATOL_HIDDEN * np.abs(want_lat).max(),
                               rtol=0)
    want = np.asarray(jcodec.apply(params, jnp.asarray(wav), method=jcodec.tokenize))
    got = tcodec.tokenize(torch.from_numpy(wav))
    assert got.shape == (h.TINY_CODEC["num_quantizers"], 2, 7) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # the whole codec tree crosses from the JAX package
    state = codec_params_from_jax(h.to_numpy_tree(params))
    fresh = AcousticCodec(**h.TINY_CODEC, device="cpu")
    fresh.load_state_dict(state)
    assert torch.equal(fresh.tokenize(torch.from_numpy(wav)), got)


def test_codec_encoder_strides_and_published_width():
    codec = AcousticCodec(device="cpu")  # AcousticCodec()'s own defaults
    enc = codec.encoder
    assert [getattr(enc, f"block_{i}").down.stride for i in range(4)] == [3, 4, 5, 8]
    assert enc.conv_in.kernel.shape == (7, 1, 96) and enc.conv_out.kernel.shape == (3, 1536, 256)
    assert enc.block_3.down.kernel.shape == (16, 768, 1536) and enc.block_3.down.padding == 4
    defaults = {f.name: f.default for f in dataclasses.fields(JaxAcousticCodec)
                if f.name in ("d_model", "strides", "latent_dim")}
    assert defaults == {"d_model": codec.d_model, "strides": codec.strides,
                        "latent_dim": codec.latent_dim}
