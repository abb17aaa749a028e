"""The decode side of the acoustic codec (RVQ lookup, Vocos backbone, ISTFT
head, DAC-style conv decoder) in the PyTorch package against the JAX package:
the same numpy weights and the same inputs go through both, on the CPU.

Tolerances, and why: everything here is float32 on both sides; convolutions,
matrix products and the inverse FFT sum in another order in the two
frameworks. Plain lookups are exactly equal. One layer: atol 2e-5 on O(1)
values. The 1920-point inverse FFT and the whole decoder (a few layers, then
``exp`` of the magnitude): atol 1e-4 relative to the largest sample. The conv
decoder (some 25 convolutions in a row, pre-``tanh`` values in the tens): 3e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_audio_helpers as h
from maxtext_indextts2_tpu.audio import acoustic as jax_acoustic
from maxtext_indextts2_tpu.audio import quantize as jax_quantize
from maxtext_indextts2_tpu.audio import vocos as jax_vocos
from maxtext_indextts2_tpu_torch.audio import acoustic, quantize, vocos
from maxtext_indextts2_tpu_torch.utils.param_bridge import (
    codec_decoder_params_from_jax, params_to_jax,
)

ATOL_LAYER = 2e-5
RTOL_WAV = 1e-4  # of the largest sample
RTOL_CONV_DECODER = 3e-4


def _seed_module(module, seed):
    """Seeded normal weights for a PyTorch module (norm scales, snake alphas
    and layer scales around their usual values); returns the JAX tree."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, p in module.state_dict().items():
        shape = tuple(p.shape)
        if name.endswith(("scale", "alpha", "scale.embedding")):
            w = 1.0 + 0.1 * rng.normal(size=shape)
        elif name.endswith("gamma"):
            w = 0.5 + 0.1 * rng.normal(size=shape)
        elif name.endswith("kernel"):
            w = rng.normal(size=shape) / np.sqrt(max(1, int(np.prod(shape[:-1]))))
        elif name.endswith(("bias", "shift.embedding")):
            w = 0.1 * rng.normal(size=shape)
        else:
            w = rng.normal(size=shape)
        state[name] = torch.from_numpy(w.astype(np.float32))
    module.load_state_dict(state)
    return {"params": h.to_jnp(params_to_jax(state))}


def _close_wav(got, want, rtol_of_max=RTOL_WAV):
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=rtol_of_max * np.abs(want).max(), rtol=0)


def test_residual_vq_vq2emb_matches_jax():
    tq = quantize.ResidualVQ(48, 3, 64, 8, device="cpu")
    params = _seed_module(tq, 0)
    jq = jax_quantize.ResidualVQ(input_dim=48, num_quantizers=3, codebook_size=64, codebook_dim=8)
    ids = np.random.default_rng(1).integers(0, 64, size=(3, 2, 11))
    for n in (None, 2):
        want = jq.apply(params, jnp.asarray(ids), n, method=jq.vq2emb)
        got = tq.vq2emb(torch.from_numpy(ids), n).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_LAYER)
    # one quantizer: raw codebook rows are a plain lookup, exactly equal
    rows = tq.vq_1.decode_code(torch.from_numpy(ids[1])).detach().numpy()
    np.testing.assert_array_equal(rows, np.asarray(params["params"]["vq_1"]["codebook"])[ids[1]])


def test_factorized_vq_without_projection_is_the_codebook():
    tq = quantize.FactorizedVectorQuantize(8, 16, 8, device="cpu")
    assert not hasattr(tq, "out_proj")
    ids = torch.tensor([[0, 5, 15]])
    assert torch.equal(tq.vq2emb(ids), tq.codebook[ids])


@pytest.mark.parametrize("adanorm", [None, 4], ids=["layernorm", "adanorm"])
def test_vocos_backbone_matches_jax(adanorm):
    tb = vocos.VocosBackbone(24, 32, 64, 3, adanorm, device="cpu")
    params = _seed_module(tb, 2)
    jb = jax_vocos.VocosBackbone(input_channels=24, dim=32, intermediate_dim=64, num_layers=3,
                                 adanorm_num_embeddings=adanorm)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 19, 24)).astype(np.float32)
    cond = np.array([1, 3]) if adanorm else None
    want = jb.apply(params, jnp.asarray(x), None if cond is None else jnp.asarray(cond))
    got = tb(torch.from_numpy(x), None if cond is None else torch.from_numpy(cond))
    assert got.shape == (2, 19, 32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL_LAYER)


def test_convnext_block_matches_jax():
    tb = vocos.ConvNeXtBlock(16, 40, 0.25, device="cpu")
    params = _seed_module(tb, 4)
    jb = jax_vocos.ConvNeXtBlock(dim=16, intermediate_dim=40, layer_scale_init_value=0.25)
    x = np.random.default_rng(5).normal(size=(2, 13, 16)).astype(np.float32)
    want = jb.apply(params, jnp.asarray(x))
    np.testing.assert_allclose(tb(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               atol=ATOL_LAYER)


@pytest.mark.parametrize("n_fft,hop,frames", [(1920, 480, 7), (16, 4, 9), (12, 6, 1), (8, 8, 5)])
def test_istft_overlap_add_matches_jax(n_fft, hop, frames):
    rng = np.random.default_rng(6)
    re = rng.normal(size=(2, frames, n_fft // 2 + 1)).astype(np.float32)
    im = rng.normal(size=(2, frames, n_fft // 2 + 1)).astype(np.float32)
    want = jax_vocos.istft_overlap_add(jnp.asarray(re), jnp.asarray(im), n_fft, hop)
    got = vocos.istft_overlap_add(torch.from_numpy(re), torch.from_numpy(im), n_fft, hop).numpy()
    assert got.shape == (2, frames * hop)
    _close_wav(got, want)


def test_istft_rejects_a_hop_that_does_not_divide_n_fft():
    z = torch.zeros((1, 2, 6))
    with pytest.raises(ValueError):
        vocos.istft_overlap_add(z, z, 10, 4)


def test_istft_head_matches_jax():
    th = vocos.ISTFTHead(20, 1920, 480, device="cpu")
    params = _seed_module(th, 7)
    jh = jax_vocos.ISTFTHead(n_fft=1920, hop=480)
    # wide inputs so that the magnitude clamp (exp(20), then 100) is reached
    x = (3.0 * np.random.default_rng(8).normal(size=(2, 6, 20))).astype(np.float32)
    want = jh.apply(params, jnp.asarray(x))
    _close_wav(th(torch.from_numpy(x)).detach().numpy(), want)


@pytest.mark.parametrize("stride", [2, 4, 5])
def test_upsample_conv_matches_jax_and_gives_exactly_t_times_s(stride):
    tu = acoustic.UpsampleConv(6, 10, stride, device="cpu")
    params = _seed_module(tu, 9)
    ju = jax_acoustic.UpsampleConv(out_dim=10, stride=stride)
    x = np.random.default_rng(10).normal(size=(2, 9, 6)).astype(np.float32)
    want = ju.apply(params, jnp.asarray(x))
    got = tu(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 9 * stride, 10)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_LAYER)


def test_snake_and_residual_unit_match_jax():
    x = np.random.default_rng(11).normal(size=(2, 21, 12)).astype(np.float32)
    alpha = np.abs(np.random.default_rng(12).normal(size=(12,))).astype(np.float32)
    alpha[0] = 0.0  # the clamp of the divisor
    np.testing.assert_allclose(
        acoustic.snake(torch.from_numpy(x), torch.from_numpy(alpha)).numpy(),
        np.asarray(jax_acoustic.snake(jnp.asarray(x), jnp.asarray(alpha))), atol=1e-6)
    tr = acoustic.ResidualUnit(12, 3, device="cpu")
    params = _seed_module(tr, 13)
    want = jax_acoustic.ResidualUnit(dim=12, dilation=3).apply(params, jnp.asarray(x))
    np.testing.assert_allclose(tr(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               atol=ATOL_LAYER)


@pytest.mark.parametrize("use_vocos", [True, False], ids=["vocos", "conv_decoder"])
def test_codec_decoder_variants_match_jax(use_vocos):
    kw = dict(in_channels=32, num_quantizers=3, codebook_size=64, codebook_dim=8,
              vocos_dim=48, vocos_intermediate_dim=96, vocos_num_layers=2, use_vocos=use_vocos,
              upsample_initial_channel=32, up_ratios=(5, 4, 2))
    td = acoustic.CodecDecoder(**kw, device="cpu")
    params = _seed_module(td, 14)
    jd = jax_acoustic.CodecDecoder(**kw)
    ids = np.random.default_rng(15).integers(0, 64, size=(3, 2, 10))
    emb_want = jd.apply(params, jnp.asarray(ids), method=jd.vq2emb)
    emb = td.vq2emb(torch.from_numpy(ids))
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(emb_want), atol=ATOL_LAYER)
    want = jd.apply(params, emb_want, method=jd.decode)
    got = td.decode(emb).detach().numpy()
    assert got.shape == (2, 10 * (480 if use_vocos else 40)) and td.hop == got.shape[1] // 10
    _close_wav(got, want, RTOL_WAV if use_vocos else RTOL_CONV_DECODER)


def test_detokenize_matches_jax_from_the_same_ids():
    tcodec, jcodec, params = h.codec_pair(seed=16)
    ids = np.random.default_rng(17).integers(0, 64, size=(3, 2, 12))
    want = jcodec.apply(params, jnp.asarray(ids), method=jcodec.detokenize)
    got = tcodec.detokenize(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 12 * 480) and got.std() > 0
    _close_wav(got, want)


def test_codec_params_cross_from_the_jax_tree_without_the_encoder():
    tcodec, jcodec, params = h.codec_pair(seed=18)
    state = codec_decoder_params_from_jax(h.to_numpy_tree(params))
    assert state and not any(k.startswith("encoder.") for k in state)
    decoder_keys = {k for k in tcodec.state_dict() if not k.startswith("encoder.")}
    assert set(state) == decoder_keys
    fresh = acoustic.AcousticCodec(**h.TINY_CODEC, device="cpu")
    missing, unexpected = fresh.load_state_dict(state, strict=False)
    assert not unexpected and missing and all(k.startswith("encoder.") for k in missing)
    for k in decoder_keys:
        assert torch.equal(tcodec.state_dict()[k], fresh.state_dict()[k]), k
    # and back: the decoder subtree, leaf for leaf
    back = params_to_jax(tcodec.state_dict())
    flat_back = jax.tree_util.tree_leaves_with_path(back["decoder"])
    flat_want = dict(jax.tree_util.tree_leaves_with_path(
        h.to_numpy_tree(params)["params"]["decoder"]))
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(leaf, flat_want[path])
