"""Codec training in the PyTorch package against the JAX package, on the CPU:
the factorized / residual VQ's training call (losses, straight-through
gradients, quantizer dropout with the JAX package's draw), ``latent2dist``,
the log-mel loss and its gradient, the training calls of ``CodecDecoder``,
``AcousticCodec`` and ``RepCodec``, dead-code re-seeding, and one and three
steps of each trainer from the same weights and batches.

Sizes are small (2 quantizers, codebook 16, hidden 32, as the JAX package's
own ``tests/test_audio.py`` trainer test); weights are the JAX package's
init carried by the bridge; quantizer-dropout draws are JAX's
``randint(fold_in(PRNGKey(init_weights_seed + 1), step), (B,), 1, Q + 1)``.
The JAX trainers run on the test harness's 8 CPU devices without a mesh, so
their global batch is ``per_device_batch_size x 8``; the port's config gets
the same global batch on its one device.

Tolerances (float32 on both sides; convolutions, FFTs and products sum in
other orders): indices equal; float32 outputs and losses 1e-5 relative
(2e-5 through a whole codec: some 40 layers in a row; 3e-4 for the conv
decoder's waveform, as ``tests/test_torch_codec_decoder.py``); gradients 1e-4 of each
one's largest entry (1e-3 back through a whole decoder: the DAC-style conv
decoder's 25 convolutions, whose outputs ``tests/test_torch_codec_decoder.py``
already holds only to 3e-4); the log-mel's gradient 1e-4 of its largest entry. After
training steps: losses 1e-4 relative (each step's update carries the
previous steps' float32 differences), and weights as in
``tests/test_torch_train.py``: Adam's normalised step turns a float32
difference in a near-zero gradient into a visible share of one update, so
every weight is held to 5 % of one update (5e-5 at learning rate 1e-3) a step
and all but one in a thousand to 2e-6. Re-seeding is host numpy: bitwise.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.audio import acoustic as jacoustic
from maxtext_indextts2_tpu.audio import mel as jmel
from maxtext_indextts2_tpu.audio import quantize as jquantize
from maxtext_indextts2_tpu.audio import repcodec as jrepcodec
from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.train import codec_train as jct
from maxtext_indextts2_tpu_torch.audio import acoustic, mel, quantize, repcodec
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.train import codec_train as tct
from maxtext_indextts2_tpu_torch.utils.param_bridge import (
    codec_params_from_jax, params_to_jax, semantic_tokenizer_params_from_jax, tree_to_state_dict,
)

torch.set_num_threads(1)
RTOL, RTOL_CODEC, GRAD_TOL, MEL_GRAD_TOL, LOSS_STEPS_RTOL = 1e-5, 2e-5, 1e-4, 1e-4, 1e-4
GRAD_TOL_CODEC = 1e-3  # gradients back through a whole decoder
RTOL_CONV_DECODER = 3e-4  # tests/test_torch_codec_decoder.py's
JAX_DEVICES = 8
SMALL_CODEC = dict(d_model=16, latent_dim=32, vocos_dim=32, vocos_intermediate_dim=64,
                   vocos_num_layers=2)
TRAIN_ARGS = ["s2a_num_quantizers=2", "s2a_codebook_size=16", "s2a_hidden_size=32",
              "semantic_codebook_size=32", "dtype=float32", "learning_rate=1e-3"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _grads_close(tgrads: dict, jgrads, tol=GRAD_TOL):
    want = tree_to_state_dict(_np(jgrads))
    assert set(tgrads) == set(want)
    for name, g in tgrads.items():
        _close(g, want[name], tol, f"grad {name}")


def _module(jmodule, tmodule, *inputs, **kw):
    """JAX init from seed 0 -> the port's module; returns the numpy params."""
    params = _np(jmodule.init(jax.random.PRNGKey(0), *[jnp.asarray(x) for x in inputs], **kw))
    tmodule.load_state_dict(tree_to_state_dict(params), strict=True)
    return params


def _jax_draw(seed, step, b, q):
    return np.asarray(jax.random.randint(
        jax.random.fold_in(jax.random.PRNGKey(seed + 1), step), (b,), 1, q + 1))


@pytest.mark.parametrize("input_dim", [24, 8], ids=["projected", "unprojected"])
def test_factorized_vq_training_call_and_gradients_match_jax(input_dim):
    jq = jquantize.FactorizedVectorQuantize(input_dim=input_dim, codebook_size=16)
    tq = quantize.FactorizedVectorQuantize(input_dim, 16, device="cpu")
    x = np.random.default_rng(0).normal(size=(3, 9, input_dim)).astype(np.float32)
    params = _module(jq, tq, x)

    def jloss(p, xx):
        r = jq.apply(p, xx)
        return jnp.sum(r.quantized * jnp.sin(xx)) + r.commit_loss + 2 * r.codebook_loss, r

    (_, want), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    got = tq(tx)
    loss = torch.sum(got.quantized * torch.sin(tx)) + got.commit_loss + 2 * got.codebook_loss
    grads = torch.autograd.grad(loss, [tx, *tq.parameters()])
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    for field in ("quantized", "commit_loss", "codebook_loss", "commit_per_sample",
                  "codebook_per_sample"):
        _close(getattr(got, field), getattr(want, field), what=field)
    _close(grads[0], jgx, GRAD_TOL, "grad x")
    _grads_close(dict(zip([n for n, _ in tq.named_parameters()], grads[1:])), jg)
    _close(tq.latent2dist(_t(x)), jq.apply(params, jnp.asarray(x), method=jq.latent2dist),
           what="latent2dist")


@pytest.mark.parametrize("dropout", [0.0, 0.5, 1.0], ids=["no_dropout", "half", "all"])
def test_residual_vq_training_call_with_quantizer_dropout_matches_jax(dropout):
    q, b = 3, 4
    jq = jquantize.ResidualVQ(input_dim=24, num_quantizers=q, codebook_size=16,
                              quantizer_dropout=dropout)
    tq = quantize.ResidualVQ(24, q, 16, quantizer_dropout=dropout, device="cpu")
    x = np.random.default_rng(1).normal(size=(b, 9, 24)).astype(np.float32)
    params = _module(jq, tq, x)
    key = jax.random.PRNGKey(3)
    draw = np.asarray(jax.random.randint(key, (b,), 1, q + 1))

    def jloss(p):
        out = jq.apply(p, jnp.asarray(x), dropout_rng=key)
        return jnp.sum(out[0] ** 2) + jnp.sum(out[2]) + jnp.sum(out[3]), out

    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    got = tq(_t(x), dropout=_t(draw))
    loss = torch.sum(got[0] ** 2) + torch.sum(got[2]) + torch.sum(got[3])
    grads = torch.autograd.grad(loss, list(tq.parameters()))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for i, what in ((0, "out"), (2, "commit"), (3, "codebook"), (4, "per layer")):
        _close(got[i], want[i], what=what)
    _grads_close(dict(zip([n for n, _ in tq.named_parameters()], grads)), jg)
    if dropout:  # the masked samples lose their later stages
        assert not torch.allclose(got[0], tq(_t(x))[0])
    # no draw given: no dropout, as JAX without dropout_rng
    _close(tq(_t(x))[0], jq.apply(params, jnp.asarray(x))[0], what="undropped")
    gen = torch.Generator().manual_seed(0)
    assert tq(_t(x), dropout=gen)[0].shape == (b, 9, 24)
    _close(tq.latent2dist(_t(x)), jq.apply(params, jnp.asarray(x), method=jq.latent2dist),
           what="latent2dist")


@pytest.mark.parametrize("n_fft,hop", tct.MEL_RESOLUTIONS)
def test_mel_spectrogram_value_and_gradient_match_jax(n_fft, hop):
    wav = np.random.default_rng(n_fft).normal(size=(2, 4000)).astype(np.float32) * 0.1
    frames = 4000 // hop + 1
    weight = np.random.default_rng(1).normal(size=(2, frames, 80)).astype(np.float32)

    def jf(w):
        m = jmel.mel_spectrogram(w, n_mels=80, sample_rate=24000, n_fft=n_fft, hop=hop)
        return jnp.sum(m * weight), m

    (_, want), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(wav))
    tw = _t(wav).requires_grad_(True)
    got = mel.mel_spectrogram(tw, n_mels=80, sample_rate=24000, n_fft=n_fft, hop=hop)
    (g,) = torch.autograd.grad(torch.sum(got * _t(weight)), tw)
    _close(got, want, what="log-mel")
    _close(g, jg, MEL_GRAD_TOL, "gradient")


def test_mel_l1_value_and_gradient_match_jax():
    rng = np.random.default_rng(2)
    a, b = (rng.normal(size=(2, 6000)).astype(np.float32) * 0.1 for _ in range(2))
    want, jg = jax.value_and_grad(jct.mel_l1)(jnp.asarray(a), jnp.asarray(b))
    ta = _t(a).requires_grad_(True)
    got = tct.mel_l1(ta, _t(b))
    (g,) = torch.autograd.grad(got, ta)
    _close(got, want, what="mel_l1")
    _close(g, jg, MEL_GRAD_TOL, "gradient")


def _codec_grads(tmodel, jmodel, params, inputs, tcall, jcall):
    (jl, want), jg = jax.value_and_grad(lambda p: jcall(p), has_aux=True)(params)
    tl, got = tcall()
    grads = torch.autograd.grad(tl, list(tmodel.parameters()))
    _close(tl, jl, RTOL_CODEC, "loss")
    _grads_close(dict(zip([n for n, _ in tmodel.named_parameters()], grads)), jg,
                 GRAD_TOL_CODEC)
    return got, want


@pytest.mark.parametrize("use_vocos", [True, False], ids=["vocos", "conv_decoder"])
def test_codec_decoder_training_call_matches_jax(use_vocos):
    kw = dict(in_channels=16, num_quantizers=2, codebook_size=16, quantizer_dropout=0.5,
              vocos_dim=32, vocos_intermediate_dim=64, vocos_num_layers=2, use_vocos=use_vocos,
              upsample_initial_channel=32)
    jdec = jacoustic.CodecDecoder(**kw)
    tdec = acoustic.CodecDecoder(**kw, device="cpu")
    lat = np.random.default_rng(3).normal(size=(4, 5, 16)).astype(np.float32)
    params = _module(jdec, tdec, lat)
    key = jax.random.PRNGKey(4)
    draw = _t(jax.random.randint(key, (4,), 1, 3))

    def jcall(p):
        wav, idx, commit, cb = jdec.apply(p, jnp.asarray(lat), dropout_rng=key)
        return jnp.mean(wav ** 2) + commit + cb, (wav, idx, commit, cb)

    def tcall():
        out = tdec(_t(lat), dropout=draw)
        return torch.mean(out[0] ** 2) + out[2] + out[3], out

    got, want = _codec_grads(tdec, jdec, params, lat, tcall, jcall)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[0], want[0], RTOL_CODEC if use_vocos else RTOL_CONV_DECODER, "wav")
    _close(got[2], want[2], what="commit")
    _close(got[3], want[3], what="codebook")


def test_acoustic_codec_training_call_matches_jax():
    kw = dict(**SMALL_CODEC, num_quantizers=2, codebook_size=16, quantizer_dropout=0.5)
    jcodec, tcodec = jacoustic.AcousticCodec(**kw), acoustic.AcousticCodec(**kw, device="cpu")
    wav = np.random.default_rng(5).normal(size=(4, 1920)).astype(np.float32) * 0.1
    params = _module(jcodec, tcodec, wav)
    key = jax.random.PRNGKey(6)
    draw = _t(jax.random.randint(key, (4,), 1, 3))

    def jcall(p):
        recon, idx, commit, cb = jcodec.apply(p, jnp.asarray(wav), dropout_rng=key)
        return jct.mel_l1(recon, jnp.asarray(wav)) + commit + cb, (recon, idx)

    def tcall():
        recon, idx, commit, cb = tcodec(_t(wav), dropout=draw)
        return tct.mel_l1(recon, _t(wav)) + commit + cb, (recon, idx)

    got, want = _codec_grads(tcodec, jcodec, params, wav, tcall, jcall)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[0], want[0], RTOL_CODEC, "recon")
    # the training module's tree crosses both ways bitwise
    state = tcodec.state_dict()
    back = codec_params_from_jax({"params": params_to_jax(state)})
    assert back.keys() == state.keys() and all(torch.equal(back[k], v) for k, v in state.items())


def test_repcodec_training_call_matches_jax():
    kw = dict(hidden_size=32, codebook_size=32, vocos_dim=32, vocos_intermediate_dim=64,
              vocos_num_layers=2)
    jrc, trc = jrepcodec.RepCodec(**kw), repcodec.RepCodec(**kw, device="cpu")
    feats = np.random.default_rng(7).normal(size=(2, 12, 32)).astype(np.float32)
    params = _module(jrc, trc, feats)

    def jcall(p):
        recon, idx, commit, cb = jrc.apply(p, jnp.asarray(feats))
        return jnp.mean((recon - feats) ** 2) + commit + cb, (recon, idx, commit, cb)

    def tcall():
        out = trc(_t(feats))
        return torch.mean((out[0] - _t(feats)) ** 2) + out[2] + out[3], out

    got, want = _codec_grads(trc, jrc, params, feats, tcall, jcall)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[0], want[0], RTOL_CODEC, "recon")
    # the trained tree crosses both ways bitwise, and as the tokenizer's RepCodec half
    state = trc.state_dict()
    assert all(torch.equal(v, state[k]) for k, v in
               tree_to_state_dict(params_to_jax(state)).items())
    half = semantic_tokenizer_params_from_jax({"encoder": {}, "repcodec": params_to_jax(state)})
    assert all(torch.equal(half[f"repcodec.{k}"], v) for k, v in state.items())


def test_reseed_dead_codes_is_bitwise_the_jax_packages():
    codec = acoustic.AcousticCodec(**SMALL_CODEC, num_quantizers=3, codebook_size=16,
                                   device="cpu")
    state = {k: v.clone() for k, v in codec.state_dict().items()}
    usage = np.random.default_rng(8).integers(0, 4, size=(3, 16))
    usage[1] = 5  # a layer with no dead row: untouched
    usage[2, 3:] = 0
    tree = {"params": jax.tree.map(jnp.asarray, params_to_jax(state))}
    want = tree_to_state_dict(_np(jct._reseed_dead_codes(tree, usage, rng=19)))
    got = tct._reseed_dead_codes(state, usage, rng=19)
    for name, leaf in want.items():
        assert torch.equal(got[name], leaf), name
    before = codec.state_dict()
    assert torch.equal(got["decoder.quantizer.vq_1.codebook"],
                       before["decoder.quantizer.vq_1.codebook"])
    assert not torch.equal(got["decoder.quantizer.vq_2.codebook"],
                           before["decoder.quantizer.vq_2.codebook"])


def _configs(extra, rows):
    args = TRAIN_ARGS + list(extra)
    cfg = load_config(args + [f"per_device_batch_size={rows}"])
    jcfg = jax_load_config(args + [f"per_device_batch_size={rows / JAX_DEVICES}"])
    assert jcfg.global_batch_size_to_train_on == cfg.global_batch_size_to_train_on == rows
    return cfg, jcfg


def _losses(path):
    with open(path) as fh:
        return [r["loss"] for r in map(json.loads, fh)]


def _assert_trained_close(got: dict, want: dict, steps: int, lr: float = 1e-3):
    """Weights after ``steps`` Adam steps (see the module docstring)."""
    assert set(got) == set(want)
    diffs = np.concatenate([np.abs(got[k].numpy() - want[k].numpy()).ravel() for k in want])
    assert diffs.max() <= 5e-2 * lr * steps, diffs.max()
    assert np.quantile(diffs, 0.999) <= 2e-6 * steps, np.quantile(diffs, 0.999)


@pytest.mark.parametrize("steps", [1, 3])
def test_acoustic_trainer_matches_jax(tmp_path, steps):
    """The JAX trainer and the port's from the JAX init, the JAX default
    batches and quantizer-dropout draws; a re-seed fires after step 2."""
    extra = [f"steps={steps}", "codec_quantizer_dropout=0.5"]
    cfg, jcfg = _configs(extra + [f"metrics_file={tmp_path}/t.jsonl"], 4)
    jcfg = dataclasses.replace(jcfg, metrics_file=f"{tmp_path}/j.jsonl")
    want = jct.train_acoustic_codec(jcfg, codec_kwargs=SMALL_CODEC, reseed_period=2)
    jcodec = jacoustic.AcousticCodec(num_quantizers=2, codebook_size=16, quantizer_dropout=0.5,
                                     **SMALL_CODEC)
    hop = int(np.prod(jcodec.strides))
    init = _np(jcodec.init(jax.random.PRNGKey(cfg.init_weights_seed),
                           jnp.asarray(tct.acoustic_batch(cfg, 0, hop)["wav"])))
    got = tct.train_acoustic_codec(
        cfg, codec_kwargs=SMALL_CODEC, reseed_period=2, device="cpu",
        params=codec_params_from_jax(init), quiet=True,
        dropout_fn=lambda step, b: _t(_jax_draw(cfg.init_weights_seed, step, b, 2)))
    np.testing.assert_allclose(_losses(f"{tmp_path}/t.jsonl"), _losses(f"{tmp_path}/j.jsonl"),
                               rtol=LOSS_STEPS_RTOL)
    for key in ("loss", "mel_l1", "wav_l1", "commit"):
        np.testing.assert_allclose(got[key], float(want[key]), rtol=LOSS_STEPS_RTOL)
    assert [r["step"] for r in got["reseeds"]] == ([1] if steps == 3 else [])
    _assert_trained_close(got["params"], codec_params_from_jax(_np(want["params"])), steps)


@pytest.mark.parametrize("steps", [1, 3])
def test_repcodec_trainer_matches_jax(tmp_path, steps):
    cfg, jcfg = _configs([f"steps={steps}", f"metrics_file={tmp_path}/t.jsonl"], 4)
    jcfg = dataclasses.replace(jcfg, metrics_file=f"{tmp_path}/j.jsonl")
    want = jct.train_repcodec(jcfg)
    jrc = jrepcodec.RepCodec(hidden_size=32, codebook_size=32, vocos_num_layers=4)
    init = _np(jrc.init(jax.random.PRNGKey(cfg.init_weights_seed),
                        jnp.asarray(tct.repcodec_batch(cfg, 0)["feats"])))
    got = tct.train_repcodec(cfg, device="cpu", params=tree_to_state_dict(init), quiet=True)
    np.testing.assert_allclose(_losses(f"{tmp_path}/t.jsonl"), _losses(f"{tmp_path}/j.jsonl"),
                               rtol=LOSS_STEPS_RTOL)
    for key in ("loss", "rec_mse", "commit"):
        np.testing.assert_allclose(got[key], float(want[key]), rtol=LOSS_STEPS_RTOL)
    _assert_trained_close(got["params"], tree_to_state_dict(_np(want["params"])), steps)


def test_default_batches_are_the_jax_packages():
    cfg, jcfg = _configs(["data_shuffle_seed=3"], 2)
    assert tct.acoustic_batch(cfg, 5, 480)["wav"].shape == (2, 12000)  # 25 frames of 480
    assert tct.acoustic_batch(cfg, 5, 512)["wav"].shape == (2, 11776)  # a multiple of the hop
    rng = np.random.default_rng(3 + 5)
    np.testing.assert_array_equal(tct.acoustic_batch(cfg, 5, 480)["wav"],
                                  rng.standard_normal((2, 12000)).astype(np.float32) * 0.1)
    rng = np.random.default_rng(3 + 1)
    np.testing.assert_array_equal(tct.repcodec_batch(cfg, 1)["feats"],
                                  rng.standard_normal((2, 64, 32)).astype(np.float32))


@pytest.mark.parametrize("target", ["acoustic", "repcodec"])
def test_cli_trains_on_the_cpu_when_asked(capsys, monkeypatch, target):
    # the CLI builds the published widths: narrow ones and short rows here
    monkeypatch.setattr(tct, "AcousticCodec", functools.partial(acoustic.AcousticCodec,
                                                                 **SMALL_CODEC))
    monkeypatch.setattr(tct, "SECONDS", 0.1)  # 5 frames: longer than the 2048-point STFT's pad
    out = tct.main([f"codec_target={target}", "device=cpu", "steps=2", "per_device_batch_size=2",
                    "s2a_num_quantizers=2", "s2a_codebook_size=16", "s2a_hidden_size=16",
                    "semantic_codebook_size=16"])
    assert "step 1:" in capsys.readouterr().out and np.isfinite(out["loss"])
    with pytest.raises(ValueError):
        tct.main(["codec_target=vocoder", "device=cpu"])


def test_trainers_refuse_to_run_without_a_gpu_unless_asked():
    assert not torch.cuda.is_available()  # this test runs where there is no GPU
    with pytest.raises(RuntimeError):
        tct.train_repcodec(load_config(TRAIN_ARGS + ["steps=1"]))
