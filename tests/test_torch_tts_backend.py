"""The TTS back end as a whole, ``TTSPipeline.s2a_vocoder_batch`` (bucketing,
masked S2A sampling, RVQ lookup, Vocos/ISTFT), in the PyTorch package against
the JAX package's pipeline: the same weights, the same requests and JAX's own
sampler noise, on the CPU at a tiny size.

Tolerances, and why: in float32 the sampled codes must be identical, and then
the waveforms differ only by the summation order of convolutions, matrix
products and the inverse FFT: 1e-4 of the largest sample. In ``int8_offline``
a share of codes differs (see ``test_torch_s2a.py``: at least 0.75 equal) and
the vocoder's receptive field spreads every flipped code over the waveform, so
there the test holds the code agreement, the shapes and the finiteness instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_audio_helpers as h
from maxtext_indextts2_tpu.audio.pipeline import TTSPipeline as JaxTTSPipeline
from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu_torch.audio import pipeline as pl
from maxtext_indextts2_tpu_torch.audio.s2a import Int8Dense
from maxtext_indextts2_tpu_torch.config import load_config

RTOL_WAV = 1e-4  # of the largest sample
MIN_CODE_AGREEMENT_INT8 = 0.75

CFG = [
    "vocab_size=9344", "audio_codebook_size=8192", "base_emb_dim=64", "base_mlp_dim=128",
    "base_num_decoder_layers=2", "base_num_query_heads=2", "base_num_kv_heads=2", "head_dim=32",
    "max_target_length=512", "max_prefill_predict_length=128", "dtype=float32",
    "decoder_block=tts", "semantic_codebook_size=8192",
    f"s2a_num_quantizers={h.TINY['num_quantizers']}", f"s2a_hidden_size={h.TINY['hidden_size']}",
    f"s2a_num_layers={h.TINY['num_layers']}", f"s2a_num_heads={h.TINY['num_heads']}",
    f"s2a_codebook_size={h.TINY['codebook_size']}",
    f"s2a_cond_codebook_size={h.TINY['cond_codebook_size']}",
    "s2a_timesteps=[3,2,2]", "s2a_cfg_scale=2.5",
]
INFO_KEYS = {"semantic_tokens", "audio_seconds", "batch", "t_frontend", "t_lm", "t_s2a",
             "t_vocoder", "t_total", "batch_rtf"}


def _requests(seed=0):
    """Three requests of different prompt and target lengths (one target a
    single frame)."""
    rng = np.random.default_rng(seed)
    p_lens, t_lens = (9, 20, 14), (17, 1, 30)
    q, k, c = h.TINY["num_quantizers"], h.TINY["codebook_size"], h.TINY["cond_codebook_size"]
    sems = [rng.integers(0, c, size=n + 2) for n in p_lens]  # longer than the codes: cut
    acs = [rng.integers(0, k, size=(n, q)) for n in p_lens]
    gens = [[int(v) for v in rng.integers(0, c, size=n)] for n in t_lens]
    return [{} for _ in p_lens], sems, acs, gens, t_lens


def _pipelines(mode, extra=()):
    args = CFG + [f"s2a_serving_dtype={mode}", *extra]
    tmodel, jmodel, jparams = h.s2a_pair(mode)
    tcodec, jcodec, jcodec_params = h.codec_pair(seed=5)
    torch_pipe = pl.TTSPipeline(cfg=load_config(args), s2a=tmodel, codec=tcodec)
    jax_pipe = JaxTTSPipeline(
        cfg=jax_load_config(args + ["per_device_batch_size=0.125"]), engine=None,
        semantic_tokenizer=None, s2a=jmodel, s2a_params=jparams, codec=jcodec,
        codec_params=jcodec_params)
    return torch_pipe, jax_pipe


@pytest.mark.parametrize("mode,extra", [
    ("float32", ()), ("float32", ("s2a_cfg_until=0.5",)), ("int8_offline", ())],
    ids=["float32", "float32_cfg_until_half", "int8_offline"])
def test_s2a_vocoder_batch_matches_the_jax_pipeline(mode, extra):
    torch_pipe, jax_pipe = _pipelines(mode, extra)
    requests, sems, acs, gens, t_lens = _requests()
    key = jax.random.PRNGKey(3)
    kw = dict(length_bucket=16, pad_to_batch=4)
    want = jax_pipe.s2a_vocoder_batch(requests, sems, acs, gens, rng=key, **kw)
    got = torch_pipe.s2a_vocoder_batch(requests, sems, acs, gens, noise=h.jax_noise(key), **kw)
    assert len(got) == len(want) == 3  # the dummy fourth row is dropped
    for (wav, info), (jwav, jinfo), t_i in zip(got, want, t_lens):
        assert wav.dtype == np.float32 and wav.shape == jwav.shape == (t_i * 480,)
        assert np.isfinite(wav).all() and wav.std() > 0
        assert set(info) == set(jinfo) == INFO_KEYS
        assert info["semantic_tokens"] == jinfo["semantic_tokens"] == t_i
        assert info["batch"] == jinfo["batch"] == 3
        assert info["audio_seconds"] == pytest.approx(jinfo["audio_seconds"])
        assert info["t_s2a"] > 0 and info["t_vocoder"] > 0 and info["t_total"] >= info["t_s2a"]
        if mode == "float32":
            np.testing.assert_allclose(wav, jwav, atol=RTOL_WAV * np.abs(jwav).max(), rtol=0)
    # the call returns no codes: sample them once more, with the same noise
    codes = torch_pipe._sample_codes(sems, acs, gens, None, 16, 4, h.jax_noise(key), None)[:3]
    assert codes.shape == (3, 32, h.TINY["num_quantizers"])  # targets bucketed 30 -> 32
    assert 0 <= int(codes.min()) and int(codes.max()) < h.TINY["codebook_size"]
    if mode != "float32":
        # the JAX pipeline returns no codes: sample them once more from its model
        jcodes = _jax_codes(jax_pipe, sems, acs, gens, key, **kw)
        valid = np.arange(32)[None, :] < np.asarray(t_lens)[:, None]
        agree = (codes.numpy() == jcodes[:3])[valid].mean()
        assert agree >= MIN_CODE_AGREEMENT_INT8, agree


def _jax_codes(jax_pipe, sems, acs, gens, key, length_bucket, pad_to_batch):
    """The acoustic codes of the JAX pipeline's masked sampler for the batch
    ``s2a_vocoder_batch`` builds from these requests."""
    q = jax_pipe.s2a.cfg.num_quantizers
    p_rows = [min(a.shape[0], len(s)) for a, s in zip(acs, sems)]
    pb = max(pl._roundup(max(p_rows), 16), 16)
    tb = max(pl._roundup(max(len(g) for g in gens), length_bucket), length_bucket)
    cond = np.zeros((pad_to_batch, pb + tb), np.int32)
    prompt = np.zeros((pad_to_batch, pb, q), np.int32)
    x_mask = np.zeros((pad_to_batch, tb), np.int32)
    p_mask = np.zeros((pad_to_batch, pb), np.int32)
    for i, (sem, ac, gen) in enumerate(zip(sems, acs, gens)):
        cond[i, :p_rows[i]] = sem[:p_rows[i]]
        cond[i, pb:pb + len(gen)] = gen
        prompt[i, :p_rows[i]] = ac[:p_rows[i]]
        p_mask[i, :p_rows[i]] = 1
        x_mask[i, :len(gen)] = 1
    x_mask[len(gens):, 0] = 1
    p_mask[len(gens):, 0] = 1
    return np.asarray(jax_pipe._jit_s2a_masked(
        jax_pipe.s2a_params, jnp.asarray(cond), jnp.asarray(prompt), key,
        jnp.asarray(x_mask), jnp.asarray(p_mask)))


def test_s2a_vocoder_batch_buckets_and_defaults():
    torch_pipe, _ = _pipelines("float32")
    requests, sems, acs, gens, t_lens = _requests(1)
    # default generator (seed 0): two calls give the same audio
    a = torch_pipe.s2a_vocoder_batch(requests, sems, acs, gens, length_bucket=64)
    codes = torch_pipe._sample_codes(sems, acs, gens, None, 64, 3, None, None)
    assert codes.shape[:2] == (3, 64)
    for (wa, _), row in zip(a, torch_pipe.codec.detokenize(codes.permute(2, 0, 1)).numpy()):
        np.testing.assert_array_equal(wa, row[:len(wa)])
    b = torch_pipe.s2a_vocoder_batch(requests, sems, acs, gens, length_bucket=64,
                                     timings={"t_start": 0.0, "t_lm": 1.5, "t_frontend": 0.25})
    for (wa, ia), (wb, ib), t_i in zip(a, b, t_lens):
        np.testing.assert_array_equal(wa, wb)
        assert len(wa) == t_i * 480 and ia["t_lm"] == 0.0 and ib["t_lm"] == 1.5
        assert ib["t_frontend"] == 0.25 and ib["t_total"] > ia["t_total"]
    # a batch padded with dummy rows still returns the real rows only
    c = torch_pipe.s2a_vocoder_batch(requests, sems, acs, gens, length_bucket=64, pad_to_batch=5,
                                     generator=torch.Generator().manual_seed(0))
    assert [len(w) for w, _ in c] == [t * 480 for t in t_lens]
    padded = torch_pipe._sample_codes(sems, acs, gens, None, 64, 5, None, None)
    assert padded.shape == (5,) + codes.shape[1:]


@pytest.mark.parametrize("mode", h.MODES)
def test_build_tiny_pipeline_serves_every_mode_on_the_cpu(mode):
    cfg = load_config(CFG + [f"s2a_serving_dtype={mode}"])
    pipe = pl.build_tiny_pipeline(cfg, seed=1, device="cpu")
    assert pipe.engine is None and pipe.device.type == "cpu"
    want_dtype = torch.float32 if mode == "float32" else torch.bfloat16
    assert pipe.s2a.cfg.dtype == want_dtype
    dense = pipe.s2a.denoiser.layers_0.qkv
    if mode.startswith("int8"):
        assert isinstance(dense, Int8Dense) and dense.offline == (mode == "int8_offline")
        assert pipe.s2a.denoiser.c0.kernel.dtype == torch.bfloat16
        assert pipe.s2a.token_emb.dtype == torch.float32
    requests, sems, acs, gens, t_lens = _requests(2)
    out = pipe.s2a_vocoder_batch(requests, sems, acs, gens, length_bucket=16, pad_to_batch=4)
    assert [len(w) for w, _ in out] == [t * 480 for t in t_lens]
    assert all(np.isfinite(w).all() and w.std() > 0 for w, _ in out)
    # the same seed builds the same weights
    again = pl.build_tiny_pipeline(cfg, seed=1, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(pipe.s2a.state_dict().values(),
                                                again.s2a.state_dict().values()))


def test_build_tiny_pipeline_takes_given_weights_and_needs_a_gpu_by_default(monkeypatch):
    cfg = load_config(CFG + ["s2a_serving_dtype=int8_offline"])
    weights = {k: torch.from_numpy(v) for k, v in h.s2a_weights(seed=4).items()}
    codec_w = {k: torch.from_numpy(v) for k, v in h.codec_weights(seed=4).items()}
    pipe = pl.build_tiny_pipeline(cfg, device="cpu", s2a_params=weights, codec_params=codec_w,
                                  codec_kwargs=h.TINY_CODEC)
    tmodel, _, _ = h.s2a_pair("int8_offline", weights=h.s2a_weights(seed=4))
    for (k, a), b in zip(pipe.s2a.state_dict().items(), tmodel.state_dict().values()):
        assert torch.equal(a, b), k
    assert torch.equal(pipe.codec.decoder.head.out.kernel, codec_w["decoder.head.out.kernel"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pl.build_tiny_pipeline(cfg)


@pytest.mark.parametrize("seed", [0, 3])
def test_backend_requests_fill_the_same_buckets_for_every_seed(seed):
    requests, sems, acs, gens = pl.backend_requests(seed, 5, cond_vocab=96, codebook=64,
                                                    quantizers=3, prompt=(10, 25), target=(20, 50))
    assert len(requests) == len(sems) == len(acs) == len(gens) == 5
    assert max(len(s) for s in sems) == 25 and min(len(s) for s in sems) >= 10
    assert max(len(g) for g in gens) == 50 and min(len(g) for g in gens) >= 20
    assert all(a.shape == (len(s), 3) and a.max() < 64 for a, s in zip(acs, sems))
    assert all(0 <= v < 96 for g in gens for v in g)
