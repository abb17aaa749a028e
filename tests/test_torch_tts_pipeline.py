"""The zero-shot TTS pipeline as a whole (prompt tokenizers -> LM -> S2A ->
vocoder) in the PyTorch package against the JAX package's pipeline, on the
CPU at a tiny size: the same numpy weights in every stage of both, the same
prompts, and JAX's own sampler noise handed to the PyTorch sampler.

The LM's output columns of the ids that are not audio tokens are zeroed in
both packages, so greedy decoding (random weights) emits audio tokens only
and every request carries its full frame budget.

Tolerances, and why: prompt token ids, generated semantic tokens and the
sampled acoustic codes must be IDENTICAL in float32 (argmaxes of values that
agree to float32 rounding; the fixed-length sampler's attention is
``s2a_attention`` in the PyTorch package and the einsum path in the JAX
package, the same function). The waveforms then differ only by summation
order in the vocoder: 1e-4 of the largest sample.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_audio_helpers as h
import torch_port_helpers as ph
from maxtext_indextts2_tpu.audio import conformer as jax_conformer
from maxtext_indextts2_tpu.audio.pipeline import TTSPipeline as JaxTTSPipeline
from maxtext_indextts2_tpu.audio.semantic_tokenizer import SemanticTokenizer as JaxTokenizer
from maxtext_indextts2_tpu.infer.engine import Engine as JaxEngine
from maxtext_indextts2_tpu_torch.audio import pipeline as pl
from maxtext_indextts2_tpu_torch.audio.conformer import ConformerConfig
from maxtext_indextts2_tpu_torch.audio.s2a import Int8Dense
from maxtext_indextts2_tpu_torch.audio.semantic_tokenizer import SemanticTokenizer
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.ops import s2a_attention as k12
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_to_jax

# tiny shapes: one thread is enough, and the cores stay free for the other test workers
torch.set_num_threads(1)

RTOL_WAV = 1e-4  # of the largest sample
CODEBOOK = h.TINY["cond_codebook_size"]  # LM audio tokens = semantic tokens = S2A conditions
EXTRA = [
    f"audio_codebook_size={CODEBOOK}", f"semantic_codebook_size={CODEBOOK}",
    "max_target_length=256", "max_prefill_predict_length=128",
    f"s2a_num_quantizers={h.TINY['num_quantizers']}", f"s2a_hidden_size={h.TINY['hidden_size']}",
    f"s2a_num_layers={h.TINY['num_layers']}", f"s2a_num_heads={h.TINY['num_heads']}",
    f"s2a_codebook_size={h.TINY['codebook_size']}", f"s2a_cond_codebook_size={CODEBOOK}",
    "s2a_timesteps=[3,2,2]", "s2a_cfg_scale=2.5",
]
CONFORMER = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                 output_layer=2)
REPCODEC = dict(codebook_size=CODEBOOK, vocos_dim=32, vocos_intermediate_dim=64,
                vocos_num_layers=2)
INFO_KEYS = {"semantic_tokens", "audio_seconds", "t_lm", "t_s2a", "t_vocoder", "t_total", "rtf"}


@pytest.fixture(scope="module")
def pipelines():
    """(PyTorch pipeline, JAX pipeline) with the same weights in every stage."""
    cfg, jcfg = ph.configs(EXTRA, slots=2)
    lm = ph.audio_only_lm_weights(cfg, 1)
    engine = Engine(cfg, device="cpu")
    engine.set_params({k: torch.from_numpy(v) for k, v in lm.items()})
    jengine = JaxEngine(dataclasses.replace(jcfg, scan_layers=False), params=ph.jax_tree(lm))

    tok = SemanticTokenizer(ConformerConfig(**CONFORMER), REPCODEC, device="cpu")
    tok, tok_state = h.load_seeded(tok, 2)
    jtok = JaxTokenizer(jax_conformer.ConformerConfig(**CONFORMER), REPCODEC)
    tree = params_to_jax(tok_state)
    jtok.params = {half: {"params": h.to_jnp(tree[half])} for half in ("encoder", "repcodec")}

    tmodel, jmodel, jparams = h.s2a_pair("float32")
    tcodec, jcodec, jcodec_params = h.codec_pair(seed=3)
    tpipe = pl.TTSPipeline(cfg=cfg, s2a=tmodel, codec=tcodec, engine=engine,
                           semantic_tokenizer=tok)
    jpipe = JaxTTSPipeline(cfg=jcfg, engine=jengine, semantic_tokenizer=jtok, s2a=jmodel,
                           s2a_params=jparams, codec=jcodec, codec_params=jcodec_params)
    return tpipe, jpipe


def _prompt(seed, seconds):
    """One seeded signal, at 16 kHz and at 24 kHz."""
    rng = np.random.default_rng(seed)
    out = []
    for rate in (16_000, 24_000):
        t = np.arange(int(rate * seconds)) / rate
        out.append((0.3 * np.sin(2 * np.pi * 180 * t) * np.sin(2 * np.pi * 3 * t)
                    + 0.05 * rng.standard_normal(len(t))).astype(np.float32))
    return out


def _close_wav(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=RTOL_WAV * np.abs(want).max(), rtol=0)


def test_synthesize_end_to_end_matches_the_jax_pipeline(pipelines):
    tpipe, jpipe = pipelines
    w16, w24 = _prompt(0, 1.0)
    key = jax.random.PRNGKey(5)
    want, jinfo = jpipe.synthesize("hello gpu", w16, w24, max_new_tokens=12, rng=key)
    k12.launch_count = 0
    got, info = tpipe.synthesize("hello gpu", w16, w24, max_new_tokens=12,
                                 noise=h.jax_noise(key))
    assert k12.launch_count == 0  # the CPU route: plain versions only
    assert set(info) == set(jinfo) == INFO_KEYS
    assert info["semantic_tokens"] == jinfo["semantic_tokens"] == 12  # the full budget
    assert got.dtype == np.float32 and len(got) == 12 * 480 and got.std() > 0
    assert info["audio_seconds"] == pytest.approx(jinfo["audio_seconds"])
    assert info["t_s2a"] > 0 and info["t_vocoder"] > 0 and info["t_total"] >= info["t_lm"]
    _close_wav(got, np.asarray(want))


def test_synthesize_codes_equal_the_jax_sampler(pipelines):
    """The acoustic codes behind ``synthesize`` (the call returns the
    waveform only): the same cond / prompt and noise through both samplers."""
    tpipe, jpipe = pipelines
    w16, w24 = _prompt(1, 0.8)
    sems, acs = tpipe.frontend_batch([{"prompt_wav_16k": w16, "prompt_wav_24k": w24}])
    lm_prompt = tpipe.text_and_prompt_to_lm_prompt("codes", sems[0])
    gen = tpipe.generate_semantic(lm_prompt, 9)
    assert gen == jpipe.generate_semantic(lm_prompt, 9) and len(gen) == 9
    p = min(acs[0].shape[0], len(sems[0]))
    cond = np.concatenate([sems[0][:p], gen])[None]
    prompt = acs[0][None, :p]
    key = jax.random.PRNGKey(6)
    want = np.asarray(jpipe._jit_s2a(jpipe.s2a_params, cond.astype(np.int32),
                                     prompt.astype(np.int32), key))
    q = tpipe.s2a.cfg.num_quantizers
    got = tpipe.s2a.reverse_diffusion(
        torch.from_numpy(cond), torch.from_numpy(prompt), noise=h.jax_noise(key),
        n_timesteps=tuple(tpipe.cfg.s2a_timesteps)[:q], cfg=tpipe.cfg.s2a_cfg_scale,
        cfg_until=tpipe.cfg.s2a_cfg_until).numpy()
    assert got.shape == (1, 9, q)
    np.testing.assert_array_equal(got, want)


def _requests(seed, specs):
    out = []
    for i, (sec16, sec24, text, mnt) in enumerate(specs):
        w16, _ = _prompt(seed + i, sec16)
        _, w24 = _prompt(seed + i, sec24)
        out.append({"text": text, "prompt_wav_16k": w16, "prompt_wav_24k": w24,
                    "max_new_tokens": mnt})
    return out


def test_synthesize_batch_heterogeneous_matches_the_jax_pipeline(pipelines):
    tpipe, jpipe = pipelines
    reqs = _requests(10, [(1.0, 1.0, "short", 6), (0.8, 0.8, "a longer sentence", 14),
                          (1.2, 1.2, "mid", 10)])
    key = jax.random.PRNGKey(7)
    want = jpipe.synthesize_batch(reqs, rng=key, length_bucket=16, pad_to_batch=4)
    got = tpipe.synthesize_batch(reqs, noise=h.jax_noise(key), length_bucket=16,
                                 pad_to_batch=4)
    assert len(got) == len(want) == 3
    for (wav, info), (jwav, jinfo), r in zip(got, want, reqs):
        assert info["batch"] == jinfo["batch"] == 3
        assert info["semantic_tokens"] == jinfo["semantic_tokens"] == r["max_new_tokens"]
        assert len(wav) == info["semantic_tokens"] * 480  # per-row truncation
        assert info["t_frontend"] > 0 and info["t_lm"] > 0
        _close_wav(wav, np.asarray(jwav))

    # the generate_fn hook (the server's orchestrator-backed LM stage): canned
    # embedding ids flow through map_semantic and size the waveforms exactly
    m = tpipe.mapping
    audio_emb = [m.audio_to_embedding(a) for a in (1, 2, 3, 4, 5)]

    def canned(lm_prompts, mnts):
        assert len(lm_prompts) == 2 and mnts == [6, 14]
        return [audio_emb[:3], audio_emb[:5]]

    out2 = tpipe.synthesize_batch(reqs[:2], length_bucket=16, generate_fn=canned)
    assert [i["semantic_tokens"] for _, i in out2] == [3, 5]
    assert [len(w) for w, _ in out2] == [3 * 480, 5 * 480]


def test_frontend_batch_matches_per_request_and_the_jax_pipeline(pipelines):
    """Bucket-exact rows (multiples of 0.5 s) equal the per-request result;
    every row's ids equal the JAX package's batched frontend."""
    tpipe, jpipe = pipelines
    reqs = _requests(20, [(1.0, 1.0, "", 0), (0.5, 0.5, "", 0), (1.0, 1.0, "", 0)])
    sems, acs = tpipe.frontend_batch(reqs)
    jsems, jacs = jpipe.frontend_batch(reqs)
    for r, sem, ac, jsem, jac in zip(reqs, sems, acs, jsems, jacs):
        np.testing.assert_array_equal(sem, jsem)
        np.testing.assert_array_equal(ac, jac)
        ref_sem, ref_len = tpipe.semantic_tokenizer.tokenize(r["prompt_wav_16k"][None])
        np.testing.assert_array_equal(sem, ref_sem[0, : int(ref_len[0])].numpy())
        ref_ac = tpipe.codec.tokenize(torch.from_numpy(r["prompt_wav_24k"])[None])
        np.testing.assert_array_equal(ac, ref_ac.permute(1, 2, 0)[0].numpy())
    # mixed lengths off the bucket grid: shapes follow the true lengths
    reqs = _requests(30, [(0.8, 0.8, "", 0), (1.2, 1.2, "", 0)])
    sems, acs = tpipe.frontend_batch(reqs, pad_to_batch=4)
    jsems, jacs = jpipe.frontend_batch(reqs, pad_to_batch=4)
    assert sems[0].shape[0] < sems[1].shape[0]
    assert acs[0].shape == (int(24000 * 0.8) // 480, h.TINY["num_quantizers"])
    assert acs[1].shape[0] == int(24000 * 1.2) // 480
    for sem, ac, jsem, jac in zip(sems, acs, jsems, jacs):
        np.testing.assert_array_equal(sem, jsem)
        np.testing.assert_array_equal(ac, jac)


def test_lm_prompt_construction(pipelines):
    tpipe, jpipe = pipelines
    m = tpipe.mapping
    prompt = tpipe.text_and_prompt_to_lm_prompt("ab", np.array([0, 5]))
    np.testing.assert_array_equal(prompt, jpipe.text_and_prompt_to_lm_prompt("ab", [0, 5]))
    assert prompt[0] == m.audio_to_embedding(m.marker_bt_audio_id)
    ba = list(prompt).index(m.audio_to_embedding(m.marker_ba_audio_id))
    assert ba > 1  # [BT] text (with bos / eos) [BA] audio ...
    assert prompt[ba + 1] == m.audio_to_embedding(0) and prompt[ba + 2] == m.audio_to_embedding(5)
    assert (prompt < tpipe.cfg.vocab_size).all()


def test_generate_semantic_stops_on_a_non_audio_id(pipelines):
    """With the LM's own weights the stream is all audio; with a model whose
    output favours a text id, the stream stops there, in both packages."""
    tpipe, jpipe = pipelines
    lm_prompt = tpipe.text_and_prompt_to_lm_prompt("x", np.array([1, 2, 3]))
    out = tpipe.generate_semantic(lm_prompt, 8)
    assert out == jpipe.generate_semantic(lm_prompt, 8) and len(out) == 8
    assert all(0 <= a < CODEBOOK for a in out)
    m = tpipe.mapping
    raw = tpipe.engine.generate_stream(lm_prompt, 8)
    stopped = tpipe.map_semantic(raw[:3] + [m.token_to_embedding(7)] + raw[3:])
    assert stopped == out[:3]


def test_synthesize_with_int8_offline_s2a():
    """``s2a_serving_dtype=int8_offline`` builds a pre-quantized S2A stage
    (int8 kernels, float32 scales, the denoiser's float weights in
    bfloat16) and still synthesizes end to end."""
    cfg, _ = ph.configs(EXTRA + ["s2a_serving_dtype=int8_offline"], slots=2)
    engine = Engine(cfg, device="cpu")
    engine.set_params({k: torch.from_numpy(v) for k, v in ph.audio_only_lm_weights(cfg, 4).items()})
    pipe = pl.build_tiny_pipeline(cfg, seed=2, device="cpu", engine=engine,
                                  codec_kwargs=h.TINY_CODEC)
    qkv = pipe.s2a.denoiser.layers_0.qkv
    assert isinstance(qkv, Int8Dense) and qkv.kernel.dtype == torch.int8
    assert qkv.kernel_scale.dtype == torch.float32
    assert pipe.s2a.denoiser.layers_0.input_norm.to_weight.kernel.dtype == torch.bfloat16
    w16, w24 = _prompt(3, 1.0)
    wav, info = pipe.synthesize("int8 path", w16, w24, max_new_tokens=8)
    assert wav.shape == (8 * 480,) and np.isfinite(wav).all() and wav.std() > 0
    assert info["semantic_tokens"] == 8
    # the seeded tokenizer of the tiny build: the JAX package's tiny sizes
    enc = pipe.semantic_tokenizer.encoder_cfg
    assert (enc.hidden_size, enc.num_layers, enc.output_layer) == (64, 2, 2)
    assert pipe.semantic_tokenizer.repcodec.quantizer.vq_0.codebook.shape == (CODEBOOK, 8)


def test_load_torch_audio_weights_waits_for_weight_import(pipelines):
    with pytest.raises(NotImplementedError, match="port queue: 4"):
        pipelines[0].load_torch_audio_weights(s2a_state_dict={})


def test_synthesize_of_a_stream_that_stops_at_once_is_empty(pipelines, monkeypatch):
    """The LM's first token is not audio: no frames, an empty waveform, as
    the JAX pipeline returns."""
    tpipe, jpipe = pipelines
    monkeypatch.setattr(tpipe, "generate_semantic", lambda prompt, n: [])
    monkeypatch.setattr(jpipe, "generate_semantic", lambda prompt, n: [])
    w16, w24 = _prompt(4, 0.6)
    got, info = tpipe.synthesize("stop", w16, w24, max_new_tokens=5)
    want, jinfo = jpipe.synthesize("stop", w16, w24, max_new_tokens=5)
    assert got.shape == np.asarray(want).shape == (0,)
    assert info["semantic_tokens"] == jinfo["semantic_tokens"] == 0
    assert info["audio_seconds"] == 0.0
