"""``TTSPipeline.load_torch_audio_weights`` and the audio CLI
(``audio/cli.py``) of the PyTorch package, on the CPU at a tiny size.

A source pipeline's modules are written as reference-named state dicts
(``tools/reference_state_dicts.py``) and loaded into a pipeline built from
another seed: every loaded tensor must equal the source's BITWISE (the
converters invert the export exactly; under ``int8_offline`` both sides
quantize the same float weights the same way), and with the ISTFT head
carried across (the reference has none) ``synthesize`` must give the same
ids, codes and waveform, exactly, on the same prompt and sampler seed. The
JAX pipeline loading the same files holds the same S2A weights (bitwise in
float32; int8 codes equal and scales to 1 float32 step under
``int8_offline``, where the scale is a quotient rounded once on each side).
The CLI runs in-process with ``device=cpu``; its WAV is 16-bit PCM, so its
waveform is held to the in-process one within 1 / 32767 (one PCM step). Its
semantic ids equal the source tokenizer's exactly, and the JAX CLI's on the
same files at 95 % of the frames at least (float32 summation order in two
frameworks can flip a near-tie argmax).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import torch_audio_helpers as h
import torch_port_helpers as ph
from maxtext_indextts2_tpu.audio import cli as jax_cli
from maxtext_indextts2_tpu.audio import conformer as jax_conformer
from maxtext_indextts2_tpu.audio.pipeline import build_tiny_pipeline as jax_build_tiny_pipeline
from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu_torch.audio import cli
from maxtext_indextts2_tpu_torch.audio import pipeline as pl
from maxtext_indextts2_tpu_torch.audio.conformer import ConformerConfig
from maxtext_indextts2_tpu_torch.audio.s2a import S2AConfig, S2AModel
from maxtext_indextts2_tpu_torch.audio.semantic_tokenizer import SemanticTokenizer
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.tools import reference_state_dicts as rsd
from maxtext_indextts2_tpu_torch.train import checkpointing
from maxtext_indextts2_tpu_torch.utils.param_bridge import s2a_params_from_jax

CODEBOOK = h.TINY["cond_codebook_size"]
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
# semantic ids of the two packages' CLIs from the same files: equal but where
# float32 summation order flips a near-tie argmax
MIN_ID_AGREEMENT = 0.95


def _equal(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _engine(cfg):
    engine = Engine(cfg, device="cpu")
    engine.set_params({k: torch.from_numpy(v) for k, v in
                       ph.audio_only_lm_weights(cfg, 1).items()})
    return engine


def _pipeline(cfg, seed, engine, float_s2a):
    return pl.build_tiny_pipeline(
        cfg, seed=seed, device="cpu", engine=engine, s2a_params=float_s2a,
        semantic_encoder_cfg=ConformerConfig(**CONFORMER), semantic_repcodec_kwargs=REPCODEC)


def _export(pipe, float_s2a):
    """A pipeline's audio weights as the reference's artifacts."""
    tok = pipe.semantic_tokenizer
    return dict(s2a_state_dict=rsd.s2a_state_dict(float_s2a),
                codec_encoder_state_dict=rsd.codec_encoder_state_dict(pipe.codec.encoder),
                codec_decoder_state_dict=rsd.codec_decoder_state_dict(pipe.codec.decoder),
                semantic_encoder_state_dict=rsd.hf_w2vbert_state_dict(tok.encoder),
                semantic_repcodec_state_dict=rsd.repcodec_state_dict(tok.repcodec),
                semantic_stats=rsd.semantic_stats(tok.encoder))


@pytest.fixture(scope="module", params=["float32", "int8_offline"])
def loaded(request):
    """(mode, source pipeline, pipeline from another seed with the source's
    weights loaded, the reference artifacts)."""
    cfg = load_config(ph.TINY_TTS + EXTRA + ["per_device_batch_size=1",
                                             f"s2a_serving_dtype={request.param}"])
    engine = _engine(cfg)
    w_src = {k: torch.from_numpy(v) for k, v in h.s2a_weights(seed=5).items()}
    src = _pipeline(cfg, 0, engine, w_src)
    h.load_seeded(src.semantic_tokenizer, 6)  # statistics that are not the identity
    h.load_seeded(src.codec, 7)
    dst = _pipeline(cfg, 1, engine, {k: torch.from_numpy(v) for k, v in
                                     h.s2a_weights(seed=8).items()})
    files = _export(src, w_src)
    dst.load_torch_audio_weights(**files)
    return request.param, src, dst, files


def test_loaded_weights_equal_the_source_bitwise(loaded):
    mode, src, dst, _ = loaded
    _equal(dst.s2a.state_dict(), src.s2a.state_dict())
    _equal(dst.semantic_tokenizer.state_dict(), src.semantic_tokenizer.state_dict())
    head = {k for k in src.codec.state_dict() if k.startswith("decoder.head.")}
    assert head and not any(torch.equal(dst.codec.state_dict()[k], src.codec.state_dict()[k])
                            for k in head)  # the head keeps its own parameters
    _equal({k: v for k, v in dst.codec.state_dict().items() if k not in head},
           {k: v for k, v in src.codec.state_dict().items() if k not in head})
    if mode == "int8_offline":
        assert dst.s2a.denoiser.layers_0.qkv.kernel.dtype == torch.int8
        assert dst.s2a.denoiser.t0.kernel.dtype == torch.bfloat16  # the cast residual stream


def test_synthesize_with_loaded_weights_equals_the_source(loaded):
    _, src, dst, _ = loaded
    own_head = {k: v.clone() for k, v in dst.codec.decoder.head.state_dict().items()}
    dst.codec.decoder.head.load_state_dict(src.codec.decoder.head.state_dict())
    try:
        _synthesize_both(src, dst)
    finally:
        dst.codec.decoder.head.load_state_dict(own_head)


def _synthesize_both(src, dst):
    w16 = pl.prompt_signal(3, 1.0, 16_000)
    w24 = pl.prompt_signal(3, 1.0, 24_000)
    for a, b in ((src.semantic_tokenizer.tokenize(w16[None]),
                  dst.semantic_tokenizer.tokenize(w16[None])),):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    codes = {}
    for name, pipe in (("src", src), ("dst", dst)):
        sample = pipe.s2a.reverse_diffusion
        pipe.s2a.reverse_diffusion = lambda *a, _s=sample, _n=name, **k: codes.setdefault(
            _n, _s(*a, **k))
        try:
            codes[name + "_out"] = pipe.synthesize("a short text", w16, w24, max_new_tokens=12,
                                                   generator=torch.Generator().manual_seed(4))
        finally:
            del pipe.s2a.reverse_diffusion
    wav_src, info_src = codes["src_out"]
    wav_dst, info_dst = codes["dst_out"]
    assert info_src["semantic_tokens"] == info_dst["semantic_tokens"] == 12
    assert torch.equal(codes["src"], codes["dst"])
    assert wav_src.shape == wav_dst.shape and np.array_equal(wav_src, wav_dst)
    assert np.isfinite(wav_src).all() and wav_src.std() > 0


def test_the_jax_pipeline_loads_the_same_s2a_weights(loaded):
    mode, _, dst, files = loaded
    jcfg = jax_load_config(ph.TINY_TTS + EXTRA + ["per_device_batch_size=0.125",
                                                  f"s2a_serving_dtype={mode}"])
    jpipe = jax_build_tiny_pipeline(
        dataclasses.replace(jcfg, scan_layers=False),
        semantic_encoder_cfg=jax_conformer.ConformerConfig(**CONFORMER),
        semantic_repcodec_kwargs=REPCODEC)
    jpipe.load_torch_audio_weights(s2a_state_dict=files["s2a_state_dict"])
    want = s2a_params_from_jax(jax.tree.map(np.asarray, jpipe.s2a_params))
    got = dst.s2a.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].float() if got[k].dtype == torch.bfloat16 else got[k]
        w = v.float() if v.dtype == torch.bfloat16 else v
        if k.endswith("kernel_scale"):  # a quotient, rounded once on each side
            torch.testing.assert_close(g, w.to(g.dtype), rtol=2.0 ** -23, atol=0)
        else:
            assert torch.equal(g, w.to(g.dtype)), k


def test_mismatched_checkpoints_are_refused_before_anything_loads(loaded):
    mode, src, dst, files = loaded
    before = {k: v.clone() for k, v in dst.s2a.state_dict().items()}
    bigger = S2AModel(S2AConfig(**{**h.TINY, "num_layers": 3}), device="cpu")
    with pytest.raises(ValueError, match="S2A checkpoint dims"):
        dst.load_torch_audio_weights(s2a_state_dict=rsd.s2a_state_dict(bigger))
    _equal(dst.s2a.state_dict(), before)
    other = pl.AcousticCodec(**{**h.TINY_CODEC, "d_model": 16, "vocos_num_layers": 3},
                             device="cpu")
    with pytest.raises(ValueError, match="codec encoder checkpoint dims"):
        dst.load_torch_audio_weights(
            codec_encoder_state_dict=rsd.codec_encoder_state_dict(other.encoder))
    with pytest.raises(ValueError, match="codec decoder checkpoint dims"):
        dst.load_torch_audio_weights(
            codec_decoder_state_dict=rsd.codec_decoder_state_dict(other.decoder))


def test_statistics_alone_apply_to_the_current_encoder(loaded):
    _, src, dst, files = loaded
    stats = {"mean": torch.full((64,), 0.5), "var": torch.full((64,), 4.0)}
    dst.load_torch_audio_weights(semantic_stats=stats)
    assert torch.equal(dst.semantic_tokenizer.encoder.stat_std, torch.full((64,), 2.0))
    dst.load_torch_audio_weights(semantic_encoder_state_dict=files["semantic_encoder_state_dict"],
                                 semantic_stats=files["semantic_stats"])
    _equal(dst.semantic_tokenizer.state_dict(), src.semantic_tokenizer.state_dict())


# ------------------------------------------------------------------ CLI
def _write(tmp_path, name, sd):
    path = str(tmp_path / name)
    torch.save(sd, path)
    return path


def test_cli_tokenize_without_checkpoints_runs_the_tiny_tokenizer(tmp_path, capsys):
    wav = pl.prompt_signal(1, 1.0, 16_000)
    wavfile.write(tmp_path / "p.wav", 16_000, (wav * 32767).astype(np.int16))
    np.save(tmp_path / "p.npy", wav)
    out = cli.main(["tokenize", f"input={tmp_path / 'p.wav'}", f"out={tmp_path / 'ids.npy'}",
                    "device=cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ids = np.load(tmp_path / "ids.npy")
    tok = SemanticTokenizer(ConformerConfig(**cli.TINY_CONFORMER), cli.TINY_REPCODEC,
                            device="cpu")
    want, _ = tok.tokenize(cli._read_wav(str(tmp_path / "p.wav"), 16_000)[None])
    np.testing.assert_array_equal(ids, want[0].numpy())
    assert printed["n_tokens"] == out["n_tokens"] == len(ids) == 49
    assert printed["device"] == "cpu" and printed["first_tokens"] == ids[:16].tolist()
    from_npy = cli.main(["tokenize", f"input={tmp_path / 'p.npy'}", "device=cpu"])
    assert from_npy["n_tokens"] == 49


def test_cli_tokenize_with_checkpoints_equals_the_source_and_the_jax_cli(tmp_path, capsys):
    src = SemanticTokenizer(ConformerConfig(**CONFORMER), REPCODEC, device="cpu")
    h.load_seeded(src, 9)
    args = [f"w2vbert={_write(tmp_path, 'w2v.pt', rsd.hf_w2vbert_state_dict(src.encoder))}",
            f"repcodec={_write(tmp_path, 'rep.pt', rsd.repcodec_state_dict(src.repcodec))}",
            f"stats={_write(tmp_path, 'stats.pt', rsd.semantic_stats(src.encoder))}"]
    wav = pl.prompt_signal(2, 1.5, 16_000)
    wavfile.write(tmp_path / "p.wav", 16_000, wav)  # float32 WAV: read back exactly
    got = cli.main(["tokenize", f"input={tmp_path / 'p.wav'}", f"out={tmp_path / 'a.npy'}",
                    "device=cpu", *args])
    want, _ = src.tokenize(wav[None])
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), want[0].numpy())
    assert got["n_tokens"] == want.shape[1] > 0
    capsys.readouterr()
    jax_cli.main(["tokenize", f"input={tmp_path / 'p.wav'}", f"out={tmp_path / 'b.npy'}", *args])
    ours, theirs = np.load(tmp_path / "a.npy"), np.load(tmp_path / "b.npy")
    # the same weights (bitwise, test_torch_audio_weight_import.py) through two
    # frameworks: a float32 near-tie in an id's argmax may flip (1 of 74 here)
    assert ours.shape == theirs.shape and (ours == theirs).mean() >= MIN_ID_AGREEMENT


def test_cli_synthesize_without_checkpoints_writes_a_wav(tmp_path):
    wav = pl.prompt_signal(3, 1.0, 16_000)
    np.save(tmp_path / "p.npy", wav)
    out = cli.main(["synthesize", "text=hi", f"prompt={tmp_path / 'p.npy'}",
                    f"out={tmp_path / 'o.wav'}", "max_new_tokens=4", "device=cpu"])
    sr, data = wavfile.read(tmp_path / "o.wav")
    assert sr == 24_000 and data.dtype == np.int16 and len(data) == out["samples"]
    assert out["device"] == "cpu"


def test_cli_synthesize_with_checkpoints_equals_the_source_pipeline(tmp_path):
    """Every stage from files (the LM from a params-only checkpoint): the
    CLI's pipeline is the seeded source pipeline's, the ISTFT head included
    (the same seed builds it), so the waveforms agree to one PCM step."""
    cfg = load_config(cli.TINY_CFG)
    engine = _engine(cfg)
    src = pl.build_tiny_pipeline(cfg, seed=0, device="cpu", engine=engine)
    h.load_seeded(src.semantic_tokenizer, 10)
    checkpointing.save_params_only(str(tmp_path / "lm"), engine.params)
    tok = src.semantic_tokenizer
    enc, dec = src.codec.encoder, src.codec.decoder
    args = [f"s2a={_write(tmp_path, 's2a.pt', rsd.s2a_state_dict(src.s2a))}",
            f"codec_encoder={_write(tmp_path, 'enc.pt', rsd.codec_encoder_state_dict(enc))}",
            f"codec_decoder={_write(tmp_path, 'dec.pt', rsd.codec_decoder_state_dict(dec))}",
            f"w2vbert={_write(tmp_path, 'w2v.pt', rsd.hf_w2vbert_state_dict(tok.encoder))}",
            f"repcodec={_write(tmp_path, 'rep.pt', rsd.repcodec_state_dict(tok.repcodec))}",
            f"stats={_write(tmp_path, 'stats.pt', rsd.semantic_stats(tok.encoder))}",
            f"load_parameters_path={tmp_path / 'lm'}"]
    w16, w24 = pl.prompt_signal(4, 1.0, 16_000), pl.prompt_signal(4, 1.0, 24_000)
    wavfile.write(tmp_path / "p16.wav", 16_000, w16)
    wavfile.write(tmp_path / "p24.wav", 24_000, w24)
    out = cli.main(["synthesize", "text=hello there", f"prompt={tmp_path / 'p16.wav'}",
                    f"prompt24k={tmp_path / 'p24.wav'}", f"out={tmp_path / 'o.wav'}",
                    "max_new_tokens=10", "device=cpu", *args])
    want, info = src.synthesize("hello there", w16, w24, max_new_tokens=10)
    assert info["semantic_tokens"] == 10 and out["samples"] == len(want) > 0
    _, data = wavfile.read(tmp_path / "o.wav")
    pcm = np.clip(want, -1, 1)
    np.testing.assert_allclose(data / 32767.0, pcm, atol=1.0 / 32767 + 1e-6, rtol=0)
    assert data.std() > 0


def test_cli_refuses_an_unknown_command(capsys):
    with pytest.raises(SystemExit):
        cli.main(["nope"])
    assert "Usage" in capsys.readouterr().out


def test_cli_runs_on_the_gpu_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    np.save(tmp_path / "p.npy", pl.prompt_signal(1, 0.5, 16_000))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["tokenize", f"input={tmp_path / 'p.npy'}"])
    assert os.path.exists(tmp_path / "p.npy")
