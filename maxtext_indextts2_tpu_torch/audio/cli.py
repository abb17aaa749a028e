"""Audio CLIs: wav -> semantic tokens, and text + prompt -> wav synthesis.

Counterpart of the JAX package's ``audio/cli.py``. Input and output go
through ``scipy.io.wavfile`` (16-bit PCM is written; int16, int32 and float
WAVs are read, other rates resampled linearly); ``.npy`` waveforms are
accepted wherever a WAV is.

Usage (on the GPU; ``device=cpu`` asks for the CPU explicitly)::

  python -m maxtext_indextts2_tpu_torch.audio.cli tokenize input=<wav|npy> \\
      [out=<npy>] [w2vbert=<pt|HF dir>] [repcodec=<pt>] [stats=<pt>] [key=value ...]
  python -m maxtext_indextts2_tpu_torch.audio.cli synthesize text="..." \\
      prompt=<wav|npy 16k> [prompt24k=<wav|npy 24k>] [out=<wav>] \\
      [max_new_tokens=N] [s2a=<pt>] [codec_encoder=<pt>] [codec_decoder=<pt>] \\
      [w2vbert=<pt|HF dir>] [repcodec=<pt>] [stats=<pt>] [key=value ...]

The reference's torch checkpoints load directly: ``w2vbert`` is a HF
``Wav2Vec2BertModel`` state dict (or a ``save_pretrained`` directory, read
without ``transformers``), ``repcodec`` the RepCodec state dict, ``stats`` the
``wav2vec2bert_stats.pt`` mean / var dict, ``s2a`` / ``codec_*`` the
MaskGCT_S2A / acoustic codec state dicts (``audio/torch_ckpt.py``); each
stage is sized from its checkpoint. The LM's weights come from the config key
``load_parameters_path`` (a checkpoint of ``train/checkpointing.py``).
Without checkpoints this runs the tiny random-weight pipeline, for shape and
latency smoke tests.
"""

from __future__ import annotations

import json
import sys

import numpy as np

_FILE_KEYS = ("input", "out", "text", "prompt", "prompt24k", "max_new_tokens", "w2vbert",
              "repcodec", "stats", "s2a", "codec_encoder", "codec_decoder")


def _read_wav(path: str, expect_sr: int) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if sr != expect_sr:  # linear resampling
        n_out = int(round(len(data) * expect_sr / sr))
        data = np.interp(np.linspace(0.0, len(data) - 1.0, n_out),
                         np.arange(len(data), dtype=np.float64),
                         data.astype(np.float64)).astype(np.float32)
    return data


def _write_wav(path: str, wav: np.ndarray, sr: int) -> None:
    from scipy.io import wavfile

    pcm = np.clip(wav, -1.0, 1.0)
    wavfile.write(path, sr, (pcm * 32767.0).astype(np.int16))


def _parse(argv):
    """(this CLI's keys, the config's key=value arguments, device or None)."""
    from maxtext_indextts2_tpu_torch.infer.server import split_device_arg

    argv, device = split_device_arg(list(argv))
    kv, keep = {}, []
    for a in argv:
        k, eq, v = a.partition("=")
        if eq and k in _FILE_KEYS:
            kv[k] = v
        else:
            keep.append(a)
    return kv, keep, device


def _load_torch(path: str) -> dict:
    """A torch checkpoint as a flat ``{name: tensor}`` state dict: the
    ``{"state_dict" | "model": ...}`` containers unwrapped, DataParallel's
    ``module.`` prefixes stripped."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
    return {k.removeprefix("module."): v for k, v in obj.items()}


def _load_w2vbert_sd(path: str) -> dict:
    """HF Wav2Vec2BertModel weights from a ``save_pretrained`` directory (its
    safetensors or ``pytorch_model*.bin`` files, read without
    ``transformers``) or a ``.pt`` file."""
    import os

    if os.path.isdir(path):
        from maxtext_indextts2_tpu_torch.utils.ckpt_conversion import _read_hf_state_dict

        return _read_hf_state_dict(path)
    return _load_torch(path)


TINY_CONFORMER = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=256,
                      output_layer=2)
TINY_REPCODEC = dict(codebook_size=8192, vocos_dim=64, vocos_intermediate_dim=128,
                     vocos_num_layers=2)


def _build_semantic_tokenizer(kv, device):
    """The semantic tokenizer sized from its checkpoints when they are given,
    else the tiny random-weight one."""
    from maxtext_indextts2_tpu_torch.audio.conformer import (
        ConformerConfig, config_from_hf_state_dict,
    )
    from maxtext_indextts2_tpu_torch.audio.semantic_tokenizer import (
        SemanticTokenizer, stats_mean_std,
    )
    from maxtext_indextts2_tpu_torch.audio.torch_ckpt import repcodec_kwargs_from_torch

    if not (kv.get("w2vbert") or kv.get("repcodec") or kv.get("stats")):
        return SemanticTokenizer(encoder_cfg=ConformerConfig(**TINY_CONFORMER),
                                 repcodec_kwargs=TINY_REPCODEC, device=device)
    enc_sd = _load_w2vbert_sd(kv["w2vbert"]) if kv.get("w2vbert") else None
    rep_sd = _load_torch(kv["repcodec"]) if kv.get("repcodec") else None
    enc_cfg = config_from_hf_state_dict(enc_sd) if enc_sd is not None else None
    rep_kwargs = None
    if rep_sd is not None:
        rep_kwargs = repcodec_kwargs_from_torch(rep_sd)
        rep_kwargs.pop("hidden_size")  # tied to the encoder's hidden size
    tok = SemanticTokenizer(encoder_cfg=enc_cfg, repcodec_kwargs=rep_kwargs, device=device)
    stats = _load_torch(kv["stats"]) if kv.get("stats") else None
    if enc_sd is not None:
        mean = std = None
        if stats is not None:
            mean, std = stats_mean_std(stats)
        tok.load_hf_encoder(enc_sd, mean, std)
    elif stats is not None:
        tok.set_stats(stats)  # statistics without encoder weights: on the current encoder
    if rep_sd is not None:
        tok.load_torch_repcodec(rep_sd)
    return tok


TINY_CFG = [
    "vocab_size=9344", "audio_codebook_size=8192",
    "base_emb_dim=64", "base_mlp_dim=128", "base_num_decoder_layers=2",
    "base_num_query_heads=2", "base_num_kv_heads=2", "head_dim=32",
    "max_target_length=512", "max_prefill_predict_length=128",
    "per_device_batch_size=1", "dtype=float32", "decoder_block=tts",
    "s2a_num_quantizers=4", "s2a_hidden_size=64", "s2a_num_layers=2",
    "s2a_num_heads=4", "s2a_codebook_size=64", "s2a_timesteps=[2,2,2,2]",
    "semantic_codebook_size=8192",
]


def tokenize(argv):
    kv, _, device = _parse(argv)
    wav = _read_wav(kv["input"], 16000)
    tok = _build_semantic_tokenizer(kv, device)
    codes, lengths = tok.tokenize(wav[None])
    codes = codes.cpu().numpy()[0, : int(lengths[0])]
    if kv.get("out"):
        np.save(kv["out"], codes)
    result = {"n_tokens": int(codes.shape[0]),
              "tokens_per_second": round(codes.shape[0] / (len(wav) / 16000.0), 2),
              "first_tokens": codes[:16].tolist(), "out": kv.get("out", ""),
              "device": str(tok.device)}
    print(json.dumps(result))
    return result


def _build_pipeline(kv, keep, device):
    """The synthesize pipeline: each stage sized from its checkpoint (config
    keys win for what a checkpoint does not tell, e.g. ``s2a_num_heads``);
    without checkpoints, the tiny random pipeline. The LM engine loads
    ``load_parameters_path`` when it is set."""
    from maxtext_indextts2_tpu_torch.audio.conformer import config_from_hf_state_dict
    from maxtext_indextts2_tpu_torch.audio.pipeline import build_tiny_pipeline
    from maxtext_indextts2_tpu_torch.audio.torch_ckpt import (
        codec_decoder_kwargs_from_torch, codec_encoder_kwargs_from_torch,
        repcodec_kwargs_from_torch, s2a_kwargs_from_torch,
    )
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine

    sds = {k: _load_torch(kv[k]) if kv.get(k) else None
           for k in ("s2a", "codec_encoder", "codec_decoder", "repcodec", "stats")}
    sds["w2vbert"] = _load_w2vbert_sd(kv["w2vbert"]) if kv.get("w2vbert") else None

    derived = []
    if sds["s2a"] is not None:
        derived += [f"s2a_{k}={v}" for k, v in s2a_kwargs_from_torch(sds["s2a"]).items()]
    codec_kwargs = None
    if sds["codec_encoder"] is not None or sds["codec_decoder"] is not None:
        codec_kwargs = dict(vocos_dim=64, vocos_intermediate_dim=128, vocos_num_layers=2)
        if sds["codec_encoder"] is not None:
            ek = codec_encoder_kwargs_from_torch(sds["codec_encoder"])
            codec_kwargs.update(d_model=ek["d_model"], strides=ek["strides"],
                                latent_dim=ek["out_channels"])
        if sds["codec_decoder"] is not None:
            dk = codec_decoder_kwargs_from_torch(sds["codec_decoder"])
            codec_kwargs.update(
                latent_dim=dk["in_channels"], num_quantizers=dk["num_quantizers"],
                codebook_size=dk["codebook_size"], codebook_dim=dk["codebook_dim"],
                vocos_dim=dk["vocos_dim"], vocos_intermediate_dim=dk["vocos_intermediate_dim"],
                vocos_num_layers=dk["vocos_num_layers"])
    enc_cfg = config_from_hf_state_dict(sds["w2vbert"]) if sds["w2vbert"] is not None else None
    rep_kwargs = None
    if sds["repcodec"] is not None:
        rep_kwargs = repcodec_kwargs_from_torch(sds["repcodec"])
        rep_kwargs.pop("hidden_size")

    cfg = load_config(TINY_CFG + derived + keep)  # the user's keys win last
    engine = Engine(cfg, device=device)
    engine.load_params(cfg.load_parameters_path or None)
    pipe = build_tiny_pipeline(cfg, codec_kwargs=codec_kwargs, device=engine.device,
                               engine=engine, semantic_encoder_cfg=enc_cfg,
                               semantic_repcodec_kwargs=rep_kwargs)
    if any(sds[k] is not None for k in
           ("s2a", "codec_encoder", "codec_decoder", "w2vbert", "repcodec")):
        pipe.load_torch_audio_weights(
            s2a_state_dict=sds["s2a"], codec_encoder_state_dict=sds["codec_encoder"],
            codec_decoder_state_dict=sds["codec_decoder"],
            semantic_encoder_state_dict=sds["w2vbert"],
            semantic_repcodec_state_dict=sds["repcodec"], semantic_stats=sds["stats"])
    elif sds["stats"] is not None:
        pipe.semantic_tokenizer.set_stats(sds["stats"])
    return pipe


def synthesize(argv):
    kv, keep, device = _parse(argv)
    wav16 = _read_wav(kv["prompt"], 16000)
    wav24 = (_read_wav(kv["prompt24k"], 24000) if kv.get("prompt24k") else np.interp(
        np.linspace(0.0, len(wav16) - 1.0, int(len(wav16) * 1.5)),
        np.arange(len(wav16), dtype=np.float64), wav16.astype(np.float64)).astype(np.float32))
    pipe = _build_pipeline(kv, keep, device)
    wav, info = pipe.synthesize(kv.get("text", ""), wav16, wav24,
                                max_new_tokens=int(kv.get("max_new_tokens", 64)))
    out = kv.get("out", "out.wav")
    _write_wav(out, np.asarray(wav), 24000)
    result = {"out": out, "samples": int(wav.shape[0]),
              "seconds": round(wav.shape[0] / 24000.0, 3), "device": str(pipe.device),
              **{k: round(v, 4) for k, v in info.items() if isinstance(v, float)}}
    print(json.dumps(result))
    return result


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("tokenize", "synthesize"):
        print(__doc__)
        raise SystemExit(2)
    cmd, rest = argv[0], argv[1:]
    return (tokenize if cmd == "tokenize" else synthesize)(rest)


if __name__ == "__main__":
    main()
