"""Zero-shot TTS pipeline, back end: semantic tokens + prompt acoustic codes
-> acoustic codes (S2A reverse diffusion) -> 24 kHz waveform (codec decoder).

Counterpart of the JAX package's ``audio/pipeline.py`` for the stages the
server runs after the LM: ``TTSPipeline.s2a_vocoder_batch`` with its
bucketing, and ``build_tiny_pipeline`` for the S2A and codec parts. The
front end (semantic tokenizer, codec encoder, text/vocabulary mapping) and
the stages that need it are not ported yet and say so when called.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from maxtext_indextts2_tpu_torch.audio.acoustic import AcousticCodec
from maxtext_indextts2_tpu_torch.audio.s2a import (
    S2AConfig, S2AModel, cast_denoiser_params, quantize_s2a_params, serving_s2a_config,
)
from maxtext_indextts2_tpu_torch.config import Config, load_config
from maxtext_indextts2_tpu_torch.infer.engine import Engine, resolve_device
from maxtext_indextts2_tpu_torch.models.layers import _unsupported

_FRONTEND = "3, audio frontend, pipeline, /tts"
_TTS_1B = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs", "models", "tts-1b.yml")


def _roundup(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass
class TTSPipeline:
    cfg: Config
    s2a: S2AModel
    codec: AcousticCodec
    engine: Engine | None = None

    @property
    def device(self) -> torch.device:
        return self.s2a.mask_emb.device

    # ---------------------------------------------- stages not ported yet
    def load_torch_audio_weights(self, *args, **kwargs):
        _unsupported("TTSPipeline.load_torch_audio_weights (published checkpoints)", _FRONTEND)

    def text_and_prompt_to_lm_prompt(self, text, prompt_semantic):
        _unsupported("TTSPipeline.text_and_prompt_to_lm_prompt (vocabulary mapping)", _FRONTEND)

    def map_semantic(self, out_embedding_ids, force_frames: bool = False):
        _unsupported("TTSPipeline.map_semantic (vocabulary mapping)", _FRONTEND)

    def synthesize(self, *args, **kwargs):
        _unsupported("TTSPipeline.synthesize (semantic tokenizer, codec encoder)", _FRONTEND)

    def synthesize_batch(self, *args, **kwargs):
        _unsupported("TTSPipeline.synthesize_batch (semantic tokenizer, codec encoder)",
                     _FRONTEND)

    def frontend_batch(self, *args, **kwargs):
        _unsupported("TTSPipeline.frontend_batch (semantic tokenizer, codec encoder)", _FRONTEND)

    # ------------------------------------------------------------ back end
    def s2a_vocoder_batch(
        self,
        requests: list[dict],
        sems: list[np.ndarray],
        acs: list[np.ndarray],
        gens: list[list[int]],
        generator: torch.Generator | None = None,
        length_bucket: int = 64,
        pad_to_batch: int | None = None,
        timings: dict | None = None,
        noise=None,
        impl: str | None = None,
    ) -> list[tuple[np.ndarray, dict]]:
        """Stages 2+3: one batched masked S2A pass + vocoder decode for
        requests of different lengths.

        ``sems[i]``: prompt semantic tokens, ``acs[i]``: prompt acoustic codes
        ``[P_i, Q]``, ``gens[i]``: generated semantic tokens. Rows are padded
        to shared buckets (prompt to a multiple of 16, target to a multiple of
        ``length_bucket``) and run through ``reverse_diffusion`` with per-row
        masks; each wav is cut to its row's true length. ``pad_to_batch``
        pads the batch with dummy rows (one valid position) to a fixed size.
        The sampler's uniforms come from ``generator`` (default: seed 0) or
        from ``noise`` (see ``S2AModel.reverse_diffusion``). Returns
        ``(wav [t_i * hop] float32, info dict)`` per request."""
        hop = int(np.prod(self.codec.strides))
        t2 = time.perf_counter()
        b = len(requests)
        t_rows = [len(g) for g in gens]
        acoustic = self._sample_codes(sems, acs, gens, generator, length_bucket,
                                      max(b, pad_to_batch or 0), noise, impl)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t3 = time.perf_counter()
        wavs = self.codec.detokenize(acoustic.permute(2, 0, 1)).float().cpu().numpy()
        t4 = time.perf_counter()

        timings = timings or {}
        t0 = timings.get("t_start", t2)
        out = []
        for i, t_i in enumerate(t_rows):
            wav = wavs[i, : t_i * hop]
            dur = len(wav) / 24_000.0
            out.append((wav, {
                "semantic_tokens": t_i,
                "audio_seconds": dur,
                "batch": b,
                "t_frontend": timings.get("t_frontend", 0.0),
                "t_lm": timings.get("t_lm", 0.0),
                "t_s2a": t3 - t2,
                "t_vocoder": t4 - t3,
                "t_total": t4 - t0,
                "batch_rtf": (t4 - t0) / max(sum(t_rows) / 50.0, 1e-6),
            }))
        return out

    def _sample_codes(self, sems, acs, gens, generator, length_bucket, bp, noise, impl):
        """The bucketed batch of ``s2a_vocoder_batch`` through the masked
        sampler: acoustic codes ``[bp, tb, Q]``, the rows past the requests
        being dummies."""
        device = self.device
        b = len(gens)
        q = self.s2a.cfg.num_quantizers
        p_rows = [min(a.shape[0], len(s)) for a, s in zip(acs, sems)]
        t_rows = [len(g) for g in gens]
        pb = max(_roundup(max(p_rows), 16), 16)
        tb = max(_roundup(max(max(t_rows), 1), length_bucket), length_bucket)

        cond = np.zeros((bp, pb + tb), np.int64)
        prompt = np.zeros((bp, pb, q), np.int64)
        x_mask = np.zeros((bp, tb), np.int32)
        p_mask = np.zeros((bp, pb), np.int32)
        for i, (sem, ac, gen) in enumerate(zip(sems, acs, gens)):
            p_i, t_i = p_rows[i], t_rows[i]
            cond[i, :p_i] = sem[:p_i]
            cond[i, pb:pb + t_i] = gen
            prompt[i, :p_i] = np.asarray(ac)[:p_i]
            p_mask[i, :p_i] = 1
            x_mask[i, :t_i] = 1
        # dummy rows: one valid prompt/target position keeps the per-row
        # re-masking counts non-degenerate; their outputs are dropped
        x_mask[b:, 0] = 1
        p_mask[b:, 0] = 1

        if generator is None and noise is None:
            generator = torch.Generator(device=device).manual_seed(0)
        return self.s2a.reverse_diffusion(
            torch.from_numpy(cond).to(device), torch.from_numpy(prompt).to(device),
            generator=generator, noise=noise,
            n_timesteps=tuple(self.cfg.s2a_timesteps)[:q],
            cfg=self.cfg.s2a_cfg_scale, cfg_until=self.cfg.s2a_cfg_until,
            x_mask=torch.from_numpy(x_mask).to(device),
            prompt_mask=torch.from_numpy(p_mask).to(device), impl=impl,
        )


def s2a_config_from(cfg: Config) -> S2AConfig:
    return S2AConfig(
        num_quantizers=cfg.s2a_num_quantizers,
        hidden_size=cfg.s2a_hidden_size,
        num_layers=cfg.s2a_num_layers,
        num_heads=cfg.s2a_num_heads,
        codebook_size=cfg.s2a_codebook_size,
        cond_codebook_size=cfg.s2a_cond_codebook_size,
    )


def build_serving_s2a(s2a_cfg: S2AConfig, serving_dtype: str, float_params=None, device=None,
                      generator=None) -> S2AModel:
    """The S2A model as it is served in ``serving_dtype``: a float tree
    (``float_params``, or seeded random weights) converted in the JAX
    package's order: offline int8 quantization, then, for both int8 modes,
    the denoiser's float parameters cast to bfloat16."""
    serve_cfg = serving_s2a_config(s2a_cfg, serving_dtype)
    if float_params is None:
        float_model = S2AModel(dataclasses.replace(serve_cfg, int8_matmul=False),
                               device=device, generator=generator)
        float_params = float_model.state_dict()
        del float_model
    model = S2AModel(serve_cfg, device=device)
    if serve_cfg.int8_matmul == "offline":
        float_params = quantize_s2a_params(float_params, model)
    model.load_state_dict(float_params)
    if serve_cfg.int8_matmul:
        cast_denoiser_params(model)  # bfloat16 residual stream
    return model.eval()


def build_tiny_pipeline(
    cfg: Config,
    seed: int = 0,
    codec_kwargs: dict | None = None,
    device=None,
    engine: Engine | None = None,
    s2a_params=None,
    codec_params=None,
) -> TTSPipeline:
    """Randomly initialised back end (tests and smoke runs before real
    weights): the S2A model sized by ``cfg.s2a_*`` and served as
    ``cfg.s2a_serving_dtype``, and the codec decoder (``codec_kwargs`` sizes
    it; the default is tiny, ``{}`` is ``AcousticCodec``'s own published size). ``s2a_params`` (a FLOAT state dict) and
    ``codec_params`` take the place of the seeded weights. The LM ``engine``
    is the caller's to pass; the back end does not need one. Runs on the GPU
    unless ``device="cpu"``."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    s2a = build_serving_s2a(s2a_config_from(cfg), cfg.s2a_serving_dtype, s2a_params,
                            device=device, generator=generator)
    codec = AcousticCodec(**(codec_kwargs if codec_kwargs is not None else dict(
        d_model=32, latent_dim=64,
        num_quantizers=cfg.s2a_num_quantizers,
        codebook_size=cfg.s2a_codebook_size,
        vocos_dim=64, vocos_intermediate_dim=128, vocos_num_layers=2,
    )), device=device, generator=generator).eval()
    if codec_params is not None:
        codec.load_state_dict(codec_params)
    return TTSPipeline(cfg=cfg, s2a=s2a, codec=codec, engine=engine)


def build_backend(serving_dtype: str = "int8_offline", layers: int | None = None,
                  timesteps=None, seed: int = 0, device=None) -> TTSPipeline:
    """The back end at its full published width (``tts-1b.yml``'s S2A, the
    codec decoder at ``AcousticCodec``'s defaults) with seeded random weights,
    served as ``serving_dtype``; ``layers`` cuts the denoiser's depth,
    ``timesteps`` replaces the sampler's schedule. For smoke runs and profiles
    on the GPU."""
    args = [_TTS_1B, f"s2a_serving_dtype={serving_dtype}"]
    if layers is not None:
        args.append(f"s2a_num_layers={layers}")
    if timesteps is not None:
        args.append("s2a_timesteps=[" + ",".join(str(int(t)) for t in timesteps) + "]")
    return build_tiny_pipeline(load_config(args), seed=seed, codec_kwargs={}, device=device)


def backend_requests(seed: int, n: int = 8, cond_vocab: int = 8192, codebook: int = 1024,
                     quantizers: int = 12, prompt=(100, 250), target=(200, 500)):
    """``n`` seeded requests for ``s2a_vocoder_batch``: (requests, prompt
    semantic tokens, prompt acoustic codes, generated semantic tokens). The
    longest prompt and the longest target sit at the top of their ranges, so
    the batch's buckets do not depend on the seed."""
    rng = np.random.default_rng(seed)
    p_lens = rng.integers(prompt[0], prompt[1] + 1, size=n)
    t_lens = rng.integers(target[0], target[1] + 1, size=n)
    p_lens[0], t_lens[-1] = prompt[1], target[1]
    sems = [rng.integers(0, cond_vocab, size=int(p)) for p in p_lens]
    acs = [rng.integers(0, codebook, size=(int(p), quantizers)) for p in p_lens]
    gens = [[int(v) for v in rng.integers(0, cond_vocab, size=int(t))] for t in t_lens]
    return [{} for _ in range(n)], sems, acs, gens
