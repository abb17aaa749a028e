"""Zero-shot TTS pipeline: text + prompt audio -> waveform, on the device.

Counterpart of the JAX package's ``audio/pipeline.py``::

    prompt wav 16k --SemanticTokenizer--> prompt semantic tokens
    prompt wav 24k --AcousticCodec.tokenize--> prompt acoustic tokens
    [e_<BT>] text [e_<BA>] + prompt semantic  --decoder LM-->  semantic tokens
    (prompt + generated semantic, prompt acoustic) --S2A reverse diffusion-->
        acoustic tokens --codec decoder--> 24 kHz waveform

``synthesize`` runs one request through the fixed-length sampler (no pad
masks, so the denoiser's attention is ``ops/s2a_attention.py``);
``synthesize_batch`` runs requests of different lengths as one batch:
``frontend_batch`` (prompt tokenizers, bucketed), the LM, then
``s2a_vocoder_batch`` (masked sampler + vocoder). ``build_tiny_pipeline``
and ``build_pipeline`` make seeded pipelines (tiny, or at the full
published width). Published checkpoints wait for weight import
(``load_torch_audio_weights`` raises).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from maxtext_indextts2_tpu_torch.audio.acoustic import AcousticCodec
from maxtext_indextts2_tpu_torch.audio.conformer import ConformerConfig
from maxtext_indextts2_tpu_torch.audio.s2a import (
    S2AConfig, S2AModel, cast_denoiser_params, quantize_s2a_params, serving_s2a_config,
)
from maxtext_indextts2_tpu_torch.audio.semantic_tokenizer import SemanticTokenizer
from maxtext_indextts2_tpu_torch.config import Config, load_config
from maxtext_indextts2_tpu_torch.infer.engine import Engine, resolve_device
from maxtext_indextts2_tpu_torch.unported import _unsupported
from maxtext_indextts2_tpu_torch.train.data.tokenizer import build_tokenizer
from maxtext_indextts2_tpu_torch.vocab.mapping import AudioVocabMapping, default_mapping

_TTS_1B = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs", "models", "tts-1b.yml")


def _roundup(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class TTSPipeline:
    cfg: Config
    s2a: S2AModel
    codec: AcousticCodec
    engine: Engine | None = None
    semantic_tokenizer: SemanticTokenizer | None = None
    mapping: AudioVocabMapping | None = None
    tokenizer: object = None

    def __post_init__(self):
        if self.mapping is None:
            self.mapping = default_mapping(self.cfg)
        if self.tokenizer is None:
            self.tokenizer = build_tokenizer(self.cfg)
        self._e2a = self.mapping.embedding_to_audio_array(self.cfg.vocab_size)

    @property
    def device(self) -> torch.device:
        return self.s2a.mask_emb.device

    def load_torch_audio_weights(self, *args, **kwargs):
        _unsupported("TTSPipeline.load_torch_audio_weights (published checkpoints)",
                     "4b, rest of training: weight import, item 4b.1")

    # ------------------------------------------------------------ stages
    def text_and_prompt_to_lm_prompt(self, text: str, prompt_semantic) -> np.ndarray:
        m = self.mapping
        ids = [m.audio_to_embedding(m.marker_bt_audio_id)]
        ids += [m.token_to_embedding(t) for t in self.tokenizer.encode(text)]
        ids += [m.audio_to_embedding(m.marker_ba_audio_id)]
        ids += [m.audio_to_embedding(int(a)) for a in prompt_semantic]
        return np.asarray(ids, np.int32)

    def map_semantic(self, out_embedding_ids, force_frames: bool = False) -> list[int]:
        """LM embedding ids -> audio ids, stopping at the first non-audio id.
        ``force_frames`` (a load-testing knob) folds non-audio ids into the
        codebook instead, so every stream keeps its full frame budget."""
        audio_ids = []
        for e in out_embedding_ids:
            a = int(self._e2a[e]) if 0 <= e < len(self._e2a) else -1
            if a < 0 or a >= self.mapping.codebook_size:
                if not force_frames:
                    break  # EOS / non-audio token terminates generation
                a = abs(int(e)) % self.mapping.codebook_size
            audio_ids.append(a)
        return audio_ids

    def generate_semantic(self, lm_prompt: np.ndarray, max_new_tokens: int) -> list[int]:
        return self.map_semantic(self.engine.generate_stream(lm_prompt, max_new_tokens))

    def _prompt_tokens(self, wav16, lengths16, wav24) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Both prompt tokenizers on one padded batch: semantic ids [B, T16']
        and their lengths [B], acoustic ids [B, T24', Q]."""
        sem, sem_len = self.semantic_tokenizer.tokenize(wav16, lengths16)
        wav24 = torch.from_numpy(np.asarray(wav24, np.float32)).to(self.device)
        ac = self.codec.tokenize(wav24).permute(1, 2, 0)
        return sem.cpu().numpy(), sem_len.cpu().numpy(), ac.cpu().numpy()

    # ------------------------------------------------------------ pipeline
    @torch.no_grad()
    def synthesize(self, text: str, prompt_wav_16k: np.ndarray, prompt_wav_24k: np.ndarray,
                   max_new_tokens: int = 256, generator: torch.Generator | None = None,
                   noise=None, impl: str | None = None) -> tuple[np.ndarray, dict]:
        """One request through the fixed-length sampler. Returns (wav24k [T]
        float32, timing/info dict). The sampler's uniforms come from
        ``generator`` (default: seed 0) or ``noise`` (see
        ``S2AModel.reverse_diffusion``)."""
        t0 = time.perf_counter()
        w16 = np.asarray(prompt_wav_16k, np.float32)[None]
        sem, sem_len, ac_prompt = self._prompt_tokens(w16, [w16.shape[1]],
                                                      np.asarray(prompt_wav_24k)[None])
        sem_prompt = sem[0, : int(sem_len[0])]
        lm_prompt = self.text_and_prompt_to_lm_prompt(text, sem_prompt)
        t1 = time.perf_counter()
        gen_semantic = self.generate_semantic(lm_prompt, max_new_tokens)
        t2 = time.perf_counter()

        # align prompt lengths: semantic and acoustic tokens are both 50 Hz
        p = min(ac_prompt.shape[1], len(sem_prompt))
        cond = np.concatenate([sem_prompt[:p], np.asarray(gen_semantic, np.int64)])[None]
        q = self.s2a.cfg.num_quantizers
        if generator is None and noise is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        wav = np.zeros((0,), np.float32)  # the LM stopped at once: no frames, no audio
        if gen_semantic:
            acoustic = self.s2a.reverse_diffusion(
                torch.from_numpy(cond).to(self.device),
                torch.from_numpy(ac_prompt[:, :p].astype(np.int64)).to(self.device),
                generator=generator, noise=noise, n_timesteps=tuple(self.cfg.s2a_timesteps)[:q],
                cfg=self.cfg.s2a_cfg_scale, cfg_until=self.cfg.s2a_cfg_until, impl=impl)
        _sync(self.device)
        t3 = time.perf_counter()
        if gen_semantic:
            wav = self.codec.detokenize(acoustic.permute(2, 0, 1))[0].float().cpu().numpy()
        t4 = time.perf_counter()

        dur = len(wav) / 24_000.0
        info = {
            "semantic_tokens": len(gen_semantic),
            "audio_seconds": dur,
            "t_lm": t2 - t1,
            "t_s2a": t3 - t2,
            "t_vocoder": t4 - t3,
            "t_total": t4 - t0,
            "rtf": (t4 - t0) / max(dur, 1e-6),
        }
        return wav, info

    def synthesize_batch(self, requests: list[dict], generator: torch.Generator | None = None,
                         length_bucket: int = 64, generate_fn=None,
                         pad_to_batch: int | None = None, noise=None,
                         impl: str | None = None) -> list[tuple[np.ndarray, dict]]:
        """Batched synthesis of heterogeneous requests: one masked S2A pass.

        ``requests``: dicts with ``text``, ``prompt_wav_16k``,
        ``prompt_wav_24k`` and optional ``max_new_tokens`` (256) and
        ``force_frames``. ``generate_fn(lm_prompts, max_tokens) ->
        list[list[int]]`` replaces the LM stage (raw embedding ids): the
        server passes one backed by the Orchestrator's shared slots. The rest
        is ``s2a_vocoder_batch``'s contract."""
        t0 = time.perf_counter()
        sems, acs = self.frontend_batch(requests)
        t1 = time.perf_counter()
        lm_prompts = [self.text_and_prompt_to_lm_prompt(r["text"], sem)
                      for r, sem in zip(requests, sems)]
        mnts = [int(r.get("max_new_tokens", 256)) for r in requests]
        if generate_fn is None:
            outs = [self.engine.generate_stream(pr, m) for pr, m in zip(lm_prompts, mnts)]
        else:
            outs = generate_fn(lm_prompts, mnts)
        gens = [self.map_semantic(o, force_frames=bool(r.get("force_frames")))
                for o, r in zip(outs, requests)]
        t2 = time.perf_counter()
        return self.s2a_vocoder_batch(
            requests, sems, acs, gens, generator=generator, length_bucket=length_bucket,
            pad_to_batch=pad_to_batch, noise=noise, impl=impl,
            timings={"t_frontend": t1 - t0, "t_lm": t2 - t1, "t_start": t0})

    def frontend_batch(self, requests: list[dict], pad_to_batch: int | None = None
                       ) -> tuple[list[np.ndarray], list[np.ndarray]]:
        """Stage 0: prompt wavs -> (semantic tokens [P_i], acoustic tokens
        [P_i', Q]) per request. Requests are bucketed by length padded to 0.5 s
        at each rate; each bucket's batch (padded to a power of two, or to
        ``pad_to_batch``) runs the semantic tokenizer (per-row true lengths
        drive its pad mask) and the codec encoder once, and each row is cut
        to its true length. Rows that are not an exact bucket multiple see
        zero padding inside the codec convolutions' receptive field: their
        last prompt frames may differ from a per-request call; bucket-exact
        rows are identical."""
        n = len(requests)
        w16s = [np.asarray(r["prompt_wav_16k"], np.float32) for r in requests]
        w24s = [np.asarray(r["prompt_wav_24k"], np.float32) for r in requests]
        hop = int(np.prod(self.codec.strides))
        sems: list[np.ndarray | None] = [None] * n
        acs: list[np.ndarray | None] = [None] * n

        def bucket(t: int, rate: int) -> int:
            step = rate // 2
            return max(step, -(-t // step) * step)

        groups: dict[tuple[int, int], list[int]] = {}
        for i in range(n):
            key = (bucket(len(w16s[i]), 16_000), bucket(len(w24s[i]), 24_000))
            groups.setdefault(key, []).append(i)

        for (l16, l24), idx in groups.items():
            bp = 1
            while bp < len(idx):
                bp *= 2
            if pad_to_batch is not None:
                bp = max(bp, pad_to_batch)
            wav16 = np.zeros((bp, l16), np.float32)
            lens = np.full(bp, l16, np.int32)
            wav24 = np.zeros((bp, l24), np.float32)
            for j, i in enumerate(idx):
                wav16[j, : len(w16s[i])] = w16s[i]
                lens[j] = len(w16s[i])
                wav24[j, : len(w24s[i])] = w24s[i]
            sem, sem_len, ac = self._prompt_tokens(wav16, lens, wav24)
            for j, i in enumerate(idx):
                sems[i] = sem[j, : int(sem_len[j])]
                acs[i] = ac[j, : len(w24s[i]) // hop]
        return sems, acs

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
        _sync(self.device)
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
    semantic_encoder_cfg: ConformerConfig | None = None,
    semantic_repcodec_kwargs: dict | None = None,
) -> TTSPipeline:
    """Randomly initialised pipeline (tests and smoke runs before real
    weights): the S2A model sized by ``cfg.s2a_*`` and served as
    ``cfg.s2a_serving_dtype``; the codec (``codec_kwargs`` sizes it; the
    default is tiny, ``{}`` is ``AcousticCodec``'s own published size); the
    semantic tokenizer (``semantic_encoder_cfg`` / ``semantic_repcodec_kwargs``
    size it; the defaults are the JAX package's tiny sizes). ``s2a_params`` (a
    FLOAT state dict) and ``codec_params`` take the place of the seeded
    weights. The LM ``engine`` is the caller's to pass: the back
    end does not need one, ``synthesize`` does. Runs on the GPU unless
    ``device="cpu"``."""
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
    tokenizer = SemanticTokenizer(
        encoder_cfg=semantic_encoder_cfg or ConformerConfig(
            hidden_size=cfg.s2a_hidden_size // 4 if cfg.s2a_hidden_size >= 256 else 64,
            num_layers=2, num_heads=4, intermediate_size=256, output_layer=2),
        repcodec_kwargs=semantic_repcodec_kwargs if semantic_repcodec_kwargs is not None
        else dict(codebook_size=cfg.semantic_codebook_size, vocos_dim=64,
                  vocos_intermediate_dim=128, vocos_num_layers=2),
        device=device, seed=seed)
    return TTSPipeline(cfg=cfg, s2a=s2a, codec=codec, engine=engine,
                       semantic_tokenizer=tokenizer)


def _config(serving_dtype: str, layers: int | None, timesteps, extra=()) -> Config:
    args = [_TTS_1B, f"s2a_serving_dtype={serving_dtype}", *extra]
    if layers is not None:
        args.append(f"s2a_num_layers={layers}")
    if timesteps is not None:
        args.append("s2a_timesteps=[" + ",".join(str(int(t)) for t in timesteps) + "]")
    return load_config(args)


def build_backend(serving_dtype: str = "int8_offline", layers: int | None = None,
                  timesteps=None, seed: int = 0, device=None) -> TTSPipeline:
    """The back end at its full published width (``tts-1b.yml``'s S2A, the
    codec at ``AcousticCodec``'s defaults) with seeded random weights,
    served as ``serving_dtype``; ``layers`` cuts the denoiser's depth,
    ``timesteps`` replaces the sampler's schedule. For smoke runs and profiles
    on the GPU."""
    return build_tiny_pipeline(_config(serving_dtype, layers, timesteps), seed=seed,
                               codec_kwargs={}, device=device)


# the LM side of the full pipeline: bfloat16 weights, 32 slots, the ragged
# decode kernel, greedy decoding, prompts of up to 1024 tokens
PIPELINE_LM_ARGS = ("serve_params_dtype=bfloat16", "per_device_batch_size=32",
                    "decode_attention=ragged", "scan_layers=false",
                    "max_prefill_predict_length=1024", "decode_sampling_strategy=greedy")


def build_pipeline(serving_dtype: str = "int8_offline", layers: int | None = None,
                   timesteps=None, seed: int = 0, device=None) -> TTSPipeline:
    """The whole zero-shot pipeline at its full published width, seeded
    random weights: the ``tts-1b`` engine (``PIPELINE_LM_ARGS``), the
    semantic tokenizer at ``ConformerConfig()`` (1024 hidden, 16 heads, FFN
    4096, kernel 31, tapped at layer 17) and ``RepCodec()`` (Vocos 384 /
    2048 x 12, codebook 8192 x 8), the S2A model as ``build_backend`` builds
    it, and the codec at ``AcousticCodec()``'s defaults (encoder d_model 96,
    strides 3, 4, 5, 8, latent 256). ``layers`` and ``timesteps`` cut the
    sampler as in ``build_backend``; nothing is narrowed."""
    cfg = _config(serving_dtype, layers, timesteps, PIPELINE_LM_ARGS)
    engine = Engine(cfg, device=device)
    engine.load_params()
    return build_tiny_pipeline(cfg, seed=seed, codec_kwargs={}, device=engine.device,
                               engine=engine, semantic_encoder_cfg=ConformerConfig(),
                               semantic_repcodec_kwargs={})


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


def prompt_signal(seed: int, seconds: float, rate: int) -> np.ndarray:
    """One seeded voice-prompt stand-in (a few harmonics of a 90-220 Hz
    fundamental under a slow envelope), sampled at ``rate``: the 16 kHz and
    the 24 kHz prompt of a request are the same sound."""
    rng = np.random.default_rng(seed)
    f0, phases = rng.uniform(90, 220), rng.uniform(0, 2 * np.pi, size=4)
    t = np.arange(int(round(seconds * rate))) / rate
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
    x = sum(np.sin(2 * np.pi * f0 * (k + 1) * t + ph) / (k + 1) for k, ph in enumerate(phases))
    return (0.2 * env * x).astype(np.float32)


_WORDS = ("voice", "prompt", "zero", "shot", "speech", "model", "token", "audio", "card",
          "sample", "frame", "quiet", "river", "morning", "light", "across", "the", "a")


def tts_requests(seed: int, n: int = 8, prompt_seconds=(3.0, 6.0), text_bytes=(40, 160),
                 frames=(200, 500)) -> list[dict]:
    """``n`` seeded ``/tts`` requests (the dicts ``synthesize_batch`` takes):
    prompts of ``prompt_seconds``, texts of ``text_bytes`` ASCII bytes, each
    asking for a number of frames in ``frames`` with ``force_frames`` set."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        seconds = float(rng.uniform(*prompt_seconds))
        text = ""
        n_bytes = int(rng.integers(text_bytes[0], text_bytes[1] + 1))
        while len(text) < n_bytes:
            text += _WORDS[int(rng.integers(len(_WORDS)))] + " "
        out.append({"text": text[:n_bytes],
                    "prompt_wav_16k": prompt_signal(seed + i, seconds, 16_000),
                    "prompt_wav_24k": prompt_signal(seed + i, seconds, 24_000),
                    "max_new_tokens": int(rng.integers(frames[0], frames[1] + 1)),
                    "force_frames": True})
    return out
