"""Codec trainers: the acoustic codec and the RepCodec autoencoders.

Counterpart of the JAX package's ``train/codec_train.py`` on one device.
Losses:

- acoustic: the multi-scale log-mel L1 (:func:`mel_l1`) + 0.1 x the waveform
  L1 + the residual VQ's commitment and codebook losses (generator-only, no
  discriminators, as in the JAX package); every ``reseed_period`` steps the
  codebook rows no step of the window selected are re-seeded near busy rows
  (:func:`_reseed_dead_codes`, host numpy, the JAX package's draws);
- repcodec: the feature reconstruction MSE + the VQ losses.

Gradients by autograd, global-norm clipping before the optimizer (optax's
chain order) when ``gradient_clipping_threshold > 0``, the optimizer of
``train/optimizers.py``; float32 parameters, convolutions, FFTs and products
through cuDNN, cuFFT and cuBLAS (TF32 off). No kernel of this repository is on
these paths. Quantizer dropout's draw (``codec_quantizer_dropout > 0``) is an
input: ``dropout_fn(step, batch)`` gives the step's ``[B]`` draw (the JAX
package draws it from ``fold_in(PRNGKey(init_weights_seed + 1), step)``);
by default it comes from a generator on the device seeded with
``init_weights_seed + 1``. The default batches are the JAX package's numpy
draws from ``data_shuffle_seed + step``.

Run: ``python -m maxtext_indextts2_tpu_torch.train.codec_train <config.yml>
codec_target=acoustic|repcodec steps=...`` on the GPU; ``device=cpu`` asks
for the CPU explicitly.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections.abc import Callable

import numpy as np
import torch

from maxtext_indextts2_tpu_torch.audio import mel as mel_lib
from maxtext_indextts2_tpu_torch.audio.acoustic import AcousticCodec
from maxtext_indextts2_tpu_torch.audio.repcodec import RepCodec
from maxtext_indextts2_tpu_torch.config import Config, load_config
from maxtext_indextts2_tpu_torch.infer.engine import resolve_device
from maxtext_indextts2_tpu_torch.train.optimizers import (
    GradientTransformation,
    apply_updates,
    create_learning_rate_schedule,
    get_optimizer,
)
from maxtext_indextts2_tpu_torch.train.train import _clip_by_global_norm, _sync
from maxtext_indextts2_tpu_torch.utils.metrics import MetricLogger

MEL_RESOLUTIONS = ((512, 128), (1024, 256), (2048, 512))  # (n_fft, hop)
SECONDS = 0.5  # of 24 kHz audio a default batch row
REPCODEC_FRAMES = 64  # frames a default RepCodec batch row
RESEED_PERIOD = 20  # steps between dead-code re-seeds of the acoustic codec


def mel_l1(wav_a: torch.Tensor, wav_b: torch.Tensor) -> torch.Tensor:
    """Multi-scale log-mel L1 (the Vocos-style reconstruction loss)."""
    loss = 0.0
    for n_fft, hop in MEL_RESOLUTIONS:
        ma = mel_lib.mel_spectrogram(wav_a, n_mels=80, sample_rate=24000, n_fft=n_fft, hop=hop)
        mb = mel_lib.mel_spectrogram(wav_b, n_mels=80, sample_rate=24000, n_fft=n_fft, hop=hop)
        loss = loss + torch.mean(torch.abs(ma - mb))
    return loss / 3.0


def _reseed_dead_codes(params: dict[str, torch.Tensor], usage: np.ndarray, rng,
                       threshold: int = 0, jitter: float = 0.05) -> dict[str, torch.Tensor]:
    """Replace the RVQ codebook rows used ``<= threshold`` times in ``usage``
    ([Q, K] selection counts over the window) by jittered copies of rows that
    were used, drawn in proportion to their use; host numpy with
    ``np.random.default_rng(rng)``, the JAX package's draws in its order.
    ``params``: the acoustic codec's state dict (``decoder.quantizer.vq_{q}.
    codebook``), updated in place and returned.

    Straight-through FVQ sends no gradient to a row never selected, so a
    codebook that starts badly collapses onto a handful of codes; re-seeding
    dead rows near used ones splits their clusters."""
    gen = np.random.default_rng(rng)
    for q in range(usage.shape[0]):
        name = f"decoder.quantizer.vq_{q}.codebook"
        if name not in params:
            continue
        cb = params[name].detach().cpu().numpy().copy()
        used = usage[q] > threshold
        if used.all() or not used.any():
            continue
        dead, busy = np.where(~used)[0], np.where(used)[0]
        donors = gen.choice(busy, size=dead.size, p=usage[q][busy] / usage[q][busy].sum())
        noise = gen.standard_normal((dead.size, cb.shape[1])).astype(cb.dtype)
        cb[dead] = cb[donors] + jitter * noise * np.linalg.norm(cb[donors], axis=-1,
                                                                 keepdims=True)
        with torch.no_grad():
            params[name].copy_(torch.from_numpy(cb))
    return params


@dataclasses.dataclass
class CodecTrainState:
    """A codec (float32 parameters, ``requires_grad``), its named parameters,
    the optimizer and its state."""

    model: torch.nn.Module
    params: dict[str, torch.Tensor]
    tx: GradientTransformation
    opt_state: dict

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device


def setup_codec_state(cfg: Config, model: torch.nn.Module,
                      params: dict | None = None) -> CodecTrainState:
    """``model`` made trainable from its own weights or ``params`` (a state
    dict), and a fresh optimizer state."""
    if params is not None:
        model.load_state_dict(params, strict=True)
    named = dict(model.named_parameters())
    tx = get_optimizer(cfg, create_learning_rate_schedule(cfg))
    with torch.no_grad():
        opt_state = tx.init(named)
    return CodecTrainState(model, named, tx, opt_state)


def _seeded(cfg: Config, device: torch.device) -> dict:
    return dict(device=device,
                generator=torch.Generator(device=device).manual_seed(cfg.init_weights_seed))


def build_acoustic_codec(cfg: Config, codec_kwargs: dict | None = None,
                         device=None) -> AcousticCodec:
    """The trainer's codec: the config's quantizer count, codebook size and
    quantizer dropout, ``codec_kwargs`` for the other fields."""
    device = resolve_device(device)
    return AcousticCodec(num_quantizers=cfg.s2a_num_quantizers,
                         codebook_size=cfg.s2a_codebook_size,
                         quantizer_dropout=cfg.codec_quantizer_dropout,
                         **(codec_kwargs or {}), **_seeded(cfg, device))


def build_repcodec(cfg: Config, device=None) -> RepCodec:
    """The trainer's RepCodec (``s2a_hidden_size`` features,
    ``semantic_codebook_size`` codes, 4 Vocos layers a side)."""
    device = resolve_device(device)
    return RepCodec(hidden_size=cfg.s2a_hidden_size, codebook_size=cfg.semantic_codebook_size,
                    vocos_num_layers=4, **_seeded(cfg, device))


def acoustic_batch(cfg: Config, step: int, hop: int) -> dict[str, np.ndarray]:
    """The JAX package's default batch: ``global_batch_size_to_train_on`` rows
    of 0.5 s of 24 kHz noise (a multiple of the hop), from the step's seed."""
    rng = np.random.default_rng(cfg.data_shuffle_seed + step)
    b = max(1, cfg.global_batch_size_to_train_on)
    t = int(24000 * SECONDS) // hop * hop
    return {"wav": rng.standard_normal((b, t)).astype(np.float32) * 0.1}


def repcodec_batch(cfg: Config, step: int) -> dict[str, np.ndarray]:
    """The JAX package's default RepCodec batch: [B, 64, s2a_hidden_size]."""
    rng = np.random.default_rng(cfg.data_shuffle_seed + step)
    b = max(1, cfg.global_batch_size_to_train_on)
    return {"feats": rng.standard_normal(
        (b, REPCODEC_FRAMES, cfg.s2a_hidden_size)).astype(np.float32)}


def acoustic_loss(codec: AcousticCodec, wav: torch.Tensor, dropout=None, latents=None):
    """(loss, metrics) of one batch: log-mel L1 + 0.1 x waveform L1 + the VQ
    losses; ``metrics["_usage"]`` holds the [Q, K] code-usage histogram and
    ``metrics["_indices"]`` the RVQ indices. ``latents``: the encoder's
    output for ``wav`` when the caller has it (the decoder then starts there)."""
    if latents is None:
        latents = codec.encoder(wav)
    recon, idx, commit, cb = codec.decoder(latents, dropout=dropout)
    n = min(recon.shape[-1], wav.shape[-1])
    l_wav = torch.mean(torch.abs(recon[..., :n] - wav[..., :n]))
    l_mel = mel_l1(recon[..., :n], wav[..., :n])
    loss = l_mel + 0.1 * l_wav + commit + cb
    q, k = idx.shape[0], codec.codebook_size
    offsets = torch.arange(q, device=idx.device)[:, None, None] * k
    usage = torch.bincount((idx + offsets).reshape(-1), minlength=q * k).reshape(q, k)
    return loss, {"mel_l1": l_mel, "wav_l1": l_wav, "commit": commit, "_usage": usage,
                  "_indices": idx}


def repcodec_loss(codec: RepCodec, feats: torch.Tensor):
    recon, _, commit, cb = codec(feats)
    l_rec = torch.mean(torch.square(recon - feats))
    return l_rec + commit + cb, {"rec_mse": l_rec, "commit": commit}


def codec_train_step(cfg: Config, state: CodecTrainState, loss_fn: Callable) -> dict:
    """One optimizer step, in place: ``loss_fn()``'s gradients, clipped by
    their global norm when ``gradient_clipping_threshold > 0`` (before the
    optimizer, optax's chain order), the update. Returns the step's metrics."""
    loss, aux = loss_fn()
    grads = dict(zip(state.params, torch.autograd.grad(loss, list(state.params.values()))))
    with torch.no_grad():
        if cfg.gradient_clipping_threshold > 0:
            grads, _ = _clip_by_global_norm(grads, cfg.gradient_clipping_threshold)
        updates, state.opt_state = state.tx.update(grads, state.opt_state, state.params)
        del grads
        apply_updates(state.params, updates)
    return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}


def train_acoustic_codec(cfg: Config, batch_fn=None, codec_kwargs: dict | None = None,
                         reseed_period: int = RESEED_PERIOD, device=None,
                         params: dict | None = None, dropout_fn=None,
                         quiet: bool = False) -> dict:
    """Trains the acoustic codec ``cfg.steps`` steps. ``codec_kwargs``: other
    ``AcousticCodec`` fields (e.g. small Vocos widths); ``reseed_period``:
    the dead-code re-seeding cadence (0: off); ``params``: the starting state
    dict (default: seeded from ``init_weights_seed``); ``dropout_fn(step,
    b)``: the step's quantizer-dropout draw. Returns what :func:`_loop` does."""
    codec = build_acoustic_codec(cfg, codec_kwargs, device)
    state = setup_codec_state(cfg, codec, params)
    hop = math.prod(codec.strides)
    batch_fn = batch_fn or (lambda step: acoustic_batch(cfg, step, hop))
    gen = torch.Generator(device=state.device).manual_seed(cfg.init_weights_seed + 1)

    def step_fn(wav, step):
        dropout = gen if dropout_fn is None else dropout_fn(step, wav.shape[0])
        return codec_train_step(cfg, state, lambda: acoustic_loss(codec, wav, dropout))

    return _loop(cfg, state, step_fn, batch_fn, "wav", reseed_period, quiet)


def train_repcodec(cfg: Config, batch_fn=None, device=None, params: dict | None = None,
                   quiet: bool = False) -> dict:
    """Trains the RepCodec ``cfg.steps`` steps; as :func:`train_acoustic_codec`."""
    codec = build_repcodec(cfg, device)
    state = setup_codec_state(cfg, codec, params)
    batch_fn = batch_fn or (lambda step: repcodec_batch(cfg, step))

    def step_fn(feats, step):
        return codec_train_step(cfg, state, lambda: repcodec_loss(codec, feats))

    return _loop(cfg, state, step_fn, batch_fn, "feats", 0, quiet)


def _loop(cfg: Config, state: CodecTrainState, step_fn, batch_fn, key: str,
          reseed_period: int = 0, quiet: bool = False) -> dict:
    """The steps; returns the last step's metrics (floats), every step's
    logged scalars under ``history``, the distinct codes each quantizer layer
    selected at each step under ``distinct_codes`` (acoustic codec), each
    re-seed's step and dead rows a layer under ``reseeds``, and the trained
    state dict under ``params``."""
    logger = MetricLogger(cfg, quiet=quiet)
    history, distinct, reseeds, metrics = [], [], [], {}
    usage_acc = None
    try:
        _sync(state.device)
        last = time.perf_counter()
        for step in range(cfg.steps):
            batch = torch.from_numpy(np.ascontiguousarray(batch_fn(step)[key])).to(state.device)
            metrics = step_fn(batch, step)
            metrics.pop("_indices", None)
            usage = metrics.pop("_usage", None)  # never logged or returned
            if usage is not None:
                usage = usage.cpu().numpy()
                distinct.append((usage > 0).sum(axis=1).tolist())
                if reseed_period:
                    usage_acc = usage if usage_acc is None else usage_acc + usage
                    if (step + 1) % reseed_period == 0 and step < cfg.steps - 1:
                        reseeds.append({"step": step,
                                        "dead_rows": (usage_acc <= 0).sum(axis=1).tolist()})
                        _reseed_dead_codes(state.params, usage_acc, rng=step)
                        usage_acc = None
            _sync(state.device)
            now = time.perf_counter()
            history.append(logger.write_step(step, metrics, step_time=now - last))
            last = now
    finally:
        logger.close()
    out = {k: float(v) for k, v in metrics.items()}
    out.update(history=history, distinct_codes=distinct, reseeds=reseeds,
               params={n: p.detach() for n, p in state.params.items()})  # trained weights
    return out


def main(argv=None):
    import sys

    from maxtext_indextts2_tpu_torch.infer.server import split_device_arg

    argv = list(sys.argv[1:] if argv is None else argv)
    argv, device = split_device_arg(argv)
    target, keep = "acoustic", []
    for a in argv:
        if a.startswith("codec_target="):
            target = a.split("=", 1)[1]
        else:
            keep.append(a)
    if target not in ("acoustic", "repcodec"):
        raise ValueError(f"codec_target must be acoustic or repcodec, not {target!r}")
    cfg = load_config(keep)
    fn = train_acoustic_codec if target == "acoustic" else train_repcodec
    metrics = fn(cfg, device=device)
    print({k: v for k, v in metrics.items()
           if k not in ("params", "history", "distinct_codes", "reseeds")})
    return metrics


if __name__ == "__main__":
    main()
