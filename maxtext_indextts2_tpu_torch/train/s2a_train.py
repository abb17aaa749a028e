"""S2A (semantic -> acoustic) model trainer.

Counterpart of the JAX package's ``train/s2a_train.py`` on one device: the
masked-generative loss of ``audio/s2a.S2AModel.compute_loss`` (the denoiser's
AdaptiveRMSNorm through K5 on a CUDA tensor, its backward in plain PyTorch;
the masked attention materialised, or with ``MTT_S2A_SEQ_FLASH=1`` through
the flash-attention kernels K9-K11), gradients by autograd, global-norm
clipping before the optimizer (optax's chain order) when
``gradient_clipping_threshold > 0``, and the optimizer of
``train/optimizers.py``. Parameters are float32; ``dtype`` is the denoiser's
compute dtype, cast at the JAX package's points. Data: (acoustic codes
[B,T,Q], semantic codes [B,T]) pairs, synthetic by default
(:func:`synthetic_s2a_batch`, the JAX package's draws), or any ``batch_fn``.

Run: ``python -m maxtext_indextts2_tpu_torch.train.s2a_train <config.yml>
steps=100 ...`` on the GPU; ``device=cpu`` asks for the CPU explicitly.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from maxtext_indextts2_tpu_torch.audio import pipeline
from maxtext_indextts2_tpu_torch.audio.s2a import S2AConfig, S2AModel, S2ANoise, draw_s2a_noise
from maxtext_indextts2_tpu_torch.config import Config, load_config
from maxtext_indextts2_tpu_torch.infer.engine import resolve_device
from maxtext_indextts2_tpu_torch.models.layers import to_dtype
from maxtext_indextts2_tpu_torch.train.optimizers import (
    GradientTransformation,
    apply_updates,
    create_learning_rate_schedule,
    get_optimizer,
)
from maxtext_indextts2_tpu_torch.train.train import _clip_by_global_norm
from maxtext_indextts2_tpu_torch.utils.metrics import MetricLogger

def s2a_config_from(cfg: Config) -> S2AConfig:
    """The pipeline's S2A sizes with the training mask schedule and the
    compute dtype (``cfg.dtype``)."""
    return dataclasses.replace(pipeline.s2a_config_from(cfg),
                               mask_layer_schedule=cfg.s2a_mask_schedule,
                               dtype=to_dtype(cfg.dtype))


def synthetic_s2a_batch(cfg: Config, step: int) -> dict[str, np.ndarray]:
    """The JAX package's synthetic batch: numpy draws from the step's seed."""
    rng = np.random.default_rng(cfg.data_shuffle_seed + step)
    b = max(1, cfg.global_batch_size_to_train_on)
    t = min(cfg.max_target_length, 512)
    return {
        "acoustic": rng.integers(0, cfg.s2a_codebook_size,
                                 (b, t, cfg.s2a_num_quantizers)).astype(np.int32),
        "semantic": rng.integers(0, cfg.s2a_cond_codebook_size, (b, t)).astype(np.int32),
        "mask": np.ones((b, t), np.int32),
    }


@dataclasses.dataclass
class S2ATrainState:
    """The model (float32 parameters, ``requires_grad``), its named
    parameters, the optimizer and its state."""

    model: S2AModel
    params: dict[str, torch.Tensor]
    tx: GradientTransformation
    opt_state: dict

    @property
    def device(self) -> torch.device:
        return self.model.mask_emb.device


def setup_s2a_state(cfg: Config, device=None, params: dict | None = None) -> S2ATrainState:
    """The S2A model with seeded weights (``init_weights_seed``) or
    ``params`` (a state dict), and a fresh optimizer state."""
    device = resolve_device(device)
    model = S2AModel(s2a_config_from(cfg), device=device,
                     generator=torch.Generator(device=device).manual_seed(cfg.init_weights_seed))
    if params is not None:
        model.load_state_dict(params, strict=True)
    named = dict(model.named_parameters())
    tx = get_optimizer(cfg, create_learning_rate_schedule(cfg))
    with torch.no_grad():
        opt_state = tx.init(named)
    return S2ATrainState(model, named, tx, opt_state)


def batch_to_device(batch: dict, device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.int32)).to(device)
            for k, v in batch.items()}


def s2a_loss_and_grads(state: S2ATrainState, batch: dict, noise: S2ANoise,
                       impl: str | None = None, seq_flash: bool | None = None):
    """(loss, aux, grads by name) of one batch of device tensors."""
    loss, aux = state.model.compute_loss(batch["acoustic"], batch["mask"], batch["semantic"],
                                         noise, impl=impl, seq_flash=seq_flash)
    grads = torch.autograd.grad(loss, list(state.params.values()))
    return loss.detach(), aux, dict(zip(state.params, grads))


def s2a_train_step(cfg: Config, state: S2ATrainState, batch: dict, noise: S2ANoise,
                   impl: str | None = None) -> dict:
    """One optimizer step, in place: the loss's gradients, clipped by their
    global norm when ``gradient_clipping_threshold > 0`` (before the
    optimizer, optax's chain order), the update. Returns the step's metrics
    as 0-d tensors."""
    loss, aux, grads = s2a_loss_and_grads(state, batch, noise, impl)
    with torch.no_grad():
        if cfg.gradient_clipping_threshold > 0:
            grads, _ = _clip_by_global_norm(grads, cfg.gradient_clipping_threshold)
        updates, state.opt_state = state.tx.update(grads, state.opt_state, state.params)
        del grads
        apply_updates(state.params, updates)
    return {"loss": loss, **aux}


def train_s2a(cfg: Config, batch_fn=None, device=None, params: dict | None = None,
              noise_fn=None, impl: str | None = None, quiet: bool = False) -> dict:
    """Trains ``cfg.steps`` steps; returns the last step's metrics (floats),
    every step's logged scalars under ``history`` and the trained state dict
    under ``params``.

    ``params``: the starting state dict (default: seeded from
    ``init_weights_seed``); ``noise_fn(step, b, tlen)``: the step's
    ``S2ANoise`` (default: drawn from a CPU generator seeded with
    ``cfg.seed``); ``impl="plain"`` takes the kernels' plain versions
    (comparisons only)."""
    state = setup_s2a_state(cfg, device, params)
    device = state.device
    batch_fn = batch_fn or (lambda step: synthetic_s2a_batch(cfg, step))
    if noise_fn is None:
        gen = torch.Generator().manual_seed(cfg.seed)
        scfg = state.model.cfg
        noise_fn = lambda step, b, tlen: draw_s2a_noise(scfg, b, tlen, gen)  # noqa: E731

    logger = MetricLogger(cfg, quiet=quiet)
    history, metrics = [], {}
    try:
        _sync(device)
        last = time.perf_counter()
        for step in range(cfg.steps):
            batch = batch_to_device(batch_fn(step), device)
            b, tlen = batch["semantic"].shape
            metrics = s2a_train_step(cfg, state, batch, noise_fn(step, b, tlen), impl)
            _sync(device)
            now = time.perf_counter()
            history.append(logger.write_step(step, metrics, step_time=now - last))
            last = now
        if cfg.enable_checkpointing:
            from maxtext_indextts2_tpu_torch.train.checkpointing import save_params_only

            save_params_only(cfg.checkpoint_dir + "/s2a_params", state.params)
    finally:
        logger.close()
    out = {k: float(v) for k, v in metrics.items()}
    out["history"] = history
    out["params"] = {n: p.detach() for n, p in state.params.items()}  # trained weights
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    import sys

    from maxtext_indextts2_tpu_torch.infer.server import split_device_arg

    argv = list(sys.argv[1:] if argv is None else argv)
    argv, device = split_device_arg(argv)
    cfg = load_config(argv)
    metrics = train_s2a(cfg, device=device)
    print({k: v for k, v in metrics.items() if k not in ("params", "history")})
    return metrics


if __name__ == "__main__":
    main()
