"""Training runtime: train state, train / eval step, train loop, CLI.

Counterpart of the JAX package's ``train/train.py`` on one device: the
model's forward in ``MODE_TRAIN`` (flash attention K9-K11 and the remat
policy of ``models/decoder.py``), masked cross-entropy with z-loss, the
gradients by autograd, in-step gradient accumulation over microbatches,
global-norm clipping with the scale cast to each leaf's dtype, and the
optimizer of ``train/optimizers.py`` in optax's order. The parameters and
the optimizer's moments are updated in place.

Run: ``python -m maxtext_indextts2_tpu_torch.train.train <config.yml> key=value ...``
on the GPU; ``device=cpu`` asks for the CPU explicitly. Only
``dataset_type=synthetic`` runs here: the other data iterators, checkpoints,
MTP and MoE auxiliary losses and the Zero-1 all-gather raise, naming their
ROADMAP queue item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from maxtext_indextts2_tpu_torch.config import Config, load_config
from maxtext_indextts2_tpu_torch.infer.engine import resolve_device
from maxtext_indextts2_tpu_torch.models import Transformer
from maxtext_indextts2_tpu_torch.models.attention import MODE_TRAIN
from maxtext_indextts2_tpu_torch.models.decoder import _remat_policy
from maxtext_indextts2_tpu_torch.unported import _unsupported
from maxtext_indextts2_tpu_torch.ops import losses
from maxtext_indextts2_tpu_torch.train.data.synthetic import SyntheticDataIterator
from maxtext_indextts2_tpu_torch.train.optimizers import (
    GradientTransformation,
    apply_updates,
    create_learning_rate_schedule,
    get_optimizer,
)
from maxtext_indextts2_tpu_torch.utils import flops as flops_lib
from maxtext_indextts2_tpu_torch.utils.metrics import MetricLogger

_REST = "4b, rest of training"


@dataclasses.dataclass
class TrainState:
    """Parameters (the model's own, ``requires_grad``), optimizer state and
    the number of steps taken."""

    step: int
    model: Transformer
    params: dict[str, torch.Tensor]
    opt_state: dict
    tx: GradientTransformation

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device


def check_training_config(cfg: Config) -> None:
    """Raise on what this slice of the port does not train (before any
    weight is made); an unknown remat policy raises too."""
    if cfg.mtp_num_layers > 0:
        _unsupported("the multi-token-prediction auxiliary loss", "6, other model families")
    if cfg.num_experts > 1:
        _unsupported("the MoE load-balance auxiliary loss", "6, other model families")
    if cfg.zero1_fsdp_ag_once:
        _unsupported("zero1_fsdp_ag_once (a sharded all-gather)",
                     "6, parallelism on torch.distributed")
    if cfg.enable_checkpointing:
        _unsupported("training checkpoints", f"{_REST}: checkpointing")
    if cfg.enable_dropout and cfg.dropout_rate > 0:
        _unsupported("dropout in training", _REST)
    _remat_policy(cfg.remat_policy)


def setup_train_state(cfg: Config, device=None, params: dict | None = None) -> TrainState:
    """The model with seeded weights (``init_weights_seed``) or ``params``
    (a state dict, e.g. from ``utils/param_bridge.params_from_jax``), made
    trainable, and a fresh optimizer state."""
    check_training_config(cfg)
    device = resolve_device(device)
    model = Transformer(cfg, device=device)
    if params is None:
        model.init_params(cfg.init_weights_seed)
    else:
        model.load_state_dict(params, strict=True)
    for p in model.parameters():
        p.requires_grad_(True)
    named = dict(model.named_parameters())
    tx = get_optimizer(cfg, create_learning_rate_schedule(cfg))
    with torch.no_grad():
        opt_state = tx.init(named)
    return TrainState(step=0, model=model, params=named, opt_state=opt_state, tx=tx)


def loss_fn(model: Transformer, cfg: Config, batch: dict, is_train: bool = True,
            impl: str | None = None):
    """(mean loss over valid tokens, aux) for one batch."""
    if is_train and cfg.fused_vocab_ce_chunk > 0:
        if cfg.fused_ce_int8:
            losses.chunked_unembed_cross_entropy_int8()
        losses.chunked_unembed_cross_entropy()
    if is_train and cfg.fused_vocab_ce_tile > 0:
        losses.streaming_unembed_cross_entropy()
    logits = model(batch["inputs"], batch["inputs_position"], batch["inputs_segmentation"],
                   mode=MODE_TRAIN, impl=impl)
    weights = (batch["targets_segmentation"] != 0).to(torch.float32)
    loss, total_weights = losses.masked_cross_entropy(logits, batch["targets"], weights,
                                                      cfg.z_loss_weight)
    return loss, {"ce_loss": loss, "total_weights": total_weights}


def _global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def _clip_by_global_norm(grads: dict, max_norm: float):
    """The float32 scale cast to each leaf's dtype: bfloat16 grads stay bfloat16."""
    norm = _global_norm(grads.values())
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


def train_step(cfg: Config, state: TrainState, batch: dict, impl: str | None = None) -> dict:
    """One optimizer step (with in-step gradient accumulation over
    ``gradient_accumulation_steps`` microbatches); updates ``state`` in place
    and returns the step's metrics as 0-d tensors."""
    names = list(state.params)
    leaves = [state.params[n] for n in names]
    micro = cfg.gradient_accumulation_steps
    if micro > 1:
        grads = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=state.device)
        for i in range(micro):
            mb = {k: v.reshape(micro, v.shape[0] // micro, *v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, _ = loss_fn(state.model, cfg, mb, impl=impl)
            g = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
                loss_sum = loss_sum + loss.detach()
        with torch.no_grad():
            grads = {n: g / torch.tensor(micro, dtype=g.dtype) for n, g in zip(names, grads)}
            loss = loss_sum / micro
        aux = {"ce_loss": loss}
    else:
        loss, aux = loss_fn(state.model, cfg, batch, impl=impl)
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        loss = loss.detach()
        aux = {k: v.detach() for k, v in aux.items() if k != "total_weights"}

    with torch.no_grad():
        if cfg.gradient_clipping_threshold > 0:
            grads, grad_norm = _clip_by_global_norm(grads, cfg.gradient_clipping_threshold)
        else:
            grad_norm = _global_norm(grads.values())
        updates, state.opt_state = state.tx.update(grads, state.opt_state, state.params)
        del grads
        apply_updates(state.params, updates)
        del updates
        state.step += 1
        return {"loss": loss, "grad_norm": grad_norm,
                "param_norm": _global_norm(state.params.values()), **aux}


def eval_step(cfg: Config, state: TrainState, batch: dict) -> dict:
    with torch.no_grad():
        loss, aux = loss_fn(state.model, cfg, batch, is_train=False)
    return {"eval_loss": loss, "eval_total_weights": aux["total_weights"]}


def create_data_iterator(cfg: Config, device):
    if cfg.colocated_python_data_input:
        _unsupported("colocated-python data input", "6, parallelism on torch.distributed")
    if cfg.dataset_type == "synthetic":
        return SyntheticDataIterator(cfg, device=device)
    if cfg.dataset_type in ("emilia_audio", "hf", "grain", "tfds", "c4_mlperf"):
        _unsupported(f"the dataset_type={cfg.dataset_type} data iterator",
                     f"{_REST}: data iterators, item 4b.3")
    raise ValueError(f"unknown dataset_type: {cfg.dataset_type}")


def _take(batch: dict, n: int) -> dict:
    """The first ``n`` rows (the load / train remainder dropped)."""
    return {k: v[:n] for k, v in batch.items()}


def run_eval(cfg: Config, state: TrainState, num_batches: int | None = None) -> dict:
    """Average eval loss over ``eval_steps`` synthetic batches."""
    n = num_batches or (cfg.eval_steps if cfg.eval_steps > 0 else 4)
    if cfg.dataset_type == "emilia_audio":
        _unsupported("the emilia_audio eval iterator", f"{_REST}: data iterators, item 4b.3")
    eval_iter = SyntheticDataIterator(cfg, cfg.global_batch_size_to_eval_on, device=state.device)
    total, weight = 0.0, 0.0
    for _ in range(n):
        m = eval_step(cfg, state, _take(next(eval_iter), cfg.global_batch_size_to_eval_on))
        total += float(m["eval_loss"]) * float(m["eval_total_weights"])
        weight += float(m["eval_total_weights"])
    return {"eval_loss": total / max(weight, 1e-9), "eval_weight": weight}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_loop(cfg: Config, device=None, quiet: bool = False) -> dict[str, Any]:
    """Runs ``cfg.steps`` steps; returns the last step's metrics (floats) and,
    under ``history``, every step's logged scalars."""
    state = setup_train_state(cfg, device)
    data_iter = create_data_iterator(cfg, state.device)
    logger = MetricLogger(cfg, quiet=quiet)
    step_tflops = flops_lib.training_tflops_per_step(cfg)
    tokens = cfg.global_batch_size_to_train_on * cfg.max_target_length
    history, metrics = [], {}
    try:
        _sync(state.device)
        last = time.perf_counter()
        for step in range(state.step, cfg.steps):
            batch = _take(next(data_iter), cfg.global_batch_size_to_train_on)
            metrics = train_step(cfg, state, batch)
            _sync(state.device)
            now = time.perf_counter()
            history.append(logger.write_step(step, metrics, step_time=now - last,
                                             tflops_per_step=step_tflops,
                                             tokens_per_step=tokens))
            last = now
            if cfg.eval_interval > 0 and (step + 1) % cfg.eval_interval == 0:
                eval_metrics = run_eval(cfg, state)
                logger.write_step(step, eval_metrics, step_time=0.0)
                target = cfg.target_eval_loss
                if target > 0 and eval_metrics["eval_loss"] <= target:
                    if not quiet:
                        print(f"target_eval_loss {target} reached at step {step}; stopping")
                    break
                last = time.perf_counter()
    finally:
        logger.close()
    out = {k: float(v) for k, v in metrics.items()}
    out["history"] = history
    return out


def main(argv=None):
    import sys

    from maxtext_indextts2_tpu_torch.infer.server import split_device_arg

    argv = list(sys.argv[1:] if argv is None else argv)
    argv, device = split_device_arg(argv)
    cfg = load_config(argv)
    metrics = train_loop(cfg, device=device)
    print({k: v for k, v in metrics.items() if k != "history"})
    return metrics


if __name__ == "__main__":
    main()
