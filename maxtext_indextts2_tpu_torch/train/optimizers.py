"""Optimizers and the learning-rate schedule, in optax's order of operations.

Counterpart of the JAX package's ``train/optimizers.py`` (``optax.adamw``,
``adam_pax``, ``optax.sgd``; linear warmup then cosine decay). Written as
plain tensor code over a state dict of parameters ``{name: tensor}``:

- ``init(params)`` -> state; ``update(grads, state, params)`` -> (updates,
  new state); :func:`apply_updates` adds the updates to the parameters in
  place (``p + u`` rounded to p's dtype, as ``optax.apply_updates``).
- The schedule is read at the count BEFORE the update: with warmup, step 0
  has learning rate 0.
- adamw: moments in the parameter's dtype; bias correction divides the
  moments; ``wd * p`` is added to the corrected update (every leaf decays, no
  mask) and the sum is scaled by ``-lr`` cast to the leaf's dtype.
- adam_pax: bias correction folded into the decay rates (computed in float32,
  then cast), ``eps_root`` inside the square root, weight decay before the
  learning rate; its ``-lr`` stays float32, so a bfloat16 leaf gets a float32
  update that ``apply_updates`` rounds once.
- Python scalars meet a leaf as a value of the leaf's dtype (JAX's weak
  typing): in bfloat16 ``0.1 * g`` multiplies by bfloat16(0.1), not by a
  float32 0.1.

The moments are updated in place (the JAX package returns new arrays): one
copy of each moment lives on the device. LoRA-only training
(``lora_rank > 0`` with ``lora_only_training``) is :func:`lora_only`: the JAX
package's ``optax.multi_transform`` of the optimizer over the ``lora_*``
weights and ``optax.set_to_zero`` over every other one.
"""

from __future__ import annotations

import math
from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from maxtext_indextts2_tpu_torch.config import Config

Schedule = Callable[[int], float]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def create_learning_rate_schedule(cfg: Config) -> Schedule:
    """Linear warmup from 0 -> cosine decay to ``final_fraction * peak``,
    then constant; float32 arithmetic as optax's ``join_schedules``."""
    total = cfg.learning_rate_schedule_steps
    warmup = max(1, int(cfg.warmup_steps_fraction * total))
    decay = max(1, total - warmup)
    peak = cfg.learning_rate
    alpha = cfg.cosine_learning_rate_final_fraction
    f32 = np.float32

    def linear(count: int) -> np.float32:
        c = min(max(count, 0), warmup)
        frac = f32(1) - f32(c) / f32(warmup)
        return f32(0.0 - peak) * frac + f32(peak)

    def cosine(count: int) -> np.float32:
        c = f32(min(count, decay))
        cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay)))
        return f32(peak) * (f32(1 - alpha) * cos + f32(alpha))

    def schedule(count: int) -> float:
        count = int(count)
        return float(linear(count) if count < warmup else cosine(count - warmup))

    return schedule


class _Scalars:
    """Python constants as 0-d tensors of a leaf's dtype (cached per dtype)."""

    def __init__(self, **values):
        self.values = values
        self.cache: dict = {}

    def __call__(self, name: str, like: torch.Tensor) -> torch.Tensor:
        key = (name, like.dtype)
        if key not in self.cache:
            self.cache[key] = torch.tensor(self.values[name], dtype=like.dtype)
        return self.cache[key]


def _zeros(params):
    return {n: torch.zeros_like(p) for n, p in params.items()}


def adamw(schedule: Schedule, b1: float, b2: float, eps: float,
          weight_decay: float) -> GradientTransformation:
    """``optax.adamw(schedule, b1, b2, eps, weight_decay=...)``."""
    c = _Scalars(one_minus_b1=1 - b1, b1=b1, one_minus_b2=1 - b2, b2=b2, eps=eps,
                 eps_root=0.0, wd=weight_decay)

    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(grads, state, params):
        count = state["count"]
        count_inc = count + 1
        lr = schedule(count)
        updates = {}
        for n, g in grads.items():
            mu, nu, p = state["mu"][n], state["nu"][n], params[n]
            mu.mul_(c("b1", g)).add_(c("one_minus_b1", g) * g)
            nu.mul_(c("b2", g)).add_(c("one_minus_b2", g) * (g * g))
            # 1 - decay**count in float32, then in the moment's dtype
            bc1 = torch.tensor(1 - np.float32(b1) ** np.float32(count_inc), dtype=mu.dtype)
            bc2 = torch.tensor(1 - np.float32(b2) ** np.float32(count_inc), dtype=nu.dtype)
            u = (mu / bc1) / (torch.sqrt(nu / bc2 + c("eps_root", nu)) + c("eps", nu))
            u = u + c("wd", p) * p
            updates[n] = torch.tensor(-lr, dtype=u.dtype) * u
        state["count"] = count_inc
        return updates, state

    return GradientTransformation(init, update)


def adam_pax(schedule: Schedule, b1: float, b2: float, eps: float, eps_root: float,
             weight_decay: float) -> GradientTransformation:
    """The JAX package's Pax-style Adam: bias correction folded into the
    decay rates, eps_root inside the sqrt, weight decay before the rate."""
    c = _Scalars(one=1.0, eps=eps, eps_root=eps_root, wd=weight_decay)

    def corrected(beta: float, t: np.float32) -> np.float32:
        beta = np.float32(beta)
        return beta * (np.float32(1) - beta ** (t - np.float32(1))) / (np.float32(1) - beta ** t)

    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(grads, state, params):
        count = state["count"]
        t = np.float32(count) + np.float32(1)
        step = np.float32(-1.0) * np.float32(schedule(count))
        updates = {}
        for n, g in grads.items():
            mu, nu, p = state["mu"][n], state["nu"][n], params[n]
            c1 = torch.tensor(corrected(b1, t), dtype=g.dtype)
            c2 = torch.tensor(corrected(b2, t), dtype=g.dtype)
            mu.mul_(c1).add_((c("one", g) - c1) * g)
            nu.mul_(c2).add_((c("one", g) - c2) * torch.square(g))
            u = mu / (torch.sqrt(nu + c("eps_root", nu)) + c("eps", nu))
            if weight_decay > 0:
                u = u + c("wd", p) * p
            updates[n] = torch.tensor(step, dtype=torch.float32) * u.float()
        state["count"] = count + 1
        return updates, state

    return GradientTransformation(init, update)


def sgd(schedule: Schedule) -> GradientTransformation:
    """``optax.sgd(schedule)``: no momentum; the update is ``-lr * g`` in g's dtype."""

    def init(params):
        return {"count": 0}

    def update(grads, state, params=None):
        lr = schedule(state["count"])
        updates = {n: torch.tensor(-lr, dtype=g.dtype) * g for n, g in grads.items()}
        state["count"] = state["count"] + 1
        return updates, state

    return GradientTransformation(init, update)


def is_lora(name: str) -> bool:
    """A LoRA adapter's weight (``...lora_a`` / ``...lora_b``)."""
    return "lora_" in name


def lora_only(tx: GradientTransformation) -> GradientTransformation:
    """``tx`` over the LoRA weights only; every other weight is hard-frozen
    (no update, no moments), as ``optax.multi_transform({"train": tx,
    "freeze": optax.set_to_zero()}, labels)``."""

    def trainable(tree: dict) -> dict:
        return {n: v for n, v in tree.items() if is_lora(n)}

    def init(params):
        return tx.init(trainable(params))

    def update(grads, state, params):
        return tx.update(trainable(grads), state, trainable(params))

    return GradientTransformation(init, update)


def get_optimizer(cfg: Config, schedule: Schedule) -> GradientTransformation:
    if cfg.opt_type == "adamw":
        tx = adamw(schedule, cfg.adam_b1, cfg.adam_b2, cfg.adam_eps, cfg.adam_weight_decay)
    elif cfg.opt_type == "adam_pax":
        tx = adam_pax(schedule, cfg.adam_b1, cfg.adam_b2, cfg.adam_eps, cfg.adam_eps_root,
                      cfg.adam_weight_decay)
    elif cfg.opt_type == "sgd":
        tx = sgd(schedule)
    else:
        raise ValueError(f"unknown opt_type: {cfg.opt_type}")
    if cfg.lora_rank > 0 and cfg.lora_only_training:
        tx = lora_only(tx)
    return tx


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> None:
    """``p <- (p + u)`` rounded to p's dtype, in place."""
    for n, u in updates.items():
        p = params[n]
        if u.dtype == p.dtype:
            p.add_(u)
        else:
            p.copy_((p.to(u.dtype) + u).to(p.dtype))
