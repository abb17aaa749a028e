"""GRPO (Group Relative Policy Optimization).

Counterpart of the JAX package's ``train/grpo.py``. For each prompt G
completions are sampled with the inference engine; rewards are normalised
within each group into advantages; the policy gradient takes the clipped
importance ratio against the sampling pass's log-probabilities, with a KL
penalty against a frozen reference (the k3 estimator).

Generation runs on the port's ``Engine`` (on the card its decode steps are
captured CUDA graphs through the ragged decode attention K1 and the row
update K2, with the sampling noise an input of the graph). Each iteration
the trained weights move into the engine (``Engine.set_params``), gathered
from their pieces where the state is sharded: the counterpart of the JAX
package's ``pathways_reshard``.

Run: ``python -m maxtext_indextts2_tpu_torch.train.grpo <config.yml> key=value ...``
(``device=cpu`` for the CPU).
"""

from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from maxtext_indextts2_tpu_torch.config import Config, load_config
from maxtext_indextts2_tpu_torch.infer.sampling import log_probs_from_logits
from maxtext_indextts2_tpu_torch.models.attention import MODE_TRAIN


def _logps(model, batch: dict, impl=None) -> torch.Tensor:
    logits = model(batch["inputs"], batch["inputs_position"], batch["inputs_segmentation"],
                   mode=MODE_TRAIN, impl=impl)
    return log_probs_from_logits(logits.float(), batch["targets"])


def grpo_loss_fn(model, cfg: Config, ref_model, batch: dict, beta: float = 0.04,
                 epsilon: float = 0.2, impl: str | None = None):
    """batch: inputs / inputs_position / inputs_segmentation / targets
    [B*G, S], ``completion_weights`` [B*G, S], ``advantages`` [B*G] and the
    sampling pass's ``old_logps`` [B*G, S]. (loss, aux)."""
    logps = _logps(model, batch, impl)
    with torch.no_grad():
        ref_logps = _logps(ref_model, batch, impl)
    w = batch["completion_weights"]
    adv = batch["advantages"][:, None]
    ratio = torch.exp(logps - batch["old_logps"])
    pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 1 - epsilon, 1 + epsilon) * adv)
    d = ref_logps - logps  # k3 KL estimator: exp(ref - pi) - (ref - pi) - 1
    kl = torch.exp(d) - d - 1.0
    denom = torch.clamp(torch.sum(w), min=1.0)
    loss = torch.sum((pg + beta * kl) * w) / denom
    with torch.no_grad():
        aux = {"kl": torch.sum(kl * w) / denom, "mean_advantage": torch.mean(batch["advantages"])}
    return loss, aux


def group_advantages(rewards: np.ndarray, group_size: int) -> np.ndarray:
    """[B*G] rewards -> advantages normalised within each prompt's group."""
    r = np.asarray(rewards, np.float32).reshape(-1, group_size)
    mean = r.mean(axis=1, keepdims=True)
    std = r.std(axis=1, keepdims=True)
    return ((r - mean) / (std + np.float32(1e-6))).reshape(-1).astype(np.float32)


def grpo_train_step(cfg: Config, state, ref_model, batch: dict, beta: float = 0.04,
                    epsilon: float = 0.2, impl: str | None = None) -> dict:
    """One update (no clipping, as the JAX package's ``apply_gradients``)."""
    from maxtext_indextts2_tpu_torch.train import train as train_lib

    if state.plan is None:
        loss, aux = grpo_loss_fn(state.model, cfg, ref_model, batch, beta, epsilon, impl)
        grads = dict(zip(state.params, train_lib._grads(loss, list(state.params.values()))))
        return train_lib.apply_gradients(cfg, state, grads, {"loss": loss.detach(), **aux},
                                          clip=False)
    aux = {}

    def loss_of(i, mb):
        loss, a = grpo_loss_fn(state.model, cfg, ref_model, mb, beta, epsilon, impl)
        aux.update(a)
        return loss, torch.clamp(torch.sum(mb["completion_weights"]), min=1.0)

    loss, grads = train_lib.sharded_grads(
        cfg, state, [batch], loss_of, lambda mb: torch.clamp(torch.sum(mb["completion_weights"]),
                                                             min=1.0))
    return train_lib.apply_gradients(cfg, state, grads, {"loss": loss, **aux}, clip=False)


def generate_completions(engine, prompts: list[np.ndarray], group_size: int,
                         max_new_tokens: int) -> list[list[list[int]]]:
    """G sampled completions a prompt through the engine."""
    return [[engine.generate_stream(prompt, max_new_tokens) for _ in range(group_size)]
            for prompt in prompts]


def build_grpo_batch(prompts: list[np.ndarray], completions: list[list[list[int]]],
                     rewards: np.ndarray, max_len: int) -> dict:
    """[B*G, S] training rows (numpy) from the prompts and their completions;
    the loss covers the completion tokens only."""
    rows = {k: [] for k in ("inputs", "targets", "inputs_position", "inputs_segmentation",
                            "completion_weights")}
    for prompt, group in zip(prompts, completions):
        for comp in group:
            seq = np.concatenate([prompt, np.asarray(comp, np.int32)])[:max_len + 1]
            inputs = np.zeros(max_len, np.int32)
            targets = np.zeros(max_len, np.int32)
            n = len(seq) - 1
            inputs[:n] = seq[:-1]
            targets[:n] = seq[1:]
            seg = np.zeros(max_len, np.int32)
            seg[:n] = 1
            w = np.zeros(max_len, np.float32)
            w[len(prompt) - 1:n] = 1.0
            rows["inputs"].append(inputs)
            rows["targets"].append(targets)
            rows["inputs_position"].append(np.arange(max_len, dtype=np.int32))
            rows["inputs_segmentation"].append(seg)
            rows["completion_weights"].append(w)
    batch = {k: np.stack(v) for k, v in rows.items()}
    batch["advantages"] = group_advantages(rewards.reshape(-1), len(completions[0]))
    return batch


def policy_to_engine(state, engine) -> None:
    """The trained weights into the engine's parameters (gathered from their
    pieces on a mesh): the JAX package's ``pathways_reshard``."""
    from maxtext_indextts2_tpu_torch.train.train import gathered_state

    params = state.params if state.plan is None else gathered_state(state).params
    engine.set_params({n: t.detach() for n, t in params.items()})


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def grpo_train_loop(cfg: Config, reward_fn: Callable[[list[int]], float],
                    num_iterations: int = 4, group_size: int = 4,
                    prompts: list[np.ndarray] | None = None, infer_cfg: Config | None = None,
                    max_new_tokens: int = 8, device=None, engine=None):
    """Sample -> reward -> advantage -> update, ``num_iterations`` times.
    ``infer_cfg``: the engine's own config (same model, its own serving
    settings). Returns (state, the last step's metrics)."""
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.train.dpo import frozen_copy
    from maxtext_indextts2_tpu_torch.train.train import setup_train_state, world_mesh

    mesh, device = world_mesh(cfg, device)
    state = setup_train_state(cfg, device, mesh=mesh)
    ref = frozen_copy(cfg, state)
    engine = engine or Engine(infer_cfg or cfg, device=state.device)
    if prompts is None:
        prompts = [np.arange(1, 6, dtype=np.int32)]
    metrics = {}
    for _ in range(num_iterations):
        policy_to_engine(state, engine)
        completions = generate_completions(engine, prompts, group_size, max_new_tokens)
        rewards = np.asarray([[reward_fn(c) for c in g] for g in completions], np.float32)
        batch = to_device(build_grpo_batch(prompts, completions, rewards,
                                           cfg.max_target_length), state.device)
        with torch.no_grad():  # the sampling pass's log-probabilities
            if state.plan is not None:
                state.plan.gather(state.shards, state.params)
            batch["old_logps"] = _logps(state.model, batch)
            if state.plan is not None:
                state.plan.release(state.params)
        metrics = grpo_train_step(cfg, state, ref, batch)
    return state, {k: float(v) for k, v in metrics.items()}


def main(argv=None):
    """CLI demo: GRPO against a length-preference reward."""
    import sys

    from maxtext_indextts2_tpu_torch.infer.server import split_device_arg

    argv, device = split_device_arg(list(sys.argv[1:] if argv is None else argv))
    cfg = load_config(argv)

    def reward_fn(completion: list[int]) -> float:
        return float(len([t for t in completion if t != 0]))

    _, metrics = grpo_train_loop(cfg, reward_fn, device=device)
    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
