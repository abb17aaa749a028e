"""Direct Preference Optimization.

Counterpart of the JAX package's ``train/dpo.py``. A batch carries chosen and
rejected token rows; the loss is

    -log sigmoid(beta * ((pi_c - ref_c) - (pi_r - ref_r)))

over per-sequence log-probabilities summed over the target tokens, with the
reference a frozen copy of the initial policy (its own ``Transformer``, no
gradient). The step updates as the JAX package's ``state.apply_gradients``
(no clipping). On a mesh of several ranks the policy state is sharded as in
``train/train.py`` and each rank's rows count with their share of the batch.

Run: ``python -m maxtext_indextts2_tpu_torch.train.dpo <config.yml> key=value ...``
on the GPU (``device=cpu`` for the CPU; ``torchrun`` for several ranks).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from maxtext_indextts2_tpu_torch.config import Config, load_config
from maxtext_indextts2_tpu_torch.infer.sampling import log_probs_from_logits
from maxtext_indextts2_tpu_torch.models import Transformer
from maxtext_indextts2_tpu_torch.models.attention import MODE_TRAIN


def _seq_logprob(model, tokens, positions, segs, targets, weights, impl=None):
    logits = model(tokens, positions, segs, mode=MODE_TRAIN, impl=impl)
    lp = log_probs_from_logits(logits.float(), targets)
    return torch.sum(lp * weights, dim=-1)  # [B]


def dpo_loss_fn(model, cfg: Config, ref_model, batch: dict, beta: float = 0.1,
                impl: str | None = None):
    """batch keys: ``{chosen,rejected}_{inputs,targets,position,segmentation}``
    and ``..._targets_segmentation``. (mean loss over rows, aux)."""
    def lp(m, side):
        w = (batch[f"{side}_targets_segmentation"] != 0).to(torch.float32)
        return _seq_logprob(m, batch[f"{side}_inputs"], batch[f"{side}_position"],
                            batch[f"{side}_segmentation"], batch[f"{side}_targets"], w, impl)

    pi_c, pi_r = lp(model, "chosen"), lp(model, "rejected")
    with torch.no_grad():
        ref_c, ref_r = lp(ref_model, "chosen"), lp(ref_model, "rejected")
    logits = beta * ((pi_c - ref_c) - (pi_r - ref_r))
    loss = -torch.mean(F.logsigmoid(logits))
    with torch.no_grad():
        aux = {"dpo_accuracy": torch.mean((pi_c - ref_c > pi_r - ref_r).to(torch.float32)),
               "chosen_reward": torch.mean(beta * (pi_c - ref_c)),
               "rejected_reward": torch.mean(beta * (pi_r - ref_r))}
    return loss, aux


def frozen_copy(cfg: Config, state) -> Transformer:
    """The reference model: the policy's weights now, gathered where the
    state is sharded, with no gradient."""
    from maxtext_indextts2_tpu_torch.train.train import gathered_state

    params = state.params if state.plan is None else gathered_state(state).params
    ref = Transformer(cfg, device=state.device)
    ref.load_state_dict({n: t.detach().clone() for n, t in params.items()}, strict=True)
    for p in ref.parameters():
        p.requires_grad_(False)
    return ref


def dpo_train_step(cfg: Config, state, ref_model, batch: dict, beta: float = 0.1,
                   impl: str | None = None) -> dict:
    from maxtext_indextts2_tpu_torch.train import train as train_lib

    if state.plan is None:
        loss, aux = dpo_loss_fn(state.model, cfg, ref_model, batch, beta, impl)
        grads = dict(zip(state.params, train_lib._grads(loss, list(state.params.values()))))
        return train_lib.apply_gradients(cfg, state, grads, {"loss": loss.detach(), **aux},
                                          clip=False)
    aux = {}

    def loss_of(i, mb):
        loss, a = dpo_loss_fn(state.model, cfg, ref_model, mb, beta, impl)
        aux.update(a)
        return loss, _rows(mb)

    loss, grads = train_lib.sharded_grads(cfg, state, [batch], loss_of, _rows)
    aux = {k: state.plan.batch_sum(v * _rows(batch)) / state.plan.batch_sum(_rows(batch))
           for k, v in aux.items()}
    return train_lib.apply_gradients(cfg, state, grads, {"loss": loss, **aux}, clip=False)


def _rows(mb: dict) -> torch.Tensor:
    t = mb["chosen_inputs"]
    return torch.tensor(float(t.shape[0]), device=t.device)


class DPODataIterator:
    """Paired preference batches (numpy) from a source of (chosen_ids,
    rejected_ids) token lists; by default the JAX package's synthetic pairs
    (a shared prompt, chosen completions from the low half of the vocabulary,
    rejected from the high half)."""

    def __init__(self, cfg: Config, source=None):
        self.cfg = cfg
        self.source = source or self._synthetic()

    def _synthetic(self):
        rng = np.random.default_rng(self.cfg.data_shuffle_seed)
        s, v = self.cfg.max_target_length, self.cfg.vocab_size
        while True:
            base = rng.integers(1, v, size=s // 2).tolist()
            n = s - len(base)
            yield (base + rng.integers(1, max(v // 2, 2), size=n).tolist(),
                   base + rng.integers(v // 2, v, size=n).tolist())

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        cfg = self.cfg
        b, s = cfg.global_batch_size_to_load, cfg.max_target_length
        batch = {}
        rows = [next(self.source) for _ in range(b)]
        for side, idx in (("chosen", 0), ("rejected", 1)):
            toks = np.zeros((b, s), np.int32)
            for i, pair in enumerate(rows):
                ids = list(pair[idx])[:s]
                toks[i, :len(ids)] = ids
            batch[f"{side}_inputs"] = toks
            batch[f"{side}_targets"] = np.roll(toks, -1, axis=1)
            batch[f"{side}_position"] = np.broadcast_to(np.arange(s, dtype=np.int32),
                                                        (b, s)).copy()
            seg = (toks != 0).astype(np.int32)
            batch[f"{side}_segmentation"] = seg
            batch[f"{side}_targets_segmentation"] = np.roll(seg, -1, axis=1)
        return batch


def batch_piece(batch: dict, mesh, device) -> dict:
    """This rank's rows of a numpy batch, as int32 tensors on ``device``."""
    from maxtext_indextts2_tpu_torch.parallel.sharding import shard

    return {k: shard(torch.from_numpy(np.ascontiguousarray(v, dtype=np.int32)),
                     "activation_batch", mesh=mesh).to(device) for k, v in batch.items()}


def train_dpo(cfg: Config, device=None, quiet: bool = False) -> dict:
    """The DPO loop: the frozen reference is the initial policy. Returns the
    last step's metrics and, under ``history``, every step's."""
    from maxtext_indextts2_tpu_torch.train.train import setup_train_state, world_mesh

    mesh, device = world_mesh(cfg, device)
    state = setup_train_state(cfg, device, mesh=mesh)
    ref = frozen_copy(cfg, state)
    it = DPODataIterator(cfg)
    history = []
    for step in range(cfg.steps):
        batch = batch_piece(next(it), state.mesh, state.device)
        history.append({k: float(v) for k, v in dpo_train_step(cfg, state, ref, batch).items()})
        if not quiet and (step % 10 == 0 or step == cfg.steps - 1):
            print(f"dpo step {step}: " + " ".join(f"{k}={v:.4f}" for k, v in history[-1].items()))
    return {**(history[-1] if history else {}), "history": history}


def main(argv=None):
    import sys

    from maxtext_indextts2_tpu_torch.infer.server import split_device_arg

    argv, device = split_device_arg(list(sys.argv[1:] if argv is None else argv))
    return train_dpo(load_config(argv), device)


if __name__ == "__main__":
    main()
