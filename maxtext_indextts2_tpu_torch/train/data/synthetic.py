"""Synthetic LM batches: the port's own copy of the JAX package's
``train/data/synthetic.py`` (numpy only; a test holds ``make_batch`` equal to
the original's). The iterator yields the same batch forever, as tensors on
the device it is given."""

from __future__ import annotations

import numpy as np
import torch

from maxtext_indextts2_tpu_torch.config import Config


def make_batch(cfg: Config, step: int, batch_size: int | None = None) -> dict:
    """Deterministic synthetic LM batch: random tokens, causal targets."""
    b = batch_size or cfg.global_batch_size_to_load
    s = cfg.max_target_length
    rng = np.random.default_rng(cfg.data_shuffle_seed + step)
    tokens = rng.integers(1, cfg.vocab_size, size=(b, s), dtype=np.int32)
    return {
        "inputs": tokens,
        "inputs_position": np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)),
        "inputs_segmentation": np.ones((b, s), dtype=np.int32),
        "targets": np.roll(tokens, -1, axis=1),
        "targets_segmentation": np.ones((b, s), dtype=np.int32),
    }


class SyntheticDataIterator:
    """Yields the same batch forever (made once, on ``device``)."""

    def __init__(self, cfg: Config, batch_size: int | None = None, *, device):
        self.cfg = cfg
        self._step = 0
        self._batch = {k: torch.from_numpy(np.array(v)).to(device)
                       for k, v in make_batch(cfg, 0, batch_size).items()}

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        self._step += 1
        return self._batch
