"""Multi-rank data loading: each rank's local rows as its piece of the batch.

Counterpart of the JAX package's ``train/data/multihost.py``, where each
process loads its shard and ``jax.make_array_from_process_local_data``
assembles the global array. Here no global array is made: a rank loads the
rows of its piece of the ``activation_batch`` axes (the iterator it wraps is
the rank's own, e.g. built with ``data_shuffle_seed`` offset by its data
index), keeps its piece of the sequence under ``activation_length`` (the
``context`` axis), and yields them as int32 tensors on its device: what
``train/train.train_step`` takes on a mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from maxtext_indextts2_tpu_torch.parallel.sharding import local_piece, resolve


class MultiHostDataLoadIterator:
    def __init__(self, local_iterator, mesh, device,
                 logical_axes=("activation_batch", "activation_length")):
        self.local_iterator = local_iterator
        self.mesh = mesh
        self.device = torch.device(device)
        # the rows are already this rank's: only the sequence is cut here
        self.spec = (None,) + resolve(logical_axes, mesh=mesh)[1:]

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        local = next(self.local_iterator)
        out = {}
        for k, v in local.items():
            t = torch.from_numpy(np.ascontiguousarray(v, dtype=np.int32))
            out[k] = local_piece(t, self.spec[:t.ndim], self.mesh).to(self.device)
        return out
