"""Elastic training: snapshot -> recover -> resume, with a resize.

Counterpart of the JAX package's ``train/elastic.py``: periodic host-RAM
snapshots of the train state, a supervised step loop that catches a failed
step, and a recovery that rebuilds the world over the ranks still alive.
On ``torch.distributed`` a recovery destroys the process group and, where
more than one rank survives, forms a new one over them (``init_method``
gives each generation's rendezvous); the survivors re-derive the degrees
and the batch with :func:`resize_config` (the global batch follows
``per_device_batch_size``, as the JAX package's), reshard the snapshot onto
the new mesh and continue from the snapshot's step. A rank that is no longer
in the world returns. On unrecoverable failure the snapshot's parameters are
written to local disk (:func:`_emergency_checkpoint`).

``failure_injector(step)`` may raise to inject a failure (every rank at the
same step); ``devices_fn()`` gives the ranks alive (global ranks of the
first generation), by default every one.
"""

from __future__ import annotations

import dataclasses
import logging
from collections.abc import Callable

import torch
import torch.distributed as dist

from maxtext_indextts2_tpu_torch.config import Config, finalize

logger = logging.getLogger(__name__)


class Snapshot:
    """Host-RAM copy of the train state: the one-rank view (full parameters
    and moments, gathered on every rank of a mesh)."""

    def __init__(self):
        self.step: int | None = None
        self.view = None

    @torch.no_grad()
    def save(self, step: int, state):
        import types

        from maxtext_indextts2_tpu_torch.train.train import gathered_state

        if state.plan is not None:
            self.view = gathered_state(state)
        else:  # into the host buffers of the last snapshot where there is one
            old = self.view

            def copy(src: dict, dst: dict | None) -> dict:
                if dst is None or set(dst) != set(src):
                    return {n: t.detach().to("cpu", copy=True) for n, t in src.items()}
                for n, t in src.items():
                    dst[n].copy_(t)
                return dst

            opt = {k: (copy(v, None if old is None else old.opt_state.get(k))
                       if isinstance(v, dict) else v) for k, v in state.opt_state.items()}
            params = copy(state.params, None if old is None else old.params)
            self.view = types.SimpleNamespace(params=params, opt_state=opt, step=state.step)
        self.step = step

    @torch.no_grad()
    def restore_onto(self, state):
        """Copy the snapshot into ``state`` (on any mesh) in place."""
        from maxtext_indextts2_tpu_torch.train.train import load_gathered_state

        if state.plan is not None:
            load_gathered_state(state, self.view)
            return state
        for n, p in state.params.items():
            p.copy_(self.view.params[n])
        for key in ("mu", "nu"):
            if key in state.opt_state:
                for n, t in state.opt_state[key].items():
                    t.copy_(self.view.opt_state[key][n])
        if "count" in state.opt_state:
            state.opt_state["count"] = self.view.opt_state["count"]
        state.step = self.view.step
        return state


def resize_config(cfg: Config, num_devices: int, resize_axis: str = "fsdp") -> Config:
    """The config re-derived for ``num_devices`` ranks: ``resize_axis``
    absorbs the change, and the batch sizes follow ``per_device_batch_size``."""
    if num_devices == cfg.num_devices:
        return cfg
    new = dataclasses.replace(cfg)
    setattr(new, f"ici_{resize_axis}_parallelism", -1)
    return finalize(new, num_devices)


def _rejoin(alive: list[int], first_rank: int, generation: int, init_method, backend: str):
    """Leave the old process group; join the survivors' new one where more
    than one survives. Returns False when this rank is not among them."""
    if dist.is_initialized():
        dist.destroy_process_group()
    if first_rank not in alive:
        return False
    if len(alive) > 1:
        if init_method is None:
            raise RuntimeError("a recovery over several survivors needs init_method "
                               "(each generation's rendezvous)")
        dist.init_process_group(backend, init_method=init_method(generation),
                                rank=alive.index(first_rank), world_size=len(alive))
    return True


def elastic_train_loop(cfg: Config, snapshot_period: int = 5,
                       failure_injector: Callable[[int], None] | None = None,
                       max_recoveries: int = 3, devices_fn: Callable[[], list] | None = None,
                       resize_axis: str = "fsdp", device=None,
                       init_method: Callable[[int], str] | None = None) -> dict:
    """Train with snapshot recovery (and a resize when ``devices_fn`` reports
    another set of ranks after a failure). Returns the last step's metrics,
    the recoveries, the final step, world size and global batch; a rank that
    left the world returns ``{"left_at": step}``."""
    from maxtext_indextts2_tpu_torch.parallel.mesh import create_device_mesh, set_current_mesh
    from maxtext_indextts2_tpu_torch.train.train import (
        create_data_iterator,
        local_batch,
        setup_train_state,
        train_step,
    )

    first_rank = dist.get_rank() if dist.is_initialized() else 0
    world0 = dist.get_world_size() if dist.is_initialized() else 1
    backend = dist.get_backend() if dist.is_initialized() else "gloo"
    snapshot = Snapshot()
    recoveries = 0

    def build_world(n: int):
        wcfg = resize_config(cfg, n, resize_axis)
        mesh = create_device_mesh(wcfg, device) if n > 1 else None
        set_current_mesh(mesh)
        state = setup_train_state(wcfg, device, mesh=mesh)
        return wcfg, state, create_data_iterator(wcfg, state.device)

    alive = list(devices_fn()) if devices_fn is not None else list(range(world0))
    wcfg, state, data_iter = build_world(len(alive))
    step, metrics = 0, {}
    while step < cfg.steps:
        try:
            if step % snapshot_period == 0:
                snapshot.save(step, state)
            if failure_injector is not None:
                failure_injector(step)
            batch = next(data_iter)
            batch = {k: v[:wcfg.global_batch_size_to_train_on] for k, v in batch.items()}
            metrics = train_step(wcfg, state, local_batch(wcfg, batch, state.mesh))
            step += 1
        except Exception as e:  # noqa: BLE001 - recovery is the point; re-raised past the limit
            recoveries += 1
            logger.warning("step %d failed (%s); recovery %d", step, e, recoveries)
            if recoveries > max_recoveries:
                _emergency_checkpoint(cfg, snapshot, first_rank)
                raise
            alive = list(devices_fn()) if devices_fn is not None else alive
            if world0 > 1 and not _rejoin(alive, first_rank, recoveries, init_method, backend):
                return {"left_at": step, "recoveries": recoveries}
            wcfg, state, data_iter = build_world(len(alive))
            if snapshot.step is not None:
                snapshot.restore_onto(state)
                step = snapshot.step
    out = {k: float(v) for k, v in metrics.items()}
    out.update(recoveries=recoveries, final_step=step, final_num_devices=wcfg.num_devices,
               final_global_batch=wcfg.global_batch_size_to_train_on)
    return out


def _emergency_checkpoint(cfg: Config, snapshot: Snapshot, rank: int = 0):
    """Write the last snapshot's parameters to local disk (rank 0)."""
    if snapshot.view is None or rank != 0:
        return
    import os

    from maxtext_indextts2_tpu_torch.train.checkpointing import save_params_only

    path = os.path.join(cfg.base_output_directory, cfg.run_name, "emergency")
    save_params_only(path, snapshot.view.params)
    logger.warning("emergency checkpoint written to %s (step %s)", path, snapshot.step)
