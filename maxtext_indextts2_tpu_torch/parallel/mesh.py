"""The device mesh on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``. A rank is one process
with one device; the mesh lays the world's ranks out over ``cfg.mesh_axes``
with the ICI x DCN degree of each axis that the config fills (a DCN degree
lies outside the ICI one on its axis, as the JAX package's virtual-device
layout), in row-major order: rank r sits at the coordinates of index r.

:class:`Mesh` keeps ``shape`` (axis -> degree, every axis) as the JAX
``Mesh`` does, a ``torch.distributed.device_mesh.DeviceMesh`` over the axes
whose degree is above 1 (``device_mesh``; None on one rank), and a process
group for every set of those axes (:meth:`Mesh.group`): a dimension that
``parallel/sharding.resolve`` shards over two axes collects over both.

The axes that the port executes are ``data``, ``fsdp``, ``fsdp_transpose``,
``context`` and ``stage`` (the weights gathered, the batch or the sequence
split), and ``tensor``, ``autoregressive``, ``expert`` and
``context_autoregressive``, whose collectives run inside the layers
(``parallel/tensor.py``: heads, MLP width and vocabulary split over
``tensor`` x ``autoregressive``, the experts over ``expert``, the decode
cache's rows over ``context_autoregressive``), and in training ``sequence``
(the sequence split between the layers, attention's K/V all-gathered over
it) and ``tensor_sequence`` (Megatron's sequence parallelism).
``tensor_transpose`` is refused at mesh creation.

:func:`maybe_initialize_distributed` joins the process group that a launcher
describes (``torchrun``'s ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``) or an explicit ``init_method``; with one process it does
nothing. A rank's device is ``cuda:{LOCAL_RANK % device_count}`` unless the
caller asks for the CPU, so that several ranks may share one card: NCCL
carries the collectives where each rank has its own card, gloo (with the
host staging of ``parallel/comm.py``) where they share one, or on the CPU.
"""

from __future__ import annotations

import itertools
import logging
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from maxtext_indextts2_tpu_torch.unported import _unsupported

logger = logging.getLogger(__name__)

EXECUTED_AXES = ("data", "stage", "fsdp", "fsdp_transpose", "context", "sequence", "tensor",
                 "tensor_sequence", "autoregressive", "expert", "context_autoregressive")
REFUSED_AXES_ITEM = "6b, the mesh axes with collectives inside the layers"

_CURRENT: "Mesh | None" = None


class Mesh:
    """Ranks over named axes; ``shape`` holds every axis, ``devices`` the
    ranks in mesh order."""

    def __init__(self, axis_names, degrees, device=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(d) for d in degrees)))
        world = dist.get_world_size() if dist.is_initialized() else 1
        size = math.prod(self.shape.values())
        if size != world:
            raise ValueError(f"mesh {self.shape} has {size} devices, the world {world} ranks")
        self.devices = np.arange(size).reshape(tuple(self.shape.values()))
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        coords = np.unravel_index(self.rank, self.devices.shape)
        self.coords = dict(zip(self.axis_names, (int(c) for c in coords)))
        self.active = tuple(ax for ax in self.axis_names if self.shape[ax] > 1)
        self.device = torch.device(device) if device is not None else None
        self._groups: dict[tuple[str, ...], object] = {}
        self.device_mesh = None
        if self.active:
            from torch.distributed.device_mesh import DeviceMesh

            ranks = self.devices.reshape([self.shape[ax] for ax in self.active])
            dev_type = self.device.type if self.device is not None else "cpu"
            self.device_mesh = DeviceMesh(dev_type, torch.from_numpy(ranks.copy()),
                                          mesh_dim_names=self.active)
            # a group for every set of active axes, made by every rank in the
            # same order (new_group is collective)
            for n in range(1, len(self.active) + 1):
                for axes in itertools.combinations(self.active, n):
                    self._groups[axes] = self._make_group(axes)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axes_size(self, axes) -> int:
        return math.prod(self.shape.get(ax, 1) for ax in _as_tuple(axes))

    def _make_group(self, axes):
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        keep = [self.axis_names.index(ax) for ax in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in keep]
        arr = np.transpose(self.devices, rest + keep).reshape(-1, self.axes_size(axes))
        mine = None
        for row in arr:
            g = dist.new_group([int(r) for r in row])
            if self.rank in row:
                mine = g
        return mine

    def group(self, axes):
        """This rank's process group over ``axes`` (a name or a tuple; axes
        of degree 1 are dropped); None where they hold one rank."""
        axes = tuple(ax for ax in _as_tuple(axes) if self.shape.get(ax, 1) > 1)
        if not axes:
            return None
        key = tuple(ax for ax in self.active if ax in axes)
        return self._groups[key]

    def index(self, axes) -> int:
        """This rank's index in its group over ``axes``: row-major over the
        axes in mesh order (the order of the group's ranks)."""
        idx = 0
        for ax in self.axis_names:
            if ax in _as_tuple(axes):
                idx = idx * self.shape[ax] + self.coords[ax]
        return idx

    def __repr__(self):
        return f"Mesh({mesh_shape_summary(self)}, rank={self.rank})"


def _as_tuple(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def check_executed_axes(cfg) -> None:
    """Refuse a degree above 1 on an axis the port does not execute."""
    for ax in cfg.mesh_axes:
        if ax not in EXECUTED_AXES and (getattr(cfg, f"ici_{ax}_parallelism") > 1
                                        or getattr(cfg, f"dcn_{ax}_parallelism") > 1):
            _unsupported(f"the '{ax}' mesh axis (a degree above 1)", REFUSED_AXES_ITEM)


def create_device_mesh(cfg, device=None) -> Mesh:
    """The mesh of ``cfg``'s degrees over the world's ranks; it becomes the
    current mesh (:func:`current_mesh`), which the model's parallel paths
    read, as the JAX package's modules read the mesh they are given."""
    global _CURRENT
    check_executed_axes(cfg)
    ici, dcn = cfg.ici_parallelism(), cfg.dcn_parallelism()
    mesh = Mesh(cfg.mesh_axes, [ici[ax] * dcn[ax] for ax in cfg.mesh_axes], device=device)
    logger.info("created mesh: %s (%d ranks)", mesh_shape_summary(mesh), mesh.size)
    _CURRENT = mesh
    return mesh


def current_mesh() -> Mesh | None:
    return _CURRENT


def set_current_mesh(mesh: Mesh | None) -> None:
    global _CURRENT
    _CURRENT = mesh


def world_size() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` where given, else ``cuda:{LOCAL_RANK %
    device_count}`` (several ranks may share a card)."""
    if device is not None:
        return torch.device(device)
    from maxtext_indextts2_tpu_torch.infer.engine import resolve_device

    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = resolve_device(None)
    return torch.device("cuda", local % torch.cuda.device_count()) if dev.type == "cuda" \
        else dev


def maybe_initialize_distributed(cfg=None, device=None, init_method: str | None = None,
                                 rank: int | None = None,
                                 world: int | None = None) -> torch.device:
    """Join the process group (no-op for one process); returns this rank's
    device and makes it current. Backend: NCCL where every rank of the host
    has a card of its own, else gloo."""
    world = world if world is not None else int(os.environ.get("WORLD_SIZE", "1"))
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world == 1 or dist.is_initialized():
        return dev
    rank = rank if rank is not None else int(os.environ["RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = "nccl" if dev.type == "cuda" and torch.cuda.device_count() >= local_world \
        else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world)
    logger.info("rank %d of %d on %s (%s)", rank, world, dev, backend)
    return dev


def mesh_shape_summary(mesh: Mesh) -> dict[str, int]:
    return {ax: size for ax, size in mesh.shape.items() if size > 1}
