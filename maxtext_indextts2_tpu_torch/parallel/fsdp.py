"""Sharded training state: FSDP and Zero-1 over the port's mesh.

Each parameter is split over the mesh axes that ``parallel/sharding.param_spec``
gives its logical names (``embed`` over ``fsdp``, ``fsdp_transpose`` and
``context``; ``mlp`` over ``fsdp_transpose``; a dimension that does not divide
stays whole). A rank keeps its pieces (``shards``), and the AdamW moments are
made over those pieces only, so a rank holds 1/n of both. A pipeline unit's
parameters live on their ``stage`` rank alone.

One FSDP unit is the whole model: :meth:`ShardedParams.gather` all-gathers
every piece into the model's parameters before a microbatch (one transfer
for all the pieces split over the same axes), and
:meth:`ShardedParams.reduce` reduce-scatters the full gradients back to the
pieces (summed over the ranks of the batch axes: ``data``, ``fsdp``,
``fsdp_transpose`` and ``context``) before :meth:`ShardedParams.release` frees
the full weights. With ``zero1_fsdp_ag_once`` the train step gathers once a
step and reduce-scatters the gradients summed over its microbatches once.
:data:`stats` counts the gathers and reductions.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from maxtext_indextts2_tpu_torch.parallel import comm
from maxtext_indextts2_tpu_torch.parallel.sharding import entry_axes, local_piece, param_spec

BATCH_AXES = ("data", "fsdp", "fsdp_transpose", "context")

# gathers and reductions made, and the host seconds they took (each waits
# for its transfers)
stats = {"gathers": 0, "reductions": 0, "gather_seconds": 0.0, "reduce_seconds": 0.0}


@dataclasses.dataclass
class ParamShard:
    full_shape: tuple
    spec: tuple  # one resolve entry a dimension
    unit: bool  # a pipeline unit's: held by one stage rank

    def axes(self) -> set[str]:
        return {ax for entry in self.spec for ax in entry_axes(entry)}


class ShardedParams:
    """The sharding plan of a model's parameters on ``mesh``."""

    def __init__(self, params: dict, mesh, emb_dim: int, unit_names=frozenset()):
        self.mesh = mesh
        self.plan = {}
        for name, p in params.items():
            unit = name in unit_names
            self.plan[name] = ParamShard(tuple(p.shape), param_spec(
                name, tuple(p.shape), emb_dim, mesh, unit_axis=unit), unit)
        self.batch_group = mesh.group(BATCH_AXES)
        self.world_group = mesh.group(mesh.active) if mesh.active else None

    # -------------------------------------------------------------- layout

    def copies(self, name: str) -> int:
        """On how many ranks each element of ``name``'s piece lies."""
        s = self.plan[name]
        held = self.mesh.axes_size(tuple(s.axes()))
        if s.unit:
            held *= self.mesh.shape.get("stage", 1)
        return self.mesh.size // held

    def specs_with_bytes(self, params: dict) -> dict:
        """name -> (bytes of the whole parameter, its spec): the input of
        ``sharding.assert_params_sufficiently_sharded`` (a unit's ``stage``
        counts as a split)."""
        out = {}
        for name, s in self.plan.items():
            nbytes = params[name].element_size()
            for n in s.full_shape:
                nbytes *= n
            out[name] = (nbytes, s.spec + (("stage",) if s.unit else ()))
        return out

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the whole tensor ``full``."""
        return local_piece(full, self.plan[name].spec, self.mesh)

    # ------------------------------------------------------- the state

    @torch.no_grad()
    def shard_(self, params: dict) -> dict:
        """This rank's pieces (new tensors) of the model's full ``params``;
        the full weights are released."""
        shards = {n: self.local(n, p.detach()).clone() for n, p in params.items()}
        self.release(params)
        return shards

    def _split_dim(self, name: str):
        """(dimension, axes) of a parameter split along one dimension, None
        for one that is whole or split along several."""
        dims = [(d, entry_axes(e)) for d, e in enumerate(self.plan[name].spec) if e is not None]
        return dims[0] if len(dims) == 1 else None

    @torch.no_grad()
    def gather(self, shards: dict, params: dict) -> None:
        """All-gather every piece into the model's parameter of that name."""
        t0 = time.perf_counter()
        stats["gathers"] += 1
        for name, full in self.gather_all(shards).items():
            params[name].data = full
        stats["gather_seconds"] += time.perf_counter() - t0

    @torch.no_grad()
    def gather_all(self, pieces: dict) -> dict:
        """The whole tensors of ``pieces``: one collective for all the pieces
        split over the same axes (each piece flat, its split dimension
        first), so that a step makes a few large transfers rather than one a
        parameter."""
        out, buckets = {}, {}
        for name, t in pieces.items():
            one = self._split_dim(name)
            if one is None:  # whole (no transfer), or split along several dimensions
                out[name] = self.full(name, t)
            else:
                buckets.setdefault((one[1], t.dtype), []).append((name, one[0]))
        for (axes, _), members in buckets.items():
            group = self.mesh.group(axes)
            n = comm.group_size(group)
            moved = [pieces[name].movedim(d, 0) for name, d in members]
            flat = torch.cat([m.reshape(-1) for m in moved])
            rows = comm.all_gather(flat, group, 0).view(n, -1)
            off = 0
            for (name, d), m in zip(members, moved):
                part = rows[:, off:off + m.numel()].reshape(n * m.shape[0], *m.shape[1:])
                out[name] = part.movedim(0, d).contiguous()
                off += m.numel()
        return {name: out[name] for name in pieces}

    def full(self, name: str, piece: torch.Tensor) -> torch.Tensor:
        x = piece
        for dim in reversed(range(len(self.plan[name].spec))):
            axes = entry_axes(self.plan[name].spec[dim])
            if axes:
                x = comm.all_gather(x, self.mesh.group(axes), dim)
        return x

    @staticmethod
    def release(params: dict) -> None:
        for p in params.values():
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    @torch.no_grad()
    def reduce(self, grads: dict) -> dict:
        """Full gradients of this rank's microbatch -> the summed gradients
        of its pieces: reduce-scattered over the axes that split each
        parameter, all-reduced over the other batch axes; one collective of
        each for all the parameters split over the same axes, as
        :meth:`gather`."""
        t0 = time.perf_counter()
        stats["reductions"] += 1
        out, buckets = {}, {}
        for name, g in grads.items():
            one = self._split_dim(name)
            if one is None and self.plan[name].axes():  # several split dimensions
                out[name] = self._reduce_one(name, g)
            else:
                key = (one[1] if one else (), g.dtype)
                buckets.setdefault(key, []).append((name, one[0] if one else 0))
        for (axes, _), members in buckets.items():
            group = self.mesh.group(axes)
            n = comm.group_size(group)
            moved = [grads[name].movedim(d, 0) for name, d in members]
            flat = torch.cat([m.reshape(n, -1) for m in moved], dim=1).reshape(-1)
            flat = comm.reduce_scatter(flat, group, 0)
            flat = comm.all_reduce(flat, self.mesh.group(
                tuple(ax for ax in BATCH_AXES if ax not in axes)))
            off = 0
            for (name, d), m in zip(members, moved):
                k = m.numel() // n
                piece = flat[off:off + k].reshape(m.shape[0] // n, *m.shape[1:])
                out[name] = piece.movedim(0, d).contiguous()
                off += k
        stats["reduce_seconds"] += time.perf_counter() - t0
        return {name: out[name] for name in grads}

    def _reduce_one(self, name: str, g: torch.Tensor) -> torch.Tensor:
        s = self.plan[name]
        for dim, entry in enumerate(s.spec):
            axes = entry_axes(entry)
            if axes:
                g = comm.reduce_scatter(g, self.mesh.group(axes), dim)
        rest = tuple(ax for ax in BATCH_AXES if ax not in s.axes())
        return comm.all_reduce(g, self.mesh.group(rest))

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks that split the batch."""
        return comm.all_reduce(t, self.batch_group)

    def global_norm(self, pieces: dict) -> torch.Tensor:
        """The global norm of the whole tensors whose pieces are ``pieces``."""
        dev = next(iter(pieces.values())).device
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        for name, t in pieces.items():
            sq = sq + torch.sum(torch.square(t.float())) / self.copies(name)
        return torch.sqrt(comm.all_reduce(sq, self.world_group))

    def full_state_dict(self, pieces: dict) -> dict:
        """The one-rank state dict of ``pieces`` (same names; copies on the
        CPU), gathered on every rank; pipeline units come from their stage
        rank."""
        out = {n: t.detach().to("cpu", copy=True) for n, t in self.gather_all(pieces).items()}
        group = self.mesh.group("stage")
        if group is not None:
            import torch.distributed as dist

            parts = [None] * comm.group_size(group)
            dist.all_gather_object(parts, {n: t for n, t in out.items()
                                           if self.plan[n].unit}, group=group)
            for part in parts:
                out.update(part)
        return out
