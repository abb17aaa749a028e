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
``fsdp_transpose``, ``sequence``, ``context`` and ``expert``) before
:meth:`ShardedParams.release` frees the full weights. With
``zero1_fsdp_ag_once`` the train step gathers once a step and
reduce-scatters the gradients summed over its microbatches once.
:data:`stats` counts the gathers and reductions.

Under the splits inside the layers (``parallel/tensor.py``) a parameter's
storage spec and its compute spec differ: the gather runs over the storage
axes the layer does not compute on (``gathered``), so the model's parameter
holds this rank's compute piece (its heads, ``mlp`` columns, vocabulary rows
or experts), and the gradient of that piece goes back over the same axes:
reduce-scattered where they split the batch, cut to this rank's chunk where
every rank of them holds the same gradient (a norm scale stored over
``tensor`` but computed whole). Where a dimension is split for compute and
gathered too, the compute axes must come first in the mesh's order, so that
the gathered chunks make up the compute chunk. A whole weight that the ranks
of a tensor split apply to their own heads (a qk-norm scale) takes the sum of
their gradients (``partial``).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from maxtext_indextts2_tpu_torch.parallel import comm
from maxtext_indextts2_tpu_torch.parallel.sharding import entry_axes, local_piece, param_spec
from maxtext_indextts2_tpu_torch.parallel.tensor import compute_spec, partial_grad_axes, refuse

BATCH_AXES = ("data", "fsdp", "fsdp_transpose", "sequence", "context", "expert")
# the axes over which a weight that none of them splits sums its gradient:
# the batch's, and tensor_sequence, whose ranks hold their own rows of the
# length between the layers
GRAD_AXES = BATCH_AXES + ("tensor_sequence",)

# gathers and reductions made, and the host seconds they took (each waits
# for its transfers)
stats = {"gathers": 0, "reductions": 0, "gather_seconds": 0.0, "reduce_seconds": 0.0}


@dataclasses.dataclass
class ParamShard:
    full_shape: tuple
    spec: tuple  # one resolve entry a dimension: the storage
    unit: bool  # a pipeline unit's: held by one stage rank
    # per dimension, the storage axes gathered before the layer runs (the
    # ones its compute does not split), in mesh order
    gathered: tuple = ()
    # axes over which the gradient is summed besides the batch's (a whole
    # weight applied to a tensor split's heads)
    partial: tuple = ()

    def axes(self) -> set[str]:
        return {ax for entry in self.spec for ax in entry_axes(entry)}


class ShardedParams:
    """The sharding plan of a model's parameters on ``mesh``."""

    def __init__(self, params: dict, mesh, emb_dim: int, unit_names=frozenset()):
        self.mesh = mesh
        self.plan = {}
        for name, p in params.items():
            unit = name in unit_names
            shape = tuple(p.shape)
            spec = param_spec(name, shape, emb_dim, mesh, unit_axis=unit)
            compute = compute_spec(name, shape, emb_dim, mesh)
            gathered = []
            for entry, comp in zip(spec, compute):
                axes, keep = entry_axes(entry), entry_axes(comp)
                rest = tuple(ax for ax in mesh.axis_names if ax in axes and ax not in keep)
                if keep and rest and max(mesh.axis_names.index(a) for a in keep) > \
                        min(mesh.axis_names.index(a) for a in rest):
                    refuse(f"{name}: a dimension split for compute over {keep} and stored "
                           f"over {rest} too")
                gathered.append(rest)
            self.plan[name] = ParamShard(shape, spec, unit, tuple(gathered),
                                         partial_grad_axes(name, mesh))
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

    def _split_dim(self, name: str, whole: bool = False):
        """(dimension, axes) of a parameter gathered along one dimension, None
        for one gathered along none or several. ``whole``: over every storage
        axis (the whole tensor), else over the ``gathered`` ones (the
        compute piece)."""
        dims = [(d, axes) for d, axes in enumerate(self._gather_axes(name, whole)) if axes]
        return dims[0] if len(dims) == 1 else None

    def _gather_axes(self, name: str, whole: bool) -> tuple:
        s = self.plan[name]
        if whole or not s.gathered:
            return tuple(entry_axes(e) for e in s.spec)
        return s.gathered

    @torch.no_grad()
    def gather(self, shards: dict, params: dict) -> None:
        """All-gather every piece into the model's parameter of that name
        (its compute piece)."""
        t0 = time.perf_counter()
        stats["gathers"] += 1
        for name, full in self.gather_all(shards).items():
            params[name].data = full
        stats["gather_seconds"] += time.perf_counter() - t0

    @torch.no_grad()
    def gather_all(self, pieces: dict, whole: bool = False) -> dict:
        """The compute pieces (``whole``: the whole tensors) of ``pieces``:
        one collective for all the pieces gathered over the same axes (each
        piece flat, its split dimension first), so that a step makes a few
        large transfers rather than one a parameter."""
        out, buckets = {}, {}
        for name, t in pieces.items():
            one = self._split_dim(name, whole)
            if one is None:  # no transfer, or gathered along several dimensions
                out[name] = self._gathered(name, t, whole)
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
        """The whole tensor of a stored piece."""
        return self._gathered(name, piece, True)

    def _gathered(self, name: str, piece: torch.Tensor, whole: bool) -> torch.Tensor:
        x = piece
        axes_of = self._gather_axes(name, whole)
        for dim in reversed(range(len(axes_of))):
            if axes_of[dim]:
                x = comm.all_gather(x, self.mesh.group(axes_of[dim]), dim)
        return x

    @staticmethod
    def release(params: dict) -> None:
        for p in params.values():
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    @torch.no_grad()
    def reduce(self, grads: dict) -> dict:
        """Gradients of the compute pieces of this rank's microbatch -> the
        summed gradients of its stored pieces: reduce-scattered over the
        gathered axes that split the batch, cut to this rank's chunk over the
        gathered axes whose ranks hold the same gradient, all-reduced over
        the other batch axes; one collective of each for all the parameters
        split over the same axes, as :meth:`gather`."""
        t0 = time.perf_counter()
        stats["reductions"] += 1
        grads = {name: self._own_chunk(name, g) for name, g in grads.items()}
        out, buckets = {}, {}
        for name, g in grads.items():
            dims = [(d, a) for d, a in enumerate(self._reduce_axes(name)) if a]
            if len(dims) > 1:  # reduce-scattered along several dimensions
                out[name] = self._reduce_one(name, g)
            else:
                key = (dims[0][1] if dims else (), self._summed(name), g.dtype)
                buckets.setdefault(key, []).append((name, dims[0][0] if dims else 0))
        for (axes, rest, _), members in buckets.items():
            group = self.mesh.group(axes)
            n = comm.group_size(group)
            moved = [grads[name].movedim(d, 0) for name, d in members]
            flat = torch.cat([m.reshape(n, -1) for m in moved], dim=1).reshape(-1)
            flat = comm.reduce_scatter(flat, group, 0)
            flat = comm.all_reduce(flat, self.mesh.group(rest))
            off = 0
            for (name, d), m in zip(members, moved):
                k = m.numel() // n
                piece = flat[off:off + k].reshape(m.shape[0] // n, *m.shape[1:])
                out[name] = piece.movedim(0, d).contiguous()
                off += k
        stats["reduce_seconds"] += time.perf_counter() - t0
        return {name: out[name] for name in grads}

    def _reduce_axes(self, name: str) -> tuple:
        """Per dimension, the gathered axes that split the batch: the
        gradient is reduce-scattered over them."""
        return tuple(tuple(ax for ax in axes if ax in GRAD_AXES)
                     for axes in self._gather_axes(name, False))

    def _reduce_one(self, name: str, g: torch.Tensor) -> torch.Tensor:
        s = self.plan[name]
        for dim, axes in enumerate(self._reduce_axes(name)):
            if axes:
                g = comm.reduce_scatter(g, self.mesh.group(axes), dim)
        return comm.all_reduce(g, self.mesh.group(self._summed(name)))

    def _summed(self, name: str) -> tuple:
        """The axes a gradient is all-reduced over: the batch axes that do
        not split the parameter, and its ``partial`` ones."""
        s = self.plan[name]
        return tuple(ax for ax in GRAD_AXES if ax not in s.axes()) + s.partial

    def _own_chunk(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """``g`` cut to this rank's chunk over the gathered axes that do not
        split the batch (every rank of them holds the same gradient); those
        axes then leave the plan's reduction of ``name``."""
        s = self.plan[name]
        if not s.gathered:
            return g
        same = [tuple(ax for ax in axes if ax not in GRAD_AXES) for axes in s.gathered]
        if not any(same):
            return g
        if any(len(a) != len(b) for a, b in zip(same, s.gathered) if a):
            refuse(f"{name}: a dimension gathered over batch and non-batch axes")
        for dim, axes in enumerate(same):
            n = self.mesh.axes_size(axes)
            if n > 1:
                g = g.chunk(n, dim=dim)[self.mesh.index(axes)]
        return g

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
        out = {n: t.detach().to("cpu", copy=True)
               for n, t in self.gather_all(pieces, whole=True).items()}
        group = self.mesh.group("stage")
        if group is not None:
            import torch.distributed as dist

            parts = [None] * comm.group_size(group)
            dist.all_gather_object(parts, {n: t for n, t in out.items()
                                           if self.plan[n].unit}, group=group)
            for part in parts:
                out.update(part)
        return out
