"""The port's collectives over ``torch.distributed``, and their host staging.

Every collective of the parallel paths goes through this module, so that
what crosses between ranks is counted in one place. On a host with one card
a rank the process group is NCCL and tensors go to it as they are. Several
ranks sharing one card cannot use NCCL (2.28 refuses a second rank on the
same device with ``ncclInvalidUsage``), so they run on gloo. Gloo (PyTorch
2.11) takes CUDA tensors for its collectives and copies them through the host
itself, into host memory it allocates for each call; a CUDA tensor handed to
its send or receive aborts the process. So on gloo every CUDA tensor is
copied here into pinned host memory (PyTorch's caching host allocator: a
step's transfers reuse the last step's buffers), the collective or transfer
runs there, and the result is copied back: the compute stays on the card.
Gloo sums on the host's cores, a few ns an element, so on gloo a
reduce-scatter is an all-to-all of the chunks and a sum on the card.
:data:`stats` counts the calls of each collective
(``calls``), the bytes each one carried (``bytes``: what a rank put in) and
the bytes this module staged through the host, both ways (``staged_bytes``).

The autograd Functions below are the differentiable collectives: of the
context-parallel attention, :class:`AllGather` (its backward reduce-scatters)
and :class:`AllToAll` (its backward is the inverse all-to-all); of the
expert dispatch, :class:`AllToAllV` (split sizes; the backward is the reverse
exchange); of the tensor split inside the layers, Megatron's pair
:class:`CopyToGroup` ("f": identity forward, all-reduce backward) and
:class:`ReduceFromGroup` ("g": float32 all-reduce forward, identity
backward), and under sequence parallelism :class:`AllGather` and
:class:`ReduceScatter` along the length in their place.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist


stats = {"staged_bytes": 0, "calls": collections.Counter(), "bytes": collections.Counter()}


def reset_stats() -> None:
    stats["staged_bytes"] = 0
    stats["calls"].clear()
    stats["bytes"].clear()


def _count(op: str, *tensors) -> None:
    stats["calls"][op] += 1
    stats["bytes"][op] += sum(t.numel() * t.element_size() for t in tensors)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    stats["staged_bytes"] += t.numel() * t.element_size()
    return h


def _to_device(h: torch.Tensor, device) -> torch.Tensor:
    stats["staged_bytes"] += h.numel() * h.element_size()
    return h.to(device)


def _run(op: str, t: torch.Tensor, group, fn):
    """``fn(x)`` on ``t`` or on its host copy; returns what ``fn`` returns,
    on ``t``'s device."""
    _count(op, t)
    if not _staged(t, group):
        return fn(t.contiguous())
    return _to_device(fn(_to_host(t)), t.device)


# a staged gloo transfer larger than this goes as concurrent collectives of at
# most this size: gloo on loopback moved 1.6-1.9x the bytes so (PERF.md)
CHUNK_BYTES = 64 << 20


def _chunks(x: torch.Tensor, group) -> int:
    if x.is_cuda or dist.get_backend(group) != "gloo":
        return 1
    return max(1, min(8, x.numel() * x.element_size() // CHUNK_BYTES))


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim``, in group-rank order."""
    n = group_size(group)
    if n == 1:
        return t

    def fn(x):
        out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
        k = _chunks(x, group)
        if k == 1:
            dist.all_gather_into_tensor(out, x, group=group)
            return out
        flat, rows = x.reshape(-1), out.view(n, -1)
        parts = flat.chunk(k)
        outs = [torch.empty(n * p.numel(), dtype=x.dtype, pin_memory=x.is_pinned())
                for p in parts]
        works = [dist.all_gather_into_tensor(o, p, group=group, async_op=True)
                 for o, p in zip(outs, parts)]
        off = 0
        for w, o, p in zip(works, outs, parts):
            w.wait()
            rows[:, off:off + p.numel()] = o.view(n, -1)
            off += p.numel()
        return out

    out = _run("all_gather", t.movedim(dim, 0), group, fn)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum over the group, split along ``dim``: this rank's chunk. On
    gloo the chunks are exchanged by an all-to-all and summed on ``t``'s
    device (in float32): gloo sums on the host's cores at a few ns an
    element, which made its reduce-scatter and all-reduce the slowest part
    of a sharded step (PERF.md)."""
    n = group_size(group)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} does not split into {n}")
    x = t.movedim(dim, 0)
    if dist.get_backend(group) == "gloo":
        got = all_to_all(x, group, 0, 0, op="reduce_scatter")  # chunk j: from rank j
        total = got.reshape(n, x.shape[0] // n, *x.shape[1:]).float().sum(0)
        return total.to(t.dtype).movedim(0, dim)

    def fn(y):
        out = torch.empty((y.shape[0] // n, *y.shape[1:]), dtype=y.dtype, device=y.device)
        dist.reduce_scatter_tensor(out, y, group=group)
        return out

    return _run("reduce_scatter", x, group, fn).movedim(0, dim)


def all_reduce(t: torch.Tensor, group, op: str = "all_reduce") -> torch.Tensor:
    """The sum over the group (a new tensor; ``t`` is left as it was);
    ``op``: the name it is counted under."""
    if group_size(group) == 1:
        return t

    def fn(x):
        x = x.clone() if x is t else x
        works = [dist.all_reduce(p, group=group, async_op=True)
                 for p in x.reshape(-1).chunk(_chunks(x, group))]
        for w in works:
            w.wait()
        return x

    return _run(op, t, group, fn)


def broadcast(t: torch.Tensor, group, src: int) -> torch.Tensor:
    """Group rank ``src``'s tensor on every rank of the group (``t`` gives
    the shape and dtype elsewhere)."""
    if group_size(group) == 1:
        return t

    def fn(x):
        x = x.clone() if x is t else x
        dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
        return x

    return _run("broadcast", t, group, fn)


def all_to_all(t: torch.Tensor, group, split_dim: int, concat_dim: int,
               op: str = "all_to_all") -> torch.Tensor:
    """Split ``split_dim`` into group-size chunks, send chunk j to group rank
    j, and concatenate what arrives along ``concat_dim`` in group-rank order
    (JAX's tiled ``all_to_all``). ``op``: the name it is counted under."""
    n = group_size(group)
    if n == 1:
        return t
    if t.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(t.shape)} does not split "
                         f"into {n}")
    x = t.movedim(split_dim, 0)
    chunk = x.shape[0] // n
    y = all_to_all_v(x, group, [chunk] * n, [chunk] * n, op)
    y = y.reshape(n, chunk, *x.shape[1:])  # chunk j came from rank j
    y = y.movedim(1, split_dim + 1)  # [n, ... split_dim/n at split_dim ...]
    return torch.cat(list(y.unbind(0)), dim=concat_dim)


def all_to_all_v(x: torch.Tensor, group, in_splits, out_splits,
                 op: str = "all_to_all") -> torch.Tensor:
    """Send rows ``[sum(in_splits[:j]), sum(in_splits[:j+1]))`` of ``x``
    (along dim 0) to group rank j and receive ``out_splits[j]`` rows from
    each rank j, concatenated in group-rank order: the all-to-all with split
    sizes (the expert dispatch's), which :func:`all_to_all` takes with equal
    splits."""
    if group_size(group) == 1:
        return x
    in_splits, out_splits = [int(v) for v in in_splits], [int(v) for v in out_splits]
    if sum(in_splits) != x.shape[0]:
        raise ValueError(f"all_to_all: splits {in_splits} of {x.shape[0]} rows")

    def fn(y):
        out = torch.empty((sum(out_splits), *y.shape[1:]), dtype=y.dtype, device=y.device)
        dist.all_to_all_single(out, y, output_split_sizes=out_splits,
                               input_split_sizes=in_splits, group=group)
        return out

    return _run(op, x, group, fn)


class Exchange:
    """A ring hop in flight: :meth:`wait` returns what arrived, on the
    senders' devices."""

    def __init__(self, sends, group, dst: int, src: int, tag: int):
        _count("exchange", *sends)
        gdst, gsrc = dist.get_global_rank(group, dst), dist.get_global_rank(group, src)
        self.devices = [t.device for t in sends]
        self.staged = [_staged(t, group) for t in sends]
        self.outs = [_to_host(t) if s else t.contiguous() for t, s in zip(sends, self.staged)]
        self.recvs = [torch.empty(t.shape, dtype=t.dtype, device=t.device,
                                  pin_memory=s) for t, s in zip(self.outs, self.staged)]
        ops = [dist.P2POp(dist.isend, t, gdst, group, tag) for t in self.outs]
        ops += [dist.P2POp(dist.irecv, r, gsrc, group, tag) for r in self.recvs]
        self.works = dist.batch_isend_irecv(ops)

    def wait(self) -> list[torch.Tensor]:
        for work in self.works:
            work.wait()
        return [_to_device(r, d) if s else r
                for r, d, s in zip(self.recvs, self.devices, self.staged)]


def exchange(sends: list[torch.Tensor], group, dst: int, src: int, tag: int = 0) -> Exchange:
    """Start sending each tensor to group rank ``dst`` and receiving as many
    of the same shapes from group rank ``src``, in one ``batch_isend_irecv``
    (a ring hop); the caller computes meanwhile and then waits."""
    return Exchange(sends, group, dst, src, tag)


class PendingSend:
    """A started send whose buffer stays alive until :meth:`wait`."""

    def __init__(self, work, buffer):
        self.work, self.buffer = work, buffer

    def wait(self):
        self.work.wait()


def isend(t: torch.Tensor, group, dst: int, tag: int = 0) -> PendingSend:
    """Start sending ``t`` to group rank ``dst`` (the pipeline's hops)."""
    _count("send", t)
    buf = _to_host(t) if _staged(t, group) else t.contiguous()
    work = dist.isend(buf, dist.get_global_rank(group, dst), group=group, tag=tag)
    return PendingSend(work, buf)


def recv(like: torch.Tensor, group, src: int, tag: int = 0) -> torch.Tensor:
    """Receive a tensor of ``like``'s shape and dtype from group rank ``src``,
    onto ``like``'s device."""
    stats["calls"]["recv"] += 1
    staged = _staged(like, group)
    buf = torch.empty(like.shape, dtype=like.dtype,
                      pin_memory=staged) if staged else torch.empty_like(like)
    dist.recv(buf, dist.get_global_rank(group, src), group=group, tag=tag)
    return _to_device(buf, like.device) if staged else buf


# ------------------------------------------------------- autograd collectives


class AllGather(torch.autograd.Function):
    """All-gather along ``dim`` forward; the gradient is reduce-scattered
    back (each rank's copy of the gathered tensor feeds its own loss)."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class AllToAll(torch.autograd.Function):
    """:func:`all_to_all` forward, the inverse all-to-all backward."""

    @staticmethod
    def forward(ctx, t, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return all_to_all(t, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return all_to_all(g, ctx.group, concat_dim, split_dim), None, None, None


class AllToAllV(torch.autograd.Function):
    """:func:`all_to_all_v` forward; the backward sends the gradient rows
    back by the reverse exchange."""

    @staticmethod
    def forward(ctx, x, group, in_splits, out_splits):
        ctx.group, ctx.splits = group, (in_splits, out_splits)
        return all_to_all_v(x, group, in_splits, out_splits, "all_to_all_v")

    @staticmethod
    def backward(ctx, g):
        in_splits, out_splits = ctx.splits
        return all_to_all_v(g.contiguous(), ctx.group, out_splits, in_splits,
                            "all_to_all_v"), None, None, None


class AllReduce(torch.autograd.Function):
    """The sum over the group forward and backward: each rank's loss is a
    function of the sum, so a rank's part of it takes the gradients of every
    rank's loss (the global load-balance loss of a split batch)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class CopyToGroup(torch.autograd.Function):
    """Megatron's "f", before a column-parallel product: the identity
    forward; the backward sums the input's gradient over the group (each
    rank's columns contribute a part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group, "tp_grad_all_reduce"), None


class ReduceFromGroup(torch.autograd.Function):
    """Megatron's "g", after a row-parallel product: the partial sums summed
    over the group in float32 and rounded once to ``dtype`` (where the JAX
    dot rounds its float32 ``preferred_element_type``); the backward is the
    identity (every rank holds the whole output's gradient)."""

    @staticmethod
    def forward(ctx, x, group, dtype):
        ctx.dtype_in = x.dtype
        return all_reduce(x.float(), group, "tp_all_reduce").to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype_in), None, None


class ReduceScatter(torch.autograd.Function):
    """The partial sums summed over the group in float32, this rank's chunk
    of ``dim`` kept and rounded once to ``dtype`` (Megatron's "g" under
    sequence parallelism); the backward all-gathers the chunks' gradients."""

    @staticmethod
    def forward(ctx, x, group, dim, dtype):
        ctx.group, ctx.dim, ctx.dtype_in = group, dim, x.dtype
        return reduce_scatter(x.float(), group, dim).to(dtype)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, ctx.dim).to(ctx.dtype_in), None, None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """:class:`CopyToGroup` where the group holds several ranks."""
    return x if group_size(group) == 1 else CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group, dtype: torch.dtype) -> torch.Tensor:
    """:class:`ReduceFromGroup` where the group holds several ranks, else
    ``x`` in ``dtype``."""
    return x.to(dtype) if group_size(group) == 1 else ReduceFromGroup.apply(x, group, dtype)
