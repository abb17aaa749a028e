"""Flash attention for training: K9 (forward), K10 (dq), K11 (dk, dv).

Counterpart of the JAX package's ``ops/flash_attention.py``. One op covers
causal, packed (segment ids), sliding-window and chunked attention with an
optional logit soft cap, because the mask comes from positions and segment
ids element by element: ``q_seg == kv_seg and q_seg != 0``, causal
``kv_pos <= q_pos``, sliding ``kv_pos > q_pos - window``, chunked
``q_pos // chunk == kv_pos // chunk``. Masked logits are
``DEFAULT_MASK_VALUE`` (set after the soft cap); a fully masked row (segment 0
padding) gives o = 0 and lse = -inf.

:func:`flash_attention` is a ``torch.autograd.Function``: its forward
launches K9 and saves ``(q, k, v, o, lse)``; its backward computes
``delta = sum(o * do, -1)`` in plain PyTorch (the JAX package does the same
outside its kernels) and launches K10 and K11. Rounding points, which are
the contract: logits, max, sum and accumulators in float32; K9 rounds its
unnormalised probabilities to v's dtype before the PV product and the output
to q's dtype; K10 rounds ds to k's dtype before ``ds @ k``; K11 is float32
throughout and rounds dk and dv once. The materialised plain versions below
keep the same points; where K9 rounds ``exp(s - m)`` against its running max
and the plain version against the row's max, bfloat16 outputs may differ by
one step.

On a CUDA tensor the hand-written kernels of ``csrc/flash_attention.cuh``
run (or the call raises); they are built for the head dims of ``HEAD_DIMS``
(64, 128 and 256, the flagship's), and any other width raises with that list
(the JAX kernels take any: ROADMAP queues the others), and any GQA group
that divides H (the kernels read the group from H / Hkv at run time; a K11
block walks the whole group). They read q, k and v through their strides, so the
[B, S, N, D] projections of the model need no transposed copy, and they
choose their own tiles (the TPU kernel's VMEM block sizes have no
counterpart here). In bfloat16, K9, K10 and K11 run on the tensor cores and
copy rows 16 bytes at a time: the wrapper raises on an operand whose start or
strides do not allow that (the model's projections do). K11 splits its
float32 p and ds into two bfloat16 terms for its products, so neither is
rounded to bfloat16. The plain versions are taken only for a tensor that lies
on the CPU, or when a test or an on-device comparison asks with
``impl="plain"``.

Layouts follow the JAX package: ``flash_attention`` takes q ``[B, H, Sq, D]``,
k and v ``[B, Hkv, Skv, D]`` (any strides with the last axis contiguous) and
positions / segment ids ``[B, S]`` int32; ``flash_attention_sharded`` is the
model's ``[B, S, N, D]`` entry, on one device or context-parallel over a
mesh (all-gather, ring or Ulysses).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from maxtext_indextts2_tpu_torch.ops.ada_rmsnorm import FLOAT_DTYPES, route, rows_of_16_bytes

DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
HEAD_DIMS = (64, 128, 256)  # head widths the kernels are built for

# launches of each CUDA kernel by this process
launch_counts = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


# ------------------------------------------------------------ plain versions


def _grouped(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, H, S, D] -> [B, Hkv, G, S, D] float32 (q head h reads kv head h // G)."""
    b, h, s, d = q.shape
    return q.float().reshape(b, hkv, h // hkv, s, d)


def _mask(q_pos, kv_pos, q_seg, kv_seg, causal, sliding_window, chunk_size):
    """[B, 1, 1, Sq, Skv] bool: True where a query may attend to a key."""
    qp, kp = q_pos[:, :, None].long(), kv_pos[:, None, :].long()
    qs, ks = q_seg[:, :, None], kv_seg[:, None, :]
    mask = (qs == ks) & (qs != 0)
    if causal:
        mask &= kp <= qp
    if sliding_window > 0:
        mask &= kp > qp - sliding_window
    if chunk_size > 0:
        mask &= torch.div(qp, chunk_size, rounding_mode="floor") == torch.div(
            kp, chunk_size, rounding_mode="floor")
    return mask[:, None, None]


def _logits(q, k, q_pos, kv_pos, q_seg, kv_seg, causal, sliding_window, chunk_size,
            soft_cap, scale):
    """Scaled, capped, masked float32 logits [B, Hkv, G, Sq, Skv], the mask,
    and the soft cap's derivative factor (None without a cap)."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", _grouped(q, k.shape[1]), k.float()) * scale
    dcap = None
    if soft_cap > 0.0:
        th = torch.tanh(s / soft_cap)
        s = soft_cap * th
        dcap = 1.0 - th * th
    mask = _mask(q_pos, kv_pos, q_seg, kv_seg, causal, sliding_window, chunk_size)
    return torch.where(mask, s, DEFAULT_MASK_VALUE), mask, dcap


def _probs(s, mask, lse):
    """exp(s - lse) where visible, else 0; never exp(mask - (-inf))."""
    return torch.exp(torch.where(mask, s - lse[:, :, :, :, None], -math.inf))


def flash_fwd_plain(q, k, v, q_pos, kv_pos, q_seg, kv_seg, causal, sliding_window,
                    chunk_size, soft_cap, scale):
    """Plain PyTorch version of K9: (o [B,H,Sq,D] in q's dtype, lse [B,H,Sq,1] f32)."""
    b, h, sq, d = q.shape
    s, mask, _ = _logits(q, k, q_pos, kv_pos, q_seg, kv_seg, causal, sliding_window,
                         chunk_size, soft_cap, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    none = l == 0.0
    pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    o = (pv / torch.where(none, 1.0, l)).reshape(b, h, sq, v.shape[-1]).to(q.dtype)
    lse = torch.where(none, -math.inf, m + torch.log(torch.where(none, 1.0, l)))
    return o, lse.reshape(b, h, sq, 1)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, q_pos, kv_pos, q_seg, kv_seg, causal,
                       sliding_window, chunk_size, soft_cap, scale):
    """Plain PyTorch version of K10: dq [B,H,Sq,D] in q's dtype. lse, delta
    [B,H,Sq] or [B,H,Sq,1] float32."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    s, mask, dcap = _logits(q, k, q_pos, kv_pos, q_seg, kv_seg, causal, sliding_window,
                            chunk_size, soft_cap, scale)
    p = _probs(s, mask, lse.reshape(b, hkv, h // hkv, sq))
    dp = torch.einsum("bhgqd,bhkd->bhgqk", _grouped(do, hkv), v.float())
    ds = p * (dp - delta.reshape(b, hkv, h // hkv, sq, 1))
    if dcap is not None:
        ds = ds * dcap
    ds = ds * scale
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds.to(k.dtype).float(), k.float())
    return dq.reshape(b, h, sq, d).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, q_pos, kv_pos, q_seg, kv_seg, causal,
                        sliding_window, chunk_size, soft_cap, scale):
    """Plain PyTorch version of K11: (dk, dv) [B,Hkv,Skv,D] in k's and v's
    dtypes, summed over each GQA group, float32 throughout."""
    b, h, sq, _ = q.shape
    hkv = k.shape[1]
    s, mask, dcap = _logits(q, k, q_pos, kv_pos, q_seg, kv_seg, causal, sliding_window,
                            chunk_size, soft_cap, scale)
    p = _probs(s, mask, lse.reshape(b, hkv, h // hkv, sq))
    do_g = _grouped(do, hkv)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, do_g)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", do_g, v.float())
    ds = p * (dp - delta.reshape(b, hkv, h // hkv, sq, 1))
    if dcap is not None:
        ds = ds * dcap
    ds = ds * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, _grouped(q, hkv))
    return dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------- wrappers


def _check(q, k, v, q_pos, kv_pos, q_seg, kv_seg):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: need q [B,H,Sq,D], k and v [B,Hkv,Skv,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % hkv != 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "pair (same B and D, H a multiple of Hkv)")
    if q_pos.shape != (b, sq) or q_seg.shape != (b, sq) or kv_pos.shape != (b, skv) \
            or kv_seg.shape != (b, skv):
        raise ValueError("flash_attention: positions and segment ids must be [B, Sq] / [B, Skv]")
    if q.dtype not in FLOAT_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")


def _kernel_args(q, k, *more):
    """Shape checks of the CUDA route; returns (B, H, Hkv, Sq, Skv, D)."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {d} not in {HEAD_DIMS}")
    if hkv <= 0 or h % hkv:
        raise ValueError(f"flash_attention kernel: {h} query heads do not split into groups "
                         f"over {hkv} kv heads")
    if b > 65535 or h > 65535:
        raise ValueError(f"flash_attention kernel: batch {b} and heads {h} must be <= 65535")
    if any(t.stride(-1) != 1 for t in (q, k, *more)):
        raise ValueError("flash_attention kernel: the last axis of every operand must be "
                         "contiguous")
    if q.dtype == torch.bfloat16 and not all(map(rows_of_16_bytes, (q, k, *more))):
        raise ValueError("flash_attention kernel: bfloat16 rows are copied 16 bytes at a time: "
                         "every operand needs a 16-byte-aligned start and batch, sequence and "
                         "head strides that are multiples of 8 elements")
    return b, h, hkv, sq, skv, d


def _bsn(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, sequence, head) element strides of a [B, N, S, D] tensor."""
    return t.stride(0), t.stride(2), t.stride(1)


def _ids(*tensors):
    return [t.to(torch.int32).contiguous() for t in tensors]


def _empty_bsnd(like: torch.Tensor, shape_bnsd) -> torch.Tensor:
    """An output [B, N, S, D] laid out as [B, S, N, D] in memory (the model's
    layout), returned as the [B, N, S, D] view."""
    b, n, s, d = shape_bnsd
    return torch.empty((b, s, n, d), dtype=like.dtype, device=like.device).transpose(1, 2)


def _lib_and_stream(q):
    from maxtext_indextts2_tpu_torch.ops import _build

    return _build, _build.load_library(), torch.cuda.current_stream(q.device).cuda_stream


def flash_fwd(q, k, v, q_pos, kv_pos, q_seg, kv_seg, causal=True, sliding_window=0,
              chunk_size=0, soft_cap=0.0, scale=None, impl: str | None = None):
    """K9: (o [B,H,Sq,D] in q's dtype, lse [B,H,Sq,1] float32)."""
    _check(q, k, v, q_pos, kv_pos, q_seg, kv_seg)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    args = (causal, sliding_window, chunk_size, soft_cap, scale)
    if route("flash_fwd", impl, q, k, v, q_pos, kv_pos, q_seg, kv_seg) == "plain":
        return flash_fwd_plain(q, k, v, q_pos, kv_pos, q_seg, kv_seg, *args)
    b, h, hkv, sq, skv, d = _kernel_args(q, k, v)
    build, lib, stream = _lib_and_stream(q)
    o = _empty_bsnd(q, (b, h, sq, d))
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    qp, kp, qs, ks = _ids(q_pos, kv_pos, q_seg, kv_seg)
    code = getattr(lib, f"flash_fwd_{_SUFFIX[q.dtype]}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        qp.data_ptr(), kp.data_ptr(), qs.data_ptr(), ks.data_ptr(), b, h, hkv, sq, skv, d,
        *_bsn(q), *_bsn(k), *_bsn(v), *_bsn(o), int(causal), int(sliding_window),
        int(chunk_size), float(soft_cap), float(scale), stream)
    launch_counts["flash_fwd"] += 1
    build.check_launch(code, "flash_fwd")
    return o, lse[..., None]


def flash_bwd_dq(q, k, v, do, lse, delta, q_pos, kv_pos, q_seg, kv_seg, causal=True,
                 sliding_window=0, chunk_size=0, soft_cap=0.0, scale=None,
                 impl: str | None = None):
    """K10: dq [B,H,Sq,D] in q's dtype. lse, delta [B,H,Sq] (or [...,1]) float32."""
    _check(q, k, v, q_pos, kv_pos, q_seg, kv_seg)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    args = (causal, sliding_window, chunk_size, soft_cap, scale)
    if route("flash_bwd_dq", impl, q, k, v, do, lse, delta) == "plain":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, q_pos, kv_pos, q_seg, kv_seg, *args)
    b, h, hkv, sq, skv, d = _kernel_args(q, k, v, do)
    build, lib, stream = _lib_and_stream(q)
    dq = _empty_bsnd(q, (b, h, sq, d))
    lse, delta = (t.reshape(b, h, sq).float().contiguous() for t in (lse, delta))
    qp, kp, qs, ks = _ids(q_pos, kv_pos, q_seg, kv_seg)
    code = getattr(lib, f"flash_bwd_dq_{_SUFFIX[q.dtype]}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), qp.data_ptr(), kp.data_ptr(), qs.data_ptr(),
        ks.data_ptr(), b, h, hkv, sq, skv, d, *_bsn(q), *_bsn(k), *_bsn(v), *_bsn(do),
        *_bsn(dq), int(causal), int(sliding_window), int(chunk_size), float(soft_cap),
        float(scale), stream)
    launch_counts["flash_bwd_dq"] += 1
    build.check_launch(code, "flash_bwd_dq")
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, q_pos, kv_pos, q_seg, kv_seg, causal=True,
                  sliding_window=0, chunk_size=0, soft_cap=0.0, scale=None,
                  impl: str | None = None):
    """K11: (dk, dv) [B,Hkv,Skv,D] in k's and v's dtypes, summed over each
    GQA group in the kernel (no atomics: deterministic)."""
    _check(q, k, v, q_pos, kv_pos, q_seg, kv_seg)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    args = (causal, sliding_window, chunk_size, soft_cap, scale)
    if route("flash_bwd_dkv", impl, q, k, v, do, lse, delta) == "plain":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, q_pos, kv_pos, q_seg, kv_seg,
                                   *args)
    b, h, hkv, sq, skv, d = _kernel_args(q, k, v, do)
    build, lib, stream = _lib_and_stream(q)
    dk = _empty_bsnd(k, (b, hkv, skv, d))
    dv = _empty_bsnd(v, (b, hkv, skv, d))
    lse, delta = (t.reshape(b, h, sq).float().contiguous() for t in (lse, delta))
    qp, kp, qs, ks = _ids(q_pos, kv_pos, q_seg, kv_seg)
    code = getattr(lib, f"flash_bwd_dkv_{_SUFFIX[q.dtype]}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), qp.data_ptr(), kp.data_ptr(),
        qs.data_ptr(), ks.data_ptr(), b, h, hkv, sq, skv, d, *_bsn(q), *_bsn(k), *_bsn(v),
        *_bsn(do), *_bsn(dk), *_bsn(dv), int(causal), int(sliding_window), int(chunk_size),
        float(soft_cap), float(scale), stream)
    launch_counts["flash_bwd_dkv"] += 1
    build.check_launch(code, "flash_bwd_dkv")
    return dk, dv


# ------------------------------------------------------------- public op


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, q_seg, kv_seg, causal, sliding_window,
                chunk_size, soft_cap, scale, impl):
        o, lse = flash_fwd(q, k, v, q_pos, kv_pos, q_seg, kv_seg, causal, sliding_window,
                           chunk_size, soft_cap, scale, impl)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, q_seg, kv_seg, o, lse)
        ctx.args = (causal, sliding_window, chunk_size, soft_cap, scale, impl)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, kv_pos, q_seg, kv_seg, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = torch.sum(o.float() * do.float(), dim=-1)  # [B,H,Sq], outside the kernels
        ids = (q_pos, kv_pos, q_seg, kv_seg)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, *ids, *ctx.args)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, *ids, *ctx.args)
        return (dq, dk, dv) + (None,) * 10


def flash_attention(q, k, v, q_pos, kv_pos, q_seg, kv_seg, causal=True, sliding_window=0,
                    chunk_size=0, soft_cap=0.0, sm_scale=None, impl: str | None = None):
    """Flash attention. q [B,H,Sq,D], k/v [B,Hkv,Skv,D]; pos/seg [B,S] int32.
    Returns [B,H,Sq,D] (a view of [B,Sq,H,D] memory on the CUDA route)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else float(sm_scale)
    return _FlashAttention.apply(q, k, v, q_pos, kv_pos, q_seg, kv_seg, bool(causal),
                                 int(sliding_window), int(chunk_size), float(soft_cap), scale,
                                 impl)


def load_balanced_reorder(x: torch.Tensor, cp: int, axis: int = 1) -> torch.Tensor:
    """Reorder a sequence axis so each of ``cp`` context shards gets one chunk
    from the front and the mirrored chunk from the back: with 2*cp chunks,
    shard i receives chunks (i, 2*cp-1-i)."""
    n = 2 * cp
    chunks = torch.chunk(x, n, dim=axis)
    if len(chunks) != n or x.shape[axis] % n:
        raise ValueError(f"axis {axis} of length {x.shape[axis]} does not split into {n} chunks")
    out = []
    for i in range(cp):
        out += [chunks[i], chunks[n - 1 - i]]
    return torch.cat(out, dim=axis)


def load_balanced_inverse(x: torch.Tensor, cp: int, axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`load_balanced_reorder`."""
    n = 2 * cp
    chunks = torch.chunk(x, n, dim=axis)
    if len(chunks) != n or x.shape[axis] % n:
        raise ValueError(f"axis {axis} of length {x.shape[axis]} does not split into {n} chunks")
    out: list = [None] * n
    for i in range(cp):
        out[i] = chunks[2 * i]
        out[n - 1 - i] = chunks[2 * i + 1]
    return torch.cat(out, dim=axis)


def flash_attention_sharded(q, k, v, segment_ids, mesh=None, positions=None, causal=True,
                            sliding_window=0, chunk_size=0, logits_soft_cap=0.0,
                            algorithm="allgather", impl: str | None = None):
    """The model's ``[B,S,N,D]`` entry: q [B,S,H,D], k/v [B,S,Hkv,D] ->
    [B,S,H,D] (contiguous on the CUDA route: no copy).

    On a ``mesh`` whose ``context`` degree cp is above 1 the tensors are this
    rank's sequence shard (in the load-balanced order the train step gives
    the batch; ``positions`` are global, so masks stay right) and K/V come
    by ``algorithm``:

    - ``"allgather"``: K/V, positions and segment ids all-gathered over
      ``context`` (the gradient of K/V reduce-scattered back), then K9-K11
      on the local q;
    - ``"ring"``: K/V stay sharded and rotate (``ops/ring_attention.py``);
    - ``"ulysses"``: an all-to-all turns sequence shards into head shards
      (every rank the whole sequence for H/cp heads), K9-K11 run there, and
      a second all-to-all turns the output back; heads must divide by cp.

    cp == 1 takes the plain path, as the JAX package does."""
    b, s = q.shape[:2]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=q.device)[None].expand(b, s)
    if segment_ids is None:
        segment_ids = torch.ones((b, s), dtype=torch.int32, device=q.device)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = (causal, sliding_window, chunk_size, logits_soft_cap, None, impl)
    cp = 1 if mesh is None else mesh.shape.get("context", 1)
    if cp == 1:
        o = flash_attention(qh, kh, vh, positions, positions, segment_ids, segment_ids, *mask)
        return o.transpose(1, 2)
    from maxtext_indextts2_tpu_torch.parallel import comm

    group = mesh.group("context")
    if algorithm == "ring":
        from maxtext_indextts2_tpu_torch.ops.ring_attention import ring_flash_attention

        o = ring_flash_attention(qh, kh, vh, positions, positions, segment_ids, segment_ids,
                                 group, *mask)
    elif algorithm == "ulysses":
        if q.shape[2] % cp or k.shape[2] % cp:
            raise ValueError(f"ulysses needs query heads ({q.shape[2]}) and kv heads "
                             f"({k.shape[2]}) divisible by context parallelism ({cp}); use "
                             "context_parallel_algorithm=ring instead")
        q_a, k_a, v_a = (comm.AllToAll.apply(t, group, 1, 2) for t in (qh, kh, vh))
        pos_f = comm.all_gather(positions, group, 1)
        seg_f = comm.all_gather(segment_ids, group, 1)
        o = flash_attention(q_a, k_a, v_a, pos_f, pos_f, seg_f, seg_f, *mask)
        o = comm.AllToAll.apply(o, group, 2, 1)
    elif algorithm == "allgather":
        k_f, v_f = (comm.AllGather.apply(t, group, 2) for t in (kh, vh))
        pos_f = comm.all_gather(positions, group, 1)
        seg_f = comm.all_gather(segment_ids, group, 1)
        o = flash_attention(qh, k_f, v_f, positions, pos_f, segment_ids, seg_f, *mask)
    else:
        raise ValueError(f"unknown context-parallel algorithm: {algorithm!r}")
    return o.transpose(1, 2)
