"""Ring attention: context parallelism with K/V sequence-sharded over a ring.

Counterpart of the JAX package's ``ops/ring_attention.py``. Each rank of the
``context`` group holds S/cp of q, k and v; its k/v block moves one hop
around the ring a step, cp steps in all, so attention memory for K/V is
O(S/cp). Each step runs K9 (``ops/flash_attention.flash_fwd``, which returns
the output and its log-sum-exp) of the local q against the block in hand,
and the partials merge in float32 with the ``-inf``-safe log-sum-exp
combine (plain PyTorch, as the JAX package's ``jnp`` merge). The block's
global positions and segment ids travel with it, so causal, sliding-window,
chunked and packed masks and GQA stay right without ring-specific masking,
as does the load-balanced order of ``flash_attention.load_balanced_reorder``.

A hop is one ``batch_isend_irecv`` (``parallel/comm.exchange``): a send to
rank+1 and a receive from rank-1, started before the step's kernel and
waited for after it, so the transfer overlaps the kernel. The backward
follows the ring schedule: K10 and K11 (``flash_bwd_dq``, ``flash_bwd_dkv``)
with the merged output and log-sum-exp; dq accumulates locally in float32,
dk and dv accumulate in float32 and travel with their block, so that after
cp hops each is back on its home rank.
"""

from __future__ import annotations

import math

import torch

from maxtext_indextts2_tpu_torch.ops.flash_attention import flash_bwd_dkv, flash_bwd_dq, flash_fwd
from maxtext_indextts2_tpu_torch.parallel import comm

_KV_TAG, _GRAD_TAG = 1, 2


def _merge(o_a, lse_a, o_b, lse_b):
    """Combine two normalised flash partials (o float32 [..., D], lse
    [..., 1]); an empty partial (lse -inf, o 0) gets weight 0, so -inf - -inf
    never makes a NaN."""
    lse = torch.logaddexp(lse_a, lse_b)
    w_a = torch.where(torch.isneginf(lse_a), 0.0, torch.exp(lse_a - lse))
    w_b = torch.where(torch.isneginf(lse_b), 0.0, torch.exp(lse_b - lse))
    return o_a * w_a + o_b * w_b, lse


def _hop(tensors, group, tag):
    cp, me = comm.group_size(group), comm.group_rank(group)
    return comm.exchange(tensors, group, (me + 1) % cp, (me - 1) % cp, tag)


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, q_seg, kv_seg, group, causal, sliding_window,
                chunk_size, soft_cap, scale, impl):
        cp = comm.group_size(group)
        args = (causal, sliding_window, chunk_size, soft_cap, scale, impl)
        b, h, sq, d = q.shape
        o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, sq, 1), -math.inf, dtype=torch.float32, device=q.device)
        block = [k, v, kv_pos, kv_seg]
        for step in range(cp):
            hop = _hop(block, group, _KV_TAG) if step < cp - 1 else None
            o_b, lse_b = flash_fwd(q, block[0], block[1], q_pos, block[2], q_seg, block[3], *args)
            o, lse = _merge(o, lse, o_b.float(), lse_b)
            if hop is not None:
                block = hop.wait()
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, q_seg, kv_seg, o, lse)
        ctx.group, ctx.args = group, args
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, kv_pos, q_seg, kv_seg, o, lse = ctx.saved_tensors
        group, args = ctx.group, ctx.args
        cp = comm.group_size(group)
        do = do.contiguous()
        delta = torch.sum(o.float() * do.float(), dim=-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        block = [k, v, kv_pos, kv_seg]
        for step in range(cp):
            hop = _hop(block, group, _KV_TAG) if step < cp - 1 else None
            ids = (q_pos, block[2], q_seg, block[3])
            dq.add_(flash_bwd_dq(q, block[0], block[1], do, lse, delta, *ids, *args).float())
            dk_b, dv_b = flash_bwd_dkv(q, block[0], block[1], do, lse, delta, *ids, *args)
            dk.add_(dk_b.float())
            dv.add_(dv_b.float())
            # dk and dv ride with their block: after cp hops they are home
            dk, dv = _hop([dk, dv], group, _GRAD_TAG).wait()
            if hop is not None:
                block = hop.wait()
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)) + (None,) * 11


def ring_flash_attention(q, k, v, q_pos, kv_pos, q_seg, kv_seg, group, causal=True,
                         sliding_window=0, chunk_size=0, soft_cap=0.0, sm_scale=None,
                         impl: str | None = None):
    """Ring flash attention over this rank's shards: q [B,H,Sq/cp,D], k/v
    [B,Hkv,Skv/cp,D]; positions and segment ids [B, S/cp] hold the GLOBAL
    positions / ids of the local tokens. Returns [B,H,Sq/cp,D] in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else float(sm_scale)
    return _RingFlash.apply(q, k, v, q_pos, kv_pos, q_seg, kv_seg, group, bool(causal),
                            int(sliding_window), int(chunk_size), float(soft_cap), scale, impl)
