"""Mixture-of-Experts: routed experts with dropless dispatch.

Counterpart of the JAX package's ``models/moe.py`` (``RoutedMoE``), with its
parameter names:

- ``gate``: the float32 router (a ``DenseGeneral`` of E outputs, input and
  product in float32); softmax or sigmoid scores; ``gate_bias`` (DeepSeek-V3
  ``routed_bias``) added for the selection only; group-limited routing
  (``n_routing_groups`` / ``topk_routing_group``); top-k, the combine weights
  taken from the unbiased scores, ``normalize_topk_weights`` and
  ``routed_scaling_factor``; the Switch-style load-balance loss, returned
  beside the output (a training forward's; ``train.loss_fn`` adds it);
- ``wi_0`` / ``wi_1`` ``[E, emb, mlp]`` and ``wo`` ``[E, mlp, emb]``: the
  experts, direct parameters (``int8w_serve``: int8, with float32
  ``*_scale`` ``[E, 1, out]``, one scale an (expert, output channel));
- ``shared_experts``: an always-on gated MLP of ``mlp * shared_experts``
  (float kernels under every quantization, as in the JAX package);
- ``moe_weight_on_input`` (llama4): the routing weight scales each expert's
  INPUT, not its output.

Two routes compute the experts, chosen as the JAX package chooses them (it
takes the sparse one only on its accelerator): the SPARSE route on a CUDA
tensor with ``sparse_matmul`` (the default), the DENSE einsum route on the
CPU or with ``sparse_matmul=false``. The dense route runs every expert on
every token and masks with the combine weights (E / k times the products).
The sparse route sorts the (token, slot) pairs by expert (a stable sort),
gathers the rows, builds the per-expert offsets on the device
(``scatter_add_`` of ones into an ``[E]`` count, then ``cumsum``: no
``bincount``, ``nonzero`` or host read, so a captured decode step holds it),
runs the three grouped products of ``ops/grouped_matmul`` (bf16, or the int8
kernels on int8 experts with the activations row-quantized as the JAX
package's ``q_rows``) with the activation between them, applies the routing
weight and adds each token's k rows back in float32 in the order of their
sorted positions (the order of the JAX package's scatter-add), by a gather
rather than an atomic scatter, so that two runs give the same bits.

On a mesh (``parallel/tensor.py``): under a tensor split (``tp``) each
expert's ``mlp`` width is split like ``MlpBlock``'s (``wi_*`` columns, ``wo``
rows: golden ``moe_ep4_tp2.json``), the experts' input and the routing
weights pass ``comm.CopyToGroup`` and the combined float32 partial output is summed over
the group once (``comm.ReduceFromGroup``); the shared experts are a split
``MlpBlock``. Under an expert split (``ep``) a rank holds ``num_experts / n``
experts and the sparse route runs on every device, the CPU included: the
sorted rows go to their experts' ranks by a variable-split all-to-all
(``comm.AllToAllV``, after an exchange of the per-rank counts), each rank runs
its experts through the grouped products (the hand-written kernels on the
card, forward and backward) over the rows it received sorted by local
expert, and a second all-to-all brings the rows home, in this rank's sorted
order, before the float32 combine. A training forward's rows are this rank's
piece of the batch; a serving engine's rows are the same on every rank
(``rows_replicated``), so each rank dispatches its chunk of them and the
outputs are all-gathered. On a mesh that splits the batch (``batch_group``)
the load-balance loss is that of the global batch: the token counts and the
score sums are summed over the batch ranks (``comm.AllReduce``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from maxtext_indextts2_tpu_torch.config import Config
from maxtext_indextts2_tpu_torch.models.layers import (
    ACTIVATIONS,
    DenseGeneral,
    MlpBlock,
    _truncated_normal_,
    to_dtype,
)
from maxtext_indextts2_tpu_torch.ops.grouped_matmul import grouped_matmul, grouped_matmul_int8


def q_rows(v: torch.Tensor):
    """The JAX package's per-row int8 codes of the sparse int8 route:
    ``sc = max(amax, 1e-9) / 127``, ``round(v / sc)`` (divisions by tensors,
    so that the GPU does not multiply by a rounded reciprocal). Returns
    (int8 codes, float32 scales ``[rows, 1]``)."""
    v32 = v.float()
    amax = torch.amax(torch.abs(v32), dim=-1, keepdim=True)
    sc = torch.clamp(amax, min=1e-9) / torch.full_like(amax, 127.0)
    return torch.round(v32 / sc).to(torch.int8), sc


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``one_hot(idx, n)`` by a comparison: ``F.one_hot`` reads its input's
    range back to the host on the CPU."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


class RoutedMoE(nn.Module):
    """Routed experts (+ shared experts) of one MoE sub-layer. ``forward``
    returns (output ``[B, S, emb]`` in ``dtype``, the load-balance loss)."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        self.cfg = cfg
        e, m, n_exp = cfg.emb_dim, cfg.moe_mlp_dim, cfg.num_experts
        self.dtype = to_dtype(cfg.dtype)
        wdt = to_dtype(cfg.weight_dtype)
        self.gate = DenseGeneral(e, n_exp, dtype=torch.float32, weight_dtype=wdt, device=device)
        self.gate_bias = (nn.Parameter(torch.zeros((n_exp,), dtype=torch.float32, device=device),
                                       requires_grad=False)
                          if cfg.routed_bias else None)
        self.int8_experts = cfg.quantization == "int8w_serve"
        edt = torch.int8 if self.int8_experts else wdt
        shapes = {"wi_0": (n_exp, e, m), "wi_1": (n_exp, e, m), "wo": (n_exp, m, e)}
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.empty(shape, dtype=edt, device=device),
                                             requires_grad=False))
            if self.int8_experts:
                setattr(self, f"{name}_scale", nn.Parameter(
                    torch.ones((shape[0], 1, shape[2]), dtype=torch.float32, device=device),
                    requires_grad=False))
        self.shared_experts = (
            MlpBlock(e, m * cfg.shared_experts, cfg.mlp_activations, dtype=self.dtype,
                     weight_dtype=wdt, device=device)
            if cfg.shared_experts > 0 else None)
        # parallel/tensor.split_model: the tensor and expert splits, the
        # group over which a training batch is split, and whether the rows
        # are the same on every rank (a serving engine)
        self.tp = self.ep = self.batch_group = None
        self.rows_replicated = False

    def reset_parameters(self, generator=None):
        """Variance-scaling truncated normal over each expert's fan-in (the
        JAX package's init); int8 experts are filled from a float checkpoint."""
        for name in ("wi_0", "wi_1", "wo"):
            w = getattr(self, name)
            if self.int8_experts:
                w.zero_()
                getattr(self, f"{name}_scale").fill_(1.0)
            else:
                _truncated_normal_(w, math.sqrt(1.0 / w.shape[1]), generator)
        if self.gate_bias is not None:
            self.gate_bias.zero_()

    # ------------------------------------------------------------- routing
    def route(self, inputs: torch.Tensor, top_idx: torch.Tensor | None = None):
        """(top_idx [B, S, k] int64, top_w [B, S, k] in dtype, scores [B, S, E]
        float32). ``top_idx``: where given, the selection taken instead of the
        scores' top-k (a comparison of two routes pins one routing), the
        weights still gathered from these scores. No gradient passes through
        the selection, as in the JAX package."""
        cfg = self.cfg
        logits = self.gate(inputs.float())
        if cfg.routed_score_func == "sigmoid":
            scores = torch.sigmoid(logits)
        else:
            scores = torch.softmax(logits, dim=-1)
        if top_idx is None:
            select = scores
            if self.gate_bias is not None:
                # aux-loss-free balancing bias: the selection only
                select = scores + self.gate_bias.float()
            if cfg.n_routing_groups > 0:
                select = self._group_limited(select)
            _, top_idx = torch.topk(select, cfg.num_experts_per_tok, dim=-1)
        top_w = torch.gather(scores, -1, top_idx)
        if cfg.normalize_topk_weights:
            top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
        top_w = top_w * cfg.routed_scaling_factor
        return top_idx, top_w.to(self.dtype), scores

    def _group_limited(self, scores: torch.Tensor) -> torch.Tensor:
        """Keep only the experts of the ``topk_routing_group`` groups whose two
        best scores sum highest."""
        cfg = self.cfg
        g, kg = cfg.n_routing_groups, cfg.topk_routing_group
        b, s, n = scores.shape
        grouped = scores.reshape(b, s, g, n // g)
        group_score = torch.topk(grouped, 2, dim=-1).values.sum(-1)
        top_groups = torch.topk(group_score, kg, dim=-1).indices
        group_mask = torch.zeros_like(group_score).scatter_(-1, top_groups, 1.0)
        mask = group_mask.repeat_interleave(n // g, dim=-1)
        return torch.where(mask > 0, scores, torch.full_like(scores, -math.inf))

    def load_balance_loss(self, top_idx, scores) -> torch.Tensor:
        """Switch / GShard style: E * sum(tokens share x mean score) / k."""
        n_exp, k = self.cfg.num_experts, self.cfg.num_experts_per_tok
        one_hot = _one_hot(top_idx, n_exp, torch.float32)  # [B, S, k, E]
        if self.batch_group is None:
            tokens_per_expert = one_hot.sum(2).mean((0, 1))
            prob_per_expert = scores.mean((0, 1))
        else:  # over the global batch
            from maxtext_indextts2_tpu_torch.parallel import comm

            count = torch.full((1,), float(one_hot.shape[0] * one_hot.shape[1]),
                               device=scores.device)
            sums = comm.AllReduce.apply(torch.cat([one_hot.sum(2).sum((0, 1)),
                                                   scores.sum((0, 1)), count]),
                                        self.batch_group)
            tokens_per_expert, prob_per_expert = sums[:n_exp] / sums[-1], \
                sums[n_exp:2 * n_exp] / sums[-1]
        return n_exp * torch.sum(tokens_per_expert * prob_per_expert) / k

    # ------------------------------------------------------------- experts
    def _float_experts(self):
        """(wi_0, wi_1, wo) as float weights: int8 experts dequantized in
        float32 (the JAX package's dense route of int8 experts)."""
        if not self.int8_experts:
            return self.wi_0, self.wi_1, self.wo
        return tuple(getattr(self, n).float() * getattr(self, f"{n}_scale")
                     for n in ("wi_0", "wi_1", "wo"))

    def _act(self, h0, h1):
        acts = self.cfg.mlp_activations
        h = ACTIVATIONS[acts[0]](h0)
        return h * h1 if len(acts) > 1 else h

    def dense_experts(self, x, top_idx, top_w, wi_0, wi_1, wo):
        """Every expert on every token, masked by the combine weights."""
        dt = self.dtype
        x = x.to(dt)
        combine = (_one_hot(top_idx, self.cfg.num_experts, dt)
                   * top_w[..., None]).sum(2)  # [B, S, E]
        w0, w1, w2 = wi_0.to(dt), wi_1.to(dt), wo.to(dt)
        if self.cfg.moe_weight_on_input:
            xw = x[:, :, None, :] * combine[..., None]  # [B, S, X, E]
            h0 = torch.einsum("bsxe,xem->bsxm", xw, w0)
            h1 = torch.einsum("bsxe,xem->bsxm", xw, w1)
            o = torch.einsum("bsxm,xme->bsxe", self._act(h0, h1), w2)
            mask = (combine != 0).to(dt)
            return torch.einsum("bsxe,bsx->bse", o, mask)
        h0 = torch.einsum("bse,xem->bsxm", x, w0)
        h1 = torch.einsum("bse,xem->bsxm", x, w1)
        o = torch.einsum("bsxm,xme->bsxe", self._act(h0, h1), w2)
        return torch.einsum("bsxe,bsx->bse", o, combine)

    def sparse_experts(self, x, top_idx, top_w, wi_0, wi_1, wo, scales=None,
                       impl: str | None = None, out_dtype=None):
        """Dropless dispatch through the grouped products (``scales``: the
        int8 experts' ``(wi_0_scale, wi_1_scale, wo_scale)``); the float32
        combine is cast to ``out_dtype`` (default ``dtype``). Under an expert
        split the experts are this rank's (:meth:`_expert_parallel`)."""
        cfg = self.cfg
        dt = self.dtype
        b, s, e = x.shape
        k, n_exp = cfg.num_experts_per_tok, cfg.num_experts
        t = b * s
        x_flat = x.reshape(t, e).to(dt)
        expert_flat = top_idx.reshape(t * k)
        w_flat = top_w.reshape(t * k)

        expert_sorted, order = torch.sort(expert_flat, stable=True)
        token_of = order // k
        x_sorted = x_flat[token_of]
        w_sorted = w_flat[order]
        if cfg.moe_weight_on_input:
            x_sorted = x_sorted * w_sorted[:, None]
        counts = torch.zeros((n_exp,), dtype=torch.int32, device=x.device).scatter_add_(
            0, expert_flat, torch.ones_like(expert_flat, dtype=torch.int32))
        offsets = _offsets(counts)

        if self.ep is not None:
            o_sorted = self._expert_parallel(x_sorted, counts, wi_0, wi_1, wo, impl)
        elif scales is not None:
            wi_0_s, wi_1_s, wo_s = scales

            def rdot(v, w_q, w_s):
                vq, vs = q_rows(v)
                return grouped_matmul_int8(vq, w_q, offsets, vs, w_s, dt, impl=impl)

            h = self._act(rdot(x_sorted, wi_0, wi_0_s), rdot(x_sorted, wi_1, wi_1_s))
            o_sorted = rdot(h, wo, wo_s)
        else:
            h0 = grouped_matmul(x_sorted, wi_0.to(dt), offsets, impl=impl)
            h1 = grouped_matmul(x_sorted, wi_1.to(dt), offsets, impl=impl)
            o_sorted = grouped_matmul(self._act(h0, h1), wo.to(dt), offsets, impl=impl)
        if not cfg.moe_weight_on_input:
            o_sorted = o_sorted * w_sorted[:, None]
        # each token's k rows, in the order of their sorted positions, summed
        # in float32 from zero
        position = torch.empty_like(order).scatter_(
            0, order, torch.arange(t * k, device=x.device))
        rows = torch.sort(position.reshape(t, k), dim=1).values
        gathered = o_sorted.float()[rows]  # [T, k, E]
        out = torch.zeros((t, e), dtype=torch.float32, device=x.device)
        for j in range(k):
            out = out + gathered[:, j]
        return out.to(out_dtype or dt).reshape(b, s, e)

    def _expert_parallel(self, x_sorted, counts, wi_0, wi_1, wo, impl):
        """The grouped products of rows sorted by global expert id, run on
        the ranks that hold the experts: the rows for rank j's experts go to
        rank j, which sorts what it received by local expert (stable: by
        source rank within an expert), runs its experts and sends each row
        back; returns the rows in ``x_sorted``'s order."""
        from maxtext_indextts2_tpu_torch.parallel import comm

        ep, dt = self.ep, self.dtype
        n, local = ep.size, wi_0.shape[0]
        send = counts.reshape(n, local)  # rows for each rank's experts
        recv = comm.all_to_all(send, ep.group, 0, 0, op="expert_counts")  # [source, expert]
        send_rows, recv_host = send.sum(1).tolist(), recv.tolist()
        recv_rows = [sum(r) for r in recv_host]
        got = comm.AllToAllV.apply(x_sorted, ep.group, send_rows, recv_rows)
        key = torch.repeat_interleave(
            torch.arange(local, device=x_sorted.device).repeat(n), recv.reshape(-1).long())
        perm = torch.sort(key, stable=True).indices
        xs = got[perm]
        offsets = _offsets(recv.sum(0, dtype=torch.int32))
        h0 = grouped_matmul(xs, wi_0.to(dt), offsets, impl=impl)
        h1 = grouped_matmul(xs, wi_1.to(dt), offsets, impl=impl)
        y = grouped_matmul(self._act(h0, h1), wo.to(dt), offsets, impl=impl)
        y = y[torch.argsort(perm)]  # back in the order received
        return comm.AllToAllV.apply(y, ep.group, recv_rows, send_rows)

    def forward(self, inputs: torch.Tensor, impl: str | None = None, aux_loss: bool = True):
        """(output, the load-balance loss, or None without ``aux_loss``: a
        serving step computes nothing it does not use)."""
        cfg = self.cfg
        top_idx, top_w, scores = self.route(inputs)
        lb_loss = self.load_balance_loss(top_idx, scores) if aux_loss else None
        x = inputs
        out_dtype = None
        if self.tp is not None:
            from maxtext_indextts2_tpu_torch.parallel import comm

            # the routing weights scale each rank's partial products: their
            # gradient is summed over the group too
            x, top_w = (comm.copy_to_group(t, self.tp.group) for t in (inputs, top_w))
            out_dtype = torch.float32  # partial sums, reduced below
        if self.ep is not None:
            out = self._sparse_on_ranks(x, top_idx, top_w, impl, out_dtype)
        elif cfg.sparse_matmul and inputs.device.type == "cuda":
            scales = None
            if self.int8_experts:
                scales = (self.wi_0_scale, self.wi_1_scale, self.wo_scale)
            out = self.sparse_experts(x, top_idx, top_w, self.wi_0, self.wi_1, self.wo,
                                      scales, impl, out_dtype)
        else:
            out = self.dense_experts(x, top_idx, top_w, *self._float_experts())
        if self.tp is not None:
            out = comm.reduce_from_group(out, self.tp.group, self.dtype)
        if self.shared_experts is not None:
            out = out + self.shared_experts(inputs)
        return out, lb_loss

    def _sparse_on_ranks(self, x, top_idx, top_w, impl, out_dtype):
        """The sparse route under an expert split. Rows the same on every
        rank (serving) are cut into the expert group's chunks, each rank
        dispatches its own, and the chunks' outputs are all-gathered."""
        experts = (self.wi_0, self.wi_1, self.wo)
        if not self.rows_replicated:
            return self.sparse_experts(x, top_idx, top_w, *experts, None, impl, out_dtype)
        from maxtext_indextts2_tpu_torch.parallel import comm

        b, s, e = x.shape
        t, n = b * s, self.ep.size
        c = -(-t // n)
        pad = c * n - t

        def piece(v):
            v = v.reshape(t, *v.shape[2:])
            if pad:
                v = torch.cat([v, torch.zeros((pad, *v.shape[1:]), dtype=v.dtype,
                                              device=v.device)])
            return v[self.ep.rank * c:(self.ep.rank + 1) * c][None]

        out = self.sparse_experts(piece(x), piece(top_idx), piece(top_w), *experts, None, impl,
                                  out_dtype)
        return comm.all_gather(out[0], self.ep.group, 0)[:t].reshape(b, s, e)


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    """Group bounds ``[G + 1]`` int32 of per-group row counts, on the device."""
    return torch.cat([torch.zeros((1,), dtype=torch.int32, device=counts.device),
                      torch.cumsum(counts, 0, dtype=torch.int32)])
