"""Loss ops: cross-entropy with z-loss, and the vocabulary-fused variants.

Counterpart of the JAX package's ``ops/losses.py`` for the LM training step.
:func:`cross_entropy_with_logits` is a ``torch.autograd.Function`` with the
JAX package's custom VJP: the forward gathers the target logit (no one-hot
``[B, S, V]`` tensor), the backward rebuilds the softmax from the saved
shifted logits and subtracts the one-hot term at the targets:

    d total / d logits = softmax - onehot(target) + 2 * z_loss * log_z * softmax

Everything is float32; the gradient is handed back in the logits' dtype
(PyTorch casts it). z-loss (ST-MoE, arXiv:2202.08906) pulls log Z toward 0.
Under a tensor split (``tp``, ``parallel/tensor.py``) the logits are this
rank's vocabulary slice and :class:`_VocabParallelCrossEntropy` takes them as
they are: the max, the sum of exponentials and the target's logit are
reduced over the group (Megatron's vocab-parallel cross-entropy), and the
backward is the same formula on the rank's slice.

The vocabulary-fused variants project the final-normed hidden states ``y``
[B, S, E] onto an ``[E, V]`` unembedding ``kernel`` inside the loss, so the
``[B*S, V]`` logits never exist at once (at a 264,192-row vocabulary they
are 8.66 GB in float32 at 4 x 2048 tokens). Each is a
``torch.autograd.Function`` with the JAX function's signature and its
``(mean_loss, total_weight)`` contract, and applies ``scale`` (the tied
embedding's 1/sqrt(E)), ``soft_cap``, ``z_loss``, ``compute_dtype`` and the
logits' dtype where the JAX code does:

- :func:`chunked_unembed_cross_entropy`: row chunks of ``chunk`` rows; the
  backward recomputes each chunk's logits (JAX: ``jax.checkpoint`` inside a
  ``lax.scan``) and sums dW in the kernel's dtype over the chunks, last chunk
  first, as the scan's transpose does.
- :func:`streaming_unembed_cross_entropy`: vocabulary tiles over all rows,
  an online log-sum-exp in the forward; the backward writes each tile's dW
  once and carries only the ``[N, E]`` dy.
- :func:`chunked_unembed_cross_entropy_int8`: the kernel quantized once a
  call (per-column absmax int8), the rows per row; int8 x int8 products; the
  gradient passes straight through to the kernel, dW from one bfloat16
  product a chunk.

The products are plain matrix products (the JAX package leaves them to XLA
outside any Pallas kernel). Where JAX asks for a float32 result of bfloat16
operands (``preferred_element_type``), the products are exact and the sums
float32 (:func:`_mm`); the int8 products sum exactly in int32
(``torch._int_mm``, on the card and on the CPU), where XLA on the CPU sums
the converted values in float32: the rounded bfloat16 logits agree, a float32
result can differ in its last bits once a sum passes 2**24.
"""

from __future__ import annotations

import torch

from maxtext_indextts2_tpu_torch.models.layers import to_dtype


def _ce_forward(logits: torch.Tensor, targets: torch.Tensor, z_loss: float):
    """(total, ce, (shifted, sum_exp, log_z)) of float32 ``logits`` [..., V]."""
    max_logit = torch.amax(logits, dim=-1, keepdim=True)
    shifted = logits - max_logit
    sum_exp = torch.sum(torch.exp(shifted), dim=-1)
    log_z = torch.log(sum_exp) + max_logit.squeeze(-1)
    target_logit = torch.gather(logits, -1, targets.long()[..., None]).squeeze(-1)
    ce = log_z - target_logit
    total = ce + z_loss * torch.square(log_z)
    return total, ce, (shifted, sum_exp, log_z)


def _ce_backward(shifted, sum_exp, log_z, targets, g_total, g_ce, z_loss: float):
    """d / d logits of the per-token (total, ce) with cotangents (g_total, g_ce)."""
    softmax = torch.exp(shifted) / sum_exp[..., None]
    coeff = (g_total + g_ce)[..., None]
    dlogits = coeff * softmax
    dlogits += (g_total * 2.0 * z_loss * log_z)[..., None] * softmax
    # subtract the one-hot term at each target
    dlogits.scatter_add_(-1, targets.long()[..., None], -coeff)
    return dlogits


class _CrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, z_loss):
        total, ce, (shifted, sum_exp, log_z) = _ce_forward(logits.float(), targets, z_loss)
        ctx.save_for_backward(shifted, sum_exp, log_z, targets)
        ctx.z_loss = z_loss
        return total, ce

    @staticmethod
    def backward(ctx, g_total, g_ce):
        shifted, sum_exp, log_z, targets = ctx.saved_tensors
        return _ce_backward(shifted, sum_exp, log_z, targets, g_total, g_ce, ctx.z_loss), None, None


class _VocabParallelCrossEntropy(torch.autograd.Function):
    """:class:`_CrossEntropy` of logits split over the vocabulary: ``logits``
    [..., V / n] are the columns ``[start, start + V / n)`` of this rank of
    ``group``."""

    @staticmethod
    def forward(ctx, logits, targets, z_loss, group, start):
        from maxtext_indextts2_tpu_torch.parallel import comm

        x = logits.float()
        m = torch.amax(x, dim=-1)
        m = torch.amax(comm.all_gather(m[None], group, 0), dim=0)  # the global max
        shifted = x - m[..., None]
        local = targets.long() - start
        inside = (local >= 0) & (local < x.shape[-1])
        local = torch.where(inside, local, 0)
        picked = torch.gather(x, -1, local[..., None]).squeeze(-1)
        parts = torch.stack([torch.sum(torch.exp(shifted), dim=-1),
                             torch.where(inside, picked, torch.zeros_like(picked))])
        sum_exp, target_logit = comm.all_reduce(parts, group, "ce_all_reduce").unbind(0)
        log_z = torch.log(sum_exp) + m
        ce = log_z - target_logit
        total = ce + z_loss * torch.square(log_z)
        ctx.save_for_backward(shifted, sum_exp, log_z, local, inside)
        ctx.z_loss = z_loss
        return total, ce

    @staticmethod
    def backward(ctx, g_total, g_ce):
        shifted, sum_exp, log_z, local, inside = ctx.saved_tensors
        softmax = torch.exp(shifted) / sum_exp[..., None]
        coeff = (g_total + g_ce)[..., None]
        dlogits = coeff * softmax
        dlogits += (g_total * 2.0 * ctx.z_loss * log_z)[..., None] * softmax
        dlogits.scatter_add_(-1, local[..., None], -coeff * inside[..., None])
        return dlogits, None, None, None, None


def cross_entropy_with_logits(logits: torch.Tensor, targets: torch.Tensor, z_loss: float,
                              tp=None):
    """Per-token CE + z-loss. logits [..., V] float, targets [...] int.
    Returns (total_loss, ce_loss), each [...] float32. ``tp``: the logits are
    this rank's vocabulary slice of a tensor split (``parallel/tensor.Split``)."""
    if tp is not None:
        return _VocabParallelCrossEntropy.apply(logits, targets, float(z_loss), tp.group,
                                                tp.rank * logits.shape[-1])
    return _CrossEntropy.apply(logits, targets, float(z_loss))


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor,
                         z_loss: float = 0.0, tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted mean CE over valid tokens: (mean_loss, total_weight).
    ``weights`` is the segment mask (1 for real tokens, 0 for padding);
    ``tp``: vocabulary-split logits (:func:`cross_entropy_with_logits`)."""
    total, _ = cross_entropy_with_logits(logits, targets, z_loss, tp)
    total = total * weights
    denom = torch.clamp(torch.sum(weights), min=1e-6)
    return torch.sum(total) / denom, denom


# ------------------------------------------------ vocabulary-fused variants


def _mm(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` with float32 sums, the result in ``out_dtype`` (JAX's
    ``preferred_element_type``). Operands of one 16-bit type multiply in it
    (exact products); a float32 result of them is asked of cuBLAS directly
    on the card. Operands of two types multiply in float32 (XLA's
    promotion)."""
    if a.dtype == b.dtype and a.dtype != torch.float32:
        if out_dtype == a.dtype:
            return a @ b
        if a.is_cuda and out_dtype == torch.float32:
            return torch.mm(a, b, out_dtype=torch.float32)
    return (a.float() @ b.float()).to(out_dtype)


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, out_dtype):
        ctx.save_for_backward(a, b)
        return _mm(a, b, out_dtype)

    @staticmethod
    def backward(ctx, g):
        # JAX's transpose of a dot with preferred_element_type: the cotangent
        # (of the result's type) times the other operand, the result's type,
        # then each operand's own
        a, b = ctx.saved_tensors
        da = _mm(g, b.t(), g.dtype).to(a.dtype) if ctx.needs_input_grad[0] else None
        db = _mm(a.t(), g, g.dtype).to(b.dtype) if ctx.needs_input_grad[1] else None
        return da, db, None


def matmul(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """:func:`_mm` of 2-D operands with its gradient as JAX transposes it."""
    return _Matmul.apply(a, b, out_dtype)


def _int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> int32, summed exactly. cuBLAS takes
    ``M > 16``: a shorter ``a`` gets zero rows, dropped from the result."""
    m = a.shape[0]
    if a.is_cuda and m <= 16:
        a = torch.cat([a, a.new_zeros((32 - m, a.shape[1]))])
    return torch._int_mm(a.contiguous(), b)[:m]


def _scale_cap(logits: torch.Tensor, scale: float, soft_cap: float):
    """Scale then soft cap, as ``Transformer._unembed`` does: (logits, th)
    with ``th = tanh(x / cap)`` (None without a cap)."""
    if scale != 1.0:
        logits = logits * scale
    th = None
    if soft_cap > 0.0:
        th = torch.tanh(logits / soft_cap)
        logits = soft_cap * th
    return logits, th


def _unscale_cap(dlog: torch.Tensor, th, scale: float) -> torch.Tensor:
    """The chain rule of :func:`_scale_cap` back to the product's logits."""
    if th is not None:
        dlog = dlog * ((1.0 + th) * (1.0 - th))
    if scale != 1.0:
        dlog = dlog * scale
    return dlog


def _flat(y, targets, weights):
    b, s, e = y.shape
    return (y.reshape(b * s, e), targets.reshape(b * s).long(),
            weights.reshape(b * s).float())


class _ChunkedCE(torch.autograd.Function):
    """sum(total * w) over row chunks; the backward recomputes each chunk."""

    @staticmethod
    def forward(ctx, yf, kernel, tf, wf, z_loss, chunk, soft_cap, scale, dt, ldt):
        kern = kernel.to(dt)
        loss_sum = torch.zeros((), dtype=torch.float32, device=yf.device)
        for r0 in range(0, yf.shape[0], chunk):
            logits = _mm(yf[r0:r0 + chunk].to(dt), kern, ldt).float()
            logits, _ = _scale_cap(logits, scale, soft_cap)
            total, _, _ = _ce_forward(logits, tf[r0:r0 + chunk], z_loss)
            loss_sum = loss_sum + torch.sum(total * wf[r0:r0 + chunk])
        ctx.save_for_backward(yf, kernel, tf, wf)
        ctx.args = (z_loss, chunk, soft_cap, scale, dt, ldt)
        return loss_sum

    @staticmethod
    def backward(ctx, g):
        yf, kernel, tf, wf = ctx.saved_tensors
        z_loss, chunk, soft_cap, scale, dt, ldt = ctx.args
        kern = kernel.to(dt)
        # the cotangent (ldt) meets the kernel (dt) in the transposed products:
        # one promoted copy of the kernel for the whole backward
        kern_b = kern.to(torch.promote_types(dt, ldt))
        dy = torch.empty_like(yf)
        dw = torch.zeros(kernel.shape, dtype=kernel.dtype, device=kernel.device)
        starts = list(range(0, yf.shape[0], chunk))
        for r0 in reversed(starts):  # the scan's transpose walks the chunks backwards
            y_c = yf[r0:r0 + chunk].to(dt)
            t_c = tf[r0:r0 + chunk]
            logits, th = _scale_cap(_mm(y_c, kern, ldt).float(), scale, soft_cap)
            _, _, (shifted, sum_exp, log_z) = _ce_forward(logits, t_c, z_loss)
            g_total = wf[r0:r0 + chunk] * g
            dlog = _ce_backward(shifted, sum_exp, log_z, t_c, g_total, torch.zeros_like(g_total),
                                z_loss)
            del shifted, logits
            dlog = _unscale_cap(dlog, th, scale).to(ldt)
            dy[r0:r0 + chunk] = _mm(dlog, kern_b.t(), ldt).to(dt).to(yf.dtype)
            dw += _mm(y_c.t(), dlog, ldt).to(dt).to(kernel.dtype)
        return dy, dw, None, None, None, None, None, None, None, None


def chunked_unembed_cross_entropy(y, kernel, targets, weights, z_loss: float = 0.0,
                                  chunk: int = 512, soft_cap: float = 0.0, scale: float = 1.0,
                                  compute_dtype=None, logits_dtype=None):
    """Vocab projection fused into the loss, ``chunk`` flattened rows at a
    time: y [B, S, E] final-normed hidden states, kernel [E, V] (the
    unembedding, or the tied embedding transposed), targets / weights
    [B, S]. ``compute_dtype``: the products' operand type (default y's);
    ``logits_dtype``: their result's (default float32). Returns
    (mean_loss, total_weight), as :func:`masked_cross_entropy` over the
    model's logits."""
    yf, tf, wf = _flat(y, targets, weights)
    dt = to_dtype(compute_dtype) if compute_dtype else y.dtype
    ldt = to_dtype(logits_dtype) if logits_dtype else torch.float32
    loss_sum = _ChunkedCE.apply(yf, kernel, tf, wf, float(z_loss), int(chunk), float(soft_cap),
                                float(scale), dt, ldt)
    denom = torch.clamp(torch.sum(wf), min=1e-6)
    return loss_sum / denom, denom


def _pick_vocab_tile(v: int, max_tile: int) -> int:
    """Largest lane-aligned divisor of ``v`` that is <= max_tile (falls back
    to the whole vocab when none exists: streaming degenerates to one tile)."""
    for t in range(min(v, max_tile), 127, -1):
        if v % t == 0 and t % 128 == 0:
            return t
    return v


class _StreamCE(torch.autograd.Function):
    """sum(total * w) over vocabulary tiles with an online log-sum-exp."""

    @staticmethod
    def forward(ctx, yf, kernel, tf, wf, z_loss, vt, soft_cap, scale, dt):
        n, v = yf.shape[0], kernel.shape[1]
        y_dt = yf.to(dt)
        m = torch.full((n,), -torch.inf, dtype=torch.float32, device=yf.device)
        l = torch.zeros((n,), dtype=torch.float32, device=yf.device)
        tgt = torch.zeros((n,), dtype=torch.float32, device=yf.device)
        rows = torch.arange(n, device=yf.device)
        for v0 in range(0, v, vt):
            logits, _ = _scale_cap(_mm(y_dt, kernel[:, v0:v0 + vt].to(dt), torch.float32),
                                   scale, soft_cap)
            m_new = torch.maximum(m, torch.amax(logits, dim=-1))
            l = l * torch.exp(m - m_new) + torch.sum(torch.exp(logits - m_new[:, None]), dim=-1)
            m = m_new
            loc = tf - v0
            inb = (loc >= 0) & (loc < vt)
            tgt = torch.where(inb, logits[rows, loc.clamp(0, vt - 1)], tgt)
        lse = torch.log(l) + m
        total = (lse - tgt) + z_loss * torch.square(lse)
        ctx.save_for_backward(yf, kernel, tf, wf, lse)
        ctx.args = (z_loss, vt, soft_cap, scale, dt)
        return torch.sum(total * wf)

    @staticmethod
    def backward(ctx, g):
        yf, kernel, tf, wf, lse = ctx.saved_tensors
        z_loss, vt, soft_cap, scale, dt = ctx.args
        n, v = yf.shape[0], kernel.shape[1]
        y_dt = yf.to(dt)
        # d total / d logits_j = coef * (p_j * (1 + 2 z lse) - onehot_j)
        coef = wf * g
        pz = coef * (1.0 + 2.0 * z_loss * lse)
        rows = torch.arange(n, device=yf.device)
        dy = torch.zeros((n, yf.shape[1]), dtype=torch.float32, device=yf.device)
        dw = torch.empty(kernel.shape, dtype=kernel.dtype, device=kernel.device)
        for v0 in range(0, v, vt):
            wt = kernel[:, v0:v0 + vt].to(dt)
            logits, _ = _scale_cap(_mm(y_dt, wt, torch.float32), scale, soft_cap)
            dlog = torch.exp(logits - lse[:, None]) * pz[:, None]
            loc = tf - v0
            inb = (loc >= 0) & (loc < vt)
            dlog[rows, loc.clamp(0, vt - 1)] -= torch.where(inb, coef, 0.0)
            if soft_cap > 0.0:
                dlog = dlog * (1.0 - torch.square(logits / soft_cap))
            if scale != 1.0:
                dlog = dlog * scale
            dlog_c = dlog.to(dt)
            del dlog, logits
            dy += _mm(dlog_c, wt.t(), torch.float32)
            dw[:, v0:v0 + vt] = _mm(y_dt.t(), dlog_c, torch.float32).to(dw.dtype)
        return dy.to(yf.dtype), dw, None, None, None, None, None, None, None


def streaming_unembed_cross_entropy(y, kernel, targets, weights, z_loss: float = 0.0,
                                    max_tile: int = 8192, soft_cap: float = 0.0,
                                    scale: float = 1.0, compute_dtype=None):
    """The contract of :func:`chunked_unembed_cross_entropy` over vocabulary
    tiles (the largest 128-aligned divisor of V up to ``max_tile``) with all
    rows resident: the kernel is read a constant number of times a step and
    dW is written once a tile."""
    yf, tf, wf = _flat(y, targets, weights)
    dt = to_dtype(compute_dtype) if compute_dtype else y.dtype
    vt = _pick_vocab_tile(kernel.shape[1], int(max_tile))
    loss_sum = _StreamCE.apply(yf, kernel, tf, wf, float(z_loss), vt, float(soft_cap),
                               float(scale), dt)
    denom = torch.clamp(torch.sum(wf), min=1e-6)
    return loss_sum / denom, denom


def _rowq8(x: torch.Tensor):
    """Per-row symmetric absmax int8: x [..., K] -> (int8, float32 scale [...])."""
    xf = x.float()
    s = torch.clamp(torch.amax(torch.abs(xf), dim=-1), min=1e-30) / 127.0
    return torch.round(xf / s[..., None]).to(torch.int8), s


def _colq8(k: torch.Tensor):
    """Per-column absmax int8 of the [E, V] unembedding."""
    kf = k.float()
    s = torch.clamp(torch.amax(torch.abs(kf), dim=0), min=1e-30) / 127.0
    return torch.round(kf / s[None, :]).to(torch.int8), s


def _q8_logits(y_c, kq, sk, soft_cap, scale, ldt):
    yq, sy = _rowq8(y_c)
    acc = _int8_mm(yq, kq).to(ldt).float()
    logits = acc * (sy[:, None] * sk[None, :])
    return _scale_cap(logits, scale, soft_cap)[0]


class _Q8CE(torch.autograd.Function):
    """sum(total * w) over row chunks with int8 products; the kernel's
    gradient passes straight through its quantization."""

    @staticmethod
    def forward(ctx, yf, kernel, tf, wf, z_loss, chunk, soft_cap, scale, ldt):
        kq, sk = _colq8(kernel)
        loss_sum = torch.zeros((), dtype=torch.float32, device=yf.device)
        lse = torch.empty(yf.shape[0], dtype=torch.float32, device=yf.device)
        for r0 in range(0, yf.shape[0], chunk):
            logits = _q8_logits(yf[r0:r0 + chunk], kq, sk, soft_cap, scale, ldt)
            m = torch.amax(logits, dim=-1)
            lse_c = torch.log(torch.sum(torch.exp(logits - m[:, None]), dim=-1)) + m
            tl = torch.gather(logits, -1, tf[r0:r0 + chunk, None]).squeeze(-1)
            total = (lse_c - tl) + z_loss * torch.square(lse_c)
            loss_sum = loss_sum + torch.sum(total * wf[r0:r0 + chunk])
            lse[r0:r0 + chunk] = lse_c
        ctx.save_for_backward(yf, kq, sk, tf, wf, lse)
        ctx.args = (z_loss, chunk, soft_cap, scale, ldt, kernel.dtype)
        return loss_sum

    @staticmethod
    def backward(ctx, g):
        yf, kq, sk, tf, wf, lse = ctx.saved_tensors
        z_loss, chunk, soft_cap, scale, ldt, kdtype = ctx.args
        dy = torch.empty(yf.shape, dtype=torch.float32, device=yf.device)
        dw = torch.zeros(kq.shape, dtype=kdtype, device=kq.device)
        kq_t = kq.t()
        for r0 in range(0, yf.shape[0], chunk):
            y_c, t_c, lse_c = yf[r0:r0 + chunk], tf[r0:r0 + chunk], lse[r0:r0 + chunk]
            rows = torch.arange(y_c.shape[0], device=yf.device)
            logits = _q8_logits(y_c, kq, sk, soft_cap, scale, ldt)
            p = torch.exp(logits - lse_c[:, None])
            coef = wf[r0:r0 + chunk] * g
            pz = coef * (1.0 + 2.0 * z_loss * lse_c)
            # logits is the capped value: logits / cap = tanh(x)
            capchain = 1.0 - torch.square(logits / soft_cap) if soft_cap > 0.0 else None
            del logits
            # the smooth softmax part, quantized for the dy product, and the
            # one-hot spike at the target, applied exactly (its size would set
            # the int8 scale and crush the ~1/V softmax terms)
            dsoft = p * pz[:, None]
            del p
            if capchain is not None:
                dsoft = dsoft * capchain
            if scale != 1.0:
                dsoft = dsoft * scale
            gq, sg = _rowq8(dsoft * sk[None, :])
            dy_c = _int8_mm(gq, kq_t).float() * sg[:, None]
            del gq
            spike = -coef * scale
            if capchain is not None:
                spike = spike * capchain[rows, t_c]
            del capchain
            w_t = kq[:, t_c].float().t()  # [C, E]
            dy[r0:r0 + chunk] = dy_c + (spike * sk[t_c])[:, None] * w_t
            dsoft[rows, t_c] += spike
            # dW of the raw kernel, straight through the quantization
            dw += _mm(y_c.to(torch.bfloat16).t(), dsoft.to(torch.bfloat16),
                      torch.float32).to(kdtype)
        return dy.to(yf.dtype), dw, None, None, None, None, None, None, None


def chunked_unembed_cross_entropy_int8(y, kernel, targets, weights, z_loss: float = 0.0,
                                       chunk: int = 512, soft_cap: float = 0.0,
                                       scale: float = 1.0, logits_dtype="bfloat16"):
    """:func:`chunked_unembed_cross_entropy` with int8 products: the kernel
    quantized once a call (per-column scales), each chunk's rows per row;
    ``logits_dtype`` is the products' result type. The kernel's gradient is
    straight-through; dW sums in the kernel's dtype, one bfloat16 product a
    chunk."""
    yf, tf, wf = _flat(y, targets, weights)
    ldt = to_dtype(logits_dtype) if logits_dtype else torch.bfloat16
    loss_sum = _Q8CE.apply(yf, kernel, tf, wf, float(z_loss), int(chunk), float(soft_cap),
                           float(scale), ldt)
    denom = torch.clamp(torch.sum(wf), min=1e-6)
    return loss_sum / denom, denom
