"""Loss ops: cross-entropy with z-loss.

Counterpart of the JAX package's ``ops/losses.py`` for the LM training step.
:func:`cross_entropy_with_logits` is a ``torch.autograd.Function`` with the
JAX package's custom VJP: the forward gathers the target logit (no one-hot
``[B, S, V]`` tensor), the backward rebuilds the softmax from the saved
shifted logits and subtracts the one-hot term at the targets:

    d total / d logits = softmax - onehot(target) + 2 * z_loss * log_z * softmax

Everything is float32; the gradient is handed back in the logits' dtype
(PyTorch casts it). z-loss (ST-MoE, arXiv:2202.08906) pulls log Z toward 0.

The vocabulary-fused variants of the JAX package (``chunked_unembed_cross_
entropy``, ``streaming_unembed_cross_entropy`` and the int8 one) are not
ported: they raise, naming their queue item.
"""

from __future__ import annotations

import torch

from maxtext_indextts2_tpu_torch.unported import _unsupported

_FUSED_CE = "4b, rest of training: the vocabulary-fused cross-entropy variants, item 4b.6"


class _CrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, z_loss):
        logits = logits.float()
        max_logit = torch.amax(logits, dim=-1, keepdim=True)
        shifted = logits - max_logit
        sum_exp = torch.sum(torch.exp(shifted), dim=-1)
        log_z = torch.log(sum_exp) + max_logit.squeeze(-1)
        target_logit = torch.gather(logits, -1, targets.long()[..., None]).squeeze(-1)
        ce = log_z - target_logit
        total = ce + z_loss * torch.square(log_z)
        ctx.save_for_backward(shifted, sum_exp, log_z, targets)
        ctx.z_loss = z_loss
        return total, ce

    @staticmethod
    def backward(ctx, g_total, g_ce):
        shifted, sum_exp, log_z, targets = ctx.saved_tensors
        z_loss = ctx.z_loss
        softmax = torch.exp(shifted) / sum_exp[..., None]
        coeff = (g_total + g_ce)[..., None]
        dlogits = coeff * softmax
        dlogits += (g_total * 2.0 * z_loss * log_z)[..., None] * softmax
        # subtract the one-hot term at each target
        dlogits.scatter_add_(-1, targets.long()[..., None], -coeff)
        return dlogits, None, None


def cross_entropy_with_logits(logits: torch.Tensor, targets: torch.Tensor, z_loss: float):
    """Per-token CE + z-loss. logits [..., V] float, targets [...] int.
    Returns (total_loss, ce_loss), each [...] float32."""
    return _CrossEntropy.apply(logits, targets, float(z_loss))


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor,
                         z_loss: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted mean CE over valid tokens: (mean_loss, total_weight).
    ``weights`` is the segment mask (1 for real tokens, 0 for padding)."""
    total, _ = cross_entropy_with_logits(logits, targets, z_loss)
    total = total * weights
    denom = torch.clamp(torch.sum(weights), min=1e-6)
    return torch.sum(total) / denom, denom


def chunked_unembed_cross_entropy(*args, **kwargs):
    _unsupported("chunked_unembed_cross_entropy (fused_vocab_ce_chunk > 0)", _FUSED_CE)


def chunked_unembed_cross_entropy_int8(*args, **kwargs):
    _unsupported("chunked_unembed_cross_entropy_int8 (fused_ce_int8)", _FUSED_CE)


def streaming_unembed_cross_entropy(*args, **kwargs):
    _unsupported("streaming_unembed_cross_entropy (fused_vocab_ce_tile > 0)", _FUSED_CE)
