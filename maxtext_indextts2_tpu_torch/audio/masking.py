"""Masking utilities for masked-generative audio training.

Counterpart of the JAX package's ``audio/masking.py`` (layer schedules,
random / causal / padding / structured-span masks, masked cross-entropy),
with ``torch`` in the place of ``jax.numpy``. Noise is an input: a random
mask takes a ``torch.Generator`` or the draws themselves (the uniforms of
:func:`create_random_mask`, the span lengths and starts of
:func:`create_structured_mask`), so a test can hand it the JAX package's
draws. The structured span mask is the JAX package's vectorised form: a fixed
budget of spans with uniform starts and lengths, a prefix of them kept while
the cumulative length is below the target, their coverage OR-ed.
"""

from __future__ import annotations

import numpy as np
import torch


def get_mask_layer_schedule(schedule_type: str = "linear", num_layers: int = 12):
    """Per-layer schedule values in [0, 1]."""
    if num_layers < 2:
        # the schedules interpolate over (num_layers - 1) steps; a single
        # layer has nothing to schedule
        return [0.0] * num_layers
    i = np.arange(num_layers, dtype=np.float64)
    if schedule_type == "linear":
        vals = np.linspace(0.0, 1.0, num_layers)
    elif schedule_type == "cosine":
        vals = 0.5 * (1 + np.cos(np.pi * i / (num_layers - 1)))
    elif schedule_type == "arccos":
        vals = np.arccos(1 - 2 * i / (num_layers - 1)) / np.pi
    else:
        raise ValueError(f"Unknown schedule type: {schedule_type}")
    return vals.astype(np.float32).tolist()


def get_layer_mask_prob(layer_idx: int, schedule, base_prob: float = 0.3) -> float:
    """base + (1 - base) * schedule[layer]."""
    if layer_idx >= len(schedule):
        return base_prob
    return base_prob + (1 - base_prob) * schedule[layer_idx]


def create_random_mask(shape, mask_prob, generator: torch.Generator | None = None,
                       uniforms: torch.Tensor | None = None) -> torch.Tensor:
    """Bernoulli(mask_prob) boolean mask: ``uniforms < mask_prob``, the
    uniforms in [0, 1) given or drawn from ``generator``."""
    if uniforms is None:
        device = generator.device if generator is not None else None
        uniforms = torch.rand(tuple(shape), generator=generator, device=device)
    if tuple(uniforms.shape) != tuple(shape):
        raise ValueError(f"uniforms of shape {tuple(uniforms.shape)} for a mask of {shape}")
    return uniforms < mask_prob


def create_causal_mask(seq_len: int, device=None) -> torch.Tensor:
    """[S, S] bool, True ABOVE the diagonal (positions to mask out)."""
    r = torch.arange(seq_len, device=device)
    return r[None, :] > r[:, None]


def create_padding_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, S] bool, True at PAD positions."""
    return torch.arange(max_len, device=lengths.device)[None, :] >= lengths[:, None]


def apply_mask_to_sequence(sequence, mask, mask_token_id):
    """Replace masked positions with the mask token id."""
    return torch.where(mask, torch.as_tensor(mask_token_id, dtype=sequence.dtype,
                                             device=sequence.device), sequence)


def compute_masked_loss(logits, targets, mask):
    """Mean cross-entropy over masked positions only (a where-mask, no -100
    sentinel) in the logits' dtype; the count floored at 1."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    denom = torch.clamp(torch.sum(mask), min=1)
    return torch.sum(torch.where(mask, nll, 0.0)) / denom


def create_structured_mask(shape: tuple[int, int], mask_prob: float, min_span: int = 1,
                           max_span: int = 10, generator: torch.Generator | None = None,
                           spans: tuple[torch.Tensor, torch.Tensor] | None = None
                           ) -> torch.Tensor:
    """Span mask covering ~mask_prob of each row with contiguous spans.

    A fixed budget of ``ceil(prob * S / min_span)`` spans a row, lengths
    uniform in [min_span, max_span] and starts uniform in [0, max(S -
    min_span, 1)), given as ``spans = (lengths, starts)`` ([B, n] integers
    each) or drawn from ``generator``; the spans are kept while the
    cumulative length before them is below the target, and their coverage is
    OR-ed. Spans may overlap."""
    b, s = shape
    target = mask_prob * s
    n_spans = max(1, int(np.ceil(target / max(min_span, 1))))
    if spans is None:
        device = generator.device if generator is not None else None
        lens = torch.randint(min_span, max_span + 1, (b, n_spans), generator=generator,
                             device=device)
        starts = torch.randint(0, max(s - min_span, 1), (b, n_spans), generator=generator,
                               device=device)
    else:
        lens, starts = (torch.as_tensor(t).long() for t in spans)
        if tuple(lens.shape) != (b, n_spans) or tuple(starts.shape) != (b, n_spans):
            raise ValueError(f"spans must be two [{b}, {n_spans}] tensors")
    # keep spans while the cumulative length is still below the target
    keep = (torch.cumsum(lens, dim=1) - lens) < target
    lens = torch.where(keep, lens, 0)
    pos = torch.arange(s, device=lens.device)[None, None, :]  # [1, 1, S]
    covered = (pos >= starts[..., None]) & (pos < (starts + lens)[..., None])
    return torch.any(covered, dim=1)
