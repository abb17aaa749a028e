"""Token sampling: greedy / weighted (temperature) / top-k / nucleus.

Counterpart of the JAX package's ``infer/sampling.py``. A categorical draw
is ``argmax(logits + Gumbel noise)``, as in ``jax.random.categorical``; the
noise comes from a ``torch.Generator`` or, so that a test can feed both
packages the same draw, from the ``noise`` argument (standard Gumbel, shape
of the logits that are drawn from).
"""

from __future__ import annotations

import torch

NEG_INF = -1.0e9


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from uniform [0, 1) draws."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def _gumbel(shape, generator, device) -> torch.Tensor:
    return gumbel_from_uniform(
        torch.rand(shape, generator=generator, device=device, dtype=torch.float32))


def _categorical(logits, generator, noise):
    if noise is None:
        noise = _gumbel(logits.shape, generator, logits.device)
    return torch.argmax(logits + noise.to(logits.dtype), dim=-1)


def sample_tokens(
    logits: torch.Tensor,  # [B, V] float
    generator: torch.Generator | None = None,
    strategy: str = "greedy",
    temperature: float = 1.0,
    top_k: int = 40,
    nucleus_p: float = 0.95,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Returns [B] int32 sampled token ids."""
    if strategy == "greedy":
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if strategy == "weighted":
        return _categorical(logits / temperature, generator, noise).to(torch.int32)
    if strategy == "topk":
        vals, idx = torch.topk(logits, top_k, dim=-1)
        draw = _categorical(vals / temperature, generator, noise)
        return torch.gather(idx, -1, draw[:, None])[:, 0].to(torch.int32)
    if strategy == "nucleus":
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits / temperature, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_mask = cum - probs > nucleus_p  # keep tokens until mass >= p
        threshold = torch.amin(
            torch.where(cutoff_mask, torch.full_like(sorted_logits, float("inf")),
                        sorted_logits),
            dim=-1, keepdim=True)
        masked = torch.where(logits < threshold, torch.full_like(logits, NEG_INF), logits)
        return _categorical(masked / temperature, generator, noise).to(torch.int32)
    raise ValueError(f"unknown sampling strategy: {strategy}")


def log_probs_from_logits(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """[..., V], [...] -> [...] log p(token)."""
    logz = torch.logsumexp(logits, dim=-1)
    tl = torch.gather(logits, -1, tokens.long()[..., None])[..., 0]
    return tl - logz
