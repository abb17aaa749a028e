"""Rotary position embeddings: pure functions of (x, positions).

Counterpart of the JAX package's ``models/rope.py``: the same per-pair
inverse frequencies (computed with numpy on the host) and the same float32
rotation for both pairings.
"""

from __future__ import annotations

import numpy as np
import torch


def rope_frequencies(
    head_dim: int,
    rope_type: str = "default",
    max_timescale: float = 10_000.0,
    factor: float = 8.0,
    low_freq_factor: float = 1.0,
    high_freq_factor: float = 4.0,
    original_max_position: int = 8192,
) -> np.ndarray:
    """Per-pair inverse frequencies, shape [head_dim//2], float32 (host-side)."""
    half = head_dim // 2
    inv_freq = 1.0 / (max_timescale ** (np.arange(0, half, dtype=np.float64) / half))

    if rope_type == "llama3.1":
        low_wavelen = original_max_position / low_freq_factor
        high_wavelen = original_max_position / high_freq_factor
        wavelen = 2 * np.pi / inv_freq
        scaled = np.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
        smooth = (original_max_position / wavelen - low_freq_factor) / (
            high_freq_factor - low_freq_factor
        )
        mid = (1 - smooth) * inv_freq / factor + smooth * inv_freq
        is_mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
        inv_freq = np.where(is_mid, mid, scaled)
    elif rope_type == "yarn":
        low = max(np.floor(half * np.log(original_max_position / (low_freq_factor * 2 * np.pi))
                           / np.log(max_timescale)), 0)
        high = min(np.ceil(half * np.log(original_max_position / (high_freq_factor * 2 * np.pi))
                           / np.log(max_timescale)), half - 1)
        ramp = np.clip((np.arange(half) - low) / max(high - low, 1e-3), 0, 1)
        inv_freq = inv_freq / factor * ramp + inv_freq * (1 - ramp)
    elif rope_type not in ("default", "none"):
        raise ValueError(f"unknown rope_type: {rope_type}")
    return inv_freq.astype(np.float32)


def rope_sin_cos(
    positions: torch.Tensor,
    inv_freq: torch.Tensor | np.ndarray,
    attention_scaling: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Float32 (sin, cos) of the rotation angles, each [B, S, D//2]. One
    attention call rotates q and k by the same angles: it computes them
    once and hands them to :func:`apply_rope` twice."""
    inv = torch.as_tensor(inv_freq, dtype=torch.float32, device=positions.device)
    angles = positions[..., None].float() * inv[None, None, :]
    sin, cos = torch.sin(angles), torch.cos(angles)
    if attention_scaling != 1.0:
        sin = sin * attention_scaling
        cos = cos * attention_scaling
    return sin, cos


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor | None,
    inv_freq: torch.Tensor | np.ndarray | None,
    interleave: bool = False,
    attention_scaling: float = 1.0,
    sin_cos: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Rotate q or k.

    x: [B, S, N, D] (or [B, S, D]); positions: [B, S] int; inv_freq: [D//2].
    interleave: True pairs (x0,x1),(x2,x3); False pairs the two halves (the
    llama convention). Angles and the rotation are float32; the result is
    cast back to x's dtype. ``sin_cos`` (from :func:`rope_sin_cos`) takes the
    place of ``positions`` and ``inv_freq``.
    """
    sin, cos = sin_cos or rope_sin_cos(positions, inv_freq, attention_scaling)
    for _ in range(x.ndim - 3):  # broadcast over the head axis if present
        sin = sin[..., None, :]
        cos = cos[..., None, :]

    in_dtype = x.dtype
    x = x.float()
    if interleave:
        x1 = x[..., ::2]
        x2 = x[..., 1::2]
        r1 = x1 * cos - x2 * sin
        r2 = x2 * cos + x1 * sin
        out = torch.stack([r1, r2], dim=-1).reshape(x.shape)
    else:
        half = x.shape[-1] // 2
        x1, x2 = x[..., :half], x[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(in_dtype)


def yarn_attention_scaling(factor: float) -> float:
    """mscale: temperature adjustment used with YaRN (deepseek convention)."""
    if factor <= 1.0:
        return 1.0
    return 0.1 * float(np.log(factor)) + 1.0
