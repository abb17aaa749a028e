"""KV-cache quantization: int8 values plus per-(batch, position, head)
float32 scales. (The JAX package's AQT matmul quantization and offline
weight quantization are not ported; see ROADMAP.md.)"""

from __future__ import annotations

import torch


def quantize_kv(kv: torch.Tensor, axis: int = -1):
    """Symmetric absmax int8 quantization along ``axis``. Returns (values
    int8 [..., d], scales f32 [...]): the reduced axis is dropped from the
    scales, so a [B, S, nkv, d] cache has [B, S, nkv] scales. Rounding is
    half-to-even, as in the JAX package."""
    x = kv.float()
    amax = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    scale = amax / 127.0
    q = torch.round(x / torch.clamp(scale, min=1e-9))
    return q.to(torch.int8), scale.squeeze(axis)


def dequantize_kv(values: torch.Tensor, scales: torch.Tensor, dtype=torch.bfloat16):
    """values [..., d] int8, scales [...] f32 (one per leading-dim row)."""
    return (values.float() * scales[..., None]).to(dtype)
