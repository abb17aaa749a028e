"""KV-cache quantization (int8 values plus per-(batch, position, head)
float32 scales) and the offline per-output-channel weight quantization of
the serving int8 matmuls. (The JAX package's AQT matmul quantization for the
LM is not ported; see ROADMAP.md.)"""

from __future__ import annotations

import torch


def absmax_scale(xf: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    """``max|x| / 127`` along ``dim`` as a true division. (Dividing a CUDA
    tensor by a Python number multiplies by the rounded reciprocal instead,
    which moves the scale by one float32 step and with it codes at a
    rounding boundary; the divisor is therefore a tensor.)"""
    amax = torch.amax(torch.abs(xf), dim=dim, keepdim=keepdim)
    return amax / torch.full_like(amax, 127.0)


def quantize_kv(kv: torch.Tensor, axis: int = -1):
    """Symmetric absmax int8 quantization along ``axis``. Returns (values
    int8 [..., d], scales f32 [...]): the reduced axis is dropped from the
    scales, so a [B, S, nkv, d] cache has [B, S, nkv] scales. Rounding is
    half-to-even, as in the JAX package."""
    x = kv.float()
    scale = absmax_scale(x, axis, keepdim=True)
    q = torch.round(x / torch.clamp(scale, min=1e-9))
    return q.to(torch.int8), scale.squeeze(axis)


def dequantize_kv(values: torch.Tensor, scales: torch.Tensor, dtype=torch.bfloat16):
    """values [..., d] int8, scales [...] f32 (one per leading-dim row)."""
    return (values.float() * scales[..., None]).to(dtype)


def quantize_weight_for_serving(w: torch.Tensor, reduce_dims=(0,)):
    """Offline symmetric int8 quantization of a weight, one scale per output
    channel (``reduce_dims`` are the input axes, kept with size 1 in the
    scale): ``scale = max(amax, 1e-9) / 127``, ``q = round(w / scale)``
    clipped to [-127, 127]. The rule of the JAX package's
    ``quantize_params_for_serving``. It differs from the activation rule on
    purpose: there the scale is ``amax / 127``, floored at 1e-9 only in the
    division, and nothing is clipped. Returns (int8 like w, float32 scale)."""
    wf = w.float()
    amax = torch.amax(torch.abs(wf), dim=tuple(reduce_dims), keepdim=True)
    scale = torch.clamp(amax, min=1e-9) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale
