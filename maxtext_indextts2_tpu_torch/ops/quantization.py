"""Quantized matmuls and KV-cache quantization.

- KV-cache quantization: int8 values plus per-(batch, position, head)
  float32 scales.
- The offline per-output-channel weight quantization of the serving int8
  matmuls (:func:`quantize_weight_for_serving`, and over a whole model's
  state dict :func:`quantize_params_for_serving`).
- The AQT matmuls of training (:func:`aqt_dot`, ``quantization=int8 | int8w
  | fp8``): this package's own copy of the numerics of AQT's ``config_v4``
  as the JAX package configures it (its ``ops/quantization.py``
  ``_aqt_cfg``). AQT's product there is an XLA ``dot_general``, not a
  Pallas kernel; here the int8 product is ``torch._int_mm``
  (:func:`int8_matmul`) and the fp8 product a product of the decoded fp8
  codes in the operands' dtype (exact products, float32 sums rounded once:
  XLA's fp8 dot with a float32 result, cast).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F


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


def quantize_params_for_serving(state_dict: dict, quantized: dict) -> dict:
    """A float state dict -> the ``int8w_serve`` structure of ``quantized``
    (a state dict of a model built with ``quantization="int8w_serve"``, whose
    int8 ``<name>`` leaves each have a float32 sibling ``<name>_scale``):
    every such weight is quantized by :func:`quantize_weight_for_serving`
    over the axes where its scale has size 1; every other leaf passes
    through. The JAX package's ``quantize_params_for_serving``."""
    out = {}
    for name, ref in quantized.items():
        if name.endswith("_scale") and name[:-6] in quantized:
            continue  # made with its weight
        if ref.dtype == torch.int8 and f"{name}_scale" in quantized:
            scale_shape = quantized[f"{name}_scale"].shape
            red = tuple(i for i, d in enumerate(scale_shape) if d == 1)
            out[name], out[f"{name}_scale"] = quantize_weight_for_serving(
                state_dict[name], red)
        else:
            out[name] = state_dict[name]
    return out


# ------------------------------------------------------------------ AQT

AQT_MODES = ("int8", "int8w", "fp8")
# int8 with preserve_zero: 255 buckets, absmax mapped to the far edge of the
# last one (127.5); values are clipped to 127.0 (the bound less 0.5) before
# rounding, so that none rounds into a bucket that does not exist
INT8_BOUND, INT8_CLIP = 127.5, 127.0
FP8_TYPES = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
# explicit mantissa bits of the fp8 formats and of the types they round from
_MANTISSA = {torch.float8_e4m3fn: 3, torch.float8_e5m2: 2, torch.bfloat16: 7, torch.float32: 23}
# (forward codes, input-gradient codes) of each mode; None: not quantized
_MODE_CODES = {"int8": ("int8", "int8"), "int8w": ("int8", None), "fp8": ("e4m3", "e5m2")}


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq [M, K] int8 @ wq [K, N] int8 -> int32 [M, N] (``torch._int_mm``).
    On the GPU the library wants more than 16 rows (padded here) and K, N
    multiples of 8 (anything else is refused)."""
    m, k = xq.shape
    n = wq.shape[1]
    if xq.device.type == "cuda":
        if k % 8 or n % 8:
            raise ValueError(f"int8 matmul on the GPU needs K and N multiples of 8, got {k}, {n}")
        if m <= 16:
            return torch._int_mm(F.pad(xq, (0, 0, 0, 32 - m)), wq)[:m]
    return torch._int_mm(xq, wq)


def _aqt_scale(x: torch.Tensor, dim: int, bound: float):
    """AQT's absmax calibration over ``dim`` (kept with size 1), in x's
    dtype: ``scale = amax / bound`` (an amax of 0 counts as 1) and its
    reciprocal (an infinite one counts as 1). The JAX package runs AQT inside
    ``jit``, where XLA turns the division by the constant bound into a
    product with its float32 reciprocal, rounded to x's dtype: so here too."""
    amax = torch.amax(torch.abs(x), dim=dim, keepdim=True)
    amax = torch.where(amax == 0, torch.ones_like(amax), amax).to(torch.float32)
    scale = (amax * torch.full_like(amax, float(np.float32(1.0 / bound)))).to(x.dtype)
    inv = torch.reciprocal(scale)
    return scale, torch.where(torch.isinf(inv), torch.ones_like(inv), inv)


def _mantissa_round(v: torch.Tensor, fmt: torch.dtype, bits: torch.Tensor) -> torch.Tensor:
    """AQT's fp8 stochastic rounding (``fp_mantissa_round``): the random
    ``bits`` (each below 2**n, n the mantissa bits that ``fmt`` drops) added to
    v's bit pattern, then those n bits cleared."""
    if v.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fp8 stochastic rounding takes bfloat16 or float32, got {v.dtype}")
    word = torch.int16 if v.dtype == torch.bfloat16 else torch.int32
    drop = _MANTISSA[v.dtype] - _MANTISSA[fmt]
    pattern = (v.view(word) + bits.to(word)) & ~((1 << drop) - 1)
    return pattern.view(v.dtype)


def aqt_quantize(x: torch.Tensor, dim: int, codes: str,
                 noise: torch.Tensor | None = None):
    """(codes, scale) of x along the contraction axis ``dim``, as AQT's
    ``config_v4`` numerics run inside the JAX package's ``jit``: ``x * (1 /
    scale)``, then for int8 the noise added (stochastic rounding), a clip to
    +-127 and round half to even; for fp8 (``e4m3`` / ``e5m2``) the noise's
    random bits added to the mantissa (stochastic rounding), a clip to the
    format's largest value and the cast (round to nearest even). Where XLA
    keeps the product in float32 (before the int8 noise, before the fp8
    cast) so does this; elsewhere it is rounded to x's dtype. ``noise`` as
    :func:`draw_noise` makes it."""
    if codes == "int8":
        scale, inv = _aqt_scale(x, dim, INT8_BOUND)
        if noise is None:
            v = x * inv
        else:  # XLA keeps the product in float32 up to the sum with the noise
            v = (x.float() * inv.float() + noise.to(torch.float32)).to(x.dtype)
        v = torch.clamp(v, -INT8_CLIP, INT8_CLIP)
        return torch.round(v).to(torch.int8), scale
    fmt = FP8_TYPES[codes]
    edge = float(torch.finfo(fmt).max)  # 448 (e4m3), 57344 (e5m2): bfloat16 values
    scale, inv = _aqt_scale(x, dim, edge)
    if noise is None:  # XLA casts the float32 product to fp8 without rounding it first
        v = x.float() * inv.float()
    else:  # the random bits go into x's own bit pattern
        v = _mantissa_round(x * inv, fmt, noise)
    return torch.clamp(v, -edge, edge).to(fmt), scale


def draw_noise(codes: str, shape, dtype: torch.dtype, device,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """The stochastic-rounding noise of one quantized operand of ``shape``:
    int8, float32 uniform in [-0.5, 0.5) (AQT's ``uniform(key) - 0.5``); fp8,
    int32 random bits below 2**n, n the mantissa bits of ``dtype`` that the
    format drops (AQT's ``random.bits`` masked). From ``generator`` (None:
    PyTorch's default one)."""
    if codes == "int8":
        return torch.rand(shape, generator=generator, device=device, dtype=torch.float32) - 0.5
    drop = _MANTISSA[dtype] - _MANTISSA[FP8_TYPES[codes]]
    return torch.randint(0, 1 << drop, shape, generator=generator, device=device,
                         dtype=torch.int32)


def _aqt_product(lhs, rhs, codes, lhs_noise=None):
    """lhs [M, K] @ rhs [K, N] in ``codes``, and AQT's dequantisation of the
    output: the sums (int8's int32, fp8's float32) cast to the operands'
    dtype, times the lhs scales, then times the rhs scales, each product
    rounded to that dtype."""
    dtype = lhs.dtype
    ql, sl = aqt_quantize(lhs, 1, codes, lhs_noise)
    qr, sr = aqt_quantize(rhs, 0, codes)
    if codes == "int8":
        acc = int8_matmul(ql, qr)
    else:  # fp8 codes are exact in bfloat16: its product sums them in float32
        wide = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
        acc = ql.to(wide) @ qr.to(wide)
    return acc.to(dtype) * sl * sr


@dataclasses.dataclass
class AqtNoise:
    """The stochastic-rounding noise of one training step's AQT products,
    one draw for each quantized ``DenseGeneral`` by module name (e.g.
    ``decoder.layers_0.mlp_0.wi_0``). ``tensors`` gives the draws (a test
    feeds the JAX package's); else each is drawn from ``generator`` when its
    layer's backward runs. Only the backward reads noise, and it runs once
    for each product however often a remat region recomputes the forward,
    so the step's draws are fixed before the forward runs: its generator's
    seed (``train.train.step_aqt_noise``) or the tensors."""

    tensors: Mapping[str, torch.Tensor] | None = None
    generator: torch.Generator | None = None

    def for_layer(self, name: str) -> Callable:
        """The noise of the layer ``name``, as :func:`aqt_dot` takes it."""
        if self.tensors is not None:
            return lambda codes, shape, dtype, device: self.tensors[name]
        return lambda codes, shape, dtype, device: draw_noise(codes, shape, dtype, device,
                                                              self.generator)


class _AqtDot(torch.autograd.Function):
    """x [M, K] @ w [K, N] with AQT's quantized forward and gradients.

    Forward: both operands quantized (x a scale a row, w a scale a column).
    Input gradient: ``int8`` quantizes g (a scale a row, stochastically
    rounded with ``noise``) and w (a scale a row of w, over N) to int8,
    ``fp8`` to e5m2 (g stochastically rounded too); ``int8w`` takes the plain
    product: AQT's ``int8w`` quantizes the forward's activations as ``int8``
    does, and differs from it only here. Weight gradient: the plain product
    ``x^T g`` in every mode."""

    @staticmethod
    def forward(ctx, x, w, mode, noise):
        fwd, dlhs = _MODE_CODES[mode]
        ctx.save_for_backward(x, w)
        ctx.dlhs, ctx.noise = dlhs, noise
        return _aqt_product(x, w, fwd)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt = w.t()
            if ctx.dlhs is None:
                dx = g @ wt
            else:
                noise = ctx.noise
                if callable(noise):
                    noise = noise(ctx.dlhs, tuple(g.shape), g.dtype, g.device)
                elif noise is None:
                    noise = draw_noise(ctx.dlhs, tuple(g.shape), g.dtype, g.device)
                dx = _aqt_product(g, wt, ctx.dlhs, noise.reshape(g.shape))
        if ctx.needs_input_grad[1]:
            dw = x.t() @ g
        return dx, dw, None, None


def aqt_dot(x: torch.Tensor, w: torch.Tensor, mode: str,
            noise: torch.Tensor | Callable | None = None) -> torch.Tensor:
    """``x [M, K] @ w [K, N]`` (one dtype) through AQT's numerics for
    ``mode`` in :data:`AQT_MODES`; the result in x's dtype. ``noise``: the
    stochastic-rounding noise of the input gradient's g (``int8`` and
    ``fp8``; ``int8w`` takes none), as :func:`draw_noise` makes it for
    ``[M, N]`` (any shape of M x N values), or a function of (codes, shape,
    dtype, device) that gives it when the backward runs, or None (a draw
    from PyTorch's default generator then)."""
    if mode not in _MODE_CODES:
        raise ValueError(f"unknown AQT quantization {mode!r}; known: {AQT_MODES}")
    if x.dtype != w.dtype:
        raise TypeError(f"aqt_dot: operands of one dtype, got {x.dtype} and {w.dtype}")
    return _AqtDot.apply(x, w, mode, noise)
