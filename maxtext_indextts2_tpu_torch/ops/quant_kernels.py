"""Per-row dynamic int8 quantization, alone and fused with its producer.

Counterpart of the JAX package's ``ops/quant_kernels.py``. The S2A
denoiser's int8 serving mode quantizes every matmul input on the fly; each
function here reads its float input once and writes the int8 rows plus a
compact ``[B, S]`` float32 scale array, so the normalized / activated float
tensor never goes to device memory:

* ``row_quantize_int8(x)``: ``s = max|x| / 127``,
  ``q = round_half_even(x / max(s, 1e-9))`` (a division, not a reciprocal);
* ``ada_rmsnorm_quantize(x, w)``: the output of ``ops.ada_rmsnorm`` (rounded
  to x's dtype as there) quantized like that;
* ``silu_mul_quantize(g, u)``: ``g * sigmoid(g) * u`` with the sigmoid in
  float32 rounded to g's dtype, each product in g's dtype, quantized like that.

An all-zero row gives scale 0 and zeros. On a CUDA tensor the hand-written
kernels in ``csrc/`` run (or the call raises); the plain PyTorch versions
below are taken only for tensors on the CPU or with ``impl="plain"``. These
are serving-only and carry no gradient.
"""

from __future__ import annotations

import torch

from maxtext_indextts2_tpu_torch.ops.ada_rmsnorm import (
    FLOAT_DTYPES, ada_rmsnorm_plain, check_rows_and_scale, route,
)
from maxtext_indextts2_tpu_torch.ops.quantization import absmax_scale

# launches of each CUDA kernel by this process
launch_counts = {"row_quantize_int8": 0, "ada_rmsnorm_quantize": 0, "silu_mul_quantize": 0}


def row_quantize_int8_plain(x: torch.Tensor):
    """Plain PyTorch version: (int8 [B,S,K], float32 [B,S])."""
    xf = x.float()
    scale = absmax_scale(xf, -1)
    q = torch.round(xf / torch.clamp(scale, min=1e-9)[..., None])
    return q.to(torch.int8), scale


def ada_rmsnorm_quantize_plain(x: torch.Tensor, w: torch.Tensor):
    return row_quantize_int8_plain(ada_rmsnorm_plain(x, w))


def silu_mul_plain(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``silu(g) * u`` in g's dtype with the op order of the fused kernel."""
    return g * torch.sigmoid(g.float()).to(g.dtype) * u


def silu_mul_quantize_plain(g: torch.Tensor, u: torch.Tensor):
    return row_quantize_int8_plain(silu_mul_plain(g, u))


def _check_rows(name: str, x: torch.Tensor) -> None:
    if x.ndim != 3:
        raise ValueError(f"{name}: need [B,S,K], got {tuple(x.shape)}")
    if x.dtype not in FLOAT_DTYPES:
        raise TypeError(f"{name}: input must be float32 or bfloat16, got {x.dtype}")


def _outputs(x: torch.Tensor):
    return (torch.empty(x.shape, dtype=torch.int8, device=x.device),
            torch.empty(x.shape[:2], dtype=torch.float32, device=x.device))


def _launched(name: str, code: int) -> None:
    from maxtext_indextts2_tpu_torch.ops import _build

    launch_counts[name] += 1
    _build.check_launch(code, name)


def row_quantize_int8(x: torch.Tensor, impl: str | None = None):
    """x [B, S, K] float32/bfloat16 -> (xq int8 [B, S, K], scales float32 [B, S])."""
    _check_rows("row_quantize_int8", x)
    if route("row_quantize_int8", impl, x) == "plain":
        return row_quantize_int8_plain(x)

    from maxtext_indextts2_tpu_torch.ops import _build

    lib = _build.load_library()
    x = x.contiguous()
    q, scales = _outputs(x)
    b, s, k = x.shape
    if b * s:
        _launched("row_quantize_int8", lib.row_quantize_int8(
            x.data_ptr(), q.data_ptr(), scales.data_ptr(), b * s, k, FLOAT_DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream))
    return q, scales


def ada_rmsnorm_quantize(x: torch.Tensor, w: torch.Tensor, impl: str | None = None):
    """x [B, S, D], w [B, D] -> (int8 [B, S, D], float32 [B, S]) of
    ``ada_rmsnorm(x, w)``."""
    check_rows_and_scale("ada_rmsnorm_quantize", x, w)
    if route("ada_rmsnorm_quantize", impl, x, w) == "plain":
        return ada_rmsnorm_quantize_plain(x, w)

    from maxtext_indextts2_tpu_torch.ops import _build

    lib = _build.load_library()
    x, w = x.contiguous(), w.contiguous()
    q, scales = _outputs(x)
    b, s, d = x.shape
    if b * s:
        _launched("ada_rmsnorm_quantize", lib.ada_rmsnorm_quantize(
            x.data_ptr(), w.data_ptr(), q.data_ptr(), scales.data_ptr(), b * s, s, d,
            FLOAT_DTYPES[x.dtype], int(w.dtype == torch.float32),
            torch.cuda.current_stream(x.device).cuda_stream))
    return q, scales


def silu_mul_quantize(g: torch.Tensor, u: torch.Tensor, impl: str | None = None):
    """g, u [B, S, K] of one dtype -> (int8 [B, S, K], float32 [B, S]) of
    ``silu(g) * u``."""
    _check_rows("silu_mul_quantize", g)
    if u.shape != g.shape or u.dtype != g.dtype:
        raise ValueError(f"silu_mul_quantize: u {tuple(u.shape)} {u.dtype} must match g "
                         f"{tuple(g.shape)} {g.dtype}")
    if route("silu_mul_quantize", impl, g, u) == "plain":
        return silu_mul_quantize_plain(g, u)

    from maxtext_indextts2_tpu_torch.ops import _build

    lib = _build.load_library()
    g, u = g.contiguous(), u.contiguous()
    q, scales = _outputs(g)
    b, s, k = g.shape
    if b * s:
        _launched("silu_mul_quantize", lib.silu_mul_quantize(
            g.data_ptr(), u.data_ptr(), q.data_ptr(), scales.data_ptr(), b * s, k,
            FLOAT_DTYPES[g.dtype], torch.cuda.current_stream(g.device).cuda_stream))
    return q, scales
