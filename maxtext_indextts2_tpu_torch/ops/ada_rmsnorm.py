"""Adaptive RMSNorm of the S2A denoiser, one pass over the rows.

``ada_rmsnorm(x, w)`` returns ``x * rsqrt(mean(x^2, -1) + 1e-6) * w[:, None, :]``
for ``x [B, S, D]`` and a per-batch conditioning scale ``w [B, D]``.
Counterpart of the JAX package's ``ops/ada_rmsnorm.py``. The op order is the
contract: the variance is float32, the rsqrt factor is rounded to x's dtype
BEFORE it multiplies x, that product is rounded to x's dtype, and then it is
multiplied by ``w`` cast to x's dtype (three roundings for a bfloat16 x).

On a CUDA tensor the hand-written kernel in ``csrc/ada_rmsnorm.cu`` runs (or
the call raises); the plain PyTorch version below is taken only for a tensor
that lies on the CPU, or when a test or an on-device comparison asks for it
with ``impl="plain"``. The forward is wrapped in a ``torch.autograd.Function``
whose backward is the closed formula in plain PyTorch, as the JAX package's
custom VJP is plain jnp.
"""

from __future__ import annotations

import torch

EPS = 1e-6
FLOAT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # dtype code of the C entry points

# launches of the CUDA kernel by this process
launch_count = 0


def ada_rmsnorm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the same function."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    factor = torch.rsqrt(var + EPS).to(x.dtype)
    return x * factor * w[:, None, :].to(x.dtype)


def check_rows_and_scale(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 3 or w.ndim != 2 or w.shape != (x.shape[0], x.shape[2]):
        raise ValueError(f"{name}: need x [B,S,D] and w [B,D], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.dtype not in FLOAT_DTYPES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if w.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"{name}: w must be float32 or x's dtype, got {w.dtype} for {x.dtype}")


def route(name: str, impl: str | None, *tensors: torch.Tensor) -> str:
    """``"plain"`` or ``"cuda"`` for a wrapper call: the plain version only
    for CPU tensors or on request; everything else is the kernel or an error."""
    first = tensors[0]
    if impl == "plain" or (impl is None and first.device.type == "cpu"):
        return "plain"
    if impl not in (None, "cuda"):
        raise ValueError(f"impl must be None, 'plain' or 'cuda', got {impl!r}")
    if first.device.type != "cuda" or any(t.device != first.device for t in tensors):
        raise ValueError(f"{name} kernel: every tensor must lie on one CUDA device")
    return "cuda"


def rows_of_16_bytes(t: torch.Tensor) -> bool:
    """True where ``cp.async`` can copy every row of ``t`` in 16-byte pieces: a
    16-byte-aligned start and every stride but the last a multiple of 8
    elements (a stride of an axis of length 1 is never used). The bfloat16
    tensor-core kernels need it of their operands."""
    return t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for n, st in zip(t.shape[:-1], t.stride()[:-1]) if n > 1)


def _forward(x: torch.Tensor, w: torch.Tensor, impl: str | None) -> torch.Tensor:
    global launch_count
    check_rows_and_scale("ada_rmsnorm", x, w)
    if route("ada_rmsnorm", impl, x, w) == "plain":
        return ada_rmsnorm_plain(x, w)

    from maxtext_indextts2_tpu_torch.ops import _build

    lib = _build.load_library()
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty_like(x)
    b, s, d = x.shape
    if b * s:
        code = lib.ada_rmsnorm(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), b * s, s, d, FLOAT_DTYPES[x.dtype],
            int(w.dtype == torch.float32), torch.cuda.current_stream(x.device).cuda_stream)
        launch_count += 1
        _build.check_launch(code, "ada_rmsnorm")
    return out


class _AdaRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, impl):
        ctx.save_for_backward(x, w)
        return _forward(x, w, impl)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        xf, gf, wf = x.float(), g.float(), w.float()[:, None, :]
        d = x.shape[-1]
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        r = torch.rsqrt(var + EPS)
        # y = x * r * w;  dx = w*g*r - x * r^3/D * sum(w*g*x);  dw = sum_s(x*r*g)
        wg = wf * gf
        dx = wg * r - xf * (r ** 3 / d) * torch.sum(wg * xf, dim=-1, keepdim=True)
        dw = torch.sum(xf * r * gf, dim=1)
        return dx.to(x.dtype), dw.to(w.dtype), None


def ada_rmsnorm(x: torch.Tensor, w: torch.Tensor, impl: str | None = None) -> torch.Tensor:
    """x [B, S, D] float32/bfloat16, w [B, D] (float32 or x's dtype) -> [B, S, D]
    in x's dtype. Differentiable in x and w."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _AdaRMSNorm.apply(x, w, impl)
    return _forward(x, w, impl)
