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
with ``impl="plain"``. The kernel (``rowk::norm_rows_kernel``, shared with
``ada_rmsnorm_quantize``) holds a row in a warp's registers; its launch shape
comes from static shapes only (:func:`norm_row_shape`, :func:`rows_per_worker`).
The forward is wrapped in a ``torch.autograd.Function`` whose backward is the
closed formula in plain PyTorch, as the JAX package's custom VJP is plain jnp.
"""

from __future__ import annotations

import functools
import math

import torch

EPS = 1e-6
FLOAT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # dtype code of the C entry points

# launches of the CUDA kernel by this process
launch_count = 0

# Launch shape of csrc/row_kernels.cuh's norm_rows_kernel (K5 and K7): a row
# is cut into 16-byte chunks; a lane holds at most MAX_CHUNKS of them in
# registers (one of CHUNK_COUNTS, the kernel's instantiations); a row too wide
# for one warp is split over up to MAX_WARPS_PER_ROW warps of a block, and one
# wider still is walked in rounds of that block's registers.
CHUNK_BYTES = 16
CHUNK_COUNTS = (1, 2, 4, 8)
MAX_CHUNKS = CHUNK_COUNTS[-1]
MAX_WARPS_PER_ROW = 8


def norm_row_shape(d: int, elem_bytes: int) -> tuple[int, int, bool]:
    """(chunks a lane, warps a row, rounds) for rows of ``d`` elements of
    ``elem_bytes`` bytes: one warp while its lanes hold the row in at most
    MAX_CHUNKS chunks each, else the fewest warps (up to MAX_WARPS_PER_ROW)
    that do; each lane's chunks rounded up to the next of CHUNK_COUNTS. Rows
    wider than MAX_WARPS_PER_ROW warps hold are walked in rounds."""
    chunks = -(-d // (CHUNK_BYTES // elem_bytes))
    warps = -(-chunks // (32 * MAX_CHUNKS))
    if warps > MAX_WARPS_PER_ROW:
        return MAX_CHUNKS, MAX_WARPS_PER_ROW, True
    per_lane = -(-chunks // (32 * warps))
    return next(c for c in CHUNK_COUNTS if c >= per_lane), warps, False


def rows_per_worker(rows: int, warps_per_row: int, resident_warps: int) -> int:
    """Consecutive rows each worker (``warps_per_row`` warps: one warp, or a
    block of them) walks: as few as let one wave of the warps the card holds
    at once cover every row."""
    return max(1, math.ceil(rows / max(1, resident_warps // warps_per_row)))


@functools.lru_cache(maxsize=None)
def norm_occupancy(entry: str, dtype_code: int, w_is_f32: int, chunks: int, warps_per_row: int,
                   rounds: bool, device_index: int) -> tuple[int, int]:
    """(blocks an SM holds at once, threads a block) of the instantiation
    behind C entry ``entry``, from CUDA's occupancy calculator and the
    launcher's block size: a property of the card and the instantiation, read
    once a process. Needs the GPU."""
    import ctypes

    from maxtext_indextts2_tpu_torch.ops import _build

    lib = _build.load_library()
    per_sm, threads = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        code = getattr(lib, f"{entry}_occupancy")(
            ctypes.byref(per_sm), dtype_code, w_is_f32, chunks, warps_per_row, int(rounds),
            ctypes.byref(threads))
    _build.check_launch(code, f"{entry}_occupancy")
    return per_sm.value, threads.value


@functools.lru_cache(maxsize=None)
def norm_launch(entry: str, rows: int, d: int, dtype: torch.dtype, w_is_f32: int,
                device: torch.device) -> tuple[int, int, int, int]:
    """(chunks, warps a row, rows a worker, rounds) of a launch of C entry
    ``entry`` at these static shapes (worked out once for each: a lookup a
    call)."""
    chunks, warps, rounds = norm_row_shape(d, torch.empty((), dtype=dtype).element_size())
    index = device.index if device.index is not None else torch.cuda.current_device()
    per_sm, threads = norm_occupancy(entry, FLOAT_DTYPES[dtype], w_is_f32, chunks, warps, rounds,
                                     index)
    resident_warps = (per_sm * threads // 32
                      * torch.cuda.get_device_properties(index).multi_processor_count)
    return chunks, warps, rows_per_worker(rows, warps, resident_warps), int(rounds)


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
        w_is_f32 = int(w.dtype == torch.float32)
        code = lib.ada_rmsnorm(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), b * s, s, d, FLOAT_DTYPES[x.dtype],
            w_is_f32, *norm_launch("ada_rmsnorm", b * s, d, x.dtype, w_is_f32, x.device),
            torch.cuda.current_stream(x.device).cuda_stream)
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
