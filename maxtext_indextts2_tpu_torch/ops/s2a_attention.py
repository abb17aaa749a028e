"""Non-causal attention of the S2A sampler, every key valid.

``s2a_attention(q, k, v)`` returns ``softmax(q k^T) v`` over every key for
``q, k, v [B, S, N, D]`` with the scale already folded into q. Counterpart
of the JAX package's ``ops/s2a_attention.py``; its rounding points are the
contract: logits, max and sum in float32, the normalised probabilities
rounded to v's dtype, the PV product accumulated in float32 and rounded to
q's dtype.

On a CUDA tensor the hand-written kernel in ``csrc/s2a_attention.cu`` runs
(or the call raises); it reads q, k and v through their strides, so views of
the projection's output need no copy. In bfloat16 it runs on the tensor cores
and copies rows 16 bytes at a time: the wrapper raises on an operand whose
start is not 16-byte aligned or whose batch, sequence or head stride is not a
multiple of 8 elements (the projection's views are fine); float32 takes any
stride. The plain PyTorch version below (the einsum form) is taken only for a
tensor that lies on the CPU, or when a test or an on-device comparison asks
for it with ``impl="plain"``. Serving only: no gradient.
"""

from __future__ import annotations

import torch

from maxtext_indextts2_tpu_torch.ops.ada_rmsnorm import FLOAT_DTYPES, route, rows_of_16_bytes

HEAD_DIMS = (32, 64, 128)  # head widths the kernel is built for
# Query rows of a block of the bfloat16 kernel, largest first. A block is 4
# warps: at 64 rows each warp owns 16 rows and every key; at 16 rows the warps
# split every key tile in 4 slices and merge their softmax statistics and P V
# sums. The wrapper takes 64 where that grid has at least MIN_BLOCKS blocks, two
# for each of the H100's 132 SMs: a small S and B then take 16-row blocks, so
# that more warps share the work.
BLOCK_ROWS = (64, 16)
MIN_BLOCKS = 264

# launches of the CUDA kernel by this process
launch_count = 0


def s2a_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the same function."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype).contiguous()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"s2a_attention: need q, k, v of one shape [B,S,N,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in FLOAT_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"s2a_attention: q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")


def block_rows(b: int, s: int, n: int) -> int:
    """Query rows of a block of the bfloat16 kernel for a [b, s, n, D] call."""
    for rows in BLOCK_ROWS:
        if b * n * -(-s // rows) >= MIN_BLOCKS:
            return rows
    return BLOCK_ROWS[-1]


def _kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Shape and layout checks of the CUDA route, before any library load."""
    b, s, n, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"s2a_attention kernel: head dim {d} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("s2a_attention kernel: the last axis of q, k and v must be contiguous")
    if b > 65535 or n > 65535:
        raise ValueError(f"s2a_attention kernel: batch {b} and heads {n} must be <= 65535")
    if q.dtype == torch.bfloat16 and not all(map(rows_of_16_bytes, (q, k, v))):
        raise ValueError("s2a_attention kernel: bfloat16 rows are copied 16 bytes at a time: "
                         "q, k and v need 16-byte-aligned starts and batch, sequence and head "
                         "strides that are multiples of 8 elements")


def s2a_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  impl: str | None = None, rows: int | None = None) -> torch.Tensor:
    """q, k, v [B, S, N, D] float32/bfloat16 (one dtype; scale folded into q)
    -> [B, S, N, D] contiguous in q's dtype. On the GPU the kernel takes
    D in ``HEAD_DIMS`` and strides over B, S and N with the last axis
    contiguous (bfloat16: 16-byte rows, see above); anything else raises.
    ``rows`` fixes the bfloat16 kernel's query rows a block (one of
    ``BLOCK_ROWS``; None: ``block_rows``), for measuring the choice."""
    global launch_count
    _check(q, k, v)
    if route("s2a_attention", impl, q, k, v) == "plain":
        return s2a_attention_plain(q, k, v)
    _kernel_args(q, k, v)
    b, s, n, d = q.shape
    rows = block_rows(b, s, n) if rows is None else rows
    if rows not in BLOCK_ROWS:
        raise ValueError(f"s2a_attention kernel: rows {rows} not in {BLOCK_ROWS}")

    from maxtext_indextts2_tpu_torch.ops import _build

    lib = _build.load_library()
    out = torch.empty((b, s, n, d), dtype=q.dtype, device=q.device)
    if b * s * n:
        code = lib.s2a_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, n, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], FLOAT_DTYPES[q.dtype],
            rows if q.dtype == torch.bfloat16 else 64,
            torch.cuda.current_stream(q.device).cuda_stream)
        launch_count += 1
        _build.check_launch(code, "s2a_attention")
    return out
