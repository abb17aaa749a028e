"""The int8-weight product of ``int8w_serve``: ``y = x @ dequant(q, scale)``.

``int8w_matmul(x, q, scale, bias)`` computes, for x ``[M, K]`` (bfloat16 or
float32), q ``[K, N]`` int8 and scale ``[N]`` float32,
``y = T(x @ T(T(q) * T(scale)))`` with float32 sums, then ``+ T(bias)``
rounded again, T being x's dtype: the rounding points of the JAX package's
``DenseGeneral._serve_quantized``, where XLA fuses the dequantisation into the
dot's read of the int8 kernel. It replaces no Pallas kernel.

On a CUDA tensor the hand-written kernel in ``csrc/int8w_matmul.cu`` runs for
the decode rows, ``M <= KERNEL_MAX_ROWS`` (the slots of a step, the
speculative verify span): it reads each int8 weight once, in one launch (the
K axis split over a cluster of blocks by :func:`split_plan`, the partial sums
merged in distributed shared memory). A prefill (M in the
thousands) is a large product whose weight read is a small share of its
time, so there, as in the JAX package, the weight is dequantised and
multiplied by ``torch.matmul``: a rule on M, not a fallback. A kernel that
does not build or launch raises. The plain PyTorch version below is taken
for a tensor that lies on the CPU, or when a comparison asks for it with
``impl="plain"``.
"""

from __future__ import annotations

import torch

# launches of the CUDA kernel by this process (a plain integer; a run can show
# with it that its path went through the kernel)
launch_count = 0

# the decode rows: up to the slot count and the speculative verify span
# (32 slots x (4 drafts + 1) = 160); more rows take dequantise + matmul
KERNEL_MAX_ROWS = 256
_DEPTH = 256  # a split of K covers a multiple of it
_COLS = 128  # y's columns a block
MAX_SPLITS = 8  # the splits of K form a cluster: the portable cluster size


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``T(T(q) * T(scale))`` for q ``[K, N]`` and scale ``[N]``."""
    return q.to(dtype) * scale.reshape(1, -1).to(dtype)


def int8w_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the same function: the dequantised weight,
    then the product (float32 sums, the result in x's dtype), then the bias."""
    y = x @ dequantize(q, scale, x.dtype)
    if bias is not None:
        y = y + bias.reshape(-1).to(x.dtype)
    return y


def _check(x, q, scale, bias):
    if x.ndim != 2 or q.ndim != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} @ q {tuple(q.shape)}: need [M, K] and [K, N]")
    if q.dtype != torch.int8:
        raise TypeError(f"q must be int8, got {q.dtype}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    n = q.shape[1]
    if scale.numel() != n:
        raise ValueError(f"scale has {scale.numel()} entries for {n} columns")
    if bias is not None and bias.numel() != n:
        raise ValueError(f"bias has {bias.numel()} entries for {n} columns")


def _rows_a_block(m: int, dtype: torch.dtype) -> int:
    """x's rows a block: the bfloat16 tensor-core kernel takes 16, 32 or 64
    (more rows: more blocks), the float32 CUDA-core one 8 or 16."""
    if dtype == torch.bfloat16:
        return 16 if m <= 16 else 32 if m <= 32 else 64
    return 8 if m <= 8 else 16


def split_plan(m: int, k: int, n: int, sms: int,
               dtype: torch.dtype = torch.bfloat16) -> tuple[int, int]:
    """(splits of K, K a split): K split only until the blocks reach one an
    SM (at most ``SMs // tiles`` splits, at most :data:`MAX_SPLITS`, one
    cluster), into splits of whole 256-row stages, none empty. Among those
    counts the largest that divides K's stages evenly is taken, unless it is
    under half the most allowed (then the most allowed). Set from the device
    time of every split count at the decode shapes on an H100: blocks past
    one an SM add start-up and merge costs that their bytes in flight do not
    repay, and a cluster of uneven splits is slower than a smaller even one
    (the flagship's [8, 3840 -> 4096] on 3 splits of 1280 rows against 4 of
    1024 and one of 768)."""
    tiles = -(-n // _COLS) * -(-m // _rows_a_block(m, dtype))
    stages = -(-k // _DEPTH)
    most = max(1, min(sms // tiles, stages, MAX_SPLITS))
    even = max(d for d in range(1, most + 1) if stages % d == 0)
    splits = even if 2 * even >= most else most
    per_split = -(-stages // splits) * _DEPTH
    return -(-k // per_split), per_split


def _splits(m: int, k: int, n: int, device, dtype=torch.bfloat16) -> tuple[int, int]:
    """:func:`split_plan` on ``device``'s SMs."""
    from maxtext_indextts2_tpu_torch.ops import _build

    return split_plan(m, k, n, _build.sm_count(device), dtype)


def int8w_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor | None = None, impl: str | None = None) -> torch.Tensor:
    """x ``[M, K]`` @ the int8 weight q ``[K, N]`` with its float32 scales
    ``[N]`` (any shape of N entries), plus ``bias`` ``[N]``; the result
    ``[M, N]`` in x's dtype."""
    global launch_count
    _check(x, q, scale, bias)
    if impl == "plain" or (impl is None and x.device.type == "cpu"):
        return int8w_matmul_plain(x, q, scale, bias)
    if impl not in (None, "cuda"):
        raise ValueError(f"impl must be None, 'plain' or 'cuda', got {impl!r}")
    tensors = [x, q, scale] + ([bias] if bias is not None else [])
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError("int8w_matmul kernel: x, q, scale and bias must lie on one CUDA device")
    m, k = x.shape
    n = q.shape[1]
    if m > KERNEL_MAX_ROWS:  # a prefill: dequantise, then the library's product
        return int8w_matmul_plain(x, q, scale, bias)

    from maxtext_indextts2_tpu_torch.ops import _build

    lib = _build.load_library()
    x = x.contiguous()
    q = q.contiguous()
    scale = scale.reshape(-1).to(torch.float32).contiguous()
    if bias is not None:
        bias = bias.reshape(-1).to(x.dtype).contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    splits, per_split = _splits(m, k, n, x.device, x.dtype)
    code = lib.int8w_matmul(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), m, k, n, splits, per_split,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    launch_count += 1
    _build.check_launch(code, "int8w_matmul")
    return out
