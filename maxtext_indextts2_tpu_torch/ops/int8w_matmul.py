"""The int8-weight product of ``int8w_serve``: ``y = x @ dequant(q, scale)``.

``int8w_matmul(x, q, scale, bias)`` computes, for x ``[M, K]`` (bfloat16 or
float32), q ``[K, N]`` int8 and scale ``[N]`` float32,
``y = T(x @ T(T(q) * T(scale)))`` with float32 sums, then ``+ T(bias)``
rounded again, T being x's dtype: the rounding points of the JAX package's
``DenseGeneral._serve_quantized``, where XLA fuses the dequantisation into the
dot's read of the int8 kernel. It replaces no Pallas kernel.

On a CUDA tensor the hand-written kernel in ``csrc/int8w_matmul.cu`` runs for
the decode rows, ``M <= KERNEL_MAX_ROWS`` (the slots of a step, the
speculative verify span): it reads each int8 weight once. A prefill (M in the
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
_DEPTH = 256  # K a stage of the kernel: a split covers a multiple of it
_COLS = 128  # y's columns a block
_sm_count: dict[int, int] = {}


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
    """x's rows a block: the bfloat16 tensor-core kernel takes 16 or 32, the
    float32 CUDA-core one 8 or 16."""
    if dtype == torch.bfloat16:
        return 16 if m <= 16 else 32
    return 8 if m <= 8 else 16


def _splits(m: int, k: int, n: int, device, dtype=torch.bfloat16) -> tuple[int, int]:
    """(splits of K, K a split): enough blocks for four a streaming
    multiprocessor (the weight bytes in flight that keep the memory busy),
    each split a whole number of the kernel's stages."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_count:
        _sm_count[index] = torch.cuda.get_device_properties(index).multi_processor_count
    tiles = -(-n // _COLS) * -(-m // _rows_a_block(m, dtype))
    stages = -(-k // _DEPTH)
    splits = max(1, min(-(-4 * _sm_count[index] // tiles), stages, 16))
    per_split = -(-stages // splits) * _DEPTH
    return -(-k // per_split), per_split


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
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    code = lib.int8w_matmul(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), m, k, n, splits, per_split,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    launch_count += 1
    _build.check_launch(code, "int8w_matmul")
    return out
