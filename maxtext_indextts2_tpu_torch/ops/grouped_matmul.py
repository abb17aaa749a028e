"""Grouped matrix products: ``y[r] = x[r] @ w[g(r)]`` over rows sorted by group.

The counterpart of ``jax.lax.ragged_dot``, which the JAX package's MoE layer
(``models/moe.py``, ``RoutedMoE._sparse_experts``) calls with
``preferred_element_type=float32``: x ``[R, K]`` whose rows are sorted by
group, w ``[G, K, N]``, and ``offsets`` ``[G + 1]`` int32 (group g holds rows
``[offsets[g], offsets[g + 1])``; a group may be empty). Two functions:

* ``grouped_matmul(x, w, offsets)``: bfloat16 (or float32 on the CPU)
  operands, float32 sums, the result in x's dtype:
  ``ragged_dot(...).astype(dtype)``;
* ``grouped_matmul_int8(xq, wq, offsets, row_scale, w_scale)``: int8
  operands, int32 sums; without scales the int32 sums, with them
  ``(float(sum) * row_scale[r]) * w_scale[g(r)]`` in ``out_dtype``: the
  arithmetic of the JAX package's int8 experts (``moe.py:241-266``).

On a CUDA tensor the hand-written kernels of ``csrc/grouped_matmul.cu`` run
(bfloat16 operands and result, or int8 operands with an int32 or bfloat16
result; anything else raises), with ``offsets`` read on the
device: no host sync, so a captured decode step holds the launch. The plain
PyTorch versions below loop over the groups with ``torch.matmul`` on host
offsets; they are taken for tensors on the CPU and by comparisons
(``impl="plain"``), never on a card path. No Pallas kernel is replaced: XLA
lowers ``ragged_dot`` on the TPU.
"""

from __future__ import annotations

import torch

# launches of each CUDA kernel by this process ("grouped_matmul": the bf16 kernel)
launch_counts = {"grouped_matmul": 0, "grouped_matmul_int8": 0}


def tile_rows(rows: int, groups: int) -> int:
    """Rows of y a block: 16 when the groups hold few rows each (decode), 64
    when they hold many (prefill)."""
    return 16 if rows < 32 * groups else 64


def _host_offsets(offsets: torch.Tensor) -> list[int]:
    return [int(v) for v in offsets.tolist()]


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                         offsets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one float32 product a group (exact products of
    the operands, float32 sums), cast to x's dtype."""
    y = torch.zeros((x.shape[0], w.shape[2]), dtype=torch.float32, device=x.device)
    offs = _host_offsets(offsets)
    for g in range(w.shape[0]):
        a, b = offs[g], offs[g + 1]
        if b > a:
            y[a:b] = x[a:b].float() @ w[g].float()
    return y.to(x.dtype)


def grouped_matmul_int8_plain(xq: torch.Tensor, wq: torch.Tensor, offsets: torch.Tensor,
                              row_scale: torch.Tensor | None = None,
                              w_scale: torch.Tensor | None = None,
                              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version: the int32 sums of each group's product (taken in
    float64, exact for int8 operands at any K this model has), then, with the
    scales, ``(float(sum) * row_scale) * w_scale[g]`` in ``out_dtype``."""
    sums = torch.zeros((xq.shape[0], wq.shape[2]), dtype=torch.int32, device=xq.device)
    offs = _host_offsets(offsets)
    for g in range(wq.shape[0]):
        a, b = offs[g], offs[g + 1]
        if b > a:
            sums[a:b] = (xq[a:b].double() @ wq[g].double()).to(torch.int32)
    if row_scale is None:
        return sums
    channel = w_scale.reshape(wq.shape[0], -1).float()
    group_of = torch.repeat_interleave(
        torch.arange(wq.shape[0], device=xq.device),
        torch.as_tensor([offs[g + 1] - offs[g] for g in range(wq.shape[0])], device=xq.device))
    y = (sums.float() * row_scale.reshape(-1, 1).float()) * channel[group_of]
    return y.to(out_dtype)


def _check(x, w, offsets, int8: bool):
    if x.ndim != 2 or w.ndim != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} @ w {tuple(w.shape)}: need [R, K] and [G, K, N]")
    if offsets.ndim != 1 or offsets.numel() != w.shape[0] + 1:
        raise ValueError(f"offsets {tuple(offsets.shape)}: need [G + 1] = [{w.shape[0] + 1}]")
    if offsets.dtype != torch.int32:
        raise TypeError(f"offsets must be int32, got {offsets.dtype}")
    if int8 and (x.dtype != torch.int8 or w.dtype != torch.int8):
        raise TypeError(f"int8 operands, got {x.dtype} and {w.dtype}")
    if not int8 and x.dtype != w.dtype:
        raise TypeError(f"x and w must share a dtype, got {x.dtype} and {w.dtype}")


def _route(impl: str | None, tensors) -> str:
    if impl == "plain" or (impl is None and tensors[0].device.type == "cpu"):
        return "plain"
    if impl not in (None, "cuda"):
        raise ValueError(f"impl must be None, 'plain' or 'cuda', got {impl!r}")
    dev = tensors[0].device
    if any(t.device.type != "cuda" or t.device != dev for t in tensors):
        raise ValueError("grouped_matmul kernel: every tensor must lie on one CUDA device")
    return "cuda"


def _kernel_operands(*tensors):
    out = []
    for t in tensors:
        t = t.contiguous()
        if t.data_ptr() % 16:
            raise ValueError("grouped_matmul kernel: operands must be 16-byte aligned")
        out.append(t)
    return out


def _launched(name: str, code: int) -> None:
    from maxtext_indextts2_tpu_torch.ops import _build

    launch_counts[name] += 1
    _build.check_launch(code, name)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                   impl: str | None = None) -> torch.Tensor:
    """x ``[R, K]`` (rows sorted by group) by w ``[G, K, N]`` with group
    bounds ``offsets`` ``[G + 1]`` int32 -> ``[R, N]`` in x's dtype."""
    _check(x, w, offsets, int8=False)
    if _route(impl, (x, w, offsets)) == "plain":
        return grouped_matmul_plain(x, w, offsets)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"grouped_matmul kernel: bfloat16 operands, got {x.dtype}")
    r, k = x.shape
    g, _, n = w.shape
    if k % 8 or n % 8:
        raise ValueError(f"grouped_matmul kernel: K and N multiples of 8, got {k}, {n}")
    out = torch.empty((r, n), dtype=x.dtype, device=x.device)
    if r == 0:
        return out
    from maxtext_indextts2_tpu_torch.ops import _build

    lib = _build.load_library()
    x, w, offsets = _kernel_operands(x, w, offsets)
    code = lib.grouped_matmul_bf16(
        x.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(), r, k, n, g,
        tile_rows(r, g), torch.cuda.current_stream(x.device).cuda_stream)
    _launched("grouped_matmul", code)
    return out


def grouped_matmul_int8(xq: torch.Tensor, wq: torch.Tensor, offsets: torch.Tensor,
                        row_scale: torch.Tensor | None = None,
                        w_scale: torch.Tensor | None = None,
                        out_dtype: torch.dtype = torch.bfloat16,
                        impl: str | None = None) -> torch.Tensor:
    """xq ``[R, K]`` int8 by wq ``[G, K, N]`` int8 -> the int32 sums
    ``[R, N]``, or, given ``row_scale`` ``[R]`` and ``w_scale`` (``G x N``
    float32 entries), the rescaled result in ``out_dtype`` (the kernel:
    bfloat16)."""
    _check(xq, wq, offsets, int8=True)
    if (row_scale is None) != (w_scale is None):
        raise ValueError("row_scale and w_scale go together")
    r, k = xq.shape
    g, _, n = wq.shape
    if row_scale is not None and (row_scale.numel() != r or w_scale.numel() != g * n):
        raise ValueError(f"scales of {row_scale.numel()} and {w_scale.numel()} entries for "
                         f"{r} rows and {g} x {n} channels")
    tensors = (xq, wq, offsets) + (() if row_scale is None else (row_scale, w_scale))
    if _route(impl, tensors) == "plain":
        return grouped_matmul_int8_plain(xq, wq, offsets, row_scale, w_scale, out_dtype)
    out_dtype = torch.int32 if row_scale is None else out_dtype
    if row_scale is not None and out_dtype != torch.bfloat16:
        raise TypeError(f"grouped_matmul_int8 kernel: a bfloat16 result, got {out_dtype}")
    if k % 16 or n % 16:
        raise ValueError(f"grouped_matmul_int8 kernel: K and N multiples of 16, got {k}, {n}")
    out = torch.empty((r, n), dtype=out_dtype, device=xq.device)
    if r == 0:
        return out
    from maxtext_indextts2_tpu_torch.ops import _build

    lib = _build.load_library()
    xq, wq, offsets = _kernel_operands(xq, wq, offsets)
    rs = ws = None
    if row_scale is not None:
        rs, ws = _kernel_operands(row_scale.reshape(-1).float(), w_scale.reshape(-1).float())
    code = lib.grouped_matmul_int8(
        xq.data_ptr(), wq.data_ptr(), offsets.data_ptr(),
        None if rs is None else rs.data_ptr(), None if ws is None else ws.data_ptr(),
        out.data_ptr(), r, k, n, g, tile_rows(r, g),
        torch.cuda.current_stream(xq.device).cuda_stream)
    _launched("grouped_matmul_int8", code)
    return out
