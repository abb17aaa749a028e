"""Grouped matrix products: ``y[r] = x[r] @ w[g(r)]`` over rows sorted by group.

The counterpart of ``jax.lax.ragged_dot``, which the JAX package's MoE layer
(``models/moe.py``, ``RoutedMoE._sparse_experts``) calls with
``preferred_element_type=float32``: x ``[R, K]`` whose rows are sorted by
group, w ``[G, K, N]``, and ``offsets`` ``[G + 1]`` int32 (group g holds rows
``[offsets[g], offsets[g + 1])``; a group may be empty). Two functions:

* ``grouped_matmul(x, w, offsets)``: bfloat16 or float32 operands, float32
  sums, the result in x's dtype: ``ragged_dot(...).astype(dtype)``;
* ``grouped_matmul_int8(xq, wq, offsets, row_scale, w_scale)``: int8
  operands, int32 sums; without scales the int32 sums, with them
  ``(float(sum) * row_scale[r]) * w_scale[g(r)]`` in ``out_dtype``: the
  arithmetic of the JAX package's int8 experts (``moe.py:241-266``).

``grouped_matmul`` takes gradients (training's sparse route): where autograd
records, it goes through :class:`GroupedMatmul`, whose backward launches the
two kernels of ``csrc/grouped_matmul_bwd.cu`` (bfloat16) or
``csrc/grouped_matmul_f32.cu`` (float32),

* ``grouped_matmul_dgrad(dy, w, offsets)``: ``dx[r] = dy[r] @ w[g(r)]^T``;
* ``grouped_matmul_wgrad(x, dy, offsets)``: ``dw[g] = x[rows of g]^T @
  dy[rows of g]`` ``[G, K, N]``, zeros for an empty group;

with the result dtypes of ``jax.vjp`` of ``ragged_dot(x, w, ...,
preferred_element_type=float32).astype(x.dtype)``: its jaxpr converts the
cotangent to float32, sums exact products in float32 and converts both
gradients back to the operands' dtype, so for bfloat16 operands ``dx`` and
``dw`` are bfloat16 (float32 sums rounded once), for float32 ones float32.
``grouped_matmul_int8`` takes no gradient: int8 experts are a serving
structure.

On a CUDA tensor the hand-written kernels run: ``csrc/grouped_matmul.cu``
(bfloat16 operands and result: :func:`forward_plan` picks the persistent
``wgmma`` kernel where the groups hold many rows and the split weight stream
where they hold few; or int8 operands with an int32 or bfloat16 result,
:func:`int8_plan` picking the persistent kernel or the split weight stream
the same way), ``csrc/grouped_matmul_f32.cu`` (float32 operands and result,
the forward and both gradients, register-tiled on the CUDA cores, tiles of
:func:`f32_tile_rows`: exact products summed in float32, as ``ragged_dot``
computes float32 operands); anything else raises.
``offsets`` is read on the device: no host sync, so a captured decode step
holds the launch. The plain
PyTorch versions below loop over the groups with ``torch.matmul`` on host
offsets; they are taken for tensors on the CPU and by comparisons
(``impl="plain"``), never on a card path. No Pallas kernel is replaced: XLA
lowers ``ragged_dot`` on the TPU.
"""

from __future__ import annotations

import torch

# launches of each CUDA kernel by this process ("grouped_matmul": the bf16
# kernel; the "_f32" ones: the float32 kernels of the three products)
launch_counts = {"grouped_matmul": 0, "grouped_matmul_int8": 0, "grouped_matmul_dgrad": 0,
                 "grouped_matmul_wgrad": 0, "grouped_matmul_f32": 0,
                 "grouped_matmul_f32_dgrad": 0, "grouped_matmul_f32_wgrad": 0}
# grouped_matmul_f32's mode argument
_F32_MODES = {"grouped_matmul_f32": 0, "grouped_matmul_f32_dgrad": 1,
              "grouped_matmul_f32_wgrad": 2}


# the bfloat16 forward's few-rows kernel: blocks of 16 rows x 128 columns, the
# K axis split over a cluster of at most 8 blocks, each split at least 256
# rows of K; its rings, (stages, blocks an SM their shared memory allows): 6
# stages (two an SM) only where K is long (>= 8192 rows: mixtral's wo at
# decode) and every block the grid can fill fits, else the deepest of 4
# (three) and 3 (four) whose resident blocks hold the working blocks, 4 where
# none does
FEW_ROWS, FEW_COLS, MAX_SPLITS, SPLIT_MIN_DEPTH = 16, 128, 8, 256
DEEP_RING_MIN_K = 8192
FEW_RINGS = ((4, 3), (3, 4))
# grouped_matmul_int8's few-rows kernel: the same blocks on stages of 128 of K
# (the same 16 KB of weights a stage), rings of 3 or 4 stages (int8_plan)
INT8_SPLIT_MIN_DEPTH, INT8_RING4_MAX_K = 512, 2048


def many_rows(rows: int, groups: int) -> bool:
    """The regime of a product: the groups hold many rows each (prefill,
    training: at least 32 a group on average, R >= 32 G) or few (decode)."""
    return rows >= 32 * groups


def tile_rows(rows: int, groups: int) -> int:
    """grouped_matmul_int8's rows of y a block: 16 when the groups hold few
    rows each (decode, the few-rows kernel), 64 when they hold many (prefill,
    the persistent kernel's items)."""
    return 64 if many_rows(rows, groups) else 16


def few_row_tiles(rows: int, groups: int) -> int:
    """The few-rows kernel's row tiles at most, the most ``rows`` rows can
    fill over ``groups`` groups: a touched group's first row takes a tile and
    each 16 rows more another, so sum_g ceil(rows_g / 16) <= min(R, G) + (R -
    min(R, G)) // 16. The grid is sized to it; spare tiles' blocks leave at
    once."""
    touched = min(rows, groups)
    return touched + (rows - touched) // FEW_ROWS


def working_blocks(rows: int, groups: int, n: int) -> float:
    """The few-rows kernel's blocks expected to find rows: the groups that
    ``rows`` rows drawn uniformly over ``groups`` touch, G (1 - (1 - 1/G)^R)
    (a decode group holds at most a tile of 16 rows), times the column
    tiles; at most the grid's row tiles (:func:`few_row_tiles`)."""
    touched = groups * (1.0 - (1.0 - 1.0 / groups) ** rows)
    return min(few_row_tiles(rows, groups), touched) * -(-n // FEW_COLS)


def _few_splits(rows: int, groups: int, k: int, n: int, sms: int, stage_k: int,
                split_min_depth: int) -> int:
    """The few-rows kernels' split of K over a cluster, stages of ``stage_k``:
    only where the grid of :func:`few_row_tiles` by ceil(N / 128) column
    tiles leaves SMs without a block (SMs // blocks), at most 8, each split
    at least ``split_min_depth`` of K, none empty."""
    blocks = few_row_tiles(rows, groups) * -(-n // FEW_COLS)
    stages_k = -(-k // stage_k)
    splits = max(1, min(MAX_SPLITS, -(-k // split_min_depth), sms // blocks))
    per_split = -(-stages_k // splits)
    return -(-stages_k // per_split)


def forward_plan(rows: int, groups: int, k: int, n: int, sms: int) -> tuple[int, int]:
    """The bfloat16 forward's launch, (splits, stages): (0, 0) for the
    many-rows regime (the persistent ``wgmma`` kernel); else the few-rows
    kernel over its grid of :func:`few_row_tiles` by ceil(N / 128) column
    tiles, K split by :func:`_few_splits` on stages of 64. The ring: 6
    stages where K >= 8192 and every block the grid can fill fits two an SM,
    else the deepest of :data:`FEW_RINGS` whose resident blocks hold the
    :func:`working_blocks`, else 4. Set from the device time of every ring at
    the decode shapes on an H100: a ring too deep for the blocks at work
    leaves some waiting for a slot (llama4's wi and, with all its rows on
    distinct experts, wo), one too shallow for a long K keeps too few bytes
    in flight (mixtral's wo)."""
    if many_rows(rows, groups):
        return 0, 0
    splits = _few_splits(rows, groups, k, n, sms, 64, SPLIT_MIN_DEPTH)
    blocks = few_row_tiles(rows, groups) * -(-n // FEW_COLS)
    working = working_blocks(rows, groups, n) * splits
    if k >= DEEP_RING_MIN_K and blocks * splits <= 2 * sms:
        return splits, 6
    return splits, next((st for st, per_sm in FEW_RINGS if working <= per_sm * sms), 4)


def int8_plan(rows: int, groups: int, k: int, n: int, sms: int) -> tuple[int, int]:
    """``grouped_matmul_int8``'s launch, (splits, stages): (0, 0) for the
    many-rows regime (the persistent kernel of 64-row tiles); else the
    few-rows kernel on stages of 128 of K (the raw int8 weights: 16 KB a
    stage, as the bfloat16 stage's 64 of K), K split by :func:`_few_splits`
    (each split at least :data:`INT8_SPLIT_MIN_DEPTH` of K), a ring of 4
    stages where K is short (<= :data:`INT8_RING4_MAX_K`) and the
    :func:`working_blocks` fit three blocks an SM, else 3 (four an SM). Set
    from the device time of every (splits, ring) at the decode shapes on an
    H100: the lane transposes make a stage dearer than the bfloat16 one, so
    the shallower ring, four blocks an SM, wins wherever the stream is long
    or the blocks many; no shape took the 6-stage ring."""
    if many_rows(rows, groups):
        return 0, 0
    splits = _few_splits(rows, groups, k, n, sms, 128, INT8_SPLIT_MIN_DEPTH)
    working = working_blocks(rows, groups, n) * splits
    return splits, 4 if k <= INT8_RING4_MAX_K and working <= 3 * sms else 3


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


def grouped_matmul_dgrad_plain(dy: torch.Tensor, w: torch.Tensor,
                               offsets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the input gradient: one float32 product
    ``dy[rows of g] @ w[g]^T`` a group, cast to dy's dtype."""
    dx = torch.zeros((dy.shape[0], w.shape[1]), dtype=torch.float32, device=dy.device)
    offs = _host_offsets(offsets)
    for g in range(w.shape[0]):
        a, b = offs[g], offs[g + 1]
        if b > a:
            dx[a:b] = dy[a:b].float() @ w[g].float().t()
    return dx.to(dy.dtype)


def grouped_matmul_wgrad_plain(x: torch.Tensor, dy: torch.Tensor,
                               offsets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the weight gradient: one float32 product
    ``x[rows of g]^T @ dy[rows of g]`` a group (zeros for an empty one),
    ``[G, K, N]`` in x's dtype."""
    groups = offsets.numel() - 1
    dw = torch.zeros((groups, x.shape[1], dy.shape[1]), dtype=torch.float32, device=x.device)
    offs = _host_offsets(offsets)
    for g in range(groups):
        a, b = offs[g], offs[g + 1]
        if b > a:
            dw[g] = x[a:b].float().t() @ dy[a:b].float()
    return dw.to(x.dtype)


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


class GroupedMatmul(torch.autograd.Function):
    """``grouped_matmul`` with its gradients: dgrad for x, wgrad for w (each
    only where asked for), on the route the forward took; the offsets take
    none."""

    @staticmethod
    def forward(ctx, x, w, offsets, impl):
        ctx.save_for_backward(x, w, offsets)
        ctx.impl = impl
        return _forward(x, w, offsets, impl)

    @staticmethod
    def backward(ctx, dy):
        x, w, offsets = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = grouped_matmul_dgrad(dy, w, offsets, ctx.impl)
        if ctx.needs_input_grad[1]:
            dw = grouped_matmul_wgrad(x, dy, offsets, ctx.impl)
        return dx, dw, None, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                   impl: str | None = None) -> torch.Tensor:
    """x ``[R, K]`` (rows sorted by group) by w ``[G, K, N]`` with group
    bounds ``offsets`` ``[G + 1]`` int32 -> ``[R, N]`` in x's dtype;
    differentiable in x and w (:class:`GroupedMatmul`)."""
    _check(x, w, offsets, int8=False)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GroupedMatmul.apply(x, w, offsets, impl)
    return _forward(x, w, offsets, impl)


def f32_tile_rows(rows: int, groups: int) -> int:
    """The float32 forward's and dgrad's rows of the result a block: 128
    where the groups hold at least 128 rows on average, else 64 (qwen3's
    parity step: 8,192 rows over 128 experts, 64 +- 8 a group, which a
    128-row tile would leave half empty). A group's last tile of 16 rows or
    fewer runs the kernel's short mapping (every warp on those rows)."""
    return 128 if rows >= 128 * groups else 64


def _launch_f32(name, a, b, offsets, out, r, k, n, g) -> None:
    """The float32 kernel of one of the three products (``_F32_MODES``)."""
    from maxtext_indextts2_tpu_torch.ops import _build

    lib = _build.load_library()
    a, b, offsets = _kernel_operands(a, b, offsets)
    code = lib.grouped_matmul_f32(
        a.data_ptr(), b.data_ptr(), offsets.data_ptr(), out.data_ptr(), r, k, n, g,
        _F32_MODES[name], f32_tile_rows(r, g), torch.cuda.current_stream(a.device).cuda_stream)
    _launched(name, code)


def _forward(x, w, offsets, impl):
    if _route(impl, (x, w, offsets)) == "plain":
        return grouped_matmul_plain(x, w, offsets)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"grouped_matmul kernel: bfloat16 or float32 operands, got {x.dtype}")
    r, k = x.shape
    g, _, n = w.shape
    if x.dtype == torch.bfloat16 and (k % 8 or n % 8):
        raise ValueError(f"grouped_matmul kernel: K and N multiples of 8, got {k}, {n}")
    out = torch.empty((r, n), dtype=x.dtype, device=x.device)
    if r == 0:
        return out
    if x.dtype == torch.float32:
        _launch_f32("grouped_matmul_f32", x, w, offsets, out, r, k, n, g)
        return out
    from maxtext_indextts2_tpu_torch.ops import _build

    lib = _build.load_library()
    x, w, offsets = _kernel_operands(x, w, offsets)
    code = lib.grouped_matmul_bf16(
        x.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(), r, k, n, g,
        *forward_plan(r, g, k, n, _build.sm_count(x.device)),
        torch.cuda.current_stream(x.device).cuda_stream)
    _launched("grouped_matmul", code)
    return out


def _check_bwd(a, b, offsets, what):
    if a.ndim != 2 or b.ndim not in (2, 3):
        raise ValueError(f"{what}: need 2-d rows and [G, K, N] experts")
    if offsets.ndim != 1 or offsets.dtype != torch.int32:
        raise ValueError(f"{what}: offsets must be [G + 1] int32")
    if a.dtype != b.dtype:
        raise TypeError(f"{what}: operands must share a dtype, got {a.dtype} and {b.dtype}")


def _bwd_kernel_ready(tensors, what, k, n) -> None:
    dtype = tensors[0].dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} kernel: bfloat16 or float32 operands, got {dtype}")
    if dtype == torch.bfloat16 and (k % 8 or n % 8):
        raise ValueError(f"{what} kernel: K and N multiples of 8, got {k}, {n}")


def grouped_matmul_dgrad(dy: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                         impl: str | None = None) -> torch.Tensor:
    """dy ``[R, N]`` (rows sorted by group) by w ``[G, K, N]`` transposed ->
    dx ``[R, K]`` in dy's dtype: ``dx[r] = dy[r] @ w[g(r)]^T``."""
    _check_bwd(dy, w, offsets, "grouped_matmul_dgrad")
    if w.shape[2] != dy.shape[1] or offsets.numel() != w.shape[0] + 1:
        raise ValueError(f"dy {tuple(dy.shape)} against w {tuple(w.shape)}, "
                         f"offsets {tuple(offsets.shape)}")
    if _route(impl, (dy, w, offsets)) == "plain":
        return grouped_matmul_dgrad_plain(dy, w, offsets)
    r, n = dy.shape
    g, k, _ = w.shape
    _bwd_kernel_ready((dy, w), "grouped_matmul_dgrad", k, n)
    dx = torch.empty((r, k), dtype=dy.dtype, device=dy.device)
    if r == 0:
        return dx
    if dy.dtype == torch.float32:
        _launch_f32("grouped_matmul_f32_dgrad", dy, w, offsets, dx, r, k, n, g)
        return dx
    from maxtext_indextts2_tpu_torch.ops import _build

    lib = _build.load_library()
    dy, w, offsets = _kernel_operands(dy, w, offsets)
    code = lib.grouped_matmul_dgrad(
        dy.data_ptr(), w.data_ptr(), offsets.data_ptr(), dx.data_ptr(), r, k, n, g,
        torch.cuda.current_stream(dy.device).cuda_stream)
    _launched("grouped_matmul_dgrad", code)
    return dx


def grouped_matmul_wgrad(x: torch.Tensor, dy: torch.Tensor, offsets: torch.Tensor,
                         impl: str | None = None) -> torch.Tensor:
    """x ``[R, K]`` and dy ``[R, N]`` (rows sorted by group) -> dw ``[G, K,
    N]`` in x's dtype, ``G = offsets.numel() - 1``: ``dw[g] = x[rows of g]^T
    @ dy[rows of g]``, zeros for an empty group."""
    _check_bwd(x, dy, offsets, "grouped_matmul_wgrad")
    if x.shape[0] != dy.shape[0] or offsets.numel() < 2:
        raise ValueError(f"x {tuple(x.shape)} and dy {tuple(dy.shape)}: one row each")
    if _route(impl, (x, dy, offsets)) == "plain":
        return grouped_matmul_wgrad_plain(x, dy, offsets)
    r, k = x.shape
    n, g = dy.shape[1], offsets.numel() - 1
    _bwd_kernel_ready((x, dy), "grouped_matmul_wgrad", k, n)
    dw = torch.empty((g, k, n), dtype=x.dtype, device=x.device)
    if x.dtype == torch.float32:
        _launch_f32("grouped_matmul_f32_wgrad", x, dy, offsets, dw, r, k, n, g)
        return dw
    from maxtext_indextts2_tpu_torch.ops import _build

    lib = _build.load_library()
    x, dy, offsets = _kernel_operands(x, dy, offsets)
    code = lib.grouped_matmul_wgrad(
        x.data_ptr(), dy.data_ptr(), offsets.data_ptr(), dw.data_ptr(), r, k, n, g,
        torch.cuda.current_stream(x.device).cuda_stream)
    _launched("grouped_matmul_wgrad", code)
    return dw


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
        out.data_ptr(), r, k, n, g, *int8_plan(r, g, k, n, _build.sm_count(xq.device)),
        torch.cuda.current_stream(xq.device).cuda_stream)
    _launched("grouped_matmul_int8", code)
    return out
