"""In-place per-slot KV cache row updates.

``inplace_row_update(cache, kv, idx)`` writes ``cache[b, min(idx[b]+j, S-1)]
= kv[b, j]`` for ``j < K`` and touches only those rows. Counterpart of the
JAX package's ``ops/inplace_update.py``; there the function is pure and
returns a new array (aliased to its input on the TPU), here it MUTATES
``cache`` and returns it, because the cache is the one large buffer of the
decode step and a copy would double its traffic.

On a CUDA tensor the hand-written kernel in ``csrc/inplace_update.cu`` runs
(or the call raises); the plain PyTorch version below is taken only for a
tensor that lies on the CPU, or when a test or an on-device comparison asks
for it with ``impl="plain"``.
"""

from __future__ import annotations

import math

import torch

# launches of the CUDA kernel by this process (a plain integer; a run can
# show with it that its path went through the kernel), and the same launches
# by span K (1 on a decode step, K+1 on a speculative verify pass)
launch_count = 0
span_launch_counts: dict[int, int] = {}

_CONVERT_DIRECTION = {
    (torch.bfloat16, torch.float32): 0,  # (cache dtype, kv dtype)
    (torch.float32, torch.bfloat16): 1,
}


def inplace_row_update_plain(cache: torch.Tensor, kv: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the same function (mutates and returns
    ``cache``)."""
    b_sz, s_len = cache.shape[:2]
    span = kv.shape[1]
    offs = torch.clamp(
        idx.to(torch.long)[:, None]
        + torch.arange(span, device=cache.device, dtype=torch.long)[None, :],
        min=0, max=s_len - 1,
    )
    rows = torch.arange(b_sz, device=cache.device, dtype=torch.long)[:, None]
    # span rows that clamp onto the same target are written in order j = 0..K-1
    # by the kernel's grid in no fixed order; callers keep idx+K <= S
    cache[rows, offs] = kv.to(cache.dtype)
    return cache


def _check(cache, kv, idx):
    if cache.ndim < 3 or kv.ndim != cache.ndim:
        raise ValueError(f"cache {tuple(cache.shape)} / kv {tuple(kv.shape)}: need [B,S,...] and [B,K,...]")
    if kv.shape[0] != cache.shape[0] or kv.shape[2:] != cache.shape[2:]:
        raise ValueError(f"kv {tuple(kv.shape)} does not match cache {tuple(cache.shape)}")
    if idx.shape != (cache.shape[0],):
        raise ValueError(f"idx must be [B], got {tuple(idx.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be an integer tensor, got {idx.dtype}")


def inplace_row_update(cache: torch.Tensor, kv: torch.Tensor, idx: torch.Tensor,
                       impl: str | None = None) -> torch.Tensor:
    """cache [B, S, ...inner] (updated IN PLACE and returned), kv [B, K,
    ...inner] (cast to the cache's dtype), idx [B] integer."""
    global launch_count
    _check(cache, kv, idx)
    if impl == "plain" or (impl is None and cache.device.type == "cpu"):
        return inplace_row_update_plain(cache, kv, idx)
    if impl not in (None, "cuda"):
        raise ValueError(f"impl must be None, 'plain' or 'cuda', got {impl!r}")
    if cache.device.type != "cuda" or kv.device != cache.device or idx.device != cache.device:
        raise ValueError("inplace_row_update kernel: cache, kv and idx must lie on one CUDA device")
    if not cache.is_contiguous():
        raise ValueError("inplace_row_update kernel: cache must be contiguous")

    from maxtext_indextts2_tpu_torch.ops import _build

    lib = _build.load_library()
    kv = kv.contiguous()
    idx32 = idx.to(torch.int32).contiguous()
    b_sz, s_len = cache.shape[:2]
    span = kv.shape[1]
    inner = math.prod(cache.shape[2:])
    stream = torch.cuda.current_stream(cache.device).cuda_stream
    if kv.dtype == cache.dtype:
        code = lib.inplace_row_update_bytes(
            cache.data_ptr(), kv.data_ptr(), idx32.data_ptr(), b_sz, s_len, span,
            inner * cache.element_size(), stream)
    elif (cache.dtype, kv.dtype) in _CONVERT_DIRECTION:
        code = lib.inplace_row_update_convert(
            cache.data_ptr(), kv.data_ptr(), idx32.data_ptr(), b_sz, s_len, span,
            inner, _CONVERT_DIRECTION[(cache.dtype, kv.dtype)], stream)
    else:
        raise TypeError(
            f"inplace_row_update kernel: no conversion from {kv.dtype} rows to a "
            f"{cache.dtype} cache (equal types, or float32 <-> bfloat16)")
    launch_count += 1
    span_launch_counts[span] = span_launch_counts.get(span, 0) + 1
    _build.check_launch(code, "inplace_row_update")
    return cache
