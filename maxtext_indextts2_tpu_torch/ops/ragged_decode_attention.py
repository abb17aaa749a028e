"""Ragged decode attention: one-token-per-slot GQA over variable lengths.

``softmax(q k^T / sqrt(d)) v`` over each slot's first ``lengths[b]`` cache
rows (with ``sliding_window > 0`` only the last ``sliding_window`` of them),
optionally over an int8 cache with per-(position, head) float32 scales.
Counterpart of the JAX package's ``ops/ragged_decode_attention.py``:
``ragged_decode_attention_v2`` is what the decode step calls;
``ragged_decode_attention`` keeps the older entry's signature (scales with a
trailing unit axis, float32 result for an int8 cache) and launches the same
kernel.

On a CUDA tensor the hand-written kernel in
``csrc/ragged_decode_attention.cuh`` runs (or the call raises); the plain
PyTorch version below is taken only for a tensor on the CPU, or when a test
or an on-device comparison asks for it with ``impl="plain"``.

Where this differs from the TPU kernel, on purpose: a slot of length 0 gets
ZEROS (the TPU kernel returns a finite mean of masked rows, the jnp
reference NaN); probabilities stay float32 for the PV product (the TPU
kernel rounds them to v's dtype first). The plain version does exactly what
the CUDA kernel does, so the two differ by summation order only.
"""

from __future__ import annotations

import math

import torch

HEAD_DIMS = (32, 64, 128, 256)
MAX_GROUP = 8

# launches of the CUDA kernel by this process (see ops/inplace_update.py)
launch_count = 0

_ENTRY = {
    torch.float32: "ragged_decode_attention_f32",
    torch.bfloat16: "ragged_decode_attention_bf16",
    torch.int8: "ragged_decode_attention_int8",
}


def ragged_decode_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
    sliding_window: int = 0, k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None, out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: masked full-length attention in float32."""
    b_sz, nq, d = q.shape
    s_len, nkv = k.shape[1], k.shape[2]
    group = nq // nkv
    lengths = torch.clamp(lengths.to(torch.long), min=0, max=s_len)
    qg = q.float().reshape(b_sz, nkv, group, d)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) / math.sqrt(d)
    if k_scale is not None:
        s = s * k_scale.float().permute(0, 2, 1)[:, :, None, :]
    pos = torch.arange(s_len, device=q.device)[None, :]
    mask = pos < lengths[:, None]  # [B, S]
    if sliding_window > 0:
        mask &= pos >= torch.clamp(lengths[:, None] - sliding_window, min=0)
    mask = mask[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = torch.sum(p, dim=-1, keepdim=True)
    if v_scale is not None:  # after l has summed the true probabilities
        p = p * v_scale.float().permute(0, 2, 1)[:, :, None, :]
    o = torch.einsum("bhgs,bshd->bhgd", p, v.float()) / torch.clamp(l, min=1e-30)
    return o.reshape(b_sz, nq, d).to(out_dtype or q.dtype)


def _check(q, k, v, lengths, k_scale, v_scale):
    if q.ndim != 3 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"need q [B,nq,d], k/v [B,S,nkv,d]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b_sz, nq, d = q.shape
    if k.shape[0] != b_sz or k.shape[3] != d or nq % k.shape[2] != 0:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if lengths.shape != (b_sz,):
        raise ValueError(f"lengths must be [B], got {tuple(lengths.shape)}")
    if k.dtype != v.dtype:
        raise TypeError(f"k and v dtypes differ: {k.dtype}, {v.dtype}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    if (k.dtype == torch.int8) != (k_scale is not None):
        raise TypeError("an int8 cache needs k_scale/v_scale, a float cache takes none")
    if k_scale is not None:
        for sc in (k_scale, v_scale):
            if sc.shape != k.shape[:3]:
                raise ValueError(f"scales must be [B,S,nkv]={tuple(k.shape[:3])}, got {tuple(sc.shape)}")


def ragged_decode_attention_v2(
    q: torch.Tensor,  # [B, nq, d] float32 | bfloat16
    k: torch.Tensor,  # [B, S, nkv, d] float32 | bfloat16, or int8 with k_scale
    v: torch.Tensor,
    lengths: torch.Tensor,  # [B] integer; clamped to [0, S]
    sliding_window: int = 0,
    k_scale: torch.Tensor | None = None,  # [B, S, nkv] float32 (int8 cache)
    v_scale: torch.Tensor | None = None,
    impl: str | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Returns [B, nq, d] in q's dtype (or ``out_dtype``: float32 | bfloat16)."""
    global launch_count
    _check(q, k, v, lengths, k_scale, v_scale)
    if impl == "plain" or (impl is None and q.device.type == "cpu"):
        return ragged_decode_attention_plain(
            q, k, v, lengths, sliding_window, k_scale, v_scale, out_dtype)
    if impl not in (None, "cuda"):
        raise ValueError(f"impl must be None, 'plain' or 'cuda', got {impl!r}")

    b_sz, nq, d = q.shape
    s_len, nkv = k.shape[1], k.shape[2]
    group = nq // nkv
    out_dtype = out_dtype or q.dtype
    tensors = [q, k, v, lengths] + ([k_scale, v_scale] if k_scale is not None else [])
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("ragged decode kernel: all tensors must lie on one CUDA device")
    if d not in HEAD_DIMS:
        raise ValueError(f"ragged decode kernel: head_dim {d} not in {HEAD_DIMS}")
    if group > MAX_GROUP:
        raise ValueError(f"ragged decode kernel: nq/nkv = {group} > {MAX_GROUP}")
    if q.dtype not in (torch.float32, torch.bfloat16) or out_dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"ragged decode kernel: q/out must be float32 or bfloat16, got "
                        f"{q.dtype}/{out_dtype}")
    if k.dtype not in _ENTRY:
        raise TypeError(f"ragged decode kernel: cache dtype {k.dtype} not supported")
    if k.dtype != torch.int8 and k.dtype != q.dtype:
        raise TypeError(f"ragged decode kernel: q is {q.dtype} but the cache is {k.dtype}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("ragged decode kernel: the K/V cache must be contiguous "
                         "(it is never copied)")
    if k_scale is not None and not (
            k_scale.dtype == torch.float32 and v_scale.dtype == torch.float32
            and k_scale.is_contiguous() and v_scale.is_contiguous()):
        raise ValueError("ragged decode kernel: scales must be contiguous float32")

    from maxtext_indextts2_tpu_torch.ops import _build

    lib = _build.load_library()
    q = q.contiguous()
    # clamp here as well as in the kernel: a length past the cache would be
    # an illegal address, which ends the CUDA context for the whole process
    lengths32 = torch.clamp(lengths, min=0, max=s_len).to(torch.int32).contiguous()
    out = torch.empty((b_sz, nq, d), dtype=out_dtype, device=q.device)
    code = getattr(lib, _ENTRY[k.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths32.data_ptr(),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        out.data_ptr(), b_sz, s_len, nkv, group, d, int(sliding_window),
        1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    launch_count += 1
    _build.check_launch(code, "ragged_decode_attention")
    return out


def ragged_decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
    block_kv: int = 256,  # accepted for the older entry's signature; the kernel tiles itself
    k_scale: torch.Tensor | None = None,  # [B, S, nkv, 1] float32 (int8 cache)
    v_scale: torch.Tensor | None = None,
    sliding_window: int = 0,
    impl: str | None = None,
) -> torch.Tensor:
    """The older entry's signature on the same kernel: scales carry a
    trailing unit axis and an int8 cache gives a float32 result."""
    del block_kv
    quantized = k_scale is not None
    if quantized:
        k_scale = k_scale.reshape(k.shape[:3])
        v_scale = v_scale.reshape(k.shape[:3])
    return ragged_decode_attention_v2(
        q, k, v, lengths, sliding_window=sliding_window, k_scale=k_scale,
        v_scale=v_scale, impl=impl, out_dtype=torch.float32 if quantized else None)
