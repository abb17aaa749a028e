"""Ragged and paged decode attention: one-token-per-slot GQA over variable lengths.

``softmax(q k^T / sqrt(d)) v`` over each slot's first ``lengths[b]`` cache
rows (with ``sliding_window > 0`` only the last ``sliding_window`` of them),
optionally over an int8 cache with per-(position, head) float32 scales.
Counterpart of the JAX package's ``ops/ragged_decode_attention.py``:
``ragged_decode_attention_v2`` is what the decode step calls;
``ragged_decode_attention`` keeps the older entry's signature (scales with a
trailing unit axis, float32 result for an int8 cache) and launches the same
kernel. ``paged_decode_attention_v2`` (K4) is the same attention over a
paged cache: K/V pools ``[num_pages, tokens_per_page, nkv, d]`` read through
a per-slot ``page_map`` (``infer/paged_attention.py``), float pools only.

On a CUDA tensor the hand-written kernel in
``csrc/ragged_decode_attention.cuh`` (K4: ``csrc/paged_decode_attention.cuh``,
the same kernel with a paged row address) runs, or the call raises; the
plain PyTorch version below is taken only for a tensor on the CPU, or when a
test or an on-device comparison asks for it with ``impl="plain"``. The kernel
splits each (slot, kv head)'s rows across a cluster of :func:`cluster_size`
blocks, a number taken from static shapes only, so that a call reads nothing
back to the host; a cluster launch the card refuses raises like any other
launch error.

Where this differs from the TPU kernel, on purpose: a slot of length 0 gets
ZEROS (the TPU kernel returns a finite mean of masked rows, the jnp
reference NaN); probabilities stay float32 for the PV product (the TPU
kernel rounds them to v's dtype first). The plain version does exactly what
the CUDA kernel does, so the two differ by summation order only.
"""

from __future__ import annotations

import functools
import math

import torch

HEAD_DIMS = (32, 64, 128, 256)
MAX_GROUP = 8
MAX_CLUSTER = 8  # the portable thread-block cluster size
# the fewest cache rows a block of a cluster gets at max_len
MIN_ROWS_PER_BLOCK = 32

# launches of the CUDA kernels by this process (see ops/inplace_update.py):
# the ragged kernel (K1, both entries) and the paged one (K4)
launch_count = 0
paged_launch_count = 0

_ENTRY = {
    torch.float32: "ragged_decode_attention_f32",
    torch.bfloat16: "ragged_decode_attention_bf16",
    torch.int8: "ragged_decode_attention_int8",
}


def cluster_size(b_sz: int, nkv: int, max_len: int, resident_blocks: int) -> int:
    """Blocks that share one (slot, kv head): a power of two in 1..8, from
    static shapes only -- slots x kv heads, the most rows a slot can attend to
    (the cache's length, or a shorter sliding window) and how many blocks of
    the kernel the card holds at once -- never from the lengths, which live on
    the device. As many as keep the grid within one wave of resident blocks,
    at least 2 (a split halves the longest slot's chain of loads even where
    the grid already fills the card), and none with fewer than
    ``MIN_ROWS_PER_BLOCK`` rows at max_len."""
    want = min(max(2, resident_blocks // max(1, b_sz * nkv)), max_len // MIN_ROWS_PER_BLOCK,
               MAX_CLUSTER)
    c = 1
    while 2 * c <= want:
        c *= 2
    return c


def tpp_shift(tpp: int) -> int:
    """log2(tpp) where tokens_per_page is a power of two (the kernel then
    shifts and masks), else -1."""
    return tpp.bit_length() - 1 if tpp > 0 and tpp & (tpp - 1) == 0 else -1


@functools.lru_cache(maxsize=None)
def occupancy(entry: str, head_dim: int, group: int, cluster: int,
              device_index: int) -> tuple[int, int]:
    """(blocks an SM holds, clusters of ``cluster`` blocks the card holds) of
    the kernel behind C entry ``entry`` at (head_dim, group), from CUDA's
    occupancy calculator: a property of the card and the instantiation, read
    once a process. Needs the GPU."""
    import ctypes

    from maxtext_indextts2_tpu_torch.ops import _build

    lib = _build.load_library()
    per_sm, clusters = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        code = getattr(lib, f"{entry}_occupancy")(
            ctypes.byref(per_sm), head_dim, group, cluster, ctypes.byref(clusters))
    _build.check_launch(code, f"{entry}_occupancy")
    return per_sm.value, clusters.value


@functools.lru_cache(maxsize=None)
def launch_cluster(entry: str, b_sz: int, nkv: int, max_len: int, head_dim: int, group: int,
                   device: torch.device) -> int:
    """The cluster size a launch of C entry ``entry`` takes at these shapes:
    :func:`cluster_size` with the blocks of the kernel the whole card holds
    (worked out once for each set of static shapes: a lookup a call)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    per_sm = occupancy(entry, head_dim, group, 1, index)[0]
    resident = per_sm * torch.cuda.get_device_properties(index).multi_processor_count
    return cluster_size(b_sz, nkv, max_len, resident)


def _max_rows(s_len: int, sliding_window: int) -> int:
    """The most cache rows a slot can attend to: the cache's length, or the
    window where it is shorter (both static)."""
    return min(s_len, sliding_window) if sliding_window > 0 else s_len


def _as_int32(t: torch.Tensor, max_len: int) -> torch.Tensor:
    """``t`` itself where it is contiguous int32 (the serving path's lengths
    and page map): no eager op. The kernel clamps lengths to [0, max_len] and
    page ids to the pool; only a wider integer type is clamped here first, so
    that its cast cannot wrap a length past the cache into the valid range."""
    if t.dtype == torch.int32:
        return t if t.is_contiguous() else t.contiguous()
    return torch.clamp(t, min=-1, max=max_len).to(torch.int32).contiguous()


def _check_16_byte_rows(*tensors: torch.Tensor) -> None:
    # the kernel copies K/V rows in 16-byte pieces (cp.async)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("decode attention kernel: the K/V cache must start on a "
                         "16-byte boundary")


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

    _check_16_byte_rows(k, v)

    from maxtext_indextts2_tpu_torch.ops import _build

    lib = _build.load_library()
    q = q.contiguous()
    # the kernel clamps each length to [0, S]: a length past the cache never
    # becomes an address
    lengths32 = _as_int32(lengths, s_len)
    out = torch.empty((b_sz, nq, d), dtype=out_dtype, device=q.device)
    code = getattr(lib, _ENTRY[k.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths32.data_ptr(),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        out.data_ptr(), b_sz, s_len, nkv, group, d, int(sliding_window),
        1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16),
        launch_cluster(_ENTRY[k.dtype], b_sz, nkv, _max_rows(s_len, sliding_window), d, group,
                       q.device),
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


_PAGED_ENTRY = {
    torch.float32: "paged_decode_attention_f32",
    torch.bfloat16: "paged_decode_attention_bf16",
}


def paged_decode_attention_v2_plain(
    q: torch.Tensor, key_pages: torch.Tensor, value_pages: torch.Tensor,
    page_map: torch.Tensor, lengths: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version: gather the pages the longest slot reaches (one
    read of that length on the host: this version serves comparisons and the
    CPU), then the ragged plain version over the gathered rows."""
    b_sz, nq, d = q.shape
    num_pages, tpp, nkv, _ = key_pages.shape
    lengths = torch.clamp(lengths.to(torch.long), min=0, max=tpp * page_map.shape[1])
    n_pages = max(1, -(-int(lengths.max().item()) // tpp))
    pm = torch.clamp(page_map[:, :n_pages].to(torch.long), min=0, max=num_pages - 1)
    k = key_pages[pm].reshape(b_sz, n_pages * tpp, nkv, d)
    v = value_pages[pm].reshape(b_sz, n_pages * tpp, nkv, d)
    return ragged_decode_attention_plain(q, k, v, lengths)


def _check_paged(q, key_pages, value_pages, page_map, lengths):
    if q.ndim != 3 or key_pages.ndim != 4 or value_pages.shape != key_pages.shape \
            or page_map.ndim != 2:
        raise ValueError(f"need q [B,nq,d], pools [num_pages,tpp,nkv,d], page_map [B,max_pages]; "
                         f"got {tuple(q.shape)}, {tuple(key_pages.shape)}, "
                         f"{tuple(value_pages.shape)}, {tuple(page_map.shape)}")
    b_sz, nq, d = q.shape
    if key_pages.shape[3] != d or nq % key_pages.shape[2] != 0:
        raise ValueError(f"q {tuple(q.shape)} does not match the pools {tuple(key_pages.shape)}")
    if page_map.shape[0] != b_sz or lengths.shape != (b_sz,):
        raise ValueError(f"page_map must be [B, max_pages] and lengths [B] with B={b_sz}, got "
                         f"{tuple(page_map.shape)}, {tuple(lengths.shape)}")
    if key_pages.dtype not in _PAGED_ENTRY or value_pages.dtype != key_pages.dtype:
        raise TypeError(f"paged decode attention takes float32 or bfloat16 pools, got "
                        f"{key_pages.dtype}/{value_pages.dtype}")
    if q.dtype != key_pages.dtype:
        raise TypeError(f"q is {q.dtype} but the pools are {key_pages.dtype}")
    if page_map.dtype.is_floating_point or lengths.dtype.is_floating_point:
        raise TypeError("page_map and lengths must be integer tensors")


def paged_decode_attention_v2(
    q: torch.Tensor,  # [B, nq, d] float32 | bfloat16
    key_pages: torch.Tensor,  # [num_pages, tpp, nkv, d], q's dtype
    value_pages: torch.Tensor,
    page_map: torch.Tensor,  # [B, max_pages] integer page ids (clamped to the pool)
    lengths: torch.Tensor,  # [B] integer; clamped to [0, tpp * max_pages]
    impl: str | None = None,
) -> torch.Tensor:
    """K4: returns [B, nq, d] in q's dtype; a slot of length 0 gets zeros."""
    global paged_launch_count
    _check_paged(q, key_pages, value_pages, page_map, lengths)
    if impl == "plain" or (impl is None and q.device.type == "cpu"):
        return paged_decode_attention_v2_plain(q, key_pages, value_pages, page_map, lengths)
    if impl not in (None, "cuda"):
        raise ValueError(f"impl must be None, 'plain' or 'cuda', got {impl!r}")

    b_sz, nq, d = q.shape
    num_pages, tpp, nkv, _ = key_pages.shape
    max_pages = page_map.shape[1]
    group = nq // nkv
    tensors = (q, key_pages, value_pages, page_map, lengths)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("paged decode kernel: all tensors must lie on one CUDA device")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged decode kernel: head_dim {d} not in {HEAD_DIMS}")
    if group > MAX_GROUP:
        raise ValueError(f"paged decode kernel: nq/nkv = {group} > {MAX_GROUP}")
    if not (key_pages.is_contiguous() and value_pages.is_contiguous()):
        raise ValueError("paged decode kernel: the page pools must be contiguous "
                         "(they are never copied)")

    _check_16_byte_rows(key_pages, value_pages)

    from maxtext_indextts2_tpu_torch.ops import _build

    lib = _build.load_library()
    q = q.contiguous()
    max_len = tpp * max_pages
    # the kernel clamps page ids to the pool and lengths to tpp * max_pages
    # (as the TPU kernel's wrapper does)
    pm32 = _as_int32(page_map, num_pages)
    lengths32 = _as_int32(lengths, max_len)
    out = torch.empty((b_sz, nq, d), dtype=q.dtype, device=q.device)
    is_bf16 = int(q.dtype == torch.bfloat16)
    code = getattr(lib, _PAGED_ENTRY[key_pages.dtype])(
        q.data_ptr(), key_pages.data_ptr(), value_pages.data_ptr(), pm32.data_ptr(),
        lengths32.data_ptr(), out.data_ptr(), b_sz, num_pages, tpp, tpp_shift(tpp), max_pages,
        nkv, group, d, 1.0 / math.sqrt(d), is_bf16, is_bf16,
        launch_cluster(_PAGED_ENTRY[key_pages.dtype], b_sz, nkv, max_len, d, group, q.device),
        torch.cuda.current_stream(q.device).cuda_stream)
    paged_launch_count += 1
    _build.check_launch(code, "paged_decode_attention")
    return out
