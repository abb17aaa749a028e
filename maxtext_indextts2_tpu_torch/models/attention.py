"""Attention: projections, RoPE, mask generation, kernel dispatch, KV cache.

Counterpart of the JAX package's ``models/attention.py``. ``MODE_TRAIN``
takes ``attention`` ``flash`` (K9-K11, the hand-written CUDA kernels of
``ops/flash_attention``, with their backward) or ``dot_product`` (plain
einsum/softmax); ``autoselected`` picks flash on a CUDA device at S >= 1024
(the JAX package: on a TPU). ``MODE_PREFILL`` computes attention with plain
einsum/softmax (as the JAX serving path does outside any kernel), and
``MODE_AUTOREGRESSIVE`` takes ``decode_attention`` ``dot_product``,
``bucketed`` (the same masked product over the smallest power-of-two prefix of
the cache that covers every slot: the engine gives the width, the JAX
package's ``lax.switch`` picks it from the device's lengths) or ``ragged``
(the hand-written CUDA kernel of ``ops/ragged_decode_attention``);
with a paged cache (``paged_attention``: an ``infer/paged_attention.PagedKVCache``
from :meth:`Attention.init_paged_cache`, handed in with the engine's
``PagedDecodeStep``) it takes K4, the paged kernel of the same module, on a
CUDA tensor without a logit soft cap, and otherwise
the gather route of ``infer/paged_attention.py`` (the JAX package's route
off the TPU), chosen by where the tensor lies. ``MODE_PREFILL`` with a
``cache_offset`` is one chunk of a chunked prefill: its rows land at
``[offset, offset + len)`` and it attends over everything cached so far.
``MODE_VERIFY`` is the speculative verify pass: K+1 rows a slot, written at
the slot's ``cache_index`` through the row-update kernel K2 (which leaves the
index where it is) and scored against the whole cache. The chunk's and the
verify span's attention are masked products in plain PyTorch, as in the JAX
package.
:meth:`Attention.attend` is the training forward up to the output
projection: its result is the ``attn_out`` remat anchor of
``models/decoder.py``.

The KV cache is explicit state: a :class:`KVCache` per layer, handed to the
module and UPDATED IN PLACE (the JAX package threads it through as a flax
variable collection and returns new arrays).

Under a tensor split (``tp``, ``parallel/tensor.py``) q / k / v are
column-split over the heads and ``out`` row-split: a rank projects, caches
(dense or paged) and attends over its own heads with the same kernels, and
``out`` sums the ranks' partial products. A decode cache split over
``context_autoregressive`` (``KVCache(seq_split=...)``) holds this rank's
rows of every slot: a row is written only by its owner, and ``dot_product``
decode merges the ranks' partial softmaxes by log-sum-exp
(:func:`merge_partial_attention`), where the JAX package lets GSPMD partition
the contraction.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from maxtext_indextts2_tpu_torch.infer.paged_attention import (
    PagedKVCache,
    init_paged_cache,
    paged_decode_attention,
    write_rows,
)
from maxtext_indextts2_tpu_torch.models import rope as rope_lib
from maxtext_indextts2_tpu_torch.models.layers import DenseGeneral, RMSNorm
from maxtext_indextts2_tpu_torch.ops.flash_attention import flash_attention_sharded, sequence_axis
from maxtext_indextts2_tpu_torch.parallel import comm
from maxtext_indextts2_tpu_torch.parallel.mesh import current_mesh
from maxtext_indextts2_tpu_torch.ops.inplace_update import inplace_row_update
from maxtext_indextts2_tpu_torch.ops.quantization import dequantize_kv, quantize_kv
from maxtext_indextts2_tpu_torch.ops.ragged_decode_attention import (
    paged_decode_attention_v2,
    ragged_decode_attention_v2,
)

# Large negative for masked logits.
DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

MODE_TRAIN = "train"
MODE_PREFILL = "prefill"
MODE_AUTOREGRESSIVE = "autoregressive"
# Speculative verify pass: score K+1 tokens a slot in one forward. KV is
# written at [pos, pos+K+1) per slot but cache_index is NOT advanced: the
# engine sets it after acceptance (rows past it are dead until overwritten,
# since every decode read is bounded by cache_index or the positions).
MODE_VERIFY = "verify"


def make_attention_mask(
    q_positions: torch.Tensor,  # [B, Sq]
    kv_positions: torch.Tensor,  # [B, Skv]
    q_segment_ids: torch.Tensor | None,  # [B, Sq]
    kv_segment_ids: torch.Tensor | None,  # [B, Skv]
    causal: bool = True,
    sliding_window: int = 0,
    chunk_size: int = 0,
) -> torch.Tensor:
    """Boolean [B, 1, Sq, Skv] mask (True = attend)."""
    qp = q_positions[:, :, None]
    kp = kv_positions[:, None, :]
    mask = torch.ones(
        (qp.shape[0], qp.shape[1], kp.shape[2]), dtype=torch.bool, device=qp.device
    )
    if causal:
        mask &= kp <= qp
    if sliding_window > 0:
        mask &= kp > qp - sliding_window
    if chunk_size > 0:
        mask &= (qp // chunk_size) == (kp // chunk_size)
    if q_segment_ids is not None and kv_segment_ids is not None:
        mask &= q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]
    return mask[:, None, :, :]


def _gqa_logits(q, k, mask, logits_soft_cap: float, float32_qk: bool) -> torch.Tensor:
    """Grouped-query logits [B, Nkv, G, Sq, Skv] in float32: q [B, Sq, Nq, D]
    against k [B, Skv, Nkv, D], accumulated in float32 (or q's dtype without
    ``float32_qk``), scaled by 1/sqrt(D), soft-capped, and masked with
    ``DEFAULT_MASK_VALUE`` where ``mask`` [B, 1, Sq, Skv] is False."""
    b, sq, nq, d = q.shape
    nkv = k.shape[2]
    q = q.reshape(b, sq, nkv, nq // nkv, d)
    qk_dtype = torch.float32 if float32_qk else q.dtype
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.to(qk_dtype), k.to(qk_dtype)).float()
    logits = logits / math.sqrt(d)
    if logits_soft_cap > 0.0:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    if mask is not None:
        logits = torch.where(
            mask[:, :, None, :, :], logits, torch.full_like(logits, DEFAULT_MASK_VALUE)
        )
    return logits


def dot_product_attention(
    q: torch.Tensor,  # [B, Sq, Nq, D]
    k: torch.Tensor,  # [B, Skv, Nkv, D]
    v: torch.Tensor,  # [B, Skv, Nkv, D]
    mask: torch.Tensor | None,  # [B, 1, Sq, Skv] bool
    logits_soft_cap: float = 0.0,
    float32_qk: bool = True,
) -> torch.Tensor:
    """Grouped-query einsum attention: logits accumulated in float32, masked
    with ``DEFAULT_MASK_VALUE``, softmax in float32, probabilities cast to
    v's dtype before the PV product (the JAX package's op order)."""
    b, sq, nq, _ = q.shape
    logits = _gqa_logits(q, k, mask, logits_soft_cap, float32_qk)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, nq, v.shape[-1]).to(v.dtype)


def merge_partial_attention(q, k, v, mask, logits_soft_cap: float, float32_qk: bool,
                            group) -> torch.Tensor:
    """:func:`dot_product_attention` over keys split across ``group``: this
    rank's rows give a partial max, sum of exponentials and unnormalised
    output (float32), the maxima are gathered, and the rescaled sums and
    outputs summed over the group (log-sum-exp). A rank whose rows are all
    masked holds the mask value as its max, which the others' real maxima
    scale to nothing."""
    b, sq, nq, _ = q.shape
    logits = _gqa_logits(q, k, mask, logits_soft_cap, float32_qk)
    m = torch.amax(logits, dim=-1, keepdim=True)  # [b, h, g, q, 1]
    m_all = torch.amax(comm.all_gather(m[None], group, 0), dim=0)
    p = torch.exp(logits - m_all)
    part = torch.cat([torch.einsum("bhgqk,bkhd->bhgqd", p, v.float()),
                      p.sum(-1, keepdim=True)], dim=-1)
    total = comm.all_reduce(part, group, "cache_all_reduce")
    out = total[..., :-1] / total[..., -1:]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, nq, v.shape[-1]).to(v.dtype)


def _row_update(cache, rows, idx, impl=None):
    """Write ``rows [B,K,...]`` at ``cache[b, idx[b]:idx[b]+K]`` in place,
    touching only those rows (the CUDA kernel on the GPU)."""
    return inplace_row_update(cache, rows, idx, impl=impl)


class KVCache:
    """Decode KV cache: full-length buffers plus a per-slot write index.

    Prefill fills [0, prefill_len); each autoregressive step writes one row
    per slot at that slot's ``cache_index`` and advances it. With
    ``quantize`` the values are int8 and ``key_scale``/``value_scale`` hold
    per-(position, head) float32 scales ``[B, S, nkv]``. All updates are in
    place; :meth:`update` returns the buffers themselves.

    ``seq_split`` (a ``parallel/tensor.Split`` over ``context_autoregressive``):
    this rank holds rows ``[row0, row0 + rows)`` of the ``max_length`` rows
    (``cache_index`` stays global), plus one spare row at the end that takes
    the decode writes of the rows other ranks own, so that the row kernel K2
    writes every slot without a branch; the attention reads the first
    ``rows`` only.
    """

    LEAVES = ("cached_key", "cached_value", "cache_index", "cached_segment_ids",
              "key_scale", "value_scale")

    def __init__(self, batch: int, max_length: int, num_kv_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.bfloat16, quantize: bool = False, device=None,
                 seq_split=None):
        self.max_length = max_length
        self.quantize = quantize
        self.dtype = dtype
        self.seq_split = seq_split
        self.row0, self.rows = 0, max_length
        if seq_split is not None:
            if max_length % seq_split.size:
                raise ValueError(f"a {max_length}-row cache does not split over "
                                 f"{seq_split.size} ranks")
            self.row0, _ = seq_split.bounds(max_length)
            self.rows = max_length // seq_split.size
            max_length = self.rows + 1  # the spare row
        shape = (batch, max_length, num_kv_heads, head_dim)
        store = torch.int8 if quantize else dtype
        self.cached_key = torch.zeros(shape, dtype=store, device=device)
        self.cached_value = torch.zeros(shape, dtype=store, device=device)
        self.cache_index = torch.zeros((batch,), dtype=torch.int32, device=device)
        self.cached_segment_ids = torch.zeros(
            (batch, max_length), dtype=torch.int32, device=device)
        self.key_scale = self.value_scale = None
        if quantize:
            sshape = (batch, max_length, num_kv_heads)
            self.key_scale = torch.ones(sshape, dtype=torch.float32, device=device)
            self.value_scale = torch.ones(sshape, dtype=torch.float32, device=device)

    def leaves(self) -> dict[str, torch.Tensor]:
        return {n: getattr(self, n) for n in self.LEAVES if getattr(self, n) is not None}

    def _whole(self, what: str) -> None:
        if self.seq_split is not None:
            raise ValueError(f"{what} takes a cache whose rows are not split over ranks")

    def copy_rows(self, start: int, n: int) -> "KVCache":
        """A new batch-1 cache of ``n`` rows holding rows [start, start+n) of
        batch row 0, all valid: a prefix of its own (no storage shared)."""
        self._whole("copy_rows")
        _, _, nkv, d = self.cached_key.shape
        out = KVCache(1, n, nkv, d, self.dtype, self.quantize, self.cached_key.device)
        for name in ("cached_key", "cached_value", "key_scale", "value_scale"):
            src = getattr(self, name)
            if src is not None:
                getattr(out, name)[0] = src[0, start:start + n]
        out.cached_segment_ids.fill_(1)
        out.cache_index.fill_(n)
        return out

    def load_rows(self, src: "KVCache", n: int) -> None:
        """Take rows [0, n) of ``src`` (a cache of as many rows, or more) as
        this cache's first ``n`` valid rows; the write index goes to ``n``."""
        self._whole("load_rows")
        for name in ("cached_key", "cached_value", "key_scale", "value_scale"):
            dst = getattr(self, name)
            if dst is not None:
                dst[:, :n] = getattr(src, name)[:, :n]
        self.cached_segment_ids[:, :n] = 1
        self.cached_segment_ids[:, n:] = 0
        self.cache_index.fill_(n)

    def insert_rows(self, src: "KVCache", slot: int, start: int, length: int) -> None:
        """Rows [start, start+length) of ``src``'s batch row 0 into rows [0,
        length) of ``slot``; the slot's segment ids and write index reset.
        Touches only this slot, in place (a split cache: the rows it owns)."""
        lo = min(max(length - self.row0, 0), self.rows)  # rows of [0, length) held here
        a, b = start + self.row0, start + self.row0 + lo
        self.cached_key[slot, :lo] = src.cached_key[0, a:b]
        self.cached_value[slot, :lo] = src.cached_value[0, a:b]
        if self.quantize:
            self.key_scale[slot, :lo] = src.key_scale[0, a:b]
            self.value_scale[slot, :lo] = src.value_scale[0, a:b]
        self.cached_segment_ids[slot, :lo] = 1
        self.cached_segment_ids[slot, lo:] = 0
        self.cache_index[slot] = length

    def clone(self) -> "KVCache":
        out = object.__new__(KVCache)
        out.max_length, out.quantize, out.dtype = self.max_length, self.quantize, self.dtype
        out.seq_split, out.row0, out.rows = self.seq_split, self.row0, self.rows
        for n in self.LEAVES:
            t = getattr(self, n)
            setattr(out, n, None if t is None else t.clone())
        return out

    def update(self, k: torch.Tensor, v: torch.Tensor, mode: str,
               true_lengths: torch.Tensor | None = None, impl: str | None = None,
               cache_offset: int | None = None):
        """k, v: [B, S, nkv, d] new rows. ``cache_offset`` (prefill): this
        chunk's first row (chunked prefill on top of the rows cached so far).
        Returns (cached_key, cached_value, cached_segment_ids, cache_index,
        scales-or-None)."""
        b = k.shape[0]
        k_scale = v_scale = None
        if self.quantize:
            k, k_scale = quantize_kv(k)
            v, v_scale = quantize_kv(v)
        store = self.cached_key.dtype

        if self.seq_split is not None and mode != MODE_AUTOREGRESSIVE:
            raise ValueError(f"a cache split over context_autoregressive takes decode steps "
                             f"only, not mode {mode!r} (prefill fills a whole prefix cache)")
        if mode == MODE_PREFILL:
            n = k.shape[1]
            off = int(cache_offset or 0)
            if off + n > self.max_length:
                raise ValueError(f"prefill rows [{off}, {off + n}) past a {self.max_length}-row "
                                 "cache")
            if true_lengths is None:
                true_lengths = torch.full((b,), n, dtype=torch.int32, device=k.device)
            self.cached_key[:, off:off + n] = k.to(store)
            self.cached_value[:, off:off + n] = v.to(store)
            if self.quantize:
                self.key_scale[:, off:off + n] = k_scale
                self.value_scale[:, off:off + n] = v_scale
            # [0, off) was made valid by the earlier chunks; arange < end covers it
            end = off + true_lengths.to(torch.int32)
            pos = torch.arange(self.max_length, dtype=torch.int32, device=k.device)
            self.cached_segment_ids.copy_((pos[None, :] < end[:, None]).to(torch.int32))
            self.cache_index.copy_(end)
        elif mode == MODE_VERIFY:
            # k, v are [B, K+1, nkv, d]: the span at each slot's cache_index
            # through K2; cache_index stays (the engine sets it after acceptance)
            pos = self.cache_index
            _row_update(self.cached_key, k, pos, impl)
            _row_update(self.cached_value, v, pos, impl)
            if self.quantize:
                _row_update(self.key_scale, k_scale, pos, impl)
                _row_update(self.value_scale, v_scale, pos, impl)
            span = torch.arange(k.shape[1], device=k.device)
            offs = torch.clamp(pos.long()[:, None] + span[None, :], max=self.max_length - 1)
            # the value a device tensor: a host number is a copy a CUDA graph cannot take
            self.cached_segment_ids.index_put_(
                (torch.arange(b, device=k.device)[:, None], offs),
                torch.ones_like(offs, dtype=torch.int32))
        elif mode == MODE_AUTOREGRESSIVE:
            # k, v are [B, 1, nkv, d]; one row per slot at its own position
            pos = self.cache_index
            if self.seq_split is not None:
                # this rank's row of the position, or the spare row where
                # another rank owns it
                local = pos - self.row0
                pos = torch.where((local >= 0) & (local < self.rows), local,
                                  torch.full_like(local, self.rows))
            _row_update(self.cached_key, k, pos, impl)
            _row_update(self.cached_value, v, pos, impl)
            if self.quantize:
                _row_update(self.key_scale, k_scale, pos, impl)
                _row_update(self.value_scale, v_scale, pos, impl)
            # a slot nobody released keeps stepping: clamp the marker too (an
            # index past the cache is an illegal address on CUDA)
            rows = torch.arange(b, device=k.device)
            self.cached_segment_ids.index_put_(
                (rows, torch.clamp(pos.long(), max=self.cached_segment_ids.shape[1] - 1)),
                torch.ones_like(pos))
            self.cache_index += 1
        else:
            raise ValueError(f"unknown KVCache mode {mode!r}")

        scales = (self.key_scale, self.value_scale) if self.quantize else None
        if self.seq_split is not None:  # the rows held, without the spare one
            n = self.rows
            return (self.cached_key[:, :n], self.cached_value[:, :n],
                    self.cached_segment_ids[:, :n], self.cache_index,
                    None if scales is None else tuple(t[:, :n] for t in scales))
        return (self.cached_key, self.cached_value, self.cached_segment_ids,
                self.cache_index, scales)


_FREQ_CACHE: dict = {}


def rope_frequencies_cached(head_dim, rope_type, max_timescale, factor, low, high, orig):
    key = (head_dim, rope_type, max_timescale, factor, low, high, orig)
    if key not in _FREQ_CACHE:
        _FREQ_CACHE[key] = rope_lib.rope_frequencies(
            head_dim, rope_type, max_timescale, factor, low, high, orig
        )
    return _FREQ_CACHE[key]


class Attention(nn.Module):
    """Multi-head / grouped-query attention with RoPE and cached decode."""

    def __init__(
        self,
        emb_dim: int,
        num_query_heads: int,
        num_kv_heads: int,
        head_dim: int,
        max_target_length: int = 2048,
        attention_kernel: str = "autoselected",  # autoselected | dot_product | flash
        decode_attention: str = "dot_product",  # dot_product | bucketed | ragged
        dtype: torch.dtype = torch.bfloat16,
        weight_dtype: torch.dtype = torch.float32,
        float32_qk_product: bool = False,
        attn_logits_soft_cap: float = 0.0,
        sliding_window_size: int = 0,
        chunk_attn_window_size: int = 0,
        rope_type: str = "default",
        rope_interleave: bool = False,
        rope_max_timescale: float = 10_000.0,
        rope_factor: float = 8.0,
        rope_low_freq_factor: float = 1.0,
        rope_high_freq_factor: float = 4.0,
        rope_original_max_position: int = 8192,
        use_qk_norm: bool = False,
        qk_norm_scale_plus_one: bool = False,
        qk_norm_type: str = "rms",
        use_temperature_tuning: bool = False,
        attn_temperature_scale: float = 0.1,
        attn_temperature_floor_scale: float = 8192.0,
        query_pre_attn_scalar: float | None = None,
        normalization_layer_epsilon: float = 1e-6,
        use_bias: bool = False,
        quantization: str = "",
        quantize_kvcache: bool = False,
        lora_rank: int = 0,
        context_parallelism: bool = False,  # training: the mesh's "context" or "sequence" axis
        context_parallel_algorithm: str = "allgather",  # allgather | ring | ulysses
        device=None,
    ):
        super().__init__()
        self.tp = None  # parallel/tensor.Split of a tensor-split model
        self.context_parallelism = context_parallelism
        self.context_parallel_algorithm = context_parallel_algorithm
        if attention_kernel not in ("autoselected", "dot_product", "flash"):
            raise ValueError(f"unknown attention kernel {attention_kernel!r}")
        if decode_attention not in ("dot_product", "bucketed", "ragged"):
            raise ValueError(f"unknown decode_attention {decode_attention!r}")
        if use_qk_norm and qk_norm_type not in ("rms", "l2"):
            raise ValueError(f"unknown qk_norm_type {qk_norm_type!r}")

        self.num_query_heads = num_query_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.max_target_length = max_target_length
        self.attention_kernel = attention_kernel
        self.decode_attention = decode_attention
        self.dtype = dtype
        self.float32_qk_product = float32_qk_product
        self.attn_logits_soft_cap = attn_logits_soft_cap
        self.sliding_window_size = sliding_window_size
        self.chunk_attn_window_size = chunk_attn_window_size
        self.rope_interleave = rope_interleave
        self.query_pre_attn_scalar = query_pre_attn_scalar
        self.quantize_kvcache = quantize_kvcache
        self.l2_qk_norm = use_qk_norm and qk_norm_type == "l2"
        self.normalization_layer_epsilon = normalization_layer_epsilon
        self.use_temperature_tuning = use_temperature_tuning
        self.attn_temperature_scale = attn_temperature_scale
        self.attn_temperature_floor_scale = attn_temperature_floor_scale
        # a buffer, so it lives on the module's device (a numpy array would be
        # copied from the host on every call); not part of the state dict
        inv_freq = None
        if rope_type != "none":
            inv_freq = torch.as_tensor(rope_frequencies_cached(
                head_dim, rope_type, rope_max_timescale, rope_factor,
                rope_low_freq_factor, rope_high_freq_factor, rope_original_max_position,
            ), device=device)
        self.register_buffer("inv_freq", inv_freq, persistent=False)

        dense = dict(dtype=dtype, weight_dtype=weight_dtype, use_bias=use_bias,
                     quantization=quantization, device=device)
        col = dict(parallel="column", **dense)
        self.query = DenseGeneral(emb_dim, (num_query_heads, head_dim),
                                  lora_rank=lora_rank, **col)
        self.key = DenseGeneral(emb_dim, (num_kv_heads, head_dim), **col)
        self.value = DenseGeneral(emb_dim, (num_kv_heads, head_dim),
                                  lora_rank=lora_rank, **col)
        self.out = DenseGeneral((num_query_heads, head_dim), emb_dim, axis=(-2, -1),
                                parallel="row", **dense)
        self.query_norm = self.key_norm = None
        if use_qk_norm and qk_norm_type == "rms":
            norm = dict(epsilon=normalization_layer_epsilon, dtype=dtype,
                        weight_dtype=weight_dtype, scale_plus_one=qk_norm_scale_plus_one,
                        device=device)
            self.query_norm = RMSNorm(head_dim, **norm)
            self.key_norm = RMSNorm(head_dim, **norm)

    @property
    def local_kv_heads(self) -> int:
        """The kv heads this rank holds (all of them without a tensor split)."""
        return self.num_kv_heads if self.tp is None else self.tp.chunk(self.num_kv_heads)

    def init_cache(self, batch: int, max_length: int | None = None, device=None,
                   seq_split=None) -> KVCache:
        """``seq_split``: the decode cache's rows split over
        ``context_autoregressive`` (:class:`KVCache`)."""
        return KVCache(batch, max_length or self.max_target_length, self.local_kv_heads,
                       self.head_dim, self.dtype, self.quantize_kvcache,
                       device if device is not None else self.query.kernel.device,
                       seq_split=seq_split)

    def init_paged_cache(self, num_pages: int, tokens_per_page: int,
                         device=None) -> PagedKVCache:
        """This layer's page pools ``[num_pages, tokens_per_page, nkv, d]``."""
        return init_paged_cache(num_pages, tokens_per_page, self.local_kv_heads, self.head_dim,
                                self.dtype,
                                device if device is not None else self.query.kernel.device)

    def forward(
        self,
        inputs_q: torch.Tensor,  # [B, S, E]
        inputs_kv: torch.Tensor,
        positions: torch.Tensor,  # [B, S]
        segment_ids: torch.Tensor | None,
        mode: str = MODE_TRAIN,
        cache: KVCache | PagedKVCache | None = None,
        impl: str | None = None,  # "plain": the kernels' plain versions (comparisons only)
        paged_step=None,  # infer.paged_attention.PagedDecodeStep, with a PagedKVCache
        cache_offset: int | None = None,  # chunked prefill: this chunk's first position
        decode_width: int | None = None,  # bucketed decode: the cache prefix read
    ) -> torch.Tensor:
        if mode == MODE_TRAIN:
            return self.out(self.attend(inputs_q, inputs_kv, positions, segment_ids, impl))
        if mode not in (MODE_PREFILL, MODE_AUTOREGRESSIVE, MODE_VERIFY):
            raise ValueError(f"unknown attention mode {mode!r}")
        if cache is None:
            raise ValueError(f"mode {mode!r} needs a KVCache")
        q, k, v = self._project(inputs_q, inputs_kv, positions)
        if isinstance(cache, PagedKVCache):
            return self.out(self._paged_decode(q, k, v, mode, cache, paged_step, impl))
        true_lengths = None
        if mode == MODE_PREFILL and segment_ids is not None:
            true_lengths = torch.sum((segment_ids != 0).to(torch.int32), dim=1)
        ck, cv, cseg, cidx, kv_scales = cache.update(k, v, mode, true_lengths, impl,
                                                      cache_offset)

        if mode == MODE_PREFILL and cache_offset is None:
            # attend only within the prefill segment(s)
            out = self._masked_attention(q, k, v, positions, segment_ids)
        elif mode != MODE_AUTOREGRESSIVE:
            # a prefill chunk (over everything cached so far, causal against
            # its global positions) or the verify span (over the whole cache)
            kv_positions = torch.arange(cache.max_length, dtype=torch.int32, device=q.device)
            kp, qp = kv_positions[None, None, :], positions[:, :, None]
            mask = kp <= qp
            if mode == MODE_PREFILL:
                mask = mask & (cseg[:, None, :] > 0)
            if self.sliding_window_size > 0:
                mask = mask & (kp > qp - self.sliding_window_size)
            if self.chunk_attn_window_size > 0:
                mask = mask & (kp // self.chunk_attn_window_size
                               == qp // self.chunk_attn_window_size)
            dk, dv = self._dequantized(ck, cv, kv_scales)
            out = dot_product_attention(q, dk, dv, mask[:, None], self.attn_logits_soft_cap,
                                        self.float32_qk_product)
        elif (
            self.decode_attention == "ragged"
            and self.chunk_attn_window_size == 0
            and self.attn_logits_soft_cap == 0.0
        ):
            # positions < cidx always hold real tokens of this slot: the
            # kernel reads only those rows; int8 stays int8 in memory
            scales = kv_scales or (None, None)
            out = ragged_decode_attention_v2(
                q[:, 0], ck, cv, cidx, sliding_window=self.sliding_window_size,
                k_scale=scales[0], v_scale=scales[1], impl=impl,
            ).to(q.dtype)[:, None]
        else:
            # dot_product reads the whole cache, bucketed its first
            # ``decode_width`` rows (masked rows add nothing: the same function)
            width = cache.max_length
            if self.decode_attention == "bucketed" and decode_width is not None:
                width = min(int(decode_width), width)
            out = self._masked_decode(q, ck[:, :width], cv[:, :width], cseg[:, :width], cidx,
                                      None if kv_scales is None
                                      else tuple(t[:, :width] for t in kv_scales),
                                      cache.row0, cache.seq_split)
        return self.out(out)

    def _dequantized(self, ck, cv, kv_scales):
        if kv_scales is None:
            return ck, cv
        return (dequantize_kv(ck, kv_scales[0], self.dtype),
                dequantize_kv(cv, kv_scales[1], self.dtype))

    def _masked_decode(self, q, ck, cv, cseg, cidx, kv_scales, row0: int = 0, seq_split=None):
        """One query a slot against the cache rows it holds (``< cidx``), the
        window and the chunk: a masked product over ``ck``'s rows (whose
        first is position ``row0``; with ``seq_split`` the ranks' partial
        softmaxes are merged)."""
        kv_positions = row0 + torch.arange(ck.shape[1], dtype=torch.int32,
                                           device=q.device)[None, :]
        nxt = cidx[:, None]  # next write position; the query sits at nxt-1
        valid = kv_positions < nxt
        if self.sliding_window_size > 0:
            valid &= kv_positions > (nxt - 1) - self.sliding_window_size
        if self.chunk_attn_window_size > 0:
            valid &= (kv_positions // self.chunk_attn_window_size) == (
                (nxt - 1) // self.chunk_attn_window_size
            )
        valid &= cseg > 0
        dk, dv = self._dequantized(ck, cv, kv_scales)
        if seq_split is not None:
            return merge_partial_attention(q, dk, dv, valid[:, None, None, :],
                                           self.attn_logits_soft_cap, self.float32_qk_product,
                                           seq_split.group)
        return dot_product_attention(
            q, dk, dv, valid[:, None, None, :], self.attn_logits_soft_cap,
            self.float32_qk_product,
        )

    def _paged_decode(self, q, k, v, mode, cache, step, impl):
        """One token per slot against the page pools: write it at row
        ``seq_lens - 1`` of its slot, then attend over ``seq_lens`` rows."""
        if mode != MODE_AUTOREGRESSIVE:
            raise ValueError(f"a paged cache serves decode steps only, not mode {mode!r}")
        if step is None:
            raise ValueError("paged decode needs the engine's PagedDecodeStep")
        if self.sliding_window_size or self.chunk_attn_window_size:
            raise ValueError("paged decode supports global causal attention only")
        write_rows(cache, step.rows, k[:, 0], v[:, 0], step.live)
        state = step.page_state
        if q.device.type == "cuda" and self.attn_logits_soft_cap == 0.0:
            return paged_decode_attention_v2(
                q[:, 0], cache.key_pages, cache.value_pages, state.page_map, state.seq_lens,
                impl=impl,
            )[:, None]
        return paged_decode_attention(q, cache, state, self.attn_logits_soft_cap)

    def _project(self, inputs_q, inputs_kv, positions):
        """q, k, v [B, S, N, D]: projections, qk-norm, RoPE, gemma's q scale
        (this rank's heads under a tensor split)."""
        if self.tp is not None:
            same = inputs_kv is inputs_q
            inputs_q = self.tp.enter(inputs_q)
            inputs_kv = inputs_q if same else self.tp.enter(inputs_kv)
        q = self.query(inputs_q)
        k = self.key(inputs_kv)
        v = self.value(inputs_kv)

        if self.query_norm is not None:
            q = self.query_norm(q)
            k = self.key_norm(k)

        if self.inv_freq is not None:
            sin_cos = rope_lib.rope_sin_cos(positions, self.inv_freq)  # once for q and k
            q = rope_lib.apply_rope(q, None, None, self.rope_interleave, sin_cos=sin_cos)
            k = rope_lib.apply_rope(k, None, None, self.rope_interleave, sin_cos=sin_cos)

        if self.l2_qk_norm:
            # llama4: parameter-free L2 (an rms norm without scale) AFTER rope
            q, k = self._l2(q), self._l2(k)

        if self.use_temperature_tuning:
            # llama4 NoPE layers: q times log1p(floor((pos + 1) / floor)) * scale + 1
            pos = positions.float() + 1.0
            floor = torch.floor(pos / torch.full_like(pos, self.attn_temperature_floor_scale))
            scales = torch.log1p(floor) * self.attn_temperature_scale + 1.0
            q = q * scales[..., None, None].to(q.dtype)

        if self.query_pre_attn_scalar is not None:
            # gemma semantics: scores = qk / sqrt(query_pre_attn_scalar)
            q = q * (math.sqrt(self.head_dim) / math.sqrt(self.query_pre_attn_scalar))
        return q, k, v

    def _l2(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        return (x32 * torch.rsqrt(torch.mean(torch.square(x32), dim=-1, keepdim=True)
                                  + self.normalization_layer_epsilon)).to(x.dtype)

    def attend(self, inputs_q, inputs_kv, positions, segment_ids, impl: str | None = None):
        """The training forward up to the output projection, in ``dtype``:
        the ``attn_out`` remat anchor (``models/decoder.py``)."""
        q, k, v = self._project(inputs_q, inputs_kv, positions)
        return self._train_attention(q, k, v, positions, segment_ids, impl).to(self.dtype)

    def _train_attention(self, q, k, v, positions, segment_ids, impl=None):
        kernel = self.attention_kernel
        if kernel == "autoselected":
            kernel = "flash" if (q.device.type == "cuda" and q.shape[1] >= 1024) \
                else "dot_product"
        mesh = current_mesh() if self.context_parallelism else None
        if kernel == "flash":
            return flash_attention_sharded(
                q, k, v, segment_ids, mesh=mesh, positions=positions, causal=True,
                sliding_window=self.sliding_window_size,
                chunk_size=self.chunk_attn_window_size,
                logits_soft_cap=self.attn_logits_soft_cap,
                algorithm=self.context_parallel_algorithm, impl=impl)
        axis = None if mesh is None else sequence_axis(mesh)
        if axis is not None:
            # this rank's queries against the whole sequence's keys
            group = mesh.group(axis)
            k, v = (comm.AllGather.apply(t, group, 1) for t in (k, v))
            kv_pos, kv_seg = (None if t is None else comm.all_gather(t, group, 1)
                              for t in (positions, segment_ids))
            return self._masked_attention(q, k, v, positions, segment_ids, kv_pos, kv_seg)
        return self._masked_attention(q, k, v, positions, segment_ids)

    def _masked_attention(self, q, k, v, positions, segment_ids, kv_positions=None,
                          kv_segment_ids=None):
        kv_positions = positions if kv_positions is None else kv_positions
        kv_segment_ids = segment_ids if kv_segment_ids is None else kv_segment_ids
        mask = make_attention_mask(
            positions, kv_positions, segment_ids, kv_segment_ids, causal=True,
            sliding_window=self.sliding_window_size, chunk_size=self.chunk_attn_window_size,
        )
        return dot_product_attention(
            q, k, v, mask, self.attn_logits_soft_cap, self.float32_qk_product
        )
