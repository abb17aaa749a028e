"""Attention: projections, RoPE, mask generation, decode kernel dispatch, KV cache.

Counterpart of the JAX package's ``models/attention.py`` for the serving
slice: ``MODE_TRAIN`` and ``MODE_PREFILL`` compute attention with plain
einsum/softmax (as the JAX serving path does outside any kernel), and
``MODE_AUTOREGRESSIVE`` takes ``decode_attention`` ``dot_product`` or
``ragged`` (the hand-written CUDA kernel of ``ops/ragged_decode_attention``).

The KV cache is explicit state: a :class:`KVCache` per layer, handed to the
module and UPDATED IN PLACE (the JAX package threads it through as a flax
variable collection and returns new arrays).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from maxtext_indextts2_tpu_torch.models import rope as rope_lib
from maxtext_indextts2_tpu_torch.models.layers import DenseGeneral, RMSNorm, _unsupported
from maxtext_indextts2_tpu_torch.ops.inplace_update import inplace_row_update
from maxtext_indextts2_tpu_torch.ops.quantization import dequantize_kv, quantize_kv
from maxtext_indextts2_tpu_torch.ops.ragged_decode_attention import (
    ragged_decode_attention_v2,
)

# Large negative for masked logits.
DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

MODE_TRAIN = "train"
MODE_PREFILL = "prefill"
MODE_AUTOREGRESSIVE = "autoregressive"
MODE_VERIFY = "verify"  # speculative verify pass: not ported


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
    b, sq, nq, d = q.shape
    nkv = k.shape[2]
    group = nq // nkv
    q = q.reshape(b, sq, nkv, group, d)

    qk_dtype = torch.float32 if float32_qk else q.dtype
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.to(qk_dtype), k.to(qk_dtype)).float()
    logits = logits / math.sqrt(d)
    if logits_soft_cap > 0.0:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    if mask is not None:
        logits = torch.where(
            mask[:, :, None, :, :], logits, torch.full_like(logits, DEFAULT_MASK_VALUE)
        )
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, nq, v.shape[-1]).to(v.dtype)


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
    """

    LEAVES = ("cached_key", "cached_value", "cache_index", "cached_segment_ids",
              "key_scale", "value_scale")

    def __init__(self, batch: int, max_length: int, num_kv_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.bfloat16, quantize: bool = False, device=None):
        self.max_length = max_length
        self.quantize = quantize
        self.dtype = dtype
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

    def clone(self) -> "KVCache":
        out = object.__new__(KVCache)
        out.max_length, out.quantize, out.dtype = self.max_length, self.quantize, self.dtype
        for n in self.LEAVES:
            t = getattr(self, n)
            setattr(out, n, None if t is None else t.clone())
        return out

    def update(self, k: torch.Tensor, v: torch.Tensor, mode: str,
               true_lengths: torch.Tensor | None = None, impl: str | None = None):
        """k, v: [B, S, nkv, d] new rows. Returns (cached_key, cached_value,
        cached_segment_ids, cache_index, scales-or-None)."""
        b = k.shape[0]
        k_scale = v_scale = None
        if self.quantize:
            k, k_scale = quantize_kv(k)
            v, v_scale = quantize_kv(v)
        store = self.cached_key.dtype

        if mode == MODE_PREFILL:
            n = k.shape[1]
            if true_lengths is None:
                true_lengths = torch.full((b,), n, dtype=torch.int32, device=k.device)
            self.cached_key[:, :n] = k.to(store)
            self.cached_value[:, :n] = v.to(store)
            if self.quantize:
                self.key_scale[:, :n] = k_scale
                self.value_scale[:, :n] = v_scale
            pos = torch.arange(self.max_length, dtype=torch.int32, device=k.device)
            self.cached_segment_ids.copy_(
                (pos[None, :] < true_lengths[:, None]).to(torch.int32))
            self.cache_index.copy_(true_lengths.to(torch.int32))
        elif mode == MODE_AUTOREGRESSIVE:
            # k, v are [B, 1, nkv, d]; one row per slot at its own position
            pos = self.cache_index
            _row_update(self.cached_key, k, pos, impl)
            _row_update(self.cached_value, v, pos, impl)
            if self.quantize:
                _row_update(self.key_scale, k_scale, pos, impl)
                _row_update(self.value_scale, v_scale, pos, impl)
            # a slot nobody released keeps stepping: clamp the marker too (an
            # index past the cache is an illegal address on CUDA)
            rows = torch.arange(b, device=k.device)
            self.cached_segment_ids[
                rows, torch.clamp(pos.long(), max=self.max_length - 1)] = 1
            self.cache_index += 1
        else:
            _unsupported(f"KVCache mode {mode!r} (speculative verify span)",
                         "5, decode extras")

        scales = (self.key_scale, self.value_scale) if self.quantize else None
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
        attention_kernel: str = "autoselected",  # autoselected | dot_product
        decode_attention: str = "dot_product",  # dot_product | ragged
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
        query_pre_attn_scalar: float | None = None,
        normalization_layer_epsilon: float = 1e-6,
        use_bias: bool = False,
        quantization: str = "",
        quantize_kvcache: bool = False,
        lora_rank: int = 0,
        paged_attention: bool = False,
        device=None,
    ):
        super().__init__()
        if paged_attention:
            _unsupported("paged_attention (page-table decode kernel)", "5, decode extras")
        if attention_kernel == "flash":
            _unsupported("attention=flash (training flash-attention kernels)",
                         "4, training step")
        if attention_kernel not in ("autoselected", "dot_product"):
            raise ValueError(f"unknown attention kernel {attention_kernel!r}")
        if decode_attention == "bucketed":
            _unsupported("decode_attention=bucketed", "5, decode extras")
        if decode_attention not in ("dot_product", "ragged"):
            raise ValueError(f"unknown decode_attention {decode_attention!r}")
        if use_qk_norm and qk_norm_type != "rms":
            _unsupported(f"qk_norm_type={qk_norm_type!r} (llama4)", "6, other model families")
        if use_temperature_tuning:
            _unsupported("attention temperature tuning (llama4)", "6, other model families")

        self.num_query_heads = num_query_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.max_target_length = max_target_length
        self.decode_attention = decode_attention
        self.dtype = dtype
        self.float32_qk_product = float32_qk_product
        self.attn_logits_soft_cap = attn_logits_soft_cap
        self.sliding_window_size = sliding_window_size
        self.chunk_attn_window_size = chunk_attn_window_size
        self.rope_interleave = rope_interleave
        self.query_pre_attn_scalar = query_pre_attn_scalar
        self.quantize_kvcache = quantize_kvcache
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
        self.query = DenseGeneral(emb_dim, (num_query_heads, head_dim),
                                  lora_rank=lora_rank, **dense)
        self.key = DenseGeneral(emb_dim, (num_kv_heads, head_dim), **dense)
        self.value = DenseGeneral(emb_dim, (num_kv_heads, head_dim),
                                  lora_rank=lora_rank, **dense)
        self.out = DenseGeneral((num_query_heads, head_dim), emb_dim, axis=(-2, -1), **dense)
        self.query_norm = self.key_norm = None
        if use_qk_norm:
            norm = dict(epsilon=normalization_layer_epsilon, dtype=dtype,
                        weight_dtype=weight_dtype, scale_plus_one=qk_norm_scale_plus_one,
                        device=device)
            self.query_norm = RMSNorm(head_dim, **norm)
            self.key_norm = RMSNorm(head_dim, **norm)

    def init_cache(self, batch: int, max_length: int | None = None, device=None) -> KVCache:
        return KVCache(batch, max_length or self.max_target_length, self.num_kv_heads,
                       self.head_dim, self.dtype, self.quantize_kvcache,
                       device if device is not None else self.query.kernel.device)

    def forward(
        self,
        inputs_q: torch.Tensor,  # [B, S, E]
        inputs_kv: torch.Tensor,
        positions: torch.Tensor,  # [B, S]
        segment_ids: torch.Tensor | None,
        mode: str = MODE_TRAIN,
        cache: KVCache | None = None,
        impl: str | None = None,  # "plain": the kernels' plain versions (comparisons only)
    ) -> torch.Tensor:
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

        if self.query_pre_attn_scalar is not None:
            # gemma semantics: scores = qk / sqrt(query_pre_attn_scalar)
            q = q * (math.sqrt(self.head_dim) / math.sqrt(self.query_pre_attn_scalar))

        if mode == MODE_TRAIN:
            out = self._masked_attention(q, k, v, positions, segment_ids).to(self.dtype)
        elif mode in (MODE_PREFILL, MODE_AUTOREGRESSIVE):
            if cache is None:
                raise ValueError(f"mode {mode!r} needs a KVCache")
            true_lengths = None
            if mode == MODE_PREFILL and segment_ids is not None:
                true_lengths = torch.sum((segment_ids != 0).to(torch.int32), dim=1)
            ck, cv, cseg, cidx, kv_scales = cache.update(k, v, mode, true_lengths, impl)

            if mode == MODE_PREFILL:
                # attend only within the prefill segment(s)
                out = self._masked_attention(q, k, v, positions, segment_ids)
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
                s_len = cache.max_length
                kv_positions = torch.arange(s_len, dtype=torch.int32, device=q.device)[None, :]
                nxt = cidx[:, None]  # next write position; the query sits at nxt-1
                valid = kv_positions < nxt
                if self.sliding_window_size > 0:
                    valid &= kv_positions > (nxt - 1) - self.sliding_window_size
                if self.chunk_attn_window_size > 0:
                    valid &= (kv_positions // self.chunk_attn_window_size) == (
                        (nxt - 1) // self.chunk_attn_window_size
                    )
                valid &= cseg > 0
                if kv_scales is not None:
                    dk = dequantize_kv(ck, kv_scales[0], self.dtype)
                    dv = dequantize_kv(cv, kv_scales[1], self.dtype)
                else:
                    dk, dv = ck, cv
                out = dot_product_attention(
                    q, dk, dv, valid[:, None, None, :], self.attn_logits_soft_cap,
                    self.float32_qk_product,
                )
        else:
            _unsupported(f"attention mode {mode!r} (speculative verify)", "5, decode extras")

        return self.out(out)

    def _masked_attention(self, q, k, v, positions, segment_ids):
        mask = make_attention_mask(
            positions, positions, segment_ids, segment_ids, causal=True,
            sliding_window=self.sliding_window_size, chunk_size=self.chunk_attn_window_size,
        )
        return dot_product_attention(
            q, k, v, mask, self.attn_logits_soft_cap, self.float32_qk_product
        )
