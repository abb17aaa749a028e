"""Multi-head Latent Attention (DeepSeek V2 / V3).

Counterpart of the JAX package's ``models/mla.py`` (``MLAttention``), with its
parameter names: queries through ``wq`` (or the low-rank ``wq_a`` ->
``q_norm`` -> ``wq_b`` when ``q_lora_rank > 0``); keys and values through the
compressed latent ``wkv_a`` -> (``c_kv`` normed by ``kv_norm``, the shared
rope key ``k_pe``), interleaved RoPE on the rope parts, and the per-head
expansion ``wkv_b`` of the latent into the no-rope key and the value (whose
head dim ``v_head_dim`` differs from the query's); the yarn scale folded into
q; the einsum attention of ``models/attention.py``; ``out``.

Decode caches the COMPRESSED latent, not the expanded K/V: a
:class:`LatentCache` per layer holds ``cached_ckv [B, S, kv_lora_rank]``,
``cached_kpe [B, S, d_rope]`` and ``cache_index`` (the JAX module's cache
variables), and each step expands the cache through ``wkv_b``. It keeps the
``KVCache`` protocol (``leaves``, ``copy_rows``, ``load_rows``, ``clone``,
``insert_rows``, ``update``), so the engine's insert, the prefix cache,
chunked and packed prefill and the speculative verify serve it unchanged.
Rows are written in place, by the row-update kernel K2 (``ops/inplace_update``)
for a decode step and the verify span.

Prefill attends within its segments over its own rows (what the JAX module
computes for one prompt: the cache rows past the prompt are masked there), so
a packed prefill of several prompts serves each one as alone; a prefill
chunk (``cache_offset``) writes its rows at the offset and attends over
everything cached so far. A paged cache has no latent layout: paged serving
of an MLA model raises.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from maxtext_indextts2_tpu_torch.config import Config
from maxtext_indextts2_tpu_torch.models import rope as rope_lib
from maxtext_indextts2_tpu_torch.models.attention import (
    MODE_AUTOREGRESSIVE,
    MODE_PREFILL,
    MODE_TRAIN,
    MODE_VERIFY,
    _row_update,
    dot_product_attention,
    make_attention_mask,
    rope_frequencies_cached,
)
from maxtext_indextts2_tpu_torch.models.layers import DenseGeneral, RMSNorm, to_dtype


class LatentCache:
    """MLA decode cache: the latent rows ``cached_ckv`` / ``cached_kpe`` of
    every slot plus a per-slot write index; a row is valid below its slot's
    ``cache_index``. All updates are in place."""

    LEAVES = ("cached_ckv", "cached_kpe", "cache_index")

    def __init__(self, batch: int, max_length: int, kv_lora_rank: int, rope_dim: int,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        self.max_length = max_length
        self.dtype = dtype
        self.cached_ckv = torch.zeros((batch, max_length, kv_lora_rank), dtype=dtype,
                                      device=device)
        self.cached_kpe = torch.zeros((batch, max_length, rope_dim), dtype=dtype, device=device)
        self.cache_index = torch.zeros((batch,), dtype=torch.int32, device=device)

    def leaves(self) -> dict[str, torch.Tensor]:
        return {n: getattr(self, n) for n in self.LEAVES}

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.leaves().values())

    def copy_rows(self, start: int, n: int) -> "LatentCache":
        """A new batch-1 cache of ``n`` rows holding rows [start, start+n) of
        batch row 0, all valid (no storage shared)."""
        out = LatentCache(1, n, self.cached_ckv.shape[2], self.cached_kpe.shape[2], self.dtype,
                          self.cached_ckv.device)
        out.cached_ckv[0] = self.cached_ckv[0, start:start + n]
        out.cached_kpe[0] = self.cached_kpe[0, start:start + n]
        out.cache_index.fill_(n)
        return out

    def load_rows(self, src: "LatentCache", n: int) -> None:
        """Rows [0, n) of ``src`` as this cache's first ``n`` valid rows."""
        self.cached_ckv[:, :n] = src.cached_ckv[:, :n]
        self.cached_kpe[:, :n] = src.cached_kpe[:, :n]
        self.cache_index.fill_(n)

    def insert_rows(self, src: "LatentCache", slot: int, start: int, length: int) -> None:
        """Rows [start, start+length) of ``src``'s batch row 0 into rows [0,
        length) of ``slot``; the slot's write index goes to ``length``."""
        self.cached_ckv[slot, :length] = src.cached_ckv[0, start:start + length]
        self.cached_kpe[slot, :length] = src.cached_kpe[0, start:start + length]
        self.cache_index[slot] = length

    def clone(self) -> "LatentCache":
        out = object.__new__(LatentCache)
        out.max_length, out.dtype = self.max_length, self.dtype
        for n in self.LEAVES:
            setattr(out, n, getattr(self, n).clone())
        return out

    def update(self, c_kv: torch.Tensor, k_pe: torch.Tensor, mode: str,
               true_lengths: torch.Tensor | None = None, impl: str | None = None,
               cache_offset: int | None = None) -> None:
        """Write ``c_kv [B, S, r]`` / ``k_pe [B, S, d_rope]``: prefill at
        ``cache_offset`` (0) with the index at offset + the true lengths; the
        verify span at each slot's index, the index left where it is; a
        decode step's row at each slot's index, the index advanced."""
        if mode == MODE_PREFILL:
            n = c_kv.shape[1]
            off = int(cache_offset or 0)
            if off + n > self.max_length:
                raise ValueError(f"prefill rows [{off}, {off + n}) past a {self.max_length}-row "
                                 "cache")
            if true_lengths is None:
                true_lengths = torch.full((c_kv.shape[0],), n, dtype=torch.int32,
                                          device=c_kv.device)
            self.cached_ckv[:, off:off + n] = c_kv.to(self.dtype)
            self.cached_kpe[:, off:off + n] = k_pe.to(self.dtype)
            self.cache_index.copy_(off + true_lengths.to(torch.int32))
        elif mode in (MODE_VERIFY, MODE_AUTOREGRESSIVE):
            _row_update(self.cached_ckv, c_kv, self.cache_index, impl)
            _row_update(self.cached_kpe, k_pe, self.cache_index, impl)
            if mode == MODE_AUTOREGRESSIVE:
                self.cache_index += 1
        else:
            raise ValueError(f"unknown LatentCache mode {mode!r}")


class MLAttention(nn.Module):
    """Multi-head latent attention with a latent decode cache."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.tp = None  # parallel/tensor.Split of a tensor-split model
        dtype, wdt = to_dtype(cfg.dtype), to_dtype(cfg.weight_dtype)
        self.dtype = dtype
        e, n = cfg.emb_dim, cfg.num_query_heads
        self.d_nope, self.d_rope, self.d_v = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                                              cfg.v_head_dim)
        self.kv_lora_rank = cfg.kv_lora_rank
        d_qk = self.d_nope + self.d_rope
        dense = dict(dtype=dtype, weight_dtype=wdt, device=device)

        def norm(features):
            return RMSNorm(features, epsilon=cfg.normalization_layer_epsilon, dtype=dtype,
                           weight_dtype=wdt, device=device)

        self.wq = self.wq_a = self.q_norm = self.wq_b = None
        col = dict(parallel="column", **dense)
        if cfg.q_lora_rank > 0:
            self.wq_a = DenseGeneral(e, cfg.q_lora_rank, **dense)
            self.q_norm = norm(cfg.q_lora_rank)
            self.wq_b = DenseGeneral(cfg.q_lora_rank, (n, d_qk), **col)
        else:
            self.wq = DenseGeneral(e, (n, d_qk), **col)
        self.wkv_a = DenseGeneral(e, cfg.kv_lora_rank + self.d_rope, **dense)
        self.kv_norm = norm(cfg.kv_lora_rank)
        self.wkv_b = DenseGeneral(cfg.kv_lora_rank, (n, self.d_nope + self.d_v), **col)
        self.out = DenseGeneral((n, self.d_v), e, axis=(-2, -1), parallel="row", **dense)
        self.register_buffer("inv_freq", torch.as_tensor(rope_frequencies_cached(
            self.d_rope, cfg.rope_type if cfg.rope_type != "none" else "default",
            cfg.rope_max_timescale, cfg.rope_factor, cfg.rope_low_freq_factor,
            cfg.rope_high_freq_factor, cfg.rope_original_max_position), device=device),
            persistent=False)
        # q is multiplied by this; the attention divides its logits by sqrt(d_qk)
        scale = 1.0 / math.sqrt(d_qk)
        if cfg.rope_type == "yarn":
            ms = rope_lib.yarn_attention_scaling(cfg.rope_factor)
            scale = scale * ms * ms
        self.q_mult = scale * math.sqrt(d_qk)

    def init_cache(self, batch: int, max_length: int | None = None, device=None) -> LatentCache:
        return LatentCache(batch, max_length or self.cfg.max_target_length, self.kv_lora_rank,
                           self.d_rope, self.dtype,
                           device if device is not None else self.wkv_a.kernel.device)

    def init_paged_cache(self, num_pages: int, tokens_per_page: int, device=None):
        raise ValueError("paged_attention=true does not serve multi-head latent attention: "
                         "its decode cache is the compressed latent (LatentCache), which has no "
                         "paged layout; serve it with paged_attention=false")

    def _split_input(self, x: torch.Tensor) -> torch.Tensor:
        """A column-split product's input passes ``comm.CopyToGroup``: the
        latents and the shared rope key are whole on every rank and feed its
        heads only."""
        if self.tp is None:
            return x
        from maxtext_indextts2_tpu_torch.parallel import comm

        return comm.copy_to_group(x, self.tp.group)

    def _project(self, x: torch.Tensor, positions: torch.Tensor):
        """(q [B, S, n, d_qk] with rope and scale, c_kv [B, S, r] normed,
        k_pe [B, S, d_rope] with rope; under a tensor split, this rank's
        heads of q, and c_kv / k_pe through ``CopyToGroup``)."""
        if self.wq is not None:
            q = self.wq(self._split_input(x))
        else:
            q = self.wq_b(self._split_input(self.q_norm(self.wq_a(x))))
        kv_a = self.wkv_a(x)
        c_kv = self.kv_norm(kv_a[..., :self.kv_lora_rank])
        k_pe = kv_a[..., self.kv_lora_rank:]
        sin_cos = rope_lib.rope_sin_cos(positions, self.inv_freq)
        q_pe = rope_lib.apply_rope(q[..., self.d_nope:], None, None, True, sin_cos=sin_cos)
        k_pe = rope_lib.apply_rope(k_pe, None, None, True, sin_cos=sin_cos)
        q = torch.cat([q[..., :self.d_nope], q_pe], dim=-1) * self.q_mult
        return q, self._split_input(c_kv), self._split_input(k_pe)

    def _expand(self, c_kv: torch.Tensor, k_pe: torch.Tensor):
        """The latent rows -> per-head keys [B, L, n, d_qk] and values [B, L, n, d_v]."""
        kv = self.wkv_b(c_kv)
        k_nope, v = kv[..., :self.d_nope], kv[..., self.d_nope:]
        k = torch.cat([k_nope, k_pe[..., None, :].expand(*k_nope.shape[:-1], self.d_rope)],
                      dim=-1)
        return k, v

    def _attention(self, q, k, v, mask):
        cfg = self.cfg
        return dot_product_attention(q, k, v, mask, cfg.attn_logits_soft_cap,
                                     cfg.float32_qk_product)

    def attend(self, inputs_q, inputs_kv, positions, segment_ids, impl: str | None = None):
        """The training forward up to ``out``: causal attention within the
        segments (the ``attn_out`` remat anchor of ``models/decoder.py``)."""
        q, c_kv, k_pe = self._project(inputs_q, positions)
        k, v = self._expand(c_kv, k_pe)
        mask = make_attention_mask(positions, positions, segment_ids, segment_ids, causal=True)
        return self._attention(q, k, v, mask).to(self.dtype)

    def forward(self, inputs_q, inputs_kv, positions, segment_ids, mode: str = MODE_TRAIN,
                cache: LatentCache | None = None, impl: str | None = None, paged_step=None,
                cache_offset: int | None = None, decode_width: int | None = None):
        if mode == MODE_TRAIN:
            return self.out(self.attend(inputs_q, inputs_kv, positions, segment_ids, impl))
        if mode not in (MODE_PREFILL, MODE_AUTOREGRESSIVE, MODE_VERIFY):
            raise ValueError(f"unknown attention mode {mode!r}")
        if not isinstance(cache, LatentCache):
            raise ValueError(f"mode {mode!r} needs a LatentCache, got {type(cache).__name__}")
        q, c_kv, k_pe = self._project(inputs_q, positions)
        true_lengths = None
        if mode == MODE_PREFILL and segment_ids is not None:
            true_lengths = torch.sum((segment_ids != 0).to(torch.int32), dim=1)
        cache.update(c_kv, k_pe, mode, true_lengths, impl, cache_offset)
        if mode == MODE_PREFILL and cache_offset is None:
            k, v = self._expand(c_kv, k_pe)
            mask = make_attention_mask(positions, positions, segment_ids, segment_ids,
                                       causal=True)
            return self.out(self._attention(q, k, v, mask))
        k, v = self._expand(cache.cached_ckv, cache.cached_kpe)
        kv_positions = torch.arange(cache.max_length, dtype=torch.int32, device=q.device)
        valid = kv_positions[None, :] < cache.cache_index[:, None]  # [B, L]
        if mode == MODE_AUTOREGRESSIVE:
            mask = valid[:, None, None, :]
        else:  # a prefill chunk or the verify span: causal on the global positions
            mask = (kv_positions[None, None, :] <= positions[:, :, None])
            if mode == MODE_PREFILL:
                mask = mask & valid[:, None, :]
            mask = mask[:, None]
        return self.out(self._attention(q, k, v, mask))
