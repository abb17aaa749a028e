"""Decoder: configurable transformer block + the unrolled layer stack.

Counterpart of the JAX package's ``models/decoder.py``. Family differences
(sandwich norms, qk-norm, sliding/global patterns) are data from
``models/registry.py``. Layers are always unrolled here (``layers_0``,
``layers_1``, ...): each layer's KV cache is its own buffer, updated in
place, which is how the JAX engine serves too; scan-stacked weights are
unstacked by ``utils/param_bridge.py``.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from maxtext_indextts2_tpu_torch.config import Config
from maxtext_indextts2_tpu_torch.models.attention import MODE_TRAIN, Attention
from maxtext_indextts2_tpu_torch.models.layers import MlpBlock, RMSNorm, _unsupported, to_dtype


def _attention_kwargs(cfg: Config, block, attention_type: str) -> dict[str, Any]:
    sliding = cfg.sliding_window_size if attention_type == "local_sliding" else 0
    chunk = cfg.chunk_attn_window_size if attention_type == "chunk" else 0
    nope = attention_type == "global_nope"
    return dict(
        emb_dim=cfg.emb_dim,
        num_query_heads=cfg.num_query_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        max_target_length=cfg.max_target_length,
        attention_kernel=cfg.attention,
        dtype=to_dtype(cfg.dtype),
        weight_dtype=to_dtype(cfg.weight_dtype),
        float32_qk_product=cfg.float32_qk_product,
        attn_logits_soft_cap=cfg.attn_logits_soft_cap,
        sliding_window_size=sliding,
        chunk_attn_window_size=chunk,
        rope_type="none" if nope else cfg.rope_type,
        rope_interleave=block.rope_interleave,
        rope_max_timescale=cfg.rope_max_timescale,
        rope_factor=cfg.rope_factor,
        rope_low_freq_factor=cfg.rope_low_freq_factor,
        rope_high_freq_factor=cfg.rope_high_freq_factor,
        rope_original_max_position=cfg.rope_original_max_position,
        use_qk_norm=block.use_qk_norm and not nope,
        qk_norm_scale_plus_one=block.rmsnorm_scale_plus_one,
        qk_norm_type=block.qk_norm_type,
        use_temperature_tuning=nope and block.attn_temperature_tuning,
        decode_attention=cfg.decode_attention,
        query_pre_attn_scalar=(
            cfg.query_pre_attn_scalar if cfg.query_pre_attn_scalar > 0
            else block.query_pre_attn_scalar
        ),
        normalization_layer_epsilon=cfg.normalization_layer_epsilon,
        use_bias=block.use_attn_bias,
        quantization=cfg.quantization,
        quantize_kvcache=cfg.quantize_kvcache,
        lora_rank=cfg.lora_rank,
        paged_attention=cfg.paged_attention,
    )


class DecoderLayer(nn.Module):
    """One stack unit: ``len(block.attention_pattern)`` transformer sub-layers."""

    def __init__(self, cfg: Config, block, device=None):
        super().__init__()
        if block.use_mla:
            _unsupported("multi-head latent attention (deepseek)", "6, other model families")
        if block.use_layer_norm:
            _unsupported("mean-centred LayerNorm blocks (gpt3)", "6, other model families")
        if cfg.num_experts > 1:
            _unsupported("mixture-of-experts layers", "6, other model families")
        self.block = block
        dtype, wdtype = to_dtype(cfg.dtype), to_dtype(cfg.weight_dtype)

        def norm():
            return RMSNorm(cfg.emb_dim, epsilon=cfg.normalization_layer_epsilon, dtype=dtype,
                           weight_dtype=wdtype, scale_plus_one=block.rmsnorm_scale_plus_one,
                           device=device)

        for i, attention_type in enumerate(block.attention_pattern):
            if block.use_pre_norm:
                setattr(self, f"pre_self_attention_norm_{i}", norm())
                setattr(self, f"pre_mlp_norm_{i}", norm())
            setattr(self, f"self_attention_{i}",
                    Attention(**_attention_kwargs(cfg, block, attention_type), device=device))
            if block.use_post_attn_norm:
                setattr(self, f"post_self_attention_norm_{i}", norm())
            setattr(self, f"mlp_{i}", MlpBlock(
                cfg.emb_dim, cfg.mlp_dim, cfg.mlp_activations, dtype=dtype,
                weight_dtype=wdtype, use_bias=block.use_mlp_bias,
                quantization=cfg.quantization, device=device))
            if block.use_post_ffw_norm:
                setattr(self, f"post_ffw_norm_{i}", norm())

    def init_cache(self, batch: int, max_length: int | None = None, device=None) -> list:
        return [getattr(self, f"self_attention_{i}").init_cache(batch, max_length, device)
                for i in range(len(self.block.attention_pattern))]

    def forward(self, x, positions, segment_ids, mode: str = MODE_TRAIN, cache=None,
                impl: str | None = None):
        block = self.block
        for i in range(len(block.attention_pattern)):
            h = getattr(self, f"pre_self_attention_norm_{i}")(x) if block.use_pre_norm else x
            attn_out = getattr(self, f"self_attention_{i}")(
                h, h, positions, segment_ids, mode=mode,
                cache=None if cache is None else cache[i], impl=impl)
            if block.use_post_attn_norm:
                attn_out = getattr(self, f"post_self_attention_norm_{i}")(attn_out)
            x = x + attn_out

            h = getattr(self, f"pre_mlp_norm_{i}")(x) if block.use_pre_norm else x
            mlp_out = getattr(self, f"mlp_{i}")(h)
            if block.use_post_ffw_norm:
                mlp_out = getattr(self, f"post_ffw_norm_{i}")(mlp_out)
            x = x + mlp_out
        return x


class Decoder(nn.Module):
    """Unrolled stack of DecoderLayers (``layers_{i}``)."""

    def __init__(self, cfg: Config, block, device=None):
        super().__init__()
        if cfg.using_pipeline_parallelism:
            _unsupported("pipeline parallelism", "6, parallelism on torch.distributed")
        group = len(block.attention_pattern)
        self.num_units = cfg.num_decoder_layers // group
        for i in range(self.num_units):
            setattr(self, f"layers_{i}", DecoderLayer(cfg, block, device=device))

    def init_cache(self, batch: int, max_length: int | None = None, device=None) -> list:
        """Per-unit list of per-sub-layer KVCaches."""
        return [getattr(self, f"layers_{i}").init_cache(batch, max_length, device)
                for i in range(self.num_units)]

    def forward(self, y: torch.Tensor, positions, segment_ids, mode: str = MODE_TRAIN,
                cache=None, impl: str | None = None) -> torch.Tensor:
        for i in range(self.num_units):
            y = getattr(self, f"layers_{i}")(
                y, positions, segment_ids, mode,
                None if cache is None else cache[i], impl)
        return y
