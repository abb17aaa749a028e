"""Decoder: configurable transformer block + the unrolled layer stack.

Counterpart of the JAX package's ``models/decoder.py``. Family differences
(sandwich norms, qk-norm, sliding/global patterns) are data from
``models/registry.py``. Layers are always unrolled here (``layers_0``,
``layers_1``, ...): each layer's KV cache is its own buffer, updated in
place, which is how the JAX engine serves too; scan-stacked weights are
unstacked by ``utils/param_bridge.py``.

Rematerialisation (``remat_policy``, training with gradients only), with
non-reentrant ``torch.utils.checkpoint``:

- ``none``: autograd keeps what it needs; nothing is recomputed.
- ``full``: one checkpoint around each layer (saves its input only).
- ``minimal``: the same, with a selective policy that saves the outputs of
  the projections (``aten.mm``: products without batch dimensions, the JAX
  policy ``checkpoint_dots_with_no_batch_dims``).
- ``save_attn_out`` / ``save_attn_and_mlp``: the layer is cut into
  checkpointed regions at the named anchors, ``attn_out`` (the attention
  output before ``out``, :meth:`Attention.attend`) and ``mlp_pre_wo`` (the
  input of ``wo``, :meth:`MlpBlock.pre_wo`); the anchors are region outputs,
  kept by the products that read them, and everything else is recomputed
  from the layer input in the backward. A kernel launched through ``ctypes``
  is invisible to a selective policy, so the anchors are region boundaries,
  not named ops. The attention backward needs the flash kernel's residuals
  (q, k, v, o, lse), which no anchor names: the attention region is
  recomputed, K9 with it (as in the JAX package, whose custom VJP residuals
  are not named either). Where JAX keeps only a unit's input, the regions keep
  each sub-layer's input (gemma2/3 and llama4 units hold several) and, after
  ``mlp_pre_wo``, a post-FFW norm's input.
- ``save_dot_except_mlp`` and ``save_qkv_proj`` are legacy names for
  ``save_attn_out``; an unknown name raises.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from maxtext_indextts2_tpu_torch.config import Config
from maxtext_indextts2_tpu_torch.models.attention import MODE_TRAIN, Attention
from maxtext_indextts2_tpu_torch.models.layers import MlpBlock, RMSNorm, to_dtype
from maxtext_indextts2_tpu_torch.unported import _unsupported


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
    )


_REMAT_POLICIES = ("full", "minimal", "save_attn_out", "save_attn_and_mlp")
_REMAT_LEGACY = {"save_dot_except_mlp": "save_attn_out", "save_qkv_proj": "save_attn_out"}


def _remat_policy(name: str | None) -> str | None:
    """The policy a ``remat_policy`` name stands for (None: no remat)."""
    if name == "none" or name is None:
        return None
    policy = _REMAT_LEGACY.get(name, name)
    if policy not in _REMAT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {name!r}; choose from "
            f"{['none', *_REMAT_POLICIES, *_REMAT_LEGACY]} (an unknown name must not "
            "silently become 'save nothing')"
        )
    return policy


def _save_matmuls_context():
    """Selective checkpointing that keeps every projection's output."""
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    saved = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


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

    def init_paged_cache(self, num_pages: int, tokens_per_page: int, device=None) -> list:
        return [getattr(self, f"self_attention_{i}").init_paged_cache(
            num_pages, tokens_per_page, device) for i in range(len(self.block.attention_pattern))]

    def forward(self, x, positions, segment_ids, mode: str = MODE_TRAIN, cache=None,
                impl: str | None = None, remat: str | None = None, paged_step=None):
        """``remat``: a policy of :func:`_remat_policy`, applied in
        ``MODE_TRAIN`` while gradients are recorded. ``paged_step``: the
        engine's ``PagedDecodeStep`` when ``cache`` holds page pools."""
        if mode != MODE_TRAIN or remat is None or not torch.is_grad_enabled():
            return self._unit(x, positions, segment_ids, mode, cache, impl, paged_step)
        if remat == "full":
            return checkpoint(self._unit, x, positions, segment_ids, mode, None, impl,
                              use_reentrant=False)
        if remat == "minimal":
            return checkpoint(self._unit, x, positions, segment_ids, mode, None, impl,
                              use_reentrant=False, context_fn=_save_matmuls_context)
        for i in range(len(self.block.attention_pattern)):
            attn_out = checkpoint(self._attn_anchor, i, x, positions, segment_ids, impl,
                                  use_reentrant=False)
            if remat == "save_attn_out":
                x = checkpoint(self._after_attn, i, x, attn_out, use_reentrant=False)
            else:  # save_attn_and_mlp
                x1, pre = checkpoint(self._mlp_anchor, i, x, attn_out, use_reentrant=False)
                x = self._after_mlp(i, x1, pre)
        return x

    def _unit(self, x, positions, segment_ids, mode, cache, impl, paged_step=None):
        for i in range(len(self.block.attention_pattern)):
            h = self._pre_attn(i, x)
            attn_out = getattr(self, f"self_attention_{i}")(
                h, h, positions, segment_ids, mode=mode,
                cache=None if cache is None else cache[i], impl=impl, paged_step=paged_step)
            x = self._mlp_sublayer(i, self._add_attn(i, x, attn_out))
        return x

    def _pre_attn(self, i, x):
        return getattr(self, f"pre_self_attention_norm_{i}")(x) if self.block.use_pre_norm else x

    def _add_attn(self, i, x, y):
        """The residual add of the attention sub-layer's output ``y`` (after ``out``)."""
        if self.block.use_post_attn_norm:
            y = getattr(self, f"post_self_attention_norm_{i}")(y)
        return x + y

    def _pre_mlp(self, i, x):
        return getattr(self, f"pre_mlp_norm_{i}")(x) if self.block.use_pre_norm else x

    def _after_mlp(self, i, x, pre_wo):
        mlp_out = getattr(self, f"mlp_{i}").wo(pre_wo)
        if self.block.use_post_ffw_norm:
            mlp_out = getattr(self, f"post_ffw_norm_{i}")(mlp_out)
        return x + mlp_out

    def _mlp_sublayer(self, i, x):
        return self._after_mlp(i, x, getattr(self, f"mlp_{i}").pre_wo(self._pre_mlp(i, x)))

    def _out(self, i, attn_out):
        return getattr(self, f"self_attention_{i}").out(attn_out)

    # the remat regions: the anchors are their outputs
    def _attn_anchor(self, i, x, positions, segment_ids, impl):
        h = self._pre_attn(i, x)
        return getattr(self, f"self_attention_{i}").attend(h, h, positions, segment_ids, impl)

    def _after_attn(self, i, x, attn_out):
        return self._mlp_sublayer(i, self._add_attn(i, x, self._out(i, attn_out)))

    def _mlp_anchor(self, i, x, attn_out):
        x1 = self._add_attn(i, x, self._out(i, attn_out))
        return x1, getattr(self, f"mlp_{i}").pre_wo(self._pre_mlp(i, x1))


class Decoder(nn.Module):
    """Unrolled stack of DecoderLayers (``layers_{i}``)."""

    def __init__(self, cfg: Config, block, device=None):
        super().__init__()
        if cfg.using_pipeline_parallelism:
            _unsupported("pipeline parallelism", "6, parallelism on torch.distributed")
        group = len(block.attention_pattern)
        self.num_units = cfg.num_decoder_layers // group
        self.remat_policy = cfg.remat_policy
        for i in range(self.num_units):
            setattr(self, f"layers_{i}", DecoderLayer(cfg, block, device=device))

    def init_cache(self, batch: int, max_length: int | None = None, device=None) -> list:
        """Per-unit list of per-sub-layer KVCaches."""
        return [getattr(self, f"layers_{i}").init_cache(batch, max_length, device)
                for i in range(self.num_units)]

    def init_paged_cache(self, num_pages: int, tokens_per_page: int, device=None) -> list:
        """Per-unit list of per-sub-layer page pools (PagedKVCaches)."""
        return [getattr(self, f"layers_{i}").init_paged_cache(num_pages, tokens_per_page, device)
                for i in range(self.num_units)]

    def forward(self, y: torch.Tensor, positions, segment_ids, mode: str = MODE_TRAIN,
                cache=None, impl: str | None = None, paged_step=None) -> torch.Tensor:
        remat = _remat_policy(self.remat_policy) if mode == MODE_TRAIN else None
        for i in range(self.num_units):
            y = getattr(self, f"layers_{i}")(
                y, positions, segment_ids, mode,
                None if cache is None else cache[i], impl, remat, paged_step)
        return y
