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

Dropout in training (``models/layers.MlpDropout``): each MLP's keep mask is
taken (or drawn) before the layer's regions run and handed to them as an
argument, so a recomputed region applies the same mask: a mask drawn inside
a region would be drawn again in the backward (``torch.utils.checkpoint``
restores the global RNG, not an explicit generator). Under
``save_attn_and_mlp`` the dropout and ``wo`` form one more region whose
inputs are the saved ``mlp_pre_wo`` and the mask, so, as in the JAX package,
the tensor kept is the one before dropout and the mask is applied again on
recomputation.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from maxtext_indextts2_tpu_torch.config import Config
from maxtext_indextts2_tpu_torch.models.attention import MODE_TRAIN, Attention
from maxtext_indextts2_tpu_torch.models.layers import MlpBlock, MlpDropout, RMSNorm, to_dtype
from maxtext_indextts2_tpu_torch.models.mla import MLAttention
from maxtext_indextts2_tpu_torch.models.moe import RoutedMoE
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
        attn_temperature_scale=cfg.attn_temperature_scale,
        attn_temperature_floor_scale=cfg.attn_temperature_floor_scale,
        decode_attention=cfg.decode_attention,
        # the sequence's split between the layers: context parallelism, or
        # the sequence axis (K/V all-gathered over it)
        context_parallelism=cfg.using_context_parallelism
        or cfg.ici_sequence_parallelism * cfg.dcn_sequence_parallelism > 1,
        context_parallel_algorithm=cfg.context_parallel_algorithm,
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
    """One stack unit: ``len(block.attention_pattern)`` transformer sub-layers.
    ``use_moe``: the MLP of each sub-layer that ``moe_sublayer_pattern`` (or
    the block's ``moe_sublayers``; neither: every one) names is a
    ``RoutedMoE`` (``moe_{i}``), the others a ``MlpBlock`` (``mlp_{i}``)."""

    def __init__(self, cfg: Config, block, device=None, use_moe: bool = False):
        super().__init__()
        self.block = block
        dtype, wdtype = to_dtype(cfg.dtype), to_dtype(cfg.weight_dtype)

        def norm():
            return RMSNorm(cfg.emb_dim, epsilon=cfg.normalization_layer_epsilon, dtype=dtype,
                           weight_dtype=wdtype, scale_plus_one=block.rmsnorm_scale_plus_one,
                           use_mean=block.use_layer_norm, use_bias=block.use_layer_norm,
                           device=device)

        moe_subs = tuple(cfg.moe_sublayer_pattern) or block.moe_sublayers
        self.moe = [use_moe and (moe_subs is None or i in moe_subs)
                    for i in range(len(block.attention_pattern))]
        for i, attention_type in enumerate(block.attention_pattern):
            if block.use_pre_norm:
                setattr(self, f"pre_self_attention_norm_{i}", norm())
                setattr(self, f"pre_mlp_norm_{i}", norm())
            if block.use_mla:
                attn = MLAttention(cfg, device=device)
            else:
                attn = Attention(**_attention_kwargs(cfg, block, attention_type), device=device)
            setattr(self, f"self_attention_{i}", attn)
            if block.use_post_attn_norm:
                setattr(self, f"post_self_attention_norm_{i}", norm())
            if self.moe[i]:
                setattr(self, f"moe_{i}", RoutedMoE(cfg, device=device))
            else:
                setattr(self, f"mlp_{i}", MlpBlock(
                    cfg.emb_dim, cfg.mlp_dim, cfg.mlp_activations, dtype=dtype,
                    weight_dtype=wdtype, use_bias=block.use_mlp_bias,
                    quantization=cfg.quantization, dropout_rate=cfg.dropout_rate,
                    device=device))
            if block.use_post_ffw_norm:
                setattr(self, f"post_ffw_norm_{i}", norm())

    def init_cache(self, batch: int, max_length: int | None = None, device=None,
                   seq_split=None) -> list:
        kw = {} if seq_split is None else dict(seq_split=seq_split)
        return [getattr(self, f"self_attention_{i}").init_cache(batch, max_length, device, **kw)
                for i in range(len(self.block.attention_pattern))]

    def init_paged_cache(self, num_pages: int, tokens_per_page: int, device=None) -> list:
        return [getattr(self, f"self_attention_{i}").init_paged_cache(
            num_pages, tokens_per_page, device) for i in range(len(self.block.attention_pattern))]

    def forward(self, x, positions, segment_ids, mode: str = MODE_TRAIN, cache=None,
                impl: str | None = None, remat: str | None = None, paged_step=None,
                keep_masks=None, cache_offset: int | None = None,
                decode_width: int | None = None, lb_losses: list | None = None):
        """The unit's output. ``lb_losses``: where given, the load-balance
        loss of each MoE sub-layer of a ``MODE_TRAIN`` forward is appended
        (serving computes none). ``remat``: a policy of
        :func:`_remat_policy`, applied in ``MODE_TRAIN`` while gradients are
        recorded. ``paged_step``: the engine's ``PagedDecodeStep`` when
        ``cache`` holds page pools. ``keep_masks``: one MLP dropout keep mask
        per sub-layer (training). ``cache_offset`` / ``decode_width``: chunked
        prefill's first position and bucketed decode's cache prefix
        (``models/attention.py``)."""
        masks = keep_masks or [None] * len(self.block.attention_pattern)
        if mode != MODE_TRAIN or remat is None or not torch.is_grad_enabled():
            x, losses = self._unit(x, positions, segment_ids, mode, cache, impl, paged_step,
                                   masks, cache_offset, decode_width)
        elif remat in ("full", "minimal"):
            context = {} if remat == "full" else dict(context_fn=_save_matmuls_context)
            x, losses = checkpoint(self._unit, x, positions, segment_ids, mode, None, impl, None,
                                   masks, use_reentrant=False, **context)
        else:
            x, losses = self._regions(x, positions, segment_ids, impl, remat, masks)
        if lb_losses is not None:
            lb_losses.extend(losses)
        return x

    def _regions(self, x, positions, segment_ids, impl, remat, masks):
        """The checkpointed regions of ``save_attn_out`` / ``save_attn_and_mlp``
        (x, the MoE sub-layers' load-balance losses)."""
        losses = []
        for i in range(len(self.block.attention_pattern)):
            attn_out = checkpoint(self._attn_anchor, i, x, positions, segment_ids, impl,
                                  use_reentrant=False)
            # a MoE sub-layer has no mlp_pre_wo anchor (nor has the JAX
            # package's): under save_attn_and_mlp it is recomputed from attn_out
            if remat == "save_attn_out" or self.moe[i]:
                x, lb = checkpoint(self._after_attn, i, x, attn_out, masks[i], impl,
                                   use_reentrant=False)
                losses += [] if lb is None else [lb]
                continue
            # save_attn_and_mlp
            x1, pre = checkpoint(self._mlp_anchor, i, x, attn_out, use_reentrant=False)
            if masks[i] is None:
                x = self._after_mlp(i, x1, pre)
            else:  # the dropped-out product is recomputed from the anchor and the mask
                x = checkpoint(self._after_mlp, i, x1, pre, masks[i], use_reentrant=False)
        return x, losses

    def _unit(self, x, positions, segment_ids, mode, cache, impl, paged_step=None, masks=None,
              cache_offset=None, decode_width=None):
        losses = []
        for i in range(len(self.block.attention_pattern)):
            h = self._pre_attn(i, x)
            attn_out = getattr(self, f"self_attention_{i}")(
                h, h, positions, segment_ids, mode=mode,
                cache=None if cache is None else cache[i], impl=impl, paged_step=paged_step,
                cache_offset=cache_offset, decode_width=decode_width)
            x, lb = self._mlp_sublayer(i, self._add_attn(i, x, attn_out),
                                       None if masks is None else masks[i], impl,
                                       aux=mode == MODE_TRAIN)
            losses += [] if lb is None else [lb]
        return x, losses

    def _pre_attn(self, i, x):
        return getattr(self, f"pre_self_attention_norm_{i}")(x) if self.block.use_pre_norm else x

    def _add_attn(self, i, x, y):
        """The residual add of the attention sub-layer's output ``y`` (after ``out``)."""
        if self.block.use_post_attn_norm:
            y = getattr(self, f"post_self_attention_norm_{i}")(y)
        return x + y

    def _pre_mlp(self, i, x):
        return getattr(self, f"pre_mlp_norm_{i}")(x) if self.block.use_pre_norm else x

    def _after_mlp(self, i, x, pre_wo, keep_mask=None):
        mlp_out = getattr(self, f"mlp_{i}").out(pre_wo, keep_mask)
        if self.block.use_post_ffw_norm:
            mlp_out = getattr(self, f"post_ffw_norm_{i}")(mlp_out)
        return x + mlp_out

    def _mlp_sublayer(self, i, x, keep_mask=None, impl=None, aux=True):
        """(x after the MLP or MoE sub-layer, the MoE sub-layer's load-balance
        loss where ``aux``, else None): the JAX package sows one a MoE
        sub-layer; a serving step computes none."""
        if self.moe[i]:
            mlp_out, lb = getattr(self, f"moe_{i}")(self._pre_mlp(i, x), impl, aux_loss=aux)
            if self.block.use_post_ffw_norm:
                mlp_out = getattr(self, f"post_ffw_norm_{i}")(mlp_out)
            return x + mlp_out, lb
        pre = getattr(self, f"mlp_{i}").pre_wo(self._pre_mlp(i, x))
        return self._after_mlp(i, x, pre, keep_mask), None

    def _out(self, i, attn_out):
        return getattr(self, f"self_attention_{i}").out(attn_out)

    # the remat regions: the anchors are their outputs
    def _attn_anchor(self, i, x, positions, segment_ids, impl):
        h = self._pre_attn(i, x)
        return getattr(self, f"self_attention_{i}").attend(h, h, positions, segment_ids, impl)

    def _after_attn(self, i, x, attn_out, keep_mask=None, impl=None):
        return self._mlp_sublayer(i, self._add_attn(i, x, self._out(i, attn_out)), keep_mask,
                                  impl)

    def _mlp_anchor(self, i, x, attn_out):
        x1 = self._add_attn(i, x, self._out(i, attn_out))
        return x1, getattr(self, f"mlp_{i}").pre_wo(self._pre_mlp(i, x1))


def layer_regions(cfg: Config, group: int) -> list[tuple[str, int, bool]]:
    """The decoder's regions (name, units, MoE), as the JAX package's: with
    experts and ``first_num_dense_layers`` leading dense layers,
    ``dense_layers`` then ``moe_layers``; otherwise one ``layers`` region."""
    moe = cfg.num_experts > 1
    if moe and cfg.first_num_dense_layers > 0:
        regions = [("dense_layers", cfg.first_num_dense_layers // group, False),
                   ("moe_layers", (cfg.num_decoder_layers - cfg.first_num_dense_layers) // group,
                    True)]
    else:
        regions = [("layers", cfg.num_decoder_layers // group, moe)]
    return [r for r in regions if r[1] > 0]


class Decoder(nn.Module):
    """Unrolled stack of DecoderLayers: ``layers_{i}``, or ``dense_layers_{i}``
    then ``moe_layers_{i}`` (deepseek's leading dense layers)."""

    def __init__(self, cfg: Config, block, device=None):
        super().__init__()
        group = len(block.attention_pattern)
        self.unit_names = []
        self.regions = layer_regions(cfg, group)
        for region, units, use_moe in self.regions:
            for i in range(units):
                name = f"{region}_{i}"
                setattr(self, name, DecoderLayer(cfg, block, device=device, use_moe=use_moe))
                self.unit_names.append(name)
        self.num_units = len(self.unit_names)
        self.remat_policy = cfg.remat_policy
        self.group, self.mlp_dim = group, cfg.mlp_dim
        self.cfg = cfg
        self.stage_group = None  # set by keep_stage_units: the decoder is pipelined

    def keep_stage_units(self, mesh) -> frozenset[str]:
        """Keep the units of this rank's pipeline stage and drop the others
        (``models/pipeline.py``: layer i of a region runs on stage i mod S);
        returns the kept units' parameter names (under ``decoder.``)."""
        stages = mesh.shape["stage"]
        for region, units, _ in self.regions:
            want = stages * self.cfg.num_pipeline_repeats
            if units != want:
                raise ValueError(f"pipeline needs num_units ({units}) == stages ({stages}) * "
                                 f"repeats ({self.cfg.num_pipeline_repeats}) in {region}")
        kept = []
        for name in list(self.unit_names):
            if int(name.rsplit("_", 1)[1]) % stages != mesh.coords["stage"]:
                delattr(self, name)
            else:
                kept.append(name)
        self.unit_names = kept
        self.stage_group = mesh.group("stage")
        return frozenset(f"decoder.{u}.{n}" for u in kept
                         for n, _ in getattr(self, u).named_parameters())

    def units(self) -> list[DecoderLayer]:
        return [getattr(self, name) for name in self.unit_names]

    def init_cache(self, batch: int, max_length: int | None = None, device=None,
                   seq_split=None) -> list:
        """Per-unit list of per-sub-layer KVCaches (LatentCaches for MLA);
        ``seq_split``: the rows split over ``context_autoregressive``."""
        return [unit.init_cache(batch, max_length, device, seq_split) for unit in self.units()]

    def init_paged_cache(self, num_pages: int, tokens_per_page: int, device=None) -> list:
        """Per-unit list of per-sub-layer page pools (PagedKVCaches)."""
        return [unit.init_paged_cache(num_pages, tokens_per_page, device)
                for unit in self.units()]

    def forward(self, y: torch.Tensor, positions, segment_ids, mode: str = MODE_TRAIN,
                cache=None, impl: str | None = None, paged_step=None,
                dropout: MlpDropout | None = None, cache_offset: int | None = None,
                decode_width: int | None = None, lb_losses: list | None = None) -> torch.Tensor:
        """``dropout``: the MLP dropout of a training forward; each unit's
        masks are taken before the unit runs. ``lb_losses``: where given, the
        load-balance loss of every MoE sub-layer of a ``MODE_TRAIN`` forward
        is appended (what the JAX package sows)."""
        if self.stage_group is not None:
            return self._pipelined(y, positions, segment_ids, mode, impl, dropout)
        remat = _remat_policy(self.remat_policy) if mode == MODE_TRAIN else None
        shape = (*y.shape[:-1], self.mlp_dim)
        for i, unit in enumerate(self.units()):
            masks = None
            if dropout is not None and mode == MODE_TRAIN:
                masks = [dropout.keep_mask(i * self.group + j, shape, y.device)
                         for j in range(self.group)]
            y = unit(
                y, positions, segment_ids, mode,
                None if cache is None else cache[i], impl, remat, paged_step, masks,
                cache_offset, decode_width, lb_losses)
        return y

    def _pipelined(self, y, positions, segment_ids, mode, impl, dropout):
        from maxtext_indextts2_tpu_torch.models.pipeline import pipeline_forward

        if mode != MODE_TRAIN:
            raise ValueError("a pipelined decoder holds one stage's units and runs in "
                             "training only, as in the JAX package")
        if dropout is not None:
            _unsupported("MLP dropout inside the pipelined region",
                         "6, parallelism on torch.distributed")
        for region, _, _ in self.regions:
            units = [getattr(self, n) for n in self.unit_names if n.rsplit("_", 1)[0] == region]
            y = pipeline_forward(units, self.stage_group, self.cfg, y, positions, segment_ids,
                                 impl)
        return y
