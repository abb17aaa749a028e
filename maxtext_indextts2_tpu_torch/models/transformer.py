"""Top-level Transformer: shared embedding -> Decoder -> logits.

Counterpart of the JAX package's ``models/transformer.py``. Logits come
from a separate unembedding ``logits_dense`` or are tied to the embedding
table (``logits_via_embedding``); optional soft cap; float32 cast.
``return_prelogits`` stops at the final-normed hidden states, which the
vocabulary-fused cross-entropy (``ops/losses.py``) projects itself.
``vision_embeddings`` (image soft tokens) replace the scaled text embeddings
at ``image_token_id`` positions (``models/vision.merge_vision_embeddings``).
With ``mtp_num_layers > 0`` the model holds ``mtp_1`` ... (``models/mtp.py``)
and a ``MODE_TRAIN`` forward given ``targets`` computes the MTP loss
(:meth:`Transformer._mtp_loss`) into ``aux["mtp_loss"]``; serving skips it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from maxtext_indextts2_tpu_torch.config import Config
from maxtext_indextts2_tpu_torch.models.attention import MODE_TRAIN
from maxtext_indextts2_tpu_torch.models.decoder import Decoder
from maxtext_indextts2_tpu_torch.models.layers import (
    DenseGeneral,
    Embed,
    RMSNorm,
    to_dtype,
)
from maxtext_indextts2_tpu_torch.models.mtp import MTPLayer
from maxtext_indextts2_tpu_torch.models.registry import get_block_style
from maxtext_indextts2_tpu_torch.ops import losses
from maxtext_indextts2_tpu_torch.ops.quantization import AQT_MODES, AqtNoise


class Transformer(nn.Module):
    def __init__(self, cfg: Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.block = get_block_style(cfg.decoder_block)
        dtype, wdtype = to_dtype(cfg.dtype), to_dtype(cfg.weight_dtype)
        # sqrt(E) rounded to the embedding's dtype, as the JAX package's
        # asarray(.., dtype), kept as a host number: a tensor made in the
        # forward would be a host-to-device copy, which a captured decode step
        # cannot hold
        self.emb_scale = float(torch.tensor(cfg.emb_dim ** 0.5, dtype=dtype, device="cpu"))
        self.tp = None  # parallel/tensor.Split of a tensor-split model
        self.token_embedder = Embed(cfg.vocab_size, cfg.emb_dim, dtype=dtype,
                                    weight_dtype=wdtype, split_vocab=True, device=device)
        self.decoder = Decoder(cfg, self.block, device=device)
        self.decoder_norm = RMSNorm(
            cfg.emb_dim, epsilon=cfg.normalization_layer_epsilon, dtype=dtype,
            weight_dtype=wdtype, scale_plus_one=self.block.rmsnorm_scale_plus_one,
            use_mean=self.block.use_layer_norm, use_bias=self.block.use_layer_norm,
            device=device)
        self.position_embedder = None
        if cfg.use_positional_embedding:  # gpt3: learned positions
            self.position_embedder = Embed(cfg.max_target_length, cfg.emb_dim, dtype=dtype,
                                           weight_dtype=wdtype, device=device)
        for k in range(1, cfg.mtp_num_layers + 1):
            setattr(self, f"mtp_{k}", MTPLayer(cfg, self.block, device=device))
        self.logits_dense = None
        if not cfg.logits_via_embedding:
            self.logits_dense = DenseGeneral(
                cfg.emb_dim, cfg.vocab_size,
                dtype=dtype if not cfg.logits_dot_in_fp32 else torch.float32,
                weight_dtype=wdtype, parallel="column", device=device)

    def init_params(self, seed: int = 0):
        """Seeded random weights, drawn on the parameters' own device. LoRA
        adapters are drawn after every base weight, so that a model with
        adapters has the base weights of one without from the same seed."""
        device = self.token_embedder.embedding.device
        gen = torch.Generator(device=device).manual_seed(int(seed))
        with torch.no_grad():
            for module in self.modules():
                if module is not self and hasattr(module, "reset_parameters"):
                    module.reset_parameters(gen)
            for module in self.modules():
                if isinstance(module, DenseGeneral):
                    module.reset_lora(gen)
        return self

    def set_aqt_noise(self, noise: AqtNoise | None) -> None:
        """The stochastic-rounding noise of the AQT products (``quantization=
        int8 | fp8``) of the next training forward and its backward, one
        draw a layer by module name; None: PyTorch's default generator."""
        for name, module in self.named_modules():
            if isinstance(module, DenseGeneral) and module.quantization in AQT_MODES:
                module.aqt_noise = None if noise is None else noise.for_layer(name)

    def init_cache(self, batch: int, max_length: int | None = None, device=None,
                   seq_split=None) -> list:
        return self.decoder.init_cache(batch, max_length, device, seq_split)

    def init_paged_cache(self, num_pages: int, tokens_per_page: int, device=None) -> list:
        """Page pools for paged decode, nested as :meth:`init_cache`."""
        return self.decoder.init_paged_cache(num_pages, tokens_per_page, device)

    def prelogits(self, y: torch.Tensor) -> torch.Tensor:
        """Final-normed hidden states: what the fused-vocabulary CE takes
        instead of logits."""
        return self.decoder_norm(y)

    def unembedding_kernel(self) -> tuple[torch.Tensor, float]:
        """(the [E, V] unembedding, its logits' scale): the tied embedding
        transposed with 1/sqrt(E) when ``normalize_embedding_logits``, else
        ``logits_dense``'s kernel and 1."""
        cfg = self.cfg
        if cfg.logits_via_embedding:
            scale = 1.0 / math.sqrt(cfg.emb_dim) if cfg.normalize_embedding_logits else 1.0
            return self.token_embedder.embedding.t(), scale
        return self.logits_dense.kernel, 1.0

    def _unembed(self, y: torch.Tensor, gather: bool = True) -> torch.Tensor:
        """The logits of the final-normed ``y``. Under a tensor split the
        product gives this rank's vocabulary slice, which ``gather``
        all-gathers (serving samples from the whole row; training's
        cross-entropy takes the slices, ``ops/losses.py``)."""
        cfg = self.cfg
        y = self.prelogits(y)
        if self.tp is not None:
            y = self.tp.enter(y)
        if cfg.logits_via_embedding:
            logits = self.token_embedder.attend(y, normalize=cfg.normalize_embedding_logits)
        else:
            logits = self.logits_dense(y)
        if cfg.final_logits_soft_cap > 0.0:
            logits = cfg.final_logits_soft_cap * torch.tanh(logits / cfg.final_logits_soft_cap)
        if cfg.cast_logits_to_fp32:
            logits = logits.float()
        if self.tp is not None and gather:
            from maxtext_indextts2_tpu_torch.parallel import comm

            logits = comm.all_gather(logits, self.tp.group, logits.ndim - 1)
        return logits

    def forward(
        self,
        tokens: torch.Tensor,  # [B, S] integer
        positions: torch.Tensor,  # [B, S] integer
        segment_ids: torch.Tensor | None = None,  # [B, S], 0 = padding
        mode: str = MODE_TRAIN,
        cache: list | None = None,  # from init_cache(); updated in place
        impl: str | None = None,  # "plain": kernels' plain versions (comparisons only)
        paged_step=None,  # paged decode: infer.paged_attention.PagedDecodeStep
        cache_offset: int | None = None,  # chunked prefill: this chunk's first position
        decode_width: int | None = None,  # bucketed decode: the cache prefix read
        return_prelogits: bool = False,  # fused-vocabulary CE: skip the unembedding
        dropout=None,  # training: models.layers.MlpDropout (None: deterministic)
        targets: torch.Tensor | None = None,  # [B, S]: enables the MTP loss in training
        target_weights: torch.Tensor | None = None,  # [B, S] float, the MTP loss's weights
        vision_embeddings: torch.Tensor | None = None,  # [B, T_img, E] image soft tokens
        aux: dict | None = None,  # filled with "moe_lb_loss" (a list) and "mtp_loss"
    ) -> torch.Tensor:
        cfg = self.cfg
        emb = self.token_embedder(tokens)
        if self.block.scale_embedding:
            emb = emb * self.emb_scale
        if vision_embeddings is not None:
            from maxtext_indextts2_tpu_torch.models.vision import merge_vision_embeddings

            emb = merge_vision_embeddings(emb, vision_embeddings, tokens, cfg.image_token_id)
        if self.position_embedder is not None:
            emb = emb + self.position_embedder(positions)
        lb_losses = None if aux is None else []
        y = self.decoder(emb, positions, segment_ids, mode=mode, cache=cache, impl=impl,
                         paged_step=paged_step, dropout=dropout, cache_offset=cache_offset,
                         decode_width=decode_width, lb_losses=lb_losses)
        if lb_losses:  # no MoE sub-layer (or serving): nothing sown
            aux["moe_lb_loss"] = lb_losses
        if cfg.mtp_num_layers > 0 and mode == MODE_TRAIN and targets is not None:
            mtp_loss = self._mtp_loss(y, tokens, targets, target_weights, positions,
                                      segment_ids, impl, dropout)
            if aux is not None:
                aux["mtp_loss"] = mtp_loss
        if return_prelogits:
            return self.prelogits(y)
        return self._unembed(y, gather=mode != MODE_TRAIN)

    def _mtp_loss(self, hidden, tokens, targets, target_weights, positions, segment_ids,
                  impl=None, dropout=None) -> torch.Tensor:
        """The DeepSeek-style MTP loss of the JAX package: at depth k the
        tokens, targets and weights rolled k to the left (the last k
        positions weighted 0), the depth's layer on the previous depth's
        hidden state and the rolled tokens' embedding, float32 logits of the
        shared unembedding, and the weighted CE summed over the depths over
        the summed weights (at least 1e-6). ``dropout``: the MLP dropout,
        each depth's masks after the trunk's in layer order."""
        cfg = self.cfg
        if target_weights is not None:
            w0 = target_weights.float()
        elif segment_ids is not None:
            w0 = (segment_ids != 0).float()
        else:
            w0 = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
        s = tokens.shape[1]
        h = hidden
        total_loss = total_weight = 0.0
        for k in range(1, cfg.mtp_num_layers + 1):
            tok_k = torch.roll(tokens, -k, dims=1)
            tgt_k = torch.roll(targets, -k, dims=1)
            valid = (torch.arange(s, device=tokens.device) < s - k)[None, :]
            w_k = torch.roll(w0, -k, dims=1) * valid
            masks = None
            if dropout is not None:
                group = self.decoder.group
                shape = (*h.shape[:-1], cfg.mlp_dim)
                first = (cfg.num_decoder_layers + k - 1) * group
                masks = [dropout.keep_mask(first + j, shape, h.device) for j in range(group)]
            h = getattr(self, f"mtp_{k}")(h, self.token_embedder(tok_k), positions, segment_ids,
                                          impl, masks)
            logits = self._unembed(h).float()
            ce, _ = losses.cross_entropy_with_logits(logits, tgt_k, 0.0)
            total_loss = total_loss + torch.sum(ce * w_k)
            total_weight = total_weight + torch.sum(w_k)
        return total_loss / torch.clamp(total_weight, min=1e-6)
