"""Top-level Transformer: shared embedding -> Decoder -> logits.

Counterpart of the JAX package's ``models/transformer.py``. Logits come
from a separate unembedding ``logits_dense`` or are tied to the embedding
table (``logits_via_embedding``); optional soft cap; float32 cast.
``return_prelogits`` stops at the final-normed hidden states, which the
vocabulary-fused cross-entropy (``ops/losses.py``) projects itself.
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
from maxtext_indextts2_tpu_torch.models.registry import get_block_style
from maxtext_indextts2_tpu_torch.unported import _unsupported


class Transformer(nn.Module):
    def __init__(self, cfg: Config, device=None):
        super().__init__()
        if cfg.use_positional_embedding:
            _unsupported("learned positional embeddings (gpt3)", "6, other model families")
        if cfg.mtp_num_layers > 0:
            _unsupported("multi-token prediction layers", "6, other model families")
        self.cfg = cfg
        self.block = get_block_style(cfg.decoder_block)
        dtype, wdtype = to_dtype(cfg.dtype), to_dtype(cfg.weight_dtype)
        self.token_embedder = Embed(cfg.vocab_size, cfg.emb_dim, dtype=dtype,
                                    weight_dtype=wdtype, device=device)
        self.decoder = Decoder(cfg, self.block, device=device)
        self.decoder_norm = RMSNorm(
            cfg.emb_dim, epsilon=cfg.normalization_layer_epsilon, dtype=dtype,
            weight_dtype=wdtype, scale_plus_one=self.block.rmsnorm_scale_plus_one,
            device=device)
        self.logits_dense = None
        if not cfg.logits_via_embedding:
            self.logits_dense = DenseGeneral(
                cfg.emb_dim, cfg.vocab_size,
                dtype=dtype if not cfg.logits_dot_in_fp32 else torch.float32,
                weight_dtype=wdtype, device=device)

    def init_params(self, seed: int = 0):
        """Seeded random weights, drawn on the parameters' own device."""
        device = self.token_embedder.embedding.device
        gen = torch.Generator(device=device).manual_seed(int(seed))
        with torch.no_grad():
            for module in self.modules():
                if module is not self and hasattr(module, "reset_parameters"):
                    module.reset_parameters(gen)
        return self

    def init_cache(self, batch: int, max_length: int | None = None, device=None) -> list:
        return self.decoder.init_cache(batch, max_length, device)

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

    def _unembed(self, y: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        y = self.prelogits(y)
        if cfg.logits_via_embedding:
            logits = self.token_embedder.attend(y, normalize=cfg.normalize_embedding_logits)
        else:
            logits = self.logits_dense(y)
        if cfg.final_logits_soft_cap > 0.0:
            logits = cfg.final_logits_soft_cap * torch.tanh(logits / cfg.final_logits_soft_cap)
        if cfg.cast_logits_to_fp32:
            logits = logits.float()
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
    ) -> torch.Tensor:
        emb = self.token_embedder(tokens)
        if self.block.scale_embedding:
            emb = emb * torch.tensor(self.cfg.emb_dim ** 0.5, dtype=emb.dtype,
                                     device=emb.device)
        y = self.decoder(emb, positions, segment_ids, mode=mode, cache=cache, impl=impl,
                         paged_step=paged_step, dropout=dropout, cache_offset=cache_offset,
                         decode_width=decode_width)
        if return_prelogits:
            return self.prelogits(y)
        return self._unembed(y)
