"""Multi-token prediction (DeepSeek-V3 style).

Counterpart of the JAX package's ``models/mtp.py``: each MTP depth k
re-embeds the k-shifted token stream, fuses it with the trunk's hidden state
(``hidden_norm`` and ``emb_norm``, concatenated, ``projection`` 2E -> E),
runs one dense decoder layer (``layer``) and predicts token t + k + 1 with the
shared unembedding. The loop over the depths, the shared embedding and
unembedding and the loss live in ``Transformer._mtp_loss``
(``models/transformer.py``), as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from maxtext_indextts2_tpu_torch.config import Config
from maxtext_indextts2_tpu_torch.models.attention import MODE_TRAIN
from maxtext_indextts2_tpu_torch.models.layers import DenseGeneral, RMSNorm, to_dtype


class MTPLayer(nn.Module):
    """One MTP depth: fuse (hidden, shifted-token embedding) -> a dense
    ``DecoderLayer`` (the JAX package's ``use_moe`` default, False)."""

    def __init__(self, cfg: Config, block, device=None):
        super().__init__()
        from maxtext_indextts2_tpu_torch.models.decoder import DecoderLayer

        self.dtype = to_dtype(cfg.dtype)
        wdt = to_dtype(cfg.weight_dtype)
        eps = cfg.normalization_layer_epsilon
        self.hidden_norm = RMSNorm(cfg.emb_dim, epsilon=eps, dtype=self.dtype, weight_dtype=wdt,
                                   device=device)
        self.emb_norm = RMSNorm(cfg.emb_dim, epsilon=eps, dtype=self.dtype, weight_dtype=wdt,
                                device=device)
        self.projection = DenseGeneral(2 * cfg.emb_dim, cfg.emb_dim, dtype=self.dtype,
                                       weight_dtype=wdt, device=device)
        self.layer = DecoderLayer(cfg, block, device=device)

    def forward(self, hidden: torch.Tensor, emb_k: torch.Tensor, positions: torch.Tensor,
                segment_ids: torch.Tensor | None, impl: str | None = None,
                keep_masks=None) -> torch.Tensor:
        fused = torch.cat([self.hidden_norm(hidden), self.emb_norm(emb_k.to(self.dtype))], dim=-1)
        h = self.projection(fused)
        return self.layer(h, positions, segment_ids, MODE_TRAIN, impl=impl,
                          keep_masks=keep_masks)
