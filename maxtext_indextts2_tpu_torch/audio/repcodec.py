"""RepCodec: the semantic codec that quantizes w2v-BERT features to 8192 tokens.

Counterpart of the JAX package's ``audio/repcodec.py`` for inference: a
VocosBackbone encoder over the 1024-d semantic features -> a 1-stage
ResidualVQ (factorized, codebook 8192 x 8, l2-normalised) -> ids
(``quantize``), and ids -> embeddings (``vq2emb``). The decoder half is
held (same parameter tree) but only the training autoencoder runs it, and
that call waits with training. Layout ``[B, T, C]``.
"""

from __future__ import annotations

import torch
from torch import nn

from maxtext_indextts2_tpu_torch.audio.layers import Dense
from maxtext_indextts2_tpu_torch.audio.quantize import ResidualVQ
from maxtext_indextts2_tpu_torch.audio.vocos import VocosBackbone
from maxtext_indextts2_tpu_torch.unported import _unsupported


class RepCodec(nn.Module):
    def __init__(self, hidden_size: int = 1024, codebook_size: int = 8192,
                 codebook_dim: int = 8, vocos_dim: int = 384,
                 vocos_intermediate_dim: int = 2048, vocos_num_layers: int = 12,
                 num_quantizers: int = 1, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.encoder = VocosBackbone(hidden_size, vocos_dim, vocos_intermediate_dim,
                                     vocos_num_layers, **kw)
        self.enc_proj = Dense(vocos_dim, hidden_size, **kw)
        self.quantizer = ResidualVQ(hidden_size, num_quantizers, codebook_size, codebook_dim,
                                    0.15, **kw)
        self.decoder = VocosBackbone(hidden_size, vocos_dim, vocos_intermediate_dim,
                                     vocos_num_layers, **kw)
        self.dec_proj = Dense(vocos_dim, hidden_size, **kw)

    def encode(self, feats: torch.Tensor) -> torch.Tensor:
        return self.enc_proj(self.encoder(feats))

    def quantize(self, feats: torch.Tensor) -> torch.Tensor:
        """[B,T,1024] semantic features -> [B,T] token ids in [0, 8192)."""
        _, idx = self.quantizer.quantize(self.encode(feats))
        return idx[0]  # single quantizer stage

    def vq2emb(self, indices: torch.Tensor) -> torch.Tensor:
        return self.quantizer.vq2emb(indices[None])

    def forward(self, feats):
        _unsupported("RepCodec.__call__ (the training autoencoder)",
                     "4b, rest of training: RepCodec training")
