"""Vector quantizers, decode side: factorized VQ and residual VQ.

Counterpart of the JAX package's ``audio/quantize.py`` for what serving
needs: token ids -> codebook rows -> input-space embeddings. The encode side
(nearest-neighbour search, losses, quantizer dropout) belongs to ``tokenize``
and training and is not ported yet. Layout: ``[B, T, D]`` channels-last.
"""

from __future__ import annotations

import torch
from torch import nn

from maxtext_indextts2_tpu_torch.audio.layers import Dense
from maxtext_indextts2_tpu_torch.models.layers import _unsupported

_ENCODE_SIDE = "3, audio frontend (tokenize) / 4, training step"


class FactorizedVectorQuantize(nn.Module):
    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int = 8,
                 commitment: float = 0.15, codebook_loss_weight: float = 1.0,
                 use_l2_normalize: bool = True, device=None, generator=None):
        super().__init__()
        self.input_dim, self.codebook_size, self.codebook_dim = (
            input_dim, codebook_size, codebook_dim)
        self.use_l2_normalize = use_l2_normalize
        if input_dim != codebook_dim:
            # in_proj is held (same parameter tree as the JAX package) but
            # only the encode side uses it
            self.in_proj = Dense(input_dim, codebook_dim, device=device, generator=generator)
            self.out_proj = Dense(codebook_dim, input_dim, device=device, generator=generator)
        self.codebook = nn.Parameter(torch.empty(
            (codebook_size, codebook_dim), dtype=torch.float32, device=device
        ).normal_(0.0, 1.0, generator=generator))

    def _project_out(self, z: torch.Tensor) -> torch.Tensor:
        return self.out_proj(z) if self.input_dim != self.codebook_dim else z

    def decode_code(self, indices: torch.Tensor) -> torch.Tensor:
        """indices [B,T] -> RAW codebook rows [B,T,cb_dim]."""
        return self.codebook[indices]

    def vq2emb(self, indices: torch.Tensor) -> torch.Tensor:
        """indices [B,T] -> input-space embeddings [B,T,input_dim]."""
        return self._project_out(self.decode_code(indices))

    def encode_latents(self, x):
        _unsupported("FactorizedVectorQuantize.encode_latents (RVQ encode side)", _ENCODE_SIDE)

    def latent2dist(self, x):
        _unsupported("FactorizedVectorQuantize.latent2dist (RVQ encode side)", _ENCODE_SIDE)

    def forward(self, x):
        _unsupported("FactorizedVectorQuantize.__call__ (RVQ encode side)", _ENCODE_SIDE)


class ResidualVQ(nn.Module):
    """Stack of factorized quantizers over successive residuals."""

    def __init__(self, input_dim: int, num_quantizers: int, codebook_size: int,
                 codebook_dim: int = 8, commitment: float = 0.15,
                 codebook_loss_weight: float = 1.0, use_l2_normalize: bool = True,
                 quantizer_dropout: float = 0.0, device=None, generator=None):
        super().__init__()
        self.num_quantizers = num_quantizers
        for i in range(num_quantizers):
            setattr(self, f"vq_{i}", FactorizedVectorQuantize(
                input_dim, codebook_size, codebook_dim, commitment, codebook_loss_weight,
                use_l2_normalize, device=device, generator=generator))

    def vq2emb(self, indices: torch.Tensor, n_quantizers: int | None = None) -> torch.Tensor:
        """indices [Q,B,T] -> summed input-space embeddings [B,T,D]."""
        n = n_quantizers or self.num_quantizers
        out = None
        for i in range(min(n, indices.shape[0])):
            e = getattr(self, f"vq_{i}").vq2emb(indices[i])
            out = e if out is None else out + e
        return out

    def quantize(self, x, n_quantizers: int | None = None):
        _unsupported("ResidualVQ.quantize (RVQ encode side)", _ENCODE_SIDE)

    def latent2dist(self, x, n_quantizers: int | None = None):
        _unsupported("ResidualVQ.latent2dist (RVQ encode side)", _ENCODE_SIDE)

    def forward(self, x, n_quantizers: int | None = None, dropout_rng=None):
        _unsupported("ResidualVQ.__call__ (RVQ encode side)", _ENCODE_SIDE)
