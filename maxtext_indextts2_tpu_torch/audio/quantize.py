"""Vector quantizers: factorized VQ and residual VQ, for inference.

Counterpart of the JAX package's ``audio/quantize.py`` for what serving
needs: the encode side of ``tokenize`` (project to the 8-d codebook space,
l2-normalise, nearest codebook row as the argmax of one similarity product,
the residual chain of ``ResidualVQ.quantize``) and the decode side (token ids
-> codebook rows -> input-space embeddings). The losses, quantizer dropout,
``__call__`` and ``latent2dist`` belong to training and are not ported yet.
Layout: ``[B, T, D]`` channels-last.
"""

from __future__ import annotations

import torch
from torch import nn

from maxtext_indextts2_tpu_torch.audio.layers import Dense
from maxtext_indextts2_tpu_torch.unported import _unsupported

_TRAINING = "4b, rest of training: codec training"


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True) + eps)


class FactorizedVectorQuantize(nn.Module):
    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int = 8,
                 commitment: float = 0.15, codebook_loss_weight: float = 1.0,
                 use_l2_normalize: bool = True, device=None, generator=None):
        super().__init__()
        self.input_dim, self.codebook_size, self.codebook_dim = (
            input_dim, codebook_size, codebook_dim)
        self.use_l2_normalize = use_l2_normalize
        if input_dim != codebook_dim:
            self.in_proj = Dense(input_dim, codebook_dim, device=device, generator=generator)
            self.out_proj = Dense(codebook_dim, input_dim, device=device, generator=generator)
        self.codebook = nn.Parameter(torch.empty(
            (codebook_size, codebook_dim), dtype=torch.float32, device=device
        ).normal_(0.0, 1.0, generator=generator))

    def _project_in(self, x: torch.Tensor) -> torch.Tensor:
        return self.in_proj(x) if self.input_dim != self.codebook_dim else x

    def _project_out(self, z: torch.Tensor) -> torch.Tensor:
        return self.out_proj(z) if self.input_dim != self.codebook_dim else z

    def decode_code(self, indices: torch.Tensor) -> torch.Tensor:
        """indices [B,T] -> RAW codebook rows [B,T,cb_dim]."""
        return self.codebook[indices]

    def vq2emb(self, indices: torch.Tensor) -> torch.Tensor:
        """indices [B,T] -> input-space embeddings [B,T,input_dim]."""
        return self._project_out(self.decode_code(indices))

    def encode_latents(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x [B,T,input_dim] -> (z_e [B,T,cb_dim], indices [B,T] int64).

        z_e is the UNNORMALISED projected latent; only the nearest-neighbour
        search sees l2-normalised vectors, where argmin ||z - c|| is argmax
        z.c (one [B*T, K] product)."""
        z_e = self._project_in(x)
        zn, cb = z_e, self.codebook
        if self.use_l2_normalize:
            zn, cb = _l2norm(zn), _l2norm(cb)
        sim = torch.einsum("btd,kd->btk", zn, cb)
        if not self.use_l2_normalize:
            sim = 2 * sim - torch.sum(torch.square(cb), dim=-1)[None, None, :]
        return z_e, torch.argmax(sim, dim=-1)

    def quantize(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The inference half of ``__call__``: (quantized [B,T,input_dim],
        indices [B,T]). The codebook row goes through the straight-through
        form ``z_e + (z_q - z_e)`` as there, which rounds like it."""
        z_e, indices = self.encode_latents(x)
        z_q = self.decode_code(indices)
        return self._project_out(z_e + (z_q - z_e)), indices

    def latent2dist(self, x):
        _unsupported("FactorizedVectorQuantize.latent2dist (training)", _TRAINING)

    def forward(self, x):
        _unsupported("FactorizedVectorQuantize.__call__ (losses, training)", _TRAINING)


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

    def quantize(self, x: torch.Tensor, n_quantizers: int | None = None):
        """x [B,T,D] -> (summed quantized [B,T,D], indices [Q,B,T] int64):
        each stage quantizes what the stages before it left over."""
        n = n_quantizers or self.num_quantizers
        residual, out, idx = x, torch.zeros_like(x), []
        for i in range(n):
            quantized, indices = getattr(self, f"vq_{i}").quantize(residual)
            residual = residual - quantized
            out = out + quantized
            idx.append(indices)
        return out, torch.stack(idx)

    def latent2dist(self, x, n_quantizers: int | None = None):
        _unsupported("ResidualVQ.latent2dist (training)", _TRAINING)

    def forward(self, x, n_quantizers: int | None = None, dropout_rng=None):
        _unsupported("ResidualVQ.__call__ (losses, quantizer dropout, training)", _TRAINING)
