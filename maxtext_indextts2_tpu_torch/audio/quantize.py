"""Vector quantizers: factorized VQ and residual VQ.

Counterpart of the JAX package's ``audio/quantize.py``: the encode side of
``tokenize`` (project to the 8-d codebook space, l2-normalise, nearest
codebook row as the argmax of one similarity product, the residual chain of
``ResidualVQ.quantize``), the decode side (token ids -> codebook rows ->
input-space embeddings) and training: ``forward`` gives the commitment and
codebook losses (per sample and their means) with the straight-through
estimator ``z_e + (z_q - z_e).detach()``, ``ResidualVQ`` its quantizer
dropout, and ``latent2dist`` the similarity logits. Layout: ``[B, T, D]``
channels-last.

Quantizer dropout's draw is an input: the ``[B]`` quantizer counts in
``[1, Q]`` that the JAX package draws with ``jax.random.randint(rng, (B,),
1, Q + 1)``, given as a tensor, or drawn from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from maxtext_indextts2_tpu_torch.audio.layers import Dense


class QuantizeResult(NamedTuple):
    quantized: torch.Tensor  # [B,T,D] (input space, after project_out)
    indices: torch.Tensor  # [B,T] int64
    commit_loss: torch.Tensor  # scalar
    codebook_loss: torch.Tensor  # scalar
    # per-sample [B] losses (for quantizer-dropout masking); the scalars are their means
    commit_per_sample: torch.Tensor | None = None
    codebook_per_sample: torch.Tensor | None = None


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
        self.commitment, self.codebook_loss_weight = commitment, codebook_loss_weight
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

    def latent2dist(self, x: torch.Tensor) -> torch.Tensor:
        """[B,T,input_dim] -> similarity logits [B,T,K]."""
        z_e, cb = self._project_in(x), self.codebook
        if self.use_l2_normalize:
            z_e, cb = _l2norm(z_e), _l2norm(cb)
        return torch.einsum("btd,kd->btk", z_e, cb)

    def forward(self, x: torch.Tensor) -> QuantizeResult:
        """Training: the quantized output through the straight-through
        estimator, the indices, and the commitment / codebook losses (per
        sample over T and D, and their means over the batch)."""
        z_e, indices = self.encode_latents(x)
        z_q = self.decode_code(indices)
        commit_ps = torch.mean(torch.square(z_e - z_q.detach()), dim=(1, 2)) * self.commitment
        codebook_ps = (torch.mean(torch.square(z_e.detach() - z_q), dim=(1, 2))
                       * self.codebook_loss_weight)
        z_q = z_e + (z_q - z_e).detach()
        return QuantizeResult(self._project_out(z_q), indices, torch.mean(commit_ps),
                              torch.mean(codebook_ps), commit_ps, codebook_ps)


class ResidualVQ(nn.Module):
    """Stack of factorized quantizers over successive residuals."""

    def __init__(self, input_dim: int, num_quantizers: int, codebook_size: int,
                 codebook_dim: int = 8, commitment: float = 0.15,
                 codebook_loss_weight: float = 1.0, use_l2_normalize: bool = True,
                 quantizer_dropout: float = 0.0, device=None, generator=None):
        super().__init__()
        self.num_quantizers = num_quantizers
        self.quantizer_dropout = quantizer_dropout
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

    def latent2dist(self, x: torch.Tensor, n_quantizers: int | None = None) -> torch.Tensor:
        """Per-layer similarity logits [Q,B,T,K] following the residual chain."""
        n = n_quantizers or self.num_quantizers
        residual, dists = x, []
        for i in range(n):
            q = getattr(self, f"vq_{i}")
            d = q.latent2dist(residual)
            residual = residual - q.vq2emb(torch.argmax(d, dim=-1))
            dists.append(d)
        return torch.stack(dists)

    def draw_dropout(self, batch: int, generator: torch.Generator) -> torch.Tensor:
        """A [B] draw of quantizer counts in [1, Q] (on the generator's device)."""
        return torch.randint(1, self.num_quantizers + 1, (batch,), generator=generator,
                             device=generator.device)

    def forward(self, x: torch.Tensor, n_quantizers: int | None = None,
                dropout: torch.Tensor | torch.Generator | None = None):
        """Training: (quantized_out [B,T,D], indices [Q,B,T], commit_losses
        [Q], codebook_losses [Q], per_layer_quantized [Q,B,T,D]).

        ``dropout``: the quantizer-dropout draw, a [B] tensor of counts in
        [1, Q] or a generator to draw it from; with ``quantizer_dropout > 0``
        the first ``int(B * quantizer_dropout)`` samples keep only their
        drawn number of stages: later stages' contributions and losses are
        masked per sample, while the residuals still advance unmasked. None
        (as the JAX package's ``dropout_rng=None``): no dropout."""
        n = n_quantizers or self.num_quantizers
        b = x.shape[0]
        n_per_sample = None
        if dropout is not None and self.quantizer_dropout > 0:
            draw = (self.draw_dropout(b, dropout) if isinstance(dropout, torch.Generator)
                    else dropout).to(x.device)
            n_drop = int(b * self.quantizer_dropout)
            keep_all = torch.full_like(draw, self.num_quantizers + 1)
            n_per_sample = torch.where(torch.arange(b, device=x.device) < n_drop, draw, keep_all)
        residual, out = x, torch.zeros_like(x)
        all_idx, all_commit, all_cb, all_q = [], [], [], []
        for i in range(n):
            res = getattr(self, f"vq_{i}")(residual)
            residual = residual - res.quantized
            if n_per_sample is None:
                out = out + res.quantized
                all_commit.append(res.commit_loss)
                all_cb.append(res.codebook_loss)
            else:
                mask = (i < n_per_sample).to(x.dtype)  # [B]
                out = out + res.quantized * mask[:, None, None]
                all_commit.append(torch.mean(res.commit_per_sample * mask))
                all_cb.append(torch.mean(res.codebook_per_sample * mask))
            all_idx.append(res.indices)
            all_q.append(res.quantized)
        return (out, torch.stack(all_idx), torch.stack(all_commit), torch.stack(all_cb),
                torch.stack(all_q))
