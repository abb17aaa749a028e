"""Extended vector quantizers: the EMA Euclidean codebook (k-means init,
dead-code expiry), the simple (gradient-trained) codebook, the projected
``VectorQuantize`` over either, and lookup-free quantization.

Counterpart of the JAX package's ``audio/quantize_extended.py``. Nearest
neighbours and k-means steps are products: ``||x||^2 - 2 x.c + ||c||^2`` for
the distances and a one-hot product for each cluster's sum (empty clusters
keep their mean), never an ``[N, K, D]`` broadcast and never an
``index_add_`` of floats, whose atomics would make the EMA sums vary from run
to run on the GPU.

The EMA state (``initted``, ``cluster_size``, ``embed``, ``embed_avg``,
``step``) is held in buffers under the names of the JAX package's
``"codebook"`` variable collection; a training call (``train=True``) runs
the k-means init on its first batch, the EMA update and the expiry of dead
codes in place, without gradients.

The draws are inputs: the rows that seed k-means (``init_idx``) and the rows
that replace expired codes (``expire_idx``) are index tensors into the
flattened batch, the JAX package's ``jax.random.permutation(rng, N)[:K]``
(``randint`` when N < K). Without them a training call draws them from a
CPU ``torch.Generator`` seeded with the codebook's step (the JAX package's
fallback is ``fold_in(PRNGKey(0), step)``, which this package cannot
reproduce). Layout ``[B, T, D]`` channels-last.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from maxtext_indextts2_tpu_torch.audio.layers import Dense
from maxtext_indextts2_tpu_torch.audio.quantize import QuantizeResult, _l2norm


def _sq_dist_neg(flat: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """-(||x - c||^2) as [N, K] through one product (embed: [K, D])."""
    return -(torch.sum(torch.square(flat), dim=1, keepdim=True) - 2.0 * flat @ embed.T
             + torch.sum(torch.square(embed), dim=1)[None, :])


def draw_sample_indices(n: int, num: int, generator: torch.Generator) -> torch.Tensor:
    """``num`` row indices into ``n`` rows: a permutation's first ``num``
    when ``n >= num``, else ``num`` draws with replacement."""
    if n >= num:
        return torch.randperm(n, generator=generator)[:num]
    return torch.randint(0, n, (num,), generator=generator)


def sample_vectors(samples: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The rows ``idx`` of ``samples`` [N, D] (a draw of
    :func:`draw_sample_indices`, or the JAX package's)."""
    return samples[idx.to(samples.device)]


def _assign(samples: torch.Tensor, means: torch.Tensor, use_cosine_sim: bool):
    dists = samples @ means.T if use_cosine_sim else _sq_dist_neg(samples, means)
    return F.one_hot(torch.argmax(dists, dim=-1), means.shape[0]).to(samples.dtype)


def kmeans(samples: torch.Tensor, init_idx: torch.Tensor, num_iters: int = 10,
           use_cosine_sim: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd iterations from the rows ``init_idx`` (one a cluster). Returns
    (means [K, D], bins [K]); assignment and each cluster's mean are products
    with a one-hot [N, K]; an empty cluster keeps its old mean."""
    means = sample_vectors(samples, init_idx)
    for _ in range(num_iters):
        onehot = _assign(samples, means, use_cosine_sim)
        bins = torch.sum(onehot, dim=0)
        new_means = onehot.T @ samples / torch.clamp(bins, min=1.0)[:, None]
        if use_cosine_sim:
            new_means = _l2norm(new_means)
        means = torch.where((bins == 0)[:, None], means, new_means)
    return means, torch.sum(_assign(samples, means, use_cosine_sim), dim=0)


class EuclideanCodebook(nn.Module):
    """EMA codebook; state in buffers (the JAX ``"codebook"`` collection)."""

    def __init__(self, dim: int, codebook_size: int, kmeans_init: bool = False,
                 kmeans_iters: int = 10, decay: float = 0.8, eps: float = 1e-5,
                 threshold_ema_dead_code: float = 2.0, device=None, generator=None):
        super().__init__()
        self.dim, self.codebook_size = dim, codebook_size
        self.kmeans_iters, self.decay, self.eps = kmeans_iters, decay, eps
        self.threshold_ema_dead_code = threshold_ema_dead_code
        embed = torch.empty((codebook_size, dim), dtype=torch.float32, device=device)
        embed.normal_(0.0, 1.0, generator=generator)
        self.register_buffer("initted", torch.tensor(not kmeans_init, device=device))
        self.register_buffer("cluster_size",
                             torch.zeros((codebook_size,), dtype=torch.float32, device=device))
        self.register_buffer("embed", embed)
        self.register_buffer("embed_avg", embed.clone())
        self.register_buffer("step", torch.zeros((), dtype=torch.int32, device=device))

    def forward(self, x: torch.Tensor, train: bool = False, init_idx: torch.Tensor | None = None,
                expire_idx: torch.Tensor | None = None):
        """x [..., dim] -> (quantized [..., dim], indices [...]). With
        ``train``: k-means init on the first call, then the EMA update and the
        expiry of dead codes, in place; the draws not given come from a CPU
        generator seeded with the step."""
        flat = x.reshape(-1, self.dim)
        with torch.no_grad():
            if train:
                initted = bool(self.initted)
                gen = torch.Generator().manual_seed(int(self.step))
                if init_idx is None and not initted:
                    init_idx = draw_sample_indices(flat.shape[0], self.codebook_size, gen)
                if expire_idx is None:
                    expire_idx = draw_sample_indices(flat.shape[0], self.codebook_size, gen)
                self.step += 1
                if not initted:
                    means, bins = kmeans(flat, init_idx, self.kmeans_iters)
                    self.embed.copy_(means)
                    self.embed_avg.copy_(means)
                    self.cluster_size.copy_(bins)
                    self.initted.fill_(True)
            idx_flat = torch.argmax(_sq_dist_neg(flat, self.embed), dim=-1)
            indices = idx_flat.reshape(x.shape[:-1])
            quantize = self.embed[indices]  # a copy: the update below is in place
            if train:
                self._ema_update(flat, idx_flat, expire_idx)
        return quantize, indices

    def _ema_update(self, flat, idx_flat, expire_idx):
        onehot = F.one_hot(idx_flat, self.codebook_size).to(torch.float32)
        counts = torch.sum(onehot, dim=0)
        csize = self.cluster_size * self.decay + counts * (1 - self.decay)
        embed_sum = onehot.T @ flat  # [K, D], one product
        avg = self.embed_avg * self.decay + embed_sum * (1 - self.decay)
        total = csize.sum()
        smoothed = ((csize + self.eps) / (total + self.codebook_size * self.eps)) * total
        new_embed = avg / smoothed[:, None]
        if self.threshold_ema_dead_code > 0:
            expired = csize < self.threshold_ema_dead_code
            new_embed = torch.where(expired[:, None],
                                    sample_vectors(flat, expire_idx),
                                    new_embed)
        self.cluster_size.copy_(csize)
        self.embed_avg.copy_(avg)
        self.embed.copy_(new_embed)

    def vq2emb(self, indices: torch.Tensor) -> torch.Tensor:
        return self.embed[indices]

    def latent2dist(self, x: torch.Tensor):
        """(negative squared distances [..., K], indices [...], codebook rows [..., dim])."""
        dist = _sq_dist_neg(x.reshape(-1, self.dim), self.embed)
        idx = torch.argmax(dist, dim=-1).reshape(x.shape[:-1])
        return dist.reshape(*x.shape[:-1], -1), idx, self.embed[idx]


class SimpleCodebook(nn.Module):
    """Learned (gradient-trained) codebook, optional l2-normalised search."""

    def __init__(self, dim: int, codebook_size: int, use_l2_normalize: bool = False,
                 device=None, generator=None):
        super().__init__()
        self.dim, self.use_l2_normalize = dim, use_l2_normalize
        self.embed = nn.Parameter(torch.empty(
            (codebook_size, dim), dtype=torch.float32, device=device
        ).normal_(0.0, 1.0, generator=generator))

    def forward(self, x: torch.Tensor):
        flat, cb = x.reshape(-1, self.dim), self.embed
        if self.use_l2_normalize:
            flat, cb = _l2norm(flat), _l2norm(cb)
        idx = torch.argmax(_sq_dist_neg(flat, cb), dim=-1).reshape(x.shape[:-1])
        return self.embed[idx], idx

    def vq2emb(self, indices: torch.Tensor) -> torch.Tensor:
        return self.embed[indices]


class VectorQuantize(nn.Module):
    """Projected VQ over an EMA (``"euclidean"``) or ``"simple"`` codebook;
    the API of ``audio.quantize.FactorizedVectorQuantize``."""

    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int,
                 commitment: float = 0.005, codebook_loss_weight: float = 1.0,
                 use_l2_normalize: bool = False, codebook_type: str = "euclidean",
                 kmeans_init: bool = False, kmeans_iters: int = 10, decay: float = 0.8,
                 eps: float = 1e-5, threshold_ema_dead_code: float = 2.0, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.input_dim, self.codebook_dim = input_dim, codebook_dim
        self.commitment, self.codebook_loss_weight = commitment, codebook_loss_weight
        self.codebook_type = codebook_type
        if input_dim != codebook_dim:
            self.in_proj = Dense(input_dim, codebook_dim, **kw)
            self.out_proj = Dense(codebook_dim, input_dim, **kw)
        if codebook_type == "euclidean":
            self.codebook = EuclideanCodebook(codebook_dim, codebook_size, kmeans_init,
                                              kmeans_iters, decay, eps,
                                              threshold_ema_dead_code, **kw)
        elif codebook_type == "simple":
            self.codebook = SimpleCodebook(codebook_dim, codebook_size, use_l2_normalize, **kw)
        else:
            raise NotImplementedError(codebook_type)

    def _project_in(self, x):
        return self.in_proj(x) if self.input_dim != self.codebook_dim else x

    def _project_out(self, z):
        return self.out_proj(z) if self.input_dim != self.codebook_dim else z

    def forward(self, x: torch.Tensor, train: bool = False, init_idx=None,
                expire_idx=None) -> QuantizeResult:
        z_e = self._project_in(x)
        if self.codebook_type == "euclidean":
            z_q, indices = self.codebook(z_e, train=train, init_idx=init_idx,
                                         expire_idx=expire_idx)
        else:
            z_q, indices = self.codebook(z_e)
        commit = torch.mean(torch.square(z_e - z_q.detach()))
        codebook = torch.mean(torch.square(z_e.detach() - z_q))
        z_q = z_e + (z_q - z_e).detach()
        return QuantizeResult(self._project_out(z_q), indices, commit * self.commitment,
                              codebook * self.codebook_loss_weight)

    def vq2emb(self, indices: torch.Tensor) -> torch.Tensor:
        return self._project_out(self.codebook.vq2emb(indices))


class LookupFreeQuantize(nn.Module):
    """LFQ: a binary round in sigmoid space; the code is the index's bits.
    ``codebook_size`` must be ``2 ** codebook_dim``."""

    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int, device=None,
                 generator=None):
        super().__init__()
        if 2 ** codebook_dim != codebook_size:
            raise ValueError(f"codebook_size {codebook_size} != 2 ** {codebook_dim}")
        self.input_dim, self.codebook_dim = input_dim, codebook_dim
        if input_dim != codebook_dim:
            self.in_proj = Dense(input_dim, codebook_dim, device=device, generator=generator)
            self.out_proj = Dense(codebook_dim, input_dim, device=device, generator=generator)

    def _project_in(self, x):
        return self.in_proj(x) if self.input_dim != self.codebook_dim else x

    def _project_out(self, z):
        return self.out_proj(z) if self.input_dim != self.codebook_dim else z

    def _bits(self, device) -> torch.Tensor:
        return 2 ** torch.arange(self.codebook_dim, dtype=torch.int64, device=device)

    def forward(self, x: torch.Tensor) -> QuantizeResult:
        z_e = torch.sigmoid(self._project_in(x))
        z_q = z_e + (torch.round(z_e) - z_e).detach()
        indices = torch.sum(torch.round(z_e.detach()).to(torch.int64) * self._bits(x.device),
                            dim=-1)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return QuantizeResult(self._project_out(z_q), indices, zero, zero)

    def vq2emb(self, indices: torch.Tensor, out_proj: bool = True) -> torch.Tensor:
        bits = ((indices[..., None] // self._bits(indices.device)) % 2).to(torch.float32)
        return self._project_out(bits) if out_proj else bits
