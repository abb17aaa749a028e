"""W2v-BERT-class conformer encoder: the semantic tokenizer's feature tap.

Counterpart of the JAX package's ``audio/conformer.py`` (itself the
architecture of HF's ``Wav2Vec2BertModel``), with the same parameter names
and layouts:

- feature projection: LayerNorm(160) -> Dense(1024)
- ``min(output_layer, num_layers)`` conformer layers, the only ones built:
  0.5 * FFN -> self-attention with a Shaw relative-key bias (distance
  clipped to [-64, 8]) -> conv module (pointwise -> GLU -> *causal*
  depthwise k=31 -> LN -> swish -> pointwise) -> 0.5 * FFN -> final LN
- ``SemanticEncoder``: the tap normalised by per-dim ``stat_mean`` /
  ``stat_std``.

The relative bias is computed as the JAX package does: the ``[S, S, d]``
table of distance embeddings is gathered and contracted with the queries
(at S = 300 and d = 64 that is 23 MB of float32 per layer; the gather is
kept so that the sum is taken over the same terms in the same layout).
Layout ``[B, T, C]``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from maxtext_indextts2_tpu_torch.audio.layers import Conv1d, Dense, LayerNorm
from maxtext_indextts2_tpu_torch.unported import _unsupported

_CHECKPOINTS = "4b, rest of training: weight import, item 4b.1"


@dataclass(frozen=True)
class ConformerConfig:
    input_dim: int = 160
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    conv_kernel_size: int = 31
    left_max_distance: int = 64
    right_max_distance: int = 8
    layer_norm_eps: float = 1e-5
    output_layer: int = 17  # tap layer for semantic features
    dtype: torch.dtype = torch.float32


class FeedForward(nn.Module):
    def __init__(self, cfg: ConformerConfig, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.intermediate_dense = Dense(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.output_dense = Dense(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x):
        return self.output_dense(F.silu(self.intermediate_dense(x)))


class RelPosSelfAttention(nn.Module):
    def __init__(self, cfg: ConformerConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        kw = dict(device=device, generator=generator)
        self.linear_q = Dense(h, h, **kw)
        self.linear_k = Dense(h, h, **kw)
        self.linear_v = Dense(h, h, **kw)
        self.linear_out = Dense(h, h, **kw)
        num_pos = cfg.left_max_distance + cfg.right_max_distance + 1
        self.distance_embedding = nn.Parameter(torch.empty(
            (num_pos, h // cfg.num_heads), dtype=torch.float32, device=device
        ).normal_(0.0, 0.02, generator=generator))

    def forward(self, x, pad_mask):
        cfg = self.cfg
        b, s, _ = x.shape
        n, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        q = self.linear_q(x).reshape(b, s, n, d)
        k = self.linear_k(x).reshape(b, s, n, d)
        v = self.linear_v(x).reshape(b, s, n, d)
        # a tensor: on the GPU a division by a Python number is a product
        # with its rounded reciprocal
        scale = torch.tensor(math.sqrt(d), dtype=q.dtype, device=q.device)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / scale

        # Shaw relative-position bias, distance (key - query) clipped to [-left, right]
        pos = torch.arange(s, device=x.device)
        dist = torch.clamp(pos[None, :] - pos[:, None], -cfg.left_max_distance,
                           cfg.right_max_distance)
        pe = self.distance_embedding[dist + cfg.left_max_distance]  # [S, S, d]
        scores = scores + torch.einsum("bqhd,qkd->bhqk", q, pe.to(q.dtype)) / scale

        if pad_mask is not None:
            scores = scores.masked_fill(~pad_mask[:, None, None, :].bool(), -1e9)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, cfg.hidden_size)
        return self.linear_out(out)


class ConvModule(nn.Module):
    def __init__(self, cfg: ConformerConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        kw = dict(device=device, generator=generator)
        self.layer_norm = LayerNorm(h, cfg.layer_norm_eps, device=device)
        self.pointwise_conv1 = Dense(h, 2 * h, use_bias=False, **kw)
        # depthwise (groups = channels), causal: left-padded by k - 1
        self.depthwise_conv = Conv1d(h, h, cfg.conv_kernel_size, groups=h,
                                     padding=(cfg.conv_kernel_size - 1, 0), use_bias=False, **kw)
        self.depthwise_layer_norm = LayerNorm(h, cfg.layer_norm_eps, device=device)
        self.pointwise_conv2 = Dense(h, h, use_bias=False, **kw)

    def forward(self, x, pad_mask):
        x = self.layer_norm(x)
        if pad_mask is not None:
            x = x.masked_fill(~pad_mask[..., None].bool(), 0.0)
        a, g = torch.chunk(self.pointwise_conv1(x), 2, dim=-1)
        x = self.depthwise_conv(a * torch.sigmoid(g))
        x = F.silu(self.depthwise_layer_norm(x))
        return self.pointwise_conv2(x)


class ConformerLayer(nn.Module):
    def __init__(self, cfg: ConformerConfig, device=None, generator=None):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        kw = dict(device=device, generator=generator)
        self.ffn1_layer_norm = LayerNorm(h, eps, device=device)
        self.ffn1 = FeedForward(cfg, **kw)
        self.self_attn_layer_norm = LayerNorm(h, eps, device=device)
        self.self_attn = RelPosSelfAttention(cfg, **kw)
        self.conv_module = ConvModule(cfg, **kw)
        self.ffn2_layer_norm = LayerNorm(h, eps, device=device)
        self.ffn2 = FeedForward(cfg, **kw)
        self.final_layer_norm = LayerNorm(h, eps, device=device)

    def forward(self, x, pad_mask):
        x = x + 0.5 * self.ffn1(self.ffn1_layer_norm(x))
        x = x + self.self_attn(self.self_attn_layer_norm(x), pad_mask)
        x = x + self.conv_module(x, pad_mask)
        x = x + 0.5 * self.ffn2(self.ffn2_layer_norm(x))
        return self.final_layer_norm(x)


class ConformerEncoder(nn.Module):
    """Feature projection and the layers up to the tap: only
    ``min(output_layer, num_layers)`` layers exist, as only they run."""

    def __init__(self, cfg: ConformerConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        self.fp_layer_norm = LayerNorm(cfg.input_dim, cfg.layer_norm_eps, device=device)
        self.fp_projection = Dense(cfg.input_dim, cfg.hidden_size, **kw)
        self.num_run = min(cfg.output_layer, cfg.num_layers)
        for i in range(self.num_run):
            setattr(self, f"layers_{i}", ConformerLayer(cfg, **kw))

    def forward(self, feats, pad_mask=None):
        x = self.fp_projection(self.fp_layer_norm(feats))
        for i in range(self.num_run):
            x = getattr(self, f"layers_{i}")(x, pad_mask)
        return x


class SemanticEncoder(nn.Module):
    """The conformer's tap normalised by precomputed per-dim statistics."""

    def __init__(self, cfg: ConformerConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = ConformerEncoder(cfg, device=device, generator=generator)
        h = cfg.hidden_size
        self.stat_mean = nn.Parameter(torch.zeros((h,), dtype=torch.float32, device=device))
        self.stat_std = nn.Parameter(torch.ones((h,), dtype=torch.float32, device=device))

    def forward(self, feats, pad_mask=None):
        x = self.encoder(feats, pad_mask)
        return (x - self.stat_mean) / torch.clamp(self.stat_std, min=1e-6)


def config_from_hf_state_dict(state_dict, output_layer: int = 17):
    _unsupported("conformer.config_from_hf_state_dict (HF w2v-BERT checkpoints)", _CHECKPOINTS)


def params_from_hf(state_dict, cfg: ConformerConfig, stat_mean=None, stat_std=None):
    _unsupported("conformer.params_from_hf (HF w2v-BERT checkpoints)", _CHECKPOINTS)
