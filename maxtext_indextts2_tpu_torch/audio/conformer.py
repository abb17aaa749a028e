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
  ``stat_std``;
- ``config_from_hf_state_dict`` / ``params_from_hf``: a HF
  ``Wav2Vec2BertModel`` state dict -> this config / this module's state dict.

The relative bias is computed as the JAX package does: the ``[S, S, d]``
table of distance embeddings is gathered and contracted with the queries
(at S = 300 and d = 64 that is 23 MB of float32 per layer; the gather is
kept so that the sum is taken over the same terms in the same layout).
Layout ``[B, T, C]``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from maxtext_indextts2_tpu_torch.audio.layers import Conv1d, Dense, LayerNorm


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


def _numpy(state_dict) -> dict[str, np.ndarray]:
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in state_dict.items()}


def config_from_hf_state_dict(state_dict, output_layer: int = 17) -> ConformerConfig:
    """A ConformerConfig from a HF ``Wav2Vec2BertModel`` state dict. Every
    field but one is read off the weight shapes (the head count from the
    relative-position ``distance_embedding``: rows = left + right + 1,
    columns = head_dim); the left / right split is not, so the
    w2v-bert-2.0 convention ``right = 8`` is assumed."""
    sd = _numpy(state_dict)
    hidden, input_dim = sd["feature_projection.projection.weight"].shape  # [hidden, input]
    num_layers = 0
    while f"encoder.layers.{num_layers}.final_layer_norm.weight" in sd:
        num_layers += 1
    dist = sd["encoder.layers.0.self_attn.distance_embedding.weight"]
    head_dim = dist.shape[1]
    right = 8 if dist.shape[0] > 9 else 1
    return ConformerConfig(
        input_dim=input_dim,
        hidden_size=hidden,
        num_layers=num_layers,
        num_heads=hidden // head_dim,
        intermediate_size=sd["encoder.layers.0.ffn1.intermediate_dense.weight"].shape[0],
        conv_kernel_size=sd["encoder.layers.0.conv_module.depthwise_conv.weight"].shape[-1],
        left_max_distance=dist.shape[0] - 1 - right,
        right_max_distance=right,
        output_layer=min(output_layer, num_layers),
    )


def params_from_hf(state_dict, cfg: ConformerConfig, stat_mean=None,
                   stat_std=None) -> dict[str, torch.Tensor]:
    """A HF ``Wav2Vec2BertModel`` state dict (torch tensors or numpy) -> the
    state dict of ``SemanticEncoder(cfg)``: the layers up to the tap
    (``min(output_layer, num_layers)``, the only ones this package builds),
    ``stat_mean`` / ``stat_std`` (identity by default; the layer statistics
    of the published ``wav2vec2bert_stats.pt``). A checkpoint with fewer
    layers than the tap needs raises (the JAX package asks for
    ``num_layers``: it holds the layers past the tap too)."""
    sd = _numpy(state_dict)

    def dense(prefix, bias=True):
        p = {"kernel": sd[f"{prefix}.weight"].T}
        if bias:
            p["bias"] = sd[f"{prefix}.bias"]
        return p

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    sd_layers = 0
    while f"encoder.layers.{sd_layers}.final_layer_norm.weight" in sd:
        sd_layers += 1
    tap = min(cfg.output_layer, cfg.num_layers)
    if sd_layers < tap:
        raise ValueError(
            f"state dict has {sd_layers} encoder layers but the tap needs {tap}: an "
            "incomplete checkpoint (layers past it would stay random under the tap)")
    enc = {"fp_layer_norm": ln("feature_projection.layer_norm"),
           "fp_projection": dense("feature_projection.projection")}
    for i in range(tap):
        hf = f"encoder.layers.{i}"
        enc[f"layers_{i}"] = {
            "ffn1_layer_norm": ln(f"{hf}.ffn1_layer_norm"),
            "ffn1": {"intermediate_dense": dense(f"{hf}.ffn1.intermediate_dense"),
                     "output_dense": dense(f"{hf}.ffn1.output_dense")},
            "self_attn_layer_norm": ln(f"{hf}.self_attn_layer_norm"),
            "self_attn": {
                "linear_q": dense(f"{hf}.self_attn.linear_q"),
                "linear_k": dense(f"{hf}.self_attn.linear_k"),
                "linear_v": dense(f"{hf}.self_attn.linear_v"),
                "linear_out": dense(f"{hf}.self_attn.linear_out"),
                "distance_embedding": sd[f"{hf}.self_attn.distance_embedding.weight"],
            },
            "conv_module": {
                "layer_norm": ln(f"{hf}.conv_module.layer_norm"),
                # HF Conv1d [out, in, 1] -> Dense kernel [in, out]
                "pointwise_conv1": {
                    "kernel": sd[f"{hf}.conv_module.pointwise_conv1.weight"][:, :, 0].T},
                # HF depthwise [C, 1, K] -> Conv1d kernel [K, 1, C]
                "depthwise_conv": {
                    "kernel": sd[f"{hf}.conv_module.depthwise_conv.weight"].transpose(2, 1, 0)},
                "depthwise_layer_norm": ln(f"{hf}.conv_module.depthwise_layer_norm"),
                "pointwise_conv2": {
                    "kernel": sd[f"{hf}.conv_module.pointwise_conv2.weight"][:, :, 0].T},
            },
            "ffn2_layer_norm": ln(f"{hf}.ffn2_layer_norm"),
            "ffn2": {"intermediate_dense": dense(f"{hf}.ffn2.intermediate_dense"),
                     "output_dense": dense(f"{hf}.ffn2.output_dense")},
            "final_layer_norm": ln(f"{hf}.final_layer_norm"),
        }
    h = cfg.hidden_size
    out = {f"encoder.{k}": v for k, v in _flat(enc).items()}
    out["stat_mean"] = np.zeros(h, np.float32) if stat_mean is None else np.asarray(
        stat_mean, np.float32)
    out["stat_std"] = np.ones(h, np.float32) if stat_std is None else np.asarray(
        stat_std, np.float32)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _flat(tree, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out
