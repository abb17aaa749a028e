"""Vision encoders and multimodal token fusion.

Counterpart of the JAX package's ``models/vision.py``, with its parameter
names and layouts (kernels ``[in, out]``, the patch convolution's kernel
``[P, P, 3, E]`` as flax keeps it), so that ``utils/param_bridge`` carries the
trees by name:

- ``VisionEncoder`` (``VisionConfig``): a SigLIP-style ViT. Patchify (a
  convolution whose stride is its kernel: a reshape into patches and one
  product), learned positions, pre-LN ``ViTBlock`` s (fused ``qkv``, tanh-GELU
  MLP), a final LayerNorm, an optional average pool by ``pool_stride`` and an
  optional ``projector``; ``output_dim=0`` returns the tower's output.
- ``merge_vision_embeddings``: image soft tokens in order at the
  ``image_token_id`` positions of the token stream.
- ``Gemma3MultiModalProjector``: the patch grid average-pooled to
  ``tokens_per_side``\\ :sup:`2`, a gemma RMSNorm (scale + 1) and the
  projection into the text width.
- ``Llama4VisionEncoder``: unfold patch embedding, the CLS token appended at
  the END, learned positions, 2D rope inside bias-MHA pre-LN blocks (exact-erf
  GELU MLP), then the pixel-shuffle MLP adapter.

The JAX modules' arithmetic is kept: flax's ``LayerNorm`` computes in float32
(mean, and the variance as mean of squares less the squared mean) and returns
float32 whatever its input (its parameters are float32); a ``Dense`` of
``dtype`` casts its input and weights to that dtype, as ``DenseGeneral`` does
(the patch convolution is a ``DenseGeneral`` over each patch's ``[P, P, 3]``).
Attention is ``models/attention.dot_product_attention``, the plain einsum with
a float32 softmax, as in the JAX package (no Pallas site).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from maxtext_indextts2_tpu_torch.models.attention import dot_product_attention
from maxtext_indextts2_tpu_torch.models.layers import DenseGeneral, RMSNorm


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    output_dim: int = 2048  # decoder emb_dim (0 = no projector, raw tower output)
    pool_stride: int = 4  # output tokens = (patches/stride^2)
    dtype: torch.dtype = torch.bfloat16


def _normal_(t: torch.Tensor, std: float, generator) -> torch.Tensor:
    with torch.no_grad():
        return t.copy_(torch.randn(t.shape, generator=generator, device=t.device) * std)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (epsilon 1e-6, ``scale`` and ``bias`` float32):
    statistics and result in float32."""

    def __init__(self, features: int, epsilon: float = 1e-6, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones((features,), device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros((features,), device=device), requires_grad=False)

    def reset_parameters(self, generator=None):
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias


def _dense(in_features, out_features, dtype, device, use_bias=True) -> DenseGeneral:
    """flax ``nn.Dense``: float32 ``kernel`` ``[in, out]`` and ``bias``, the
    product in ``dtype``."""
    return DenseGeneral(in_features, out_features, dtype=dtype, weight_dtype=torch.float32,
                        use_bias=use_bias, device=device)


class ViTBlock(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None):
        super().__init__()
        e = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.ln1 = LayerNorm(e, device=device)
        self.qkv = _dense(e, 3 * e, cfg.dtype, device)
        self.proj = _dense(e, e, cfg.dtype, device)
        self.ln2 = LayerNorm(e, device=device)
        self.fc1 = _dense(e, cfg.mlp_dim, cfg.dtype, device)
        self.fc2 = _dense(cfg.mlp_dim, e, cfg.dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, e = x.shape
        d = e // self.num_heads
        q, k, v = self.qkv(self.ln1(x)).chunk(3, dim=-1)
        attn = dot_product_attention(q.reshape(b, s, self.num_heads, d),
                                     k.reshape(b, s, self.num_heads, d),
                                     v.reshape(b, s, self.num_heads, d), None)
        x = x + self.proj(attn.reshape(b, s, e))
        h = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")  # jax.nn.gelu's default
        return x + self.fc2(h)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H / P, W / P, P, P, C]: each patch's pixels in
    (row, column, channel) order, the layout of flax's ``[P, P, C, E]``
    convolution kernel; with stride P and an image that P divides, flax's
    'SAME' convolution pads nothing and is this reshape and one product."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // patch, patch, w // patch, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5)


class VisionEncoder(nn.Module):
    """[B, H, W, 3] -> [B, num_image_tokens, output_dim] (``output_dim=0``:
    the tower's final-normed output, float32)."""

    def __init__(self, cfg: VisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hp = cfg.image_size // cfg.patch_size
        p = cfg.patch_size
        self.patch_embed = DenseGeneral((p, p, 3), cfg.hidden_size, axis=(-3, -2, -1),
                                        dtype=cfg.dtype, weight_dtype=torch.float32,
                                        use_bias=True, device=device)
        self.pos_embedding = nn.Parameter(torch.empty((1, hp * hp, cfg.hidden_size),
                                                      device=device), requires_grad=False)
        for i in range(cfg.num_layers):
            setattr(self, f"block_{i}", ViTBlock(cfg, device=device))
        self.final_ln = LayerNorm(cfg.hidden_size, device=device)
        self.projector = (_dense(cfg.hidden_size, cfg.output_dim, cfg.dtype, device)
                          if cfg.output_dim > 0 else None)

    def init_params(self, seed: int = 0):
        """Seeded random weights on the parameters' own device."""
        gen = torch.Generator(device=self.pos_embedding.device).manual_seed(int(seed))
        with torch.no_grad():
            _normal_(self.pos_embedding, 0.02, gen)
            for module in self.modules():
                if module is not self and hasattr(module, "reset_parameters"):
                    module.reset_parameters(gen)
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.patch_embed(patchify(images.to(cfg.dtype), cfg.patch_size))
        b, hp, wp, e = x.shape
        x = x.reshape(b, hp * wp, e) + self.pos_embedding.to(cfg.dtype)
        for i in range(cfg.num_layers):
            x = getattr(self, f"block_{i}")(x)
        x = self.final_ln(x)
        if cfg.pool_stride > 1:  # spatial average pool (gemma3-style token count)
            s = cfg.pool_stride
            x = x.reshape(b, hp, wp, e)[:, : hp // s * s, : wp // s * s]
            x = x.reshape(b, hp // s, s, wp // s, s, e).mean(dim=(2, 4)).reshape(b, -1, e)
        if self.projector is None:
            return x
        return self.projector(x)


def merge_vision_embeddings(token_embeddings: torch.Tensor, vision_embeddings: torch.Tensor,
                            tokens: torch.Tensor, image_token_id: int) -> torch.Tensor:
    """Replace the embeddings at image-placeholder positions with the vision
    tokens, in order: the i-th placeholder of a row takes the row's i-th
    vision token (the last one past the end)."""
    is_img = tokens == image_token_id
    slot = torch.clamp(torch.cumsum(is_img.to(torch.int32), dim=1) - 1, 0,
                       vision_embeddings.shape[1] - 1)
    gathered = torch.gather(vision_embeddings, 1,
                            slot[..., None].long().expand(-1, -1, vision_embeddings.shape[-1]))
    return torch.where(is_img[..., None], gathered.to(token_embeddings.dtype), token_embeddings)


class Gemma3MultiModalProjector(nn.Module):
    """SigLIP patch grid -> ``tokens_per_side``\\ :sup:`2` soft tokens in the
    text width: average pool, gemma RMSNorm (scale + 1), projection."""

    def __init__(self, vision_hidden: int, text_hidden: int, patches_per_side: int,
                 tokens_per_side: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.p, self.t = patches_per_side, tokens_per_side
        self.mm_soft_emb_norm = RMSNorm(vision_hidden, epsilon=eps, dtype=torch.float32,
                                        weight_dtype=torch.float32, scale_plus_one=True,
                                        device=device)
        self.mm_input_projection = nn.Parameter(torch.zeros((vision_hidden, text_hidden),
                                                            device=device), requires_grad=False)

    def forward(self, vision_outputs: torch.Tensor) -> torch.Tensor:
        b, _, e = vision_outputs.shape
        p, t = self.p, self.t
        k = p // t
        x = vision_outputs.reshape(b, t, k, t, k, e).mean(dim=(2, 4)).reshape(b, t * t, e)
        x = self.mm_soft_emb_norm(x)
        return (x @ self.mm_input_projection.to(x.dtype)).to(vision_outputs.dtype)


def llama4_rope_2d(image_size: int, patch_size: int, hidden_size: int, num_heads: int,
                   rope_theta: float = 10000.0) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) ``[patches + 1, head_dim / 2]`` of the 2D rope: x and y
    coordinates (from 1) interleaved, the CLS row (last) zero angle."""
    idx = image_size // patch_size
    n = idx * idx
    freq_dim = (hidden_size // num_heads) // 2
    pos = np.arange(n, dtype=np.int64)
    fx = (pos % idx).astype(np.float32)
    fy = (pos // idx).astype(np.float32)
    rope_freq = 1.0 / (rope_theta ** (
        np.arange(0, freq_dim, 2)[: freq_dim // 2].astype(np.float32) / freq_dim))
    freqs_x = np.repeat((fx + 1)[:, None] * rope_freq[None, :], 2, axis=-1)
    freqs_y = np.repeat((fy + 1)[:, None] * rope_freq[None, :], 2, axis=-1)
    freqs = np.concatenate([freqs_x, freqs_y], axis=-1)[:, ::2]
    freqs = np.concatenate([freqs, np.zeros((1, freqs.shape[1]), np.float32)])
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


class Llama4VisionEncoder(nn.Module):
    """Llama 4's vision tower -> per-image soft patches ``[B, (p *
    ratio)^2, projector_output_dim]``."""

    def __init__(self, image_size: int, patch_size: int, hidden_size: int, num_layers: int,
                 num_heads: int, intermediate_size: int, projector_input_dim: int,
                 projector_output_dim: int, pixel_shuffle_ratio: float = 0.5,
                 rope_theta: float = 10000.0, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.image_size, self.patch_size = image_size, patch_size
        self.hidden_size, self.num_layers, self.num_heads = hidden_size, num_layers, num_heads
        self.pixel_shuffle_ratio, self.dtype = pixel_shuffle_ratio, dtype
        e, hp = hidden_size, image_size // patch_size
        self.patch_embed = _dense(3 * patch_size * patch_size, e, dtype, device, use_bias=False)
        self.class_embedding = nn.Parameter(torch.empty((e,), device=device), requires_grad=False)
        self.positional_embedding_vlm = nn.Parameter(torch.empty((hp * hp + 1, e), device=device),
                                                     requires_grad=False)
        self.layernorm_pre = LayerNorm(e, device=device)
        self.layernorm_post = LayerNorm(e, device=device)
        for i in range(num_layers):
            for name in ("ln1", "ln2"):
                setattr(self, f"{name}_{i}", LayerNorm(e, device=device))
            for name in ("q", "k", "v", "o"):
                setattr(self, f"{name}_{i}", _dense(e, e, dtype, device))
            setattr(self, f"fc1_{i}", _dense(e, intermediate_size, dtype, device))
            setattr(self, f"fc2_{i}", _dense(intermediate_size, e, dtype, device))
        shuffled = int(e / (pixel_shuffle_ratio ** 2))
        self.adapter_fc1 = _dense(shuffled, projector_input_dim, dtype, device, use_bias=False)
        self.adapter_fc2 = _dense(projector_input_dim, projector_output_dim, dtype, device,
                                  use_bias=False)
        cos, sin = llama4_rope_2d(image_size, patch_size, hidden_size, num_heads, rope_theta)
        self.register_buffer("rope_cos", torch.from_numpy(cos).to(device), persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin).to(device), persistent=False)

    def init_params(self, seed: int = 0):
        gen = torch.Generator(device=self.class_embedding.device).manual_seed(int(seed))
        with torch.no_grad():
            std = self.hidden_size ** -0.5
            _normal_(self.class_embedding, std, gen)
            _normal_(self.positional_embedding_vlm, std, gen)
            for module in self.modules():
                if module is not self and hasattr(module, "reset_parameters"):
                    module.reset_parameters(gen)
        return self

    def _rope(self, t: torch.Tensor) -> torch.Tensor:
        """[B, S, H, hd]: each (even, odd) pair rotated as a complex number."""
        tr = t.reshape(*t.shape[:-1], -1, 2)
        re, im = tr[..., 0], tr[..., 1]
        c, s = self.rope_cos[None, :, None, :], self.rope_sin[None, :, None, :]
        return torch.stack([re * c - im * s, re * s + im * c], dim=-1).reshape(t.shape).to(t.dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b = images.shape[0]
        p, hp, e = self.patch_size, self.image_size // self.patch_size, self.hidden_size
        # unfold: each patch's features channel-major (torch Unfold's order)
        x = images.to(self.dtype).reshape(b, hp, p, hp, p, 3)
        x = x.permute(0, 1, 3, 5, 2, 4).reshape(b, hp * hp, 3 * p * p)
        x = self.patch_embed(x)
        x = torch.cat([x, self.class_embedding.to(self.dtype).expand(b, 1, e)], dim=1)
        x = self.layernorm_pre(x + self.positional_embedding_vlm.to(self.dtype))
        hd = e // self.num_heads
        for i in range(self.num_layers):
            h = getattr(self, f"ln1_{i}")(x)
            q, k, v = (getattr(self, f"{n}_{i}")(h).reshape(b, -1, self.num_heads, hd)
                       for n in ("q", "k", "v"))
            attn = dot_product_attention(self._rope(q), self._rope(k), v, None)
            x = x + getattr(self, f"o_{i}")(attn.reshape(b, -1, e))
            h = F.gelu(getattr(self, f"fc1_{i}")(getattr(self, f"ln2_{i}")(x)))
            x = x + getattr(self, f"fc2_{i}")(h)
        x = self.layernorm_post(x)[:, :-1]  # drop CLS
        # pixel shuffle: ratio < 1 trades space for channels
        r = self.pixel_shuffle_ratio
        g, c = int(math.isqrt(x.shape[1])), x.shape[-1]
        t = x.reshape(b, g, g, c)
        t = t.reshape(b, g, int(g * r), int(c / r)).permute(0, 2, 1, 3)
        t = t.reshape(b, int(g * r), int(g * r), int(c / (r * r))).permute(0, 2, 1, 3)
        x = t.reshape(b, -1, int(c / (r * r)))
        h = F.gelu(self.adapter_fc1(x))
        return F.gelu(self.adapter_fc2(h))
