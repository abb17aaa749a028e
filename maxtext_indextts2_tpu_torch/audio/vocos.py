"""Vocos backbone (ConvNeXt-1D) and ISTFT head.

Counterpart of the JAX package's ``audio/vocos.py``: hidden states ->
(magnitude, phase) -> inverse STFT with overlap-add. Layout ``[B, T, C]``
channels-last at every public function, as there; the convolutions move to
PyTorch's ``[B, C, T]`` inside ``layers.Conv1d``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from maxtext_indextts2_tpu_torch.audio.layers import Conv1d, Dense, LayerNorm


class _Embed(nn.Module):
    def __init__(self, num_embeddings: int, dim: int, value: float, device=None):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.full((num_embeddings, dim), value, dtype=torch.float32, device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]


class AdaLayerNorm(nn.Module):
    """LayerNorm (no affine) whose scale and shift are embedding lookups of
    a condition id."""

    def __init__(self, num_embeddings: int, dim: int, device=None):
        super().__init__()
        self.scale = _Embed(num_embeddings, dim, 1.0, device)
        self.shift = _Embed(num_embeddings, dim, 0.0, device)
        self.norm = LayerNorm(dim, affine=False)

    def forward(self, x: torch.Tensor, cond_id: torch.Tensor) -> torch.Tensor:
        scale, shift = self.scale(cond_id), self.shift(cond_id)
        x = self.norm(x)
        while scale.ndim < x.ndim:
            scale, shift = scale[:, None], shift[:, None]
        return x * scale + shift


def _norm(dim, adanorm_num_embeddings, device):
    if adanorm_num_embeddings:
        return AdaLayerNorm(adanorm_num_embeddings, dim, device)
    return LayerNorm(dim, device=device)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, intermediate_dim: int, layer_scale_init_value: float = 1e-2,
                 adanorm_num_embeddings: int | None = None, device=None, generator=None):
        super().__init__()
        self.adanorm = bool(adanorm_num_embeddings)
        kw = dict(device=device, generator=generator)
        self.dwconv = Conv1d(dim, dim, 7, groups=dim, **kw)  # depthwise
        self.norm = _norm(dim, adanorm_num_embeddings, device)
        self.pwconv1 = Dense(dim, intermediate_dim, **kw)
        self.pwconv2 = Dense(intermediate_dim, dim, **kw)
        self.gamma = nn.Parameter(torch.full(
            (dim,), layer_scale_init_value, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor, cond_id: torch.Tensor | None = None) -> torch.Tensor:
        residual = x
        x = self.dwconv(x)
        x = self.norm(x, cond_id) if self.adanorm else self.norm(x)
        x = self.pwconv2(F.gelu(self.pwconv1(x)))  # exact (erf) GELU
        return residual + self.gamma * x


class VocosBackbone(nn.Module):
    def __init__(self, input_channels: int, dim: int = 512, intermediate_dim: int = 2048,
                 num_layers: int = 30, adanorm_num_embeddings: int | None = None,
                 device=None, generator=None):
        super().__init__()
        self.num_layers = num_layers
        self.adanorm = bool(adanorm_num_embeddings)
        self.embed = Conv1d(input_channels, dim, 7, device=device, generator=generator)
        self.norm = _norm(dim, adanorm_num_embeddings, device)
        for i in range(num_layers):
            setattr(self, f"convnext_{i}", ConvNeXtBlock(
                dim, intermediate_dim, 1.0 / num_layers, adanorm_num_embeddings,
                device=device, generator=generator))
        self.final_layer_norm = LayerNorm(dim, device=device)

    def forward(self, x: torch.Tensor, cond_id: torch.Tensor | None = None) -> torch.Tensor:
        """[B, T, input_channels] -> [B, T, dim]."""
        x = self.embed(x)
        x = self.norm(x, cond_id) if self.adanorm else self.norm(x)
        for i in range(self.num_layers):
            x = getattr(self, f"convnext_{i}")(x, cond_id)
        return self.final_layer_norm(x)


def istft_overlap_add(spec_real: torch.Tensor, spec_imag: torch.Tensor, n_fft: int,
                      hop: int) -> torch.Tensor:
    """[B, F, n_fft//2+1] complex (as re/im) -> [B, F*hop]: inverse STFT with
    a periodic Hann window, overlap-added, divided by the summed squared
    windows (floored at 1e-8) and cropped by ``(n_fft - hop) // 2``."""
    if n_fft % hop:
        raise ValueError("istft requires hop | n_fft")
    spec = torch.complex(spec_real.float(), spec_imag.float())
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1)  # [B, F, n_fft]
    win = torch.hann_window(n_fft, periodic=True, dtype=torch.float32, device=frames.device)
    frames = frames * win

    b, f, _ = frames.shape
    ratio = n_fft // hop
    # frame i's k-th hop-chunk lands in output hop-block i+k: `ratio` slice-adds
    fr = frames.reshape(b, f, ratio, hop)
    blocks = f + ratio - 1
    out = torch.zeros((b, blocks, hop), dtype=torch.float32, device=frames.device)
    wsq = torch.square(win).reshape(ratio, hop)
    norm = torch.zeros((blocks, hop), dtype=torch.float32, device=frames.device)
    for k in range(ratio):
        out[:, k:k + f] += fr[:, :, k]
        norm[k:k + f] += wsq[k]
    out = out / torch.clamp(norm, min=1e-8)[None]
    pad = (n_fft - hop) // 2
    return out.reshape(b, blocks * hop)[:, pad:pad + f * hop]


class ISTFTHead(nn.Module):
    """Vocos head: hidden -> (mag, phase) -> ISTFT waveform."""

    def __init__(self, dim: int, n_fft: int = 1920, hop: int = 480, device=None, generator=None):
        super().__init__()
        self.n_fft, self.hop = n_fft, hop
        self.out = Dense(dim, n_fft + 2, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, C] -> [B, T*hop] waveform."""
        mag, phase = torch.chunk(self.out(x), 2, dim=-1)
        mag = torch.clamp(torch.exp(torch.clamp(mag, -20.0, 20.0)), max=1e2)
        return istft_overlap_add(mag * torch.cos(phase), mag * torch.sin(phase),
                                 self.n_fft, self.hop)
