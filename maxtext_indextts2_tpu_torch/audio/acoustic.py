"""Acoustic codec: DAC/SoundStream-style encoder + 12-layer RVQ + Vocos (or
DAC-style conv) decoder, 24 kHz audio, total encoder stride 480 -> 50 Hz.

Counterpart of the JAX package's ``audio/acoustic.py`` for serving:
``tokenize`` (waveform ``[B, T]`` -> encoder latents -> residual VQ ids
``[Q, B, T / 480]``) and ``detokenize`` (ids -> embeddings -> waveform
``[B, T * 480]``). The training calls wait with training. Layout ``[B, T, C]``
channels-last (``[B, T]`` waveforms).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from maxtext_indextts2_tpu_torch.audio.layers import Conv1d, lecun_normal_
from maxtext_indextts2_tpu_torch.audio.quantize import ResidualVQ
from maxtext_indextts2_tpu_torch.audio.vocos import ISTFTHead, VocosBackbone
from maxtext_indextts2_tpu_torch.unported import _unsupported


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin^2(alpha x) / alpha."""
    return x + torch.square(torch.sin(alpha * x)) / torch.clamp(alpha, min=1e-9)


class Snake1d(nn.Module):
    def __init__(self, channels: int, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones((channels,), dtype=torch.float32, device=device))

    def forward(self, x):
        return snake(x, self.alpha)


class ResidualUnit(nn.Module):
    def __init__(self, dim: int, dilation: int = 1, device=None, generator=None):
        super().__init__()
        self.snake1 = Snake1d(dim, device)
        self.conv1 = Conv1d(dim, dim, 7, dilation=dilation, device=device, generator=generator)
        self.snake2 = Snake1d(dim, device)
        self.conv2 = Conv1d(dim, dim, 1, device=device, generator=generator)

    def forward(self, x):
        return x + self.conv2(self.snake2(self.conv1(self.snake1(x))))


class EncoderBlock(nn.Module):
    """3 dilated residual units -> Snake -> strided conv (kernel 2 * stride,
    padding ceil(stride / 2) on both sides) doubling the channels."""

    def __init__(self, out_dim: int, stride: int, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        in_dim = out_dim // 2
        self.res1 = ResidualUnit(in_dim, 1, **kw)
        self.res2 = ResidualUnit(in_dim, 3, **kw)
        self.res3 = ResidualUnit(in_dim, 9, **kw)
        self.snake = Snake1d(in_dim, device)
        self.down = Conv1d(in_dim, out_dim, 2 * stride, stride=stride,
                           padding=math.ceil(stride / 2), **kw)

    def forward(self, x):
        return self.down(self.snake(self.res3(self.res2(self.res1(x)))))


class CodecEncoder(nn.Module):
    """24 kHz wav ``[B, T]`` -> ``[B, T / 480, out_channels]`` latents."""

    def __init__(self, d_model: int = 96, strides: tuple[int, ...] = (3, 4, 5, 8),
                 out_channels: int = 256, use_tanh: bool = False, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.use_tanh = use_tanh
        self.num_blocks = len(strides)
        d = d_model
        self.conv_in = Conv1d(1, d, 7, **kw)
        for i, s in enumerate(strides):
            d *= 2
            setattr(self, f"block_{i}", EncoderBlock(d, s, **kw))
        self.snake_out = Snake1d(d, device)
        self.conv_out = Conv1d(d, out_channels, 3, **kw)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(wav[..., None])
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x)
        x = self.conv_out(self.snake_out(x))
        return torch.tanh(x) if self.use_tanh else x


class UpsampleConv(nn.Module):
    """Transposed convolution (kernel 2s, stride s, padding ceil(s/2), output
    padding s % 2): output length exactly ``T * s``. The JAX package writes it
    as an input-dilated correlation with an unflipped ``[k, in, out]`` kernel
    and padding ``(k-1-p, k-1-p + s%2)``; as ``conv_transpose1d`` that is the
    same kernel flipped along k."""

    def __init__(self, in_dim: int, out_dim: int, stride: int, device=None, generator=None):
        super().__init__()
        self.stride = stride
        k = 2 * stride
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty((k, in_dim, out_dim), dtype=torch.float32, device=device),
            k * in_dim, generator))
        self.bias = nn.Parameter(torch.zeros((out_dim,), dtype=torch.float32, device=device))

    def forward(self, x):
        s = self.stride
        # [k, in, out] -> conv_transpose1d's [in, out, k], flipped along k
        w = self.kernel.flip(0).permute(1, 2, 0)
        y = F.conv_transpose1d(x.transpose(1, 2), w, self.bias, stride=s,
                               padding=s // 2 + s % 2, output_padding=s % 2)
        return y.transpose(1, 2)


class DecoderBlock(nn.Module):
    """Snake -> transposed conv -> 3 dilated residual units."""

    def __init__(self, in_dim: int, out_dim: int, stride: int, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.snake = Snake1d(in_dim, device)
        self.up = UpsampleConv(in_dim, out_dim, stride, **kw)
        self.res1 = ResidualUnit(out_dim, 1, **kw)
        self.res2 = ResidualUnit(out_dim, 3, **kw)
        self.res3 = ResidualUnit(out_dim, 9, **kw)

    def forward(self, x):
        return self.res3(self.res2(self.res1(self.up(self.snake(x)))))


class ConvDecoder(nn.Module):
    """DAC-style conv waveform decoder: conv-in, halving-channel
    DecoderBlocks, Snake, conv-out, tanh."""

    def __init__(self, in_channels: int, upsample_initial_channel: int = 1024,
                 up_ratios: tuple[int, ...] = (5, 5, 4, 2), device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        c = upsample_initial_channel
        self.num_blocks = len(up_ratios)
        self.conv_in = Conv1d(in_channels, c, 7, **kw)
        for i, s in enumerate(up_ratios):
            setattr(self, f"block_{i}", DecoderBlock(c // 2 ** i, c // 2 ** (i + 1), s, **kw))
        out = c // 2 ** len(up_ratios)
        self.snake_out = Snake1d(out, device)
        self.conv_out = Conv1d(out, 1, 7, **kw)

    def forward(self, x):
        """[B, T, in_channels] -> [B, T * prod(up_ratios)] waveform."""
        x = self.conv_in(x)
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x)
        return torch.tanh(self.conv_out(self.snake_out(x)))[..., 0]


class CodecDecoder(nn.Module):
    """RVQ over latents + Vocos (or conv) decode to a waveform."""

    def __init__(self, in_channels: int = 256, num_quantizers: int = 12,
                 codebook_size: int = 1024, codebook_dim: int = 8, commitment: float = 0.15,
                 codebook_loss_weight: float = 1.0, quantizer_dropout: float = 0.0,
                 vocos_dim: int = 512, vocos_intermediate_dim: int = 2048,
                 vocos_num_layers: int = 30, n_fft: int = 1920, hop: int = 480,
                 use_vocos: bool = True, upsample_initial_channel: int = 1024,
                 up_ratios: tuple[int, ...] = (5, 5, 4, 2), device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.use_vocos = use_vocos
        self.hop = hop if use_vocos else math.prod(up_ratios)
        self.quantizer = ResidualVQ(
            in_channels, num_quantizers, codebook_size, codebook_dim, commitment,
            codebook_loss_weight, True, quantizer_dropout, **kw)
        if use_vocos:
            self.model = VocosBackbone(in_channels, vocos_dim, vocos_intermediate_dim,
                                       vocos_num_layers, **kw)
            self.head = ISTFTHead(vocos_dim, n_fft, hop, **kw)
        else:
            self.model = ConvDecoder(in_channels, upsample_initial_channel, up_ratios, **kw)

    def vq2emb(self, indices: torch.Tensor, n_quantizers: int | None = None) -> torch.Tensor:
        """[Q,B,T] acoustic token ids -> [B,T,in_channels] embeddings."""
        return self.quantizer.vq2emb(indices, n_quantizers)

    def decode(self, quantized: torch.Tensor) -> torch.Tensor:
        """[B,T,in_channels] -> [B, T*hop] waveform."""
        if self.use_vocos:
            return self.head(self.model(quantized))
        return self.model(quantized)

    def quantize(self, latents, n_quantizers: int | None = None):
        return self.quantizer.quantize(latents, n_quantizers)

    def latent2dist(self, latents, n_quantizers: int | None = None):
        return self.quantizer.latent2dist(latents, n_quantizers)

    def forward(self, latents, n_quantizers: int | None = None, dropout_rng=None):
        _unsupported("CodecDecoder.__call__ (codec training: quantize + decode)",
                     "4b, rest of training: codec training")


class AcousticCodec(nn.Module):
    """Encoder + decoder pair with the ``tokenize()`` / ``detokenize()``
    inference API."""

    def __init__(self, d_model: int = 96, strides: tuple[int, ...] = (3, 4, 5, 8),
                 latent_dim: int = 256, num_quantizers: int = 12, codebook_size: int = 1024,
                 codebook_dim: int = 8, quantizer_dropout: float = 0.0, vocos_dim: int = 512,
                 vocos_intermediate_dim: int = 2048, vocos_num_layers: int = 30,
                 device=None, generator=None):
        super().__init__()
        self.d_model, self.strides, self.latent_dim = d_model, tuple(strides), latent_dim
        self.num_quantizers, self.codebook_size = num_quantizers, codebook_size
        self.encoder = CodecEncoder(d_model, self.strides, latent_dim, device=device,
                                    generator=generator)
        self.decoder = CodecDecoder(
            in_channels=latent_dim, num_quantizers=num_quantizers, codebook_size=codebook_size,
            codebook_dim=codebook_dim, quantizer_dropout=quantizer_dropout,
            vocos_dim=vocos_dim, vocos_intermediate_dim=vocos_intermediate_dim,
            vocos_num_layers=vocos_num_layers, device=device, generator=generator)

    @torch.no_grad()
    def detokenize(self, indices: torch.Tensor) -> torch.Tensor:
        """[Q, B, T] token ids -> [B, T*480] waveform."""
        return self.decoder.decode(self.decoder.vq2emb(indices))

    @torch.no_grad()
    def tokenize(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, T] 24 kHz wav -> [Q, B, T/480] acoustic token ids (int64)."""
        _, idx = self.decoder.quantize(self.encoder(wav))
        return idx

    def forward(self, wav, dropout_rng=None):
        _unsupported("AcousticCodec.__call__ (codec autoencoder training)",
                     "4b, rest of training: codec training")
