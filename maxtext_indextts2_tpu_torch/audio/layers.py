"""Small layers shared by the audio modules, in the JAX package's layouts.

Activations are channels-last ``[B, T, C]`` and every kernel keeps the flax
layout (``Dense`` ``[in, out]``, ``Conv1d`` ``[k, in / groups, out]``), so the
state dict carries the JAX package's parameter tree name for name. Results
take the promoted type of input and parameters, as flax modules with
``dtype=None`` do: a float32 input through bfloat16 parameters gives float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _promoted(x: torch.Tensor, *params: torch.Tensor | None) -> torch.dtype:
    dt = x.dtype
    for p in params:
        if p is not None:
            dt = torch.promote_types(dt, p.dtype)
    return dt


def lecun_normal_(t: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """Truncated normal (cut at two sigma) with variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, mean=0.0, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


class Dense(nn.Module):
    """``y = x @ kernel + bias`` over the last axis; ``kernel [in, out]``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 kernel_init: str = "lecun_normal", bias_init: float = 0.0, device=None,
                 generator=None):
        super().__init__()
        kernel = torch.zeros((in_features, features), dtype=torch.float32, device=device)
        if kernel_init == "lecun_normal":
            lecun_normal_(kernel, in_features, generator)
        elif kernel_init != "zeros":
            raise ValueError(f"unknown kernel_init {kernel_init!r}")
        self.kernel = nn.Parameter(kernel)
        self.bias = None
        if use_bias:
            self.bias = nn.Parameter(
                torch.full((features,), bias_init, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _promoted(x, self.kernel, self.bias)
        y = torch.matmul(x.to(dt), self.kernel.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class Conv1d(nn.Module):
    """1-D convolution over ``[B, T, C]`` with a flax kernel ``[k, in / groups,
    out]``. ``padding``: ``"SAME"`` (odd kernels, stride 1), an int applied
    to both sides, or ``(left, right)``. ``use_bias=False`` holds no bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1, padding="SAME", use_bias: bool = True,
                 device=None, generator=None):
        super().__init__()
        if padding == "SAME":
            if stride != 1 or kernel_size % 2 == 0:
                raise ValueError("SAME padding is implemented for odd kernels at stride 1")
            padding = dilation * (kernel_size - 1) // 2
        self.stride, self.dilation, self.groups, self.padding = stride, dilation, groups, padding
        kernel = torch.empty((kernel_size, in_channels // groups, out_channels),
                             dtype=torch.float32, device=device)
        lecun_normal_(kernel, kernel_size * in_channels // groups, generator)
        self.kernel = nn.Parameter(kernel)
        self.bias = None
        if use_bias:
            self.bias = nn.Parameter(
                torch.zeros((out_channels,), dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _promoted(x, self.kernel, self.bias)
        # [k, in/groups, out] -> conv1d's [out, in/groups, k]; [B, T, C] -> [B, C, T]
        x = x.to(dt).transpose(1, 2)
        padding = self.padding
        if isinstance(padding, tuple):
            x, padding = F.pad(x, padding), 0
        y = F.conv1d(x, self.kernel.to(dt).permute(2, 1, 0),
                     None if self.bias is None else self.bias.to(dt), stride=self.stride,
                     padding=padding, dilation=self.dilation, groups=self.groups)
        return y.transpose(1, 2)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, statistics in float32, epsilon 1e-6;
    ``affine=False`` leaves out scale and bias."""

    def __init__(self, dim: int, epsilon: float = 1e-6, affine: bool = True, device=None):
        super().__init__()
        self.dim, self.epsilon = dim, epsilon
        self.scale = self.bias = None
        if affine:
            self.scale = nn.Parameter(torch.ones((dim,), dtype=torch.float32, device=device))
            self.bias = nn.Parameter(torch.zeros((dim,), dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _promoted(x, self.scale, self.bias)
        y = F.layer_norm(x.float(), (self.dim,), None, None, self.epsilon)
        if self.scale is not None:
            y = y * self.scale.float() + self.bias.float()
        return y.to(dt)
