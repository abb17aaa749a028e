"""Core NN building blocks: Embed, RMSNorm, DenseGeneral, MlpBlock.

Counterparts of the JAX package's ``models/layers.py``. Kernels keep the
JAX layout ``[in..., out...]`` so a weight crosses between the packages as a
plain copy (``utils/param_bridge.py``). Matrix products run with inputs and
kernel cast to ``dtype`` and float32 accumulation (what cuBLAS does for
bfloat16 operands), and the result is cast back to ``dtype``.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Iterable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from maxtext_indextts2_tpu_torch.unported import _unsupported

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def to_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(DTYPES)}")
    return DTYPES[name]


def _canon_tuple(x) -> tuple[int, ...]:
    if isinstance(x, Iterable) and not isinstance(x, (str, bytes)):
        return tuple(int(v) for v in x)
    return (int(x),)


def _truncated_normal_(t: torch.Tensor, std: float, generator) -> torch.Tensor:
    """Variance-scaling truncated normal (cut at two sigma, rescaled so the
    result has standard deviation ``std``), the JAX package's dense init."""
    stddev = std / 0.87962566103423978
    return nn.init.trunc_normal_(
        t, mean=0.0, std=stddev, a=-2 * stddev, b=2 * stddev, generator=generator
    )


class DenseGeneral(nn.Module):
    """Linear map over arbitrary trailing contraction axes.

    in_shape: sizes of the contracted input axes; features: output dims;
    axis: which input axes are contracted (they must be the trailing
    ``len(in_shape)`` axes, in order, as everywhere in this model).
    ``kernel`` has shape ``in_shape + features``.
    """

    def __init__(
        self,
        in_shape: int | Sequence[int],
        features: int | Sequence[int],
        axis: int | Sequence[int] = -1,
        dtype: torch.dtype = torch.bfloat16,
        weight_dtype: torch.dtype = torch.float32,
        use_bias: bool = False,
        quantization: str = "",
        lora_rank: int = 0,
        device=None,
    ):
        super().__init__()
        if quantization:
            _unsupported(
                f"quantization={quantization!r} (AQT / int8w_serve matmuls)",
                "5, decode extras",
            )
        if lora_rank > 0:
            _unsupported("LoRA adapters", "5, decode extras")
        self.in_shape = _canon_tuple(in_shape)
        self.features = _canon_tuple(features)
        self.axis = _canon_tuple(axis)
        if len(self.axis) != len(self.in_shape):
            raise ValueError((self.axis, self.in_shape))
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.empty(self.in_shape + self.features, dtype=weight_dtype, device=device),
            requires_grad=False,
        )
        self.bias = (
            nn.Parameter(
                torch.zeros(self.features, dtype=weight_dtype, device=device),
                requires_grad=False,
            )
            if use_bias
            else None
        )

    def reset_parameters(self, generator=None):
        fan_in = math.prod(self.in_shape)
        _truncated_normal_(self.kernel, math.sqrt(1.0 / fan_in), generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        n_in = len(self.in_shape)
        axis = tuple(ax % inputs.ndim for ax in self.axis)
        if axis != tuple(range(inputs.ndim - n_in, inputs.ndim)):
            raise ValueError(f"contraction axes {self.axis} must be trailing")
        if tuple(inputs.shape[-n_in:]) != self.in_shape:
            raise ValueError((tuple(inputs.shape), self.in_shape))
        batch_shape = inputs.shape[:-n_in]
        k_in = math.prod(self.in_shape)
        x = inputs.to(self.dtype).reshape(-1, k_in)
        w = self.kernel.to(self.dtype).reshape(k_in, -1)
        out = (x @ w).reshape(*batch_shape, *self.features)
        if self.bias is not None:
            out = out + self.bias.to(self.dtype)
        return out


class RMSNorm(nn.Module):
    """RMS layer norm: statistics and scale in float32, result cast back to
    the input dtype. ``scale_plus_one`` is the gemma convention (the
    parameter stores scale-1)."""

    def __init__(
        self,
        features: int,
        epsilon: float = 1e-6,
        dtype: torch.dtype = torch.bfloat16,
        weight_dtype: torch.dtype = torch.float32,
        scale_plus_one: bool = False,
        device=None,
    ):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale_plus_one = scale_plus_one
        self.scale = nn.Parameter(
            torch.empty((features,), dtype=weight_dtype, device=device),
            requires_grad=False,
        )

    def reset_parameters(self, generator=None):
        self.scale.fill_(0.0 if self.scale_plus_one else 1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
        normed = x32 * torch.rsqrt(var + self.epsilon)
        scale = self.scale.float()
        if self.scale_plus_one:
            scale = scale + 1.0
        return (normed * scale).to(x.dtype)


class Embed(nn.Module):
    """Token embedding with optional logit tying (``attend``)."""

    def __init__(
        self,
        num_embeddings: int,
        features: int,
        dtype: torch.dtype = torch.bfloat16,
        weight_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.features = features
        self.dtype = dtype
        self.embedding = nn.Parameter(
            torch.empty((num_embeddings, features), dtype=weight_dtype, device=device),
            requires_grad=False,
        )

    def reset_parameters(self, generator=None):
        self.embedding.normal_(0.0, 1.0 / math.sqrt(self.features), generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        # gather first, cast the gathered rows: the whole table is never
        # copied when it is stored wider than the activation dtype
        return F.embedding(ids.long(), self.embedding).to(self.dtype)

    def attend(self, query: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        """Project hidden states onto the embedding table (tied logits).
        Float32 result, as the JAX package's float32-accumulated product."""
        table = self.embedding.to(self.dtype)
        logits = (query.to(self.dtype) @ table.T).float()
        if normalize:
            logits = logits / math.sqrt(self.features)
        return logits


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu,
    "swish": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": lambda x: F.gelu(x, approximate="none"),
    "relu": F.relu,
    "tanh": torch.tanh,
    "linear": lambda x: x,
    "sigmoid": torch.sigmoid,
}


class MlpBlock(nn.Module):
    """Gated MLP: one projection per activation, their product, ``wo``.
    For ("silu", "linear") this is the llama SwiGLU block."""

    def __init__(
        self,
        in_features: int,
        intermediate_dim: int,
        activations: Sequence[str] = ("silu", "linear"),
        dtype: torch.dtype = torch.bfloat16,
        weight_dtype: torch.dtype = torch.float32,
        use_bias: bool = False,
        quantization: str = "",
        device=None,
    ):
        super().__init__()
        self.activations = tuple(activations)
        kw = dict(dtype=dtype, weight_dtype=weight_dtype, use_bias=use_bias,
                  quantization=quantization, device=device)
        self.wi_names = [
            f"wi_{i}" if len(self.activations) > 1 else "wi"
            for i in range(len(self.activations))
        ]
        for name in self.wi_names:
            setattr(self, name, DenseGeneral(in_features, intermediate_dim, **kw))
        self.wo = DenseGeneral(intermediate_dim, in_features, **kw)

    def pre_wo(self, inputs: torch.Tensor) -> torch.Tensor:
        """The product of the activations, the input of ``wo``: the
        ``mlp_pre_wo`` remat anchor (``models/decoder.py``)."""
        x = None
        for name, act_name in zip(self.wi_names, self.activations):
            a = ACTIVATIONS[act_name](getattr(self, name)(inputs))
            x = a if x is None else x * a
        return x

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        return self.wo(self.pre_wo(inputs))
