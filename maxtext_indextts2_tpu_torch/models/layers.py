"""Core NN building blocks: Embed, RMSNorm, DenseGeneral (with the AQT
matmuls of training, the int8 weights of ``int8w_serve`` and LoRA adapters),
MlpBlock, and the MLP dropout of training (:class:`MlpDropout`).

Counterparts of the JAX package's ``models/layers.py``. Kernels keep the
JAX layout ``[in..., out...]`` so a weight crosses between the packages as a
plain copy (``utils/param_bridge.py``). Matrix products run with inputs and
kernel cast to ``dtype`` and float32 accumulation (what cuBLAS does for
bfloat16 operands), and the result is cast back to ``dtype``.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable, Iterable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from maxtext_indextts2_tpu_torch.ops.int8w_matmul import int8w_matmul
from maxtext_indextts2_tpu_torch.ops.quantization import AQT_MODES, aqt_dot

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

    ``quantization``:

    - ``int8`` / ``int8w`` / ``fp8``: the product goes through AQT's
      numerics (``ops/quantization.aqt_dot``); the parameters are the float
      ones. ``aqt_noise`` (set for a training step by
      ``Transformer.set_aqt_noise``) is the input gradient's
      stochastic-rounding noise.
    - ``int8w_serve``: ``kernel`` is int8 (the JAX layout) with a float32
      ``kernel_scale`` ``(1,) * len(in_shape) + features``, one scale an
      output channel; the product is ``ops/int8w_matmul`` (the dequantised
      weight ``bf16(q) * bf16(scale)``, float32 sums, the result in
      ``dtype``, then the bias). Serving only: int8 takes no gradient.

    ``lora_rank > 0`` adds ``lora_a [flat_in, r]`` (normal, std 1/r) and
    ``lora_b [r, flat_out]`` (zeros, so the adapted layer starts as the
    base one): ``(x @ a) @ b * lora_alpha / r`` is added after the base
    product, before the bias. Under ``int8w_serve`` there is no adapter, as
    in the JAX package (a merged one: ``Engine.load_lora_adapter``).

    ``parallel`` is the layer's part in a tensor split (``parallel/tensor.py``;
    ``tp``, set by ``tensor.split_model``, is the split): ``"column"`` (the
    first output dimension split: the kernel holds this rank's heads or
    ``mlp`` columns; the caller puts the input through ``comm.CopyToGroup``)
    or ``"row"`` (the first input dimension split: the product's float32
    partial sums are summed over the group by ``comm.ReduceFromGroup`` and
    rounded once to ``dtype``, then the bias is added once). The shapes the
    product takes are the kernel's own, so a kernel that holds a rank's piece
    computes that piece. Under ``int8w_serve`` a column split's kernel and
    channel scales are the rank's columns; a row split sums the ranks'
    ``int8w_matmul`` partials (each rounded to ``dtype``) in float32 and adds
    the bias once.
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
        lora_alpha: float = 16.0,
        parallel: str | None = None,
        device=None,
    ):
        super().__init__()
        if parallel not in (None, "column", "row"):
            raise ValueError(f"unknown parallel role {parallel!r}")
        self.parallel = parallel
        self.tp = None  # parallel/tensor.Split of a tensor-split model
        if quantization not in ("", "int8w_serve", *AQT_MODES):
            raise ValueError(f"unknown quantization {quantization!r}; known: "
                             f"{('int8w_serve', *AQT_MODES)}")
        self.in_shape = _canon_tuple(in_shape)
        self.features = _canon_tuple(features)
        self.axis = _canon_tuple(axis)
        if len(self.axis) != len(self.in_shape):
            raise ValueError((self.axis, self.in_shape))
        self.dtype = dtype
        self.quantization = quantization
        serve = quantization == "int8w_serve"
        self.kernel = nn.Parameter(
            torch.empty(self.in_shape + self.features,
                        dtype=torch.int8 if serve else weight_dtype, device=device),
            requires_grad=False,
        )
        self.kernel_scale = (
            nn.Parameter(torch.ones((1,) * len(self.in_shape) + self.features,
                                    dtype=torch.float32, device=device), requires_grad=False)
            if serve else None
        )
        self.bias = (
            nn.Parameter(
                torch.zeros(self.features, dtype=weight_dtype, device=device),
                requires_grad=False,
            )
            if use_bias
            else None
        )
        self.lora_rank = 0 if serve else int(lora_rank)
        self.lora_a = self.lora_b = None
        if self.lora_rank > 0:
            flat_in, flat_out = math.prod(self.in_shape), math.prod(self.features)
            self.lora_a = nn.Parameter(
                torch.empty((flat_in, self.lora_rank), dtype=weight_dtype, device=device),
                requires_grad=False)
            self.lora_b = nn.Parameter(
                torch.zeros((self.lora_rank, flat_out), dtype=weight_dtype, device=device),
                requires_grad=False)
            # alpha / r in the product's dtype (the JAX package's weak-typed
            # scalar), a buffer on the module's device: a captured decode step
            # copies nothing from the host
            self.register_buffer("lora_scale", torch.tensor(
                lora_alpha / self.lora_rank, dtype=dtype, device=device), persistent=False)
        self.aqt_noise = None

    def reset_parameters(self, generator=None):
        if self.kernel_scale is not None:  # int8w_serve: filled from a float checkpoint
            self.kernel.zero_()
            self.kernel_scale.fill_(1.0)
        else:
            fan_in = math.prod(self.in_shape)
            _truncated_normal_(self.kernel, math.sqrt(1.0 / fan_in), generator)
        if self.bias is not None:
            self.bias.zero_()

    def reset_lora(self, generator=None):
        """The adapter's initial values (``Transformer.init_params`` draws
        them after every base weight)."""
        if self.lora_a is not None:
            self.lora_a.normal_(0.0, 1.0 / self.lora_rank, generator=generator)
            self.lora_b.zero_()

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        n_in = len(self.in_shape)
        axis = tuple(ax % inputs.ndim for ax in self.axis)
        if axis != tuple(range(inputs.ndim - n_in, inputs.ndim)):
            raise ValueError(f"contraction axes {self.axis} must be trailing")
        in_shape, features = tuple(self.kernel.shape[:n_in]), tuple(self.kernel.shape[n_in:])
        if tuple(inputs.shape[-n_in:]) != in_shape:
            raise ValueError((tuple(inputs.shape), in_shape))
        batch_shape = inputs.shape[:-n_in]
        k_in = math.prod(in_shape)
        x = inputs.to(self.dtype).reshape(-1, k_in)
        row_split = self.parallel == "row" and self.tp is not None
        if self.kernel_scale is not None:
            if not row_split:
                out = int8w_matmul(x, self.kernel.reshape(k_in, -1), self.kernel_scale, self.bias)
                return out.reshape(*batch_shape, *features)
            # this rank's K-partials, summed over the group, then the bias once
            out = int8w_matmul(x, self.kernel.reshape(k_in, -1), self.kernel_scale, None)
            out = self.tp.leave(out.reshape(*batch_shape, *features), self.dtype)
            return out if self.bias is None else out + self.bias.to(self.dtype)
        w = self.kernel.to(self.dtype).reshape(k_in, -1)
        if row_split:  # the partial sums summed over the group, then the bias once
            from maxtext_indextts2_tpu_torch.ops.losses import matmul

            out = self.tp.leave(matmul(x, w, torch.float32).reshape(*batch_shape, *features),
                                self.dtype)
            return out if self.bias is None else out + self.bias.to(self.dtype)
        out = aqt_dot(x, w, self.quantization, self.aqt_noise) if self.quantization else x @ w
        if self.lora_a is not None:
            delta = (x @ self.lora_a.to(self.dtype)) @ self.lora_b.to(self.dtype)
            out = out + self.lora_scale * delta
        out = out.reshape(*batch_shape, *features)
        if self.bias is not None:
            out = out + self.bias.to(self.dtype)
        return out


class RMSNorm(nn.Module):
    """RMS layer norm: statistics and scale in float32, result cast back to
    the input dtype. ``scale_plus_one`` is the gemma convention (the
    parameter stores scale-1). With ``use_mean`` and ``use_bias`` it is a
    LayerNorm (mean-centred, with a learned ``bias`` added after the scale):
    the gpt3 family's norm, reductions in float32."""

    def __init__(
        self,
        features: int,
        epsilon: float = 1e-6,
        dtype: torch.dtype = torch.bfloat16,
        weight_dtype: torch.dtype = torch.float32,
        scale_plus_one: bool = False,
        use_mean: bool = False,
        use_bias: bool = False,
        device=None,
    ):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale_plus_one = scale_plus_one
        self.use_mean = use_mean
        self.scale = nn.Parameter(
            torch.empty((features,), dtype=weight_dtype, device=device),
            requires_grad=False,
        )
        self.bias = (nn.Parameter(torch.zeros((features,), dtype=weight_dtype, device=device),
                                  requires_grad=False)
                     if use_bias else None)

    def reset_parameters(self, generator=None):
        self.scale.fill_(0.0 if self.scale_plus_one else 1.0)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.use_mean:
            x32 = x32 - torch.mean(x32, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
        normed = x32 * torch.rsqrt(var + self.epsilon)
        scale = self.scale.float()
        if self.scale_plus_one:
            scale = scale + 1.0
        out = normed * scale
        if self.bias is not None:
            out = out + self.bias.float()
        return out.to(x.dtype)


class Embed(nn.Module):
    """Token embedding with optional logit tying (``attend``). With
    ``split_vocab`` and a tensor split ``tp`` the table holds this rank's
    rows of the vocabulary: a lookup zeroes the ids outside them and sums the
    ranks' rows (``comm.ReduceFromGroup``: one rank holds each id, so the sum
    is exact), and ``attend`` gives the logits of this rank's rows."""

    def __init__(
        self,
        num_embeddings: int,
        features: int,
        dtype: torch.dtype = torch.bfloat16,
        weight_dtype: torch.dtype = torch.float32,
        split_vocab: bool = False,
        device=None,
    ):
        super().__init__()
        self.split_vocab = split_vocab
        self.tp = None  # parallel/tensor.Split of a tensor-split model
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
        if not (self.split_vocab and self.tp is not None):
            return F.embedding(ids.long(), self.embedding).to(self.dtype)
        rows = self.embedding.shape[0]
        local = ids.long() - self.tp.rank * rows
        inside = (local >= 0) & (local < rows)
        out = F.embedding(torch.where(inside, local, 0), self.embedding)
        out = torch.where(inside[..., None], out, torch.zeros((), dtype=out.dtype,
                                                                 device=out.device))
        return self.tp.leave(out.to(self.dtype), self.dtype)

    def attend(self, query: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        """Project hidden states onto the embedding table (tied logits).
        The product's result is float32 (the JAX package's
        ``preferred_element_type``): bfloat16 operands, float32 logits."""
        from maxtext_indextts2_tpu_torch.ops.losses import matmul

        table = self.embedding.to(self.dtype)
        q = query.to(self.dtype)
        logits = matmul(q.reshape(-1, q.shape[-1]), table.T, torch.float32).reshape(
            *q.shape[:-1], table.shape[0])
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


def dropout(x: torch.Tensor, keep_mask: torch.Tensor, rate: float) -> torch.Tensor:
    """``flax.linen.Dropout`` with its mask given: kept entries divided by the
    keep probability cast to ``x``'s dtype (a division by a tensor, not the
    rounded reciprocal a Python number gives on the GPU), the others 0."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep_mask, x / keep, zero)


@dataclasses.dataclass
class MlpDropout:
    """The dropout of every MLP's activation product in one training forward:
    ``rate`` and one boolean keep mask per MLP in layer order (``[B, S,
    mlp_dim]``, the JAX package's ``bernoulli(1 - rate)``), given as
    ``masks`` or drawn from ``generator`` (``uniform < 1 - rate``) as the
    decoder reaches each layer, outside any remat region, so a recomputed
    region applies the same mask again."""

    rate: float
    masks: Sequence[torch.Tensor] | None = None
    generator: torch.Generator | None = None

    def keep_mask(self, index: int, shape, device) -> torch.Tensor:
        if self.masks is not None:
            return self.masks[index]
        return torch.rand(tuple(shape), generator=self.generator, device=device) < 1.0 - self.rate


class MlpBlock(nn.Module):
    """Gated MLP: one projection per activation, their product, ``wo``.
    For ("silu", "linear") this is the llama SwiGLU block. In training the
    product may be dropped out (:func:`dropout`, rate ``dropout_rate``)
    after the ``mlp_pre_wo`` anchor, as in the JAX package. Under a tensor
    split (``tp``) the ``wi_*`` kernels hold this rank's ``mlp`` columns and
    ``wo`` its rows: the input passes ``comm.CopyToGroup`` once and ``wo``
    sums the partial products over the group; a dropout mask of the whole
    width is cut to this rank's columns."""

    def __init__(
        self,
        in_features: int,
        intermediate_dim: int,
        activations: Sequence[str] = ("silu", "linear"),
        dtype: torch.dtype = torch.bfloat16,
        weight_dtype: torch.dtype = torch.float32,
        use_bias: bool = False,
        quantization: str = "",
        dropout_rate: float = 0.0,
        device=None,
    ):
        super().__init__()
        self.activations = tuple(activations)
        self.intermediate_dim, self.dropout_rate = intermediate_dim, dropout_rate
        self.tp = None  # parallel/tensor.Split of a tensor-split model
        kw = dict(dtype=dtype, weight_dtype=weight_dtype, use_bias=use_bias,
                  quantization=quantization, device=device)
        self.wi_names = [
            f"wi_{i}" if len(self.activations) > 1 else "wi"
            for i in range(len(self.activations))
        ]
        for name in self.wi_names:
            setattr(self, name, DenseGeneral(in_features, intermediate_dim, parallel="column",
                                             **kw))
        self.wo = DenseGeneral(intermediate_dim, in_features, parallel="row", **kw)

    def pre_wo(self, inputs: torch.Tensor) -> torch.Tensor:
        """The product of the activations, the input of ``wo``: the
        ``mlp_pre_wo`` remat anchor (``models/decoder.py``)."""
        if self.tp is not None:
            inputs = self.tp.enter(inputs)
        x = None
        for name, act_name in zip(self.wi_names, self.activations):
            a = ACTIVATIONS[act_name](getattr(self, name)(inputs))
            x = a if x is None else x * a
        return x

    def out(self, pre_wo: torch.Tensor, keep_mask: torch.Tensor | None = None) -> torch.Tensor:
        """``wo`` of the activation product, dropped out first where a keep
        mask is given."""
        if keep_mask is not None and self.dropout_rate > 0.0:
            if keep_mask.shape[-1] != pre_wo.shape[-1]:  # this rank's columns
                lo, hi = self.tp.bounds(keep_mask.shape[-1])
                keep_mask = keep_mask[..., lo:hi]
            pre_wo = dropout(pre_wo, keep_mask, self.dropout_rate)
        return self.wo(pre_wo)

    def forward(self, inputs: torch.Tensor, keep_mask: torch.Tensor | None = None) -> torch.Tensor:
        return self.out(self.pre_wo(inputs), keep_mask)
