"""MaskGCT semantic->acoustic (S2A) masked generative transformer: the
denoiser and the iterative confidence-unmasking sampler.

Counterpart of the JAX package's ``audio/s2a.py`` for serving and training:
the same parameter names and layouts, the same op order and rounding points.
Eager PyTorch has no scan, so ``reverse_diffusion`` is a Python loop over layers
and steps; ``unroll=`` is accepted and changes nothing. The four row kernels
of the int8 / bfloat16 serving modes (``ops/ada_rmsnorm.py``,
``ops/quant_kernels.py``) run as CUDA kernels for tensors on the GPU and as
their plain versions for tensors on the CPU: the choice follows the tensor,
no environment variable switches a kernel. The int8 x int8 -> int32 product
is ``torch._int_mm``.

Noise is an input: the sampler draws its uniforms from a ``torch.Generator``
or takes them from a callable ``noise(layer, step, draw, shape)``, so a test
can hand it another framework's draws.

The fixed-length sampler (no pad masks: every key valid, ``all_valid``)
runs its attention through ``ops/s2a_attention.py`` (a CUDA kernel on the
GPU); the masked path (batched serving, training) keeps the materialised
logits by default. The JAX package's opt-in sequence-flash route is ported
with its own condition: ``MTT_S2A_SEQ_FLASH=1``, S >= 512 and S % 256 == 0,
on a CUDA tensor (the JAX package: on a TPU); it runs the training flash
attention (``ops/flash_attention.py``, K9-K11) non-causal with the pad mask
as segment ids, so a padding query row comes out 0 where the materialised
route gives a softmax over the valid keys (no loss or valid output reads it).

Training: ``S2AModel.compute_loss`` takes its randomness as an
:class:`S2ANoise` (the six draws of the JAX package's
``jax.random.split(rng, 6)``), made by :func:`draw_s2a_noise` from a
``torch.Generator``, or built by a test from the JAX package's own draws.
"""

from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from maxtext_indextts2_tpu_torch.audio.layers import Dense, lecun_normal_
from maxtext_indextts2_tpu_torch.models import rope as rope_lib
from maxtext_indextts2_tpu_torch.models.attention import dot_product_attention
from maxtext_indextts2_tpu_torch.ops.ada_rmsnorm import ada_rmsnorm
from maxtext_indextts2_tpu_torch.ops.flash_attention import flash_attention
from maxtext_indextts2_tpu_torch.ops.quant_kernels import (
    ada_rmsnorm_quantize, row_quantize_int8, silu_mul_quantize,
)
from maxtext_indextts2_tpu_torch.ops.quantization import (
    absmax_scale, int8_matmul, quantize_weight_for_serving,
)
from maxtext_indextts2_tpu_torch.ops.s2a_attention import s2a_attention


@dataclass(frozen=True)
class S2AConfig:
    num_quantizers: int = 12
    hidden_size: int = 1024
    num_layers: int = 16
    num_heads: int = 16
    codebook_size: int = 1024
    cond_codebook_size: int = 8192
    cfg_dropout: float = 0.15
    mask_layer_schedule: str = "cosine"
    predict_layer_1: bool = True
    dtype: torch.dtype = torch.float32
    # Serving-only: int8 x int8 products in the denoiser's qkv/out/MLP
    # projections (per-token activation scales, per-channel weight scales).
    # "dynamic": float kernels quantized on every call; "offline": int8
    # kernels plus ``kernel_scale`` made once by ``quantize_s2a_params``.
    int8_matmul: str | bool = False  # False | "dynamic" (True) | "offline"


class Int8Dense(nn.Module):
    """Bias-free dense layer with a symmetric int8 product.

    Dynamic mode keeps a float ``kernel [in, out]`` and absmax-quantizes it
    per output channel on every call. Offline mode stores ``kernel`` as int8
    with a float32 ``kernel_scale [1, out]``; the int8 kernel keeps the shape
    ``[in, out]`` of the JAX package's tree but is laid out output-major in
    memory (strides ``(1, in)``), the operand layout the GPU's int8 product
    runs fastest with; the layout is fixed when the module is built and
    survives ``load_state_dict``.
    """

    def __init__(self, in_features: int, features: int, offline: bool = False, device=None,
                 generator=None):
        super().__init__()
        self.in_features, self.features, self.offline = in_features, features, offline
        if offline:
            self.kernel = nn.Parameter(
                torch.zeros((features, in_features), dtype=torch.int8, device=device).t(),
                requires_grad=False)
            self.kernel_scale = nn.Parameter(
                torch.ones((1, features), dtype=torch.float32, device=device),
                requires_grad=False)
        else:
            self.kernel = nn.Parameter(lecun_normal_(
                torch.empty((in_features, features), dtype=torch.float32, device=device),
                in_features, generator))

    def forward(self, x: torch.Tensor | None = None, xq: torch.Tensor | None = None,
                xs: torch.Tensor | None = None, out_dtype: torch.dtype | None = None,
                impl: str | None = None) -> torch.Tensor:
        """x: float input, OR (xq int8 [..., K], xs float32 [...]) quantized
        by the producer's fused kernel, with the result's ``out_dtype``
        (float32 when not given)."""
        if self.offline:
            wq, ws = self.kernel, self.kernel_scale
        else:
            wf = self.kernel.float()
            ws = absmax_scale(wf, 0, keepdim=True)
            wq = torch.round(wf / torch.clamp(ws, min=1e-9)).to(torch.int8)
            if wq.device.type == "cuda":
                wq = wq.t().contiguous().t()
        if xq is not None:
            out_dtype = out_dtype or torch.float32
        else:
            out_dtype = x.dtype
            rows = x if x.ndim == 3 else x.reshape(1, -1, x.shape[-1])
            xq, xs = row_quantize_int8(rows, impl=impl)
            xq, xs = xq.reshape(x.shape), xs.reshape(x.shape[:-1])
        acc = int8_matmul(xq.reshape(-1, self.in_features), wq)
        acc = acc.reshape(*xq.shape[:-1], self.features)
        # int32 * float32 promotes to float32: the conversion happens inside the
        # first product instead of in a pass of its own
        return (acc * xs[..., None] * ws).to(out_dtype)


def _dense(cfg: S2AConfig, in_features: int, features: int, device=None, generator=None):
    if cfg.int8_matmul:
        return Int8Dense(in_features, features, offline=cfg.int8_matmul == "offline",
                         device=device, generator=generator)
    return Dense(in_features, features, use_bias=False, device=device, generator=generator)


def serving_s2a_config(base: S2AConfig, serving_dtype: str) -> S2AConfig:
    """Apply ``Config.s2a_serving_dtype`` to an S2AConfig."""
    if serving_dtype in ("", "float32"):
        return base
    if serving_dtype == "bfloat16":
        return dataclasses.replace(base, dtype=torch.bfloat16)
    if serving_dtype == "int8":
        return dataclasses.replace(base, dtype=torch.bfloat16, int8_matmul="dynamic")
    if serving_dtype == "int8_offline":
        return dataclasses.replace(base, dtype=torch.bfloat16, int8_matmul="offline")
    raise ValueError(f"unknown s2a_serving_dtype: {serving_dtype}")


def cast_denoiser_params(model: "S2AModel", dtype: torch.dtype = torch.bfloat16) -> "S2AModel":
    """Cast the denoiser's float parameters to ``dtype`` in place (serve
    time) and return the model. Embeddings and logit heads stay float32 (they
    feed float32 embedding sums and logits); int8 kernels and their float32
    ``kernel_scale`` are left untouched. This keeps the residual stream in
    ``dtype``."""
    for name, p in model.denoiser.named_parameters():
        if name.endswith("kernel_scale") or not p.is_floating_point():
            continue
        p.data = p.data.to(dtype)
    return model


def quantize_s2a_params(params: dict[str, torch.Tensor], model: "S2AModel"):
    """Convert a float S2A state dict for ``int8_matmul="offline"``.

    ``model`` is an S2AModel built with ``int8_matmul="offline"``: the kernel
    of each of its offline ``Int8Dense`` modules is absmax-quantized per
    output channel (``ops.quantization.quantize_weight_for_serving``) and
    gets its ``kernel_scale``; every other entry passes through."""
    out = dict(params)
    for name, mod in model.named_modules():
        if isinstance(mod, Int8Dense) and mod.offline:
            q, scale = quantize_weight_for_serving(params[f"{name}.kernel"], reduce_dims=(0,))
            out[f"{name}.kernel"] = q
            out[f"{name}.kernel_scale"] = scale
    return out


def sinusoidal_time_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[B] in [0,1] -> [B, dim]."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    ang = t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class AdaptiveRMSNorm(nn.Module):
    """RMSNorm whose scale is predicted from a conditioning vector (zero-init
    weight, ones bias). ``quantize_out=True`` returns (int8 rows, [B,S]
    scales) instead of the float output, fused with the quantization of the
    consuming ``Int8Dense`` so that the normalized tensor is never written
    (int8 serving only)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.dim = dim
        self.to_weight = Dense(dim, dim, kernel_init="zeros", bias_init=1.0, device=device)

    def forward(self, x: torch.Tensor, cond: torch.Tensor, quantize_out: bool = False,
                impl: str | None = None):
        weight = self.to_weight(cond)
        if weight.dtype not in (torch.float32, x.dtype):
            weight = weight.to(x.dtype)
        shape = x.shape
        if weight.shape == shape and x.ndim >= 2:
            # one scale row per row of x (a per-position condition, or x [B,D]):
            # the same kernels, each row a batch entry of its own
            x, weight = x.reshape(-1, 1, shape[-1]), weight.reshape(-1, shape[-1])
        # any other pairing than x [B,S,D] with weight [B,D] is refused by the wrappers
        if quantize_out:
            q, scales = ada_rmsnorm_quantize(x, weight, impl=impl)
            return q.reshape(shape), scales.reshape(shape[:-1])
        return ada_rmsnorm(x, weight, impl=impl).reshape(shape)


class NARBlock(nn.Module):
    def __init__(self, cfg: S2AConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        kw = dict(device=device, generator=generator)
        self.input_norm = AdaptiveRMSNorm(h, device=device)
        self.qkv = _dense(cfg, h, 3 * h, **kw)
        self.out = _dense(cfg, h, h, **kw)
        self.post_attn_norm = AdaptiveRMSNorm(h, device=device)
        self.gate = _dense(cfg, h, 4 * h, **kw)
        self.up = _dense(cfg, h, 4 * h, **kw)
        self.down = _dense(cfg, 4 * h, h, **kw)

    def forward(self, x, t_cond, masks, sin_cos, impl: str | None = None,
                all_valid: bool = False, seq_flash: bool | None = None):
        """``masks``: the pad mask as the attention paths want it, from
        :func:`_attention_masks`; ``sin_cos``: RoPE angles of this length;
        ``all_valid``: no position is padding (the fixed-length sampler), so
        the attention is ``ops.s2a_attention`` and ``masks`` is not read;
        ``seq_flash``: the sequence-flash route (None: by
        :func:`_seq_flash_route`'s condition)."""
        if self.cfg.int8_matmul:
            # producer-fused quantization: the AdaLN outputs feed the int8
            # products as (int8, scales); the normalized float tensors are
            # never written
            hq, hs = self.input_norm(x, t_cond, quantize_out=True, impl=impl)
            x = x + self._self_attention(None, masks, sin_cos, hq, hs, x.dtype, impl, all_valid,
                                         seq_flash)
            hq, hs = self.post_attn_norm(x, t_cond, quantize_out=True, impl=impl)
            return x + self._swiglu_mlp(None, hq, hs, x.dtype, impl)
        h = self.input_norm(x, t_cond, impl=impl)
        x = x + self._self_attention(h, masks, sin_cos, impl=impl, all_valid=all_valid,
                                     seq_flash=seq_flash)
        h = self.post_attn_norm(x, t_cond, impl=impl)
        return x + self._swiglu_mlp(h, impl=impl)

    def _self_attention(self, x, masks, sin_cos, xq=None, xs=None, out_dtype=None, impl=None,
                        all_valid=False, seq_flash=None):
        cfg = self.cfg
        b, s, _ = (x if xq is None else xq).shape
        n, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        if xq is not None:
            qkv = self.qkv(None, xq=xq, xs=xs, out_dtype=out_dtype)
            x_dtype = out_dtype
        else:
            qkv = self.qkv(x)
            x_dtype = x.dtype
        q, k, v = torch.split(qkv, cfg.hidden_size, dim=-1)
        q = rope_lib.apply_rope(q.reshape(b, s, n, d), None, None, False, sin_cos=sin_cos)
        k = rope_lib.apply_rope(k.reshape(b, s, n, d), None, None, False, sin_cos=sin_cos)
        v = v.reshape(b, s, n, d)

        if all_valid:
            # every key valid: the sampler's one-pass kernel, float32 logits,
            # probabilities rounded to the operands' dtype (bfloat16 in the
            # bfloat16 and int8 modes); q, k, v stay in the projection layout
            ad = torch.bfloat16 if cfg.dtype == torch.bfloat16 else x_dtype
            o = s2a_attention((q * (1.0 / math.sqrt(d))).to(ad), k.to(ad), v.to(ad), impl=impl)
            o = o.to(x_dtype).reshape(b, s, cfg.hidden_size)
        elif _seq_flash_route(seq_flash, q, s):
            # flash attention over the sequence, non-causal, the pad mask as
            # segment ids on both sides; q, k, v in their own dtype
            pos = torch.arange(s, dtype=torch.int32, device=q.device)[None].expand(b, s)
            seg = masks["seg"]
            o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), pos,
                                pos, seg, seg, False, impl=impl)
            o = o.transpose(1, 2).reshape(b, s, cfg.hidden_size)
        elif cfg.dtype == torch.bfloat16:
            # bfloat16-stored logits, float32 softmax, bfloat16 probabilities,
            # float32-accumulated PV
            qb = (q * (1.0 / math.sqrt(d))).to(torch.bfloat16).transpose(1, 2)  # [B,N,S,D]
            kb = k.to(torch.bfloat16).permute(0, 2, 3, 1)  # [B,N,D,S]
            vb = v.to(torch.bfloat16).transpose(1, 2)
            logits = torch.matmul(qb, kb).masked_fill(masks["pad"], -1e9)
            probs = torch.softmax(logits, dim=-1, dtype=torch.float32).to(torch.bfloat16)
            if x_dtype == torch.bfloat16:
                o = torch.matmul(probs, vb)  # accumulated in float32, rounded once
            else:
                o = torch.matmul(probs.float(), vb.float()).to(x_dtype)
            o = o.transpose(1, 2).reshape(b, s, cfg.hidden_size)
        else:
            o = dot_product_attention(q, k, v, masks["valid"]).reshape(b, s, cfg.hidden_size)
        if cfg.int8_matmul:
            return self.out(o, impl=impl)
        return self.out(o)

    def _swiglu_mlp(self, x, xq=None, xs=None, out_dtype=None, impl=None):
        if xq is not None:
            # one quantized input shared by gate and up; silu*up is quantized
            # by its producer kernel, so the [.., 4H] float product is not written
            g = self.gate(None, xq=xq, xs=xs, out_dtype=out_dtype)
            u = self.up(None, xq=xq, xs=xs, out_dtype=out_dtype)
            dq, ds = silu_mul_quantize(g, u, impl=impl)
            return self.down(None, xq=dq, xs=ds, out_dtype=out_dtype)
        return self.down(F.silu(self.gate(x)) * self.up(x))


def _seq_flash_route(seq_flash: bool | None, q: torch.Tensor, s: int) -> bool:
    """Whether the masked attention takes the sequence-flash route: as asked,
    or (None) the JAX package's opt-in condition with a CUDA tensor in the
    place of a TPU backend: ``MTT_S2A_SEQ_FLASH=1``, S >= 512, S % 256 == 0."""
    if seq_flash is not None:
        return seq_flash
    return (q.is_cuda and s >= 512 and s % 256 == 0
            and os.environ.get("MTT_S2A_SEQ_FLASH", "0") == "1")


def _attention_masks(pad_mask: torch.Tensor) -> dict[str, torch.Tensor]:
    """The [B, S] pad mask in the forms the attention paths use, made once
    per denoiser call: ``valid`` [B,1,1,S] True = attend, ``pad`` its
    negation, ``seg`` the mask as int32 segment ids (the sequence-flash
    route)."""
    valid = (pad_mask > 0)[:, None, None, :]
    return {"valid": valid, "pad": ~valid, "seg": pad_mask.to(torch.int32)}


class _CondMLPs(nn.Module):
    """Parameter holder shared by the two denoisers: ``t0``/``t1`` (diffusion
    step) and, optionally, ``c0``/``c1`` (condition), named as in the JAX
    package's tree."""

    def __init__(self, cfg: S2AConfig, with_cond: bool, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        kw = dict(device=device, generator=generator)
        if with_cond:
            self.c0 = Dense(h, 4 * h, **kw)
            self.c1 = Dense(4 * h, h, **kw)
        self.t0 = Dense(h, 4 * h, **kw)
        self.t1 = Dense(4 * h, h, **kw)
        for i in range(cfg.num_layers):
            setattr(self, f"layers_{i}", NARBlock(cfg, **kw))
        self.final_norm = AdaptiveRMSNorm(h, device=device)
        inv = rope_lib.rope_frequencies(h // cfg.num_heads)
        self.register_buffer("inv_freq", torch.as_tensor(inv, device=device), persistent=False)

    def _t_cond(self, t):
        return self.t1(F.silu(self.t0(sinusoidal_time_emb(t, self.cfg.hidden_size))))

    def _blocks(self, x, t_cond, pad_mask, impl, all_valid=False, seq_flash=None):
        b, s, _ = x.shape
        pos = torch.arange(s, dtype=torch.int32, device=x.device)[None, :].expand(b, s)
        sin_cos = rope_lib.rope_sin_cos(pos, self.inv_freq)
        masks = None if all_valid else _attention_masks(pad_mask)
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layers_{i}")(x, t_cond, masks, sin_cos, impl=impl,
                                             all_valid=all_valid, seq_flash=seq_flash)
        return self.final_norm(x, t_cond, impl=impl)


class NARDenoiser(_CondMLPs):
    """Non-causal llama-style denoiser: the condition is added elementwise."""

    def __init__(self, cfg: S2AConfig, device=None, generator=None):
        super().__init__(cfg, True, device, generator)

    def forward(self, x, t, cond, pad_mask, impl: str | None = None, all_valid: bool = False,
                seq_flash: bool | None = None):
        """``all_valid=True``: ``pad_mask`` is all ones (the fixed-length
        sampler) and the attention skips it. ``seq_flash``: see
        :func:`_seq_flash_route`."""
        cond_emb = self.c1(F.silu(self.c0(cond)))
        return self._blocks(x + cond_emb, self._t_cond(t), pad_mask, impl, all_valid,
                            seq_flash)


class PrefixNARDenoiser(_CondMLPs):
    """Phone-conditioned prefix denoiser: the condition goes through the MLP
    and is CONCATENATED as an attention prefix; the output drops the prefix
    rows. ``use_phone_cond=False`` is an unconditional non-causal denoiser."""

    def __init__(self, cfg: S2AConfig, use_phone_cond: bool = True, device=None, generator=None):
        super().__init__(cfg, use_phone_cond, device, generator)
        self.use_phone_cond = use_phone_cond

    def forward(self, x, t, phone_emb=None, x_mask=None, phone_mask=None,
                impl: str | None = None):
        b, s, _ = x.shape
        if x_mask is None:
            x_mask = torch.ones((b, s), dtype=torch.int32, device=x.device)
        t_cond = self._t_cond(t)
        p = 0
        pad_mask = x_mask
        if self.use_phone_cond and phone_emb is not None:
            cond = self.c1(F.silu(self.c0(phone_emb)))
            p = cond.shape[1]
            if phone_mask is None:
                phone_mask = torch.ones((b, p), dtype=torch.int32, device=x.device)
            x = torch.cat([cond.to(x.dtype), x], dim=1)
            pad_mask = torch.cat([phone_mask.to(x_mask.dtype), x_mask], dim=1)
        return self._blocks(x, t_cond, pad_mask, impl)[:, p:]


def _kth_largest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th largest along the last axis, as [..., 1]."""
    return torch.topk(x, k, dim=-1).values[..., -1:]


def mask_prob_schedule(t):
    """sin mask schedule."""
    return torch.sin(t * math.pi / 2)


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u))


def _layer_weights(cfg: S2AConfig) -> np.ndarray:
    """The probability of training each quantizer layer."""
    q = cfg.num_quantizers
    lo = 0 if cfg.predict_layer_1 else 1
    if cfg.mask_layer_schedule == "uniform":
        w = np.ones(q)
    elif cfg.mask_layer_schedule == "cosine":
        w = np.array([np.cos((i - lo) / q * np.pi / 2) for i in range(q)])
    else:  # linear
        w = np.array([q - (i - lo) for i in range(q)], dtype=np.float64)
    if lo == 1:
        w[0] = 0.0
    return (w / w.sum()).astype(np.float32)


@dataclass
class S2ANoise:
    """The randomness of one ``compute_loss`` call (the JAX package splits its
    rng six ways and uses five of the keys):

    - ``t`` [B] float32: the diffusion time, in [1e-5, 1];
    - ``mask_layer``: the quantizer layer trained (an int);
    - ``bernoulli`` [B, T] bool: ``uniform < sin(t * pi / 2)``, the mask
      before the prompt is cut out of it;
    - ``use_prompt``: one draw for the batch, False with probability
      ``cfg_dropout`` (classifier-free guidance's prompt dropout);
    - ``plen`` [B] int: prompt lengths in [min(T // 4, 5), max(T // 2, 6))."""

    t: torch.Tensor
    mask_layer: int
    bernoulli: torch.Tensor
    use_prompt: bool
    plen: torch.Tensor

    def to(self, device) -> "S2ANoise":
        return dataclasses.replace(self, t=self.t.to(device), bernoulli=self.bernoulli.to(device),
                                   plen=self.plen.to(device))


def draw_s2a_noise(cfg: S2AConfig, b: int, tlen: int, generator: torch.Generator,
                   device=None) -> S2ANoise:
    """The draws of :class:`S2ANoise` from ``generator`` (on its own device),
    moved to ``device``: the same distributions as the JAX package's."""
    gen_dev = generator.device
    t = torch.clamp(torch.rand((b,), generator=generator, device=gen_dev), 1e-5, 1.0)
    weights = torch.from_numpy(_layer_weights(cfg)).to(gen_dev)
    mask_layer = int(torch.multinomial(weights, 1, generator=generator).item())
    mprob = mask_prob_schedule(t)
    bern = torch.rand((b, tlen), generator=generator, device=gen_dev) < mprob[:, None]
    use_prompt = bool(torch.rand((), generator=generator, device=gen_dev).item() > cfg.cfg_dropout)
    plen = torch.randint(min(tlen // 4, 5), max(tlen // 2, 6), (b,), generator=generator,
                         device=gen_dev)
    return S2ANoise(t, mask_layer, bern, use_prompt, plen).to(device or gen_dev)


class S2AModel(nn.Module):
    def __init__(self, cfg: S2AConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg

        def normal(*shape):
            t = torch.empty(shape, dtype=torch.float32, device=device)
            return nn.Parameter(t.normal_(0.0, 0.02, generator=generator))

        q, h, k = cfg.num_quantizers, cfg.hidden_size, cfg.codebook_size
        self.layer_emb = normal(q, h)
        self.mask_emb = normal(h)
        self.token_emb = normal(q, k, h)
        self.to_logits_w = normal(q, h, k)
        self.to_logits_b = nn.Parameter(torch.zeros((q, k), dtype=torch.float32, device=device))
        self.cond_emb = normal(cfg.cond_codebook_size, h)
        self.denoiser = NARDenoiser(cfg, device=device, generator=generator)

    # -------------------------------------------------------------- helpers
    def embed_tokens_upto(self, x0: torch.Tensor, n_layers: int):
        """sum_l token_emb[l][x0[..., l]] for l < n_layers. x0: [B,T,Q]."""
        out = 0.0
        for l in range(n_layers):
            out = out + self.token_emb[l][x0[..., l]]
        return out

    def embed_tokens_upto_stacked(self, codes: torch.Tensor):
        """codes [B,P,Q] -> summed embeddings [B,P,H]."""
        return self.embed_tokens_upto(codes, self.cfg.num_quantizers)

    # ---------------------------------------------------------------- train
    def compute_loss(self, x0, x_mask, cond_code, noise: S2ANoise, impl: str | None = None,
                     seq_flash: bool | None = None):
        """x0: [B,T,Q] acoustic codes; x_mask: [B,T]; cond_code: [B,T] semantic;
        ``noise``: this step's draws. Returns (loss, aux), as the JAX
        package's, in its order of operations and rounding points."""
        cfg = self.cfg
        b, tlen, q = x0.shape
        dev = x0.device
        noise = noise.to(dev)
        layer = int(noise.mask_layer)
        t = noise.t
        plen = noise.plen.long() if noise.use_prompt else torch.zeros(
            (b,), dtype=torch.long, device=dev)
        ar = torch.arange(tlen, device=dev)[None, :]
        is_prompt = ar < plen[:, None]  # [B,T]

        mask = noise.bernoulli & ~is_prompt
        # at least one masked position a row: the first after the prompt
        none_masked = torch.sum(mask, dim=1) == 0
        mask = mask | (none_masked[:, None] & (ar == plen[:, None]))

        # assemble xt: layers < mask_layer revealed; == mask_layer partially
        # masked; > mask_layer all mask tokens (prompt positions revealed)
        layer_ids = torch.arange(q, device=dev)
        below = (layer_ids < layer)[None, None, :, None].float()  # [1,1,Q,1]
        at_layer = (layer_ids == layer)[None, None, :, None].float()
        above = (layer_ids > layer)[None, None, :].float()  # [1,1,Q]
        token_embs = torch.stack([self.token_emb[l][x0[..., l]] for l in range(q)], dim=2)
        m = mask[:, :, None, None]
        prompt_reveal = is_prompt[:, :, None, None].float()  # [B,T,1,1]
        w_at = at_layer * torch.where(m, 0.0, 1.0)
        w_above = above[..., None] * prompt_reveal
        xt = torch.sum(token_embs * (below + w_at + w_above), dim=2)
        # the JAX package counts the masked positions of the trained layer
        # through `at[..., 0]`, i.e. only when that layer is 0; kept as it is
        n_masked_embs = float(layer == 0) * mask.float() + torch.sum(
            above * (1.0 - prompt_reveal[..., 0]), dim=-1)
        xt = xt + n_masked_embs[..., None] * self.mask_emb

        cond = self.cond_emb[cond_code] + self.layer_emb[layer][None, None, :]
        embeds = self.denoiser(xt.to(cfg.dtype), t, cond.to(cfg.dtype), x_mask, impl=impl,
                               seq_flash=seq_flash)
        logits = embeds.float() @ self.to_logits_w[layer] + self.to_logits_b[layer]

        final_mask = mask & (x_mask > 0)
        targets = x0[..., layer].long()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        denom = torch.clamp(torch.sum(final_mask).float(), min=1.0)
        loss = torch.sum(torch.where(final_mask, nll, 0.0)) / denom
        return loss, {"mask_layer": torch.tensor(layer, device=dev), "masked_tokens": denom}

    def forward(self, x0, x_mask, cond_code, noise: S2ANoise, impl: str | None = None,
                seq_flash: bool | None = None):
        return self.compute_loss(x0, x_mask, cond_code, noise, impl=impl, seq_flash=seq_flash)

    # ------------------------------------------------------------- sampling
    def _sample_step(
        self, layer, seq, mask, cum, emb_l, w_l, b_l, cond_in, uncond_in, prompt_sum,
        full_mask, x_mask, t_now, next_mask_num, is_last, draw,
        p, tlen, temperature, topk_keep, cfg_scale, rescale_cfg, steps_is_one,
        all_valid=True, impl=None,
    ):
        """One confidence-unmasking step. ``emb_l``/``w_l``/``b_l`` are this
        layer's embedding table and logit head, ``cond_in``/``uncond_in`` its
        condition (with the layer embedding) in the denoiser's dtype, all
        gathered once per layer. ``next_mask_num`` is an int or a per-row
        [B] tensor (variable-length batching); ``all_valid=False`` keeps the
        padded positions out of the CFG rescale statistics. ``draw(i, shape)``
        gives the step's i-th uniform tensor."""
        c = self.cfg
        b = seq.shape[0]
        t_vec = torch.full((b,), float(t_now), dtype=torch.float32, device=seq.device)
        cur = cum + torch.where(mask[..., None], self.mask_emb, emb_l[seq])
        cur = cur + self.mask_emb * float(c.num_quantizers - 1 - layer)

        xt_input = cur if p == 0 else torch.cat([prompt_sum, cur], dim=1)
        embeds = self.denoiser(xt_input.to(c.dtype), t_vec, cond_in, full_mask, impl=impl,
                               all_valid=all_valid)[:, p:]
        if cfg_scale > 0 and p > 0:
            uncond = self.denoiser(cur.to(c.dtype), t_vec, uncond_in, x_mask, impl=impl,
                                   all_valid=all_valid)
            steered = embeds + cfg_scale * (embeds - uncond)
            if all_valid:
                # population deviation, computed in float32 and rounded to
                # the embeddings' dtype before the square root
                def _std(x):
                    return torch.sqrt(x.float().var(correction=0).to(x.dtype))

                rescaled = steered * _std(embeds) / torch.clamp(_std(steered), min=1e-6)
            else:
                # padded positions stay out of the statistics (float32)
                w = x_mask[..., None].float()
                denom = torch.clamp(torch.sum(w) * embeds.shape[-1], min=1.0)

                def _std(x):
                    xf = x.float()
                    mu = torch.sum(xf * w) / denom
                    return torch.sqrt(torch.sum(torch.square((xf - mu) * w)) / denom)

                rescaled = steered.float() * _std(embeds) / torch.clamp(_std(steered), min=1e-6)
            embeds = rescale_cfg * rescaled + (1 - rescale_cfg) * steered

        logits = embeds.float() @ w_l + b_l
        kth = _kth_largest(logits, topk_keep)
        logits = logits.masked_fill(logits < kth, -1e9)

        anneal = np.float32(t_now)
        if steps_is_one:
            temp = np.float32(0.2)
        else:
            temp = max(np.float32(temperature) * anneal, np.float32(1e-3))
        temp_t = torch.full((), float(temp), dtype=torch.float32, device=logits.device)
        gumbel_sampled = torch.argmax(logits / temp_t + _gumbel(draw(0, logits.shape)), dim=-1)
        if steps_is_one or not is_last:
            sampled = gumbel_sampled
        else:
            sampled = torch.argmax(logits, dim=-1)
        seq = torch.where(mask, sampled, seq)
        if is_last:  # nothing is re-masked after the final step
            return seq, torch.zeros_like(mask)

        # confidence re-masking
        probs = torch.softmax(logits, dim=-1)
        conf = torch.gather(probs, -1, sampled[..., None])[..., 0]
        scores = (1.0 - conf) + float(anneal) * _gumbel(draw(1, conf.shape))
        scores = scores.masked_fill(~mask, -math.inf)
        # rank threshold; ties (the -inf of unmasked positions) keep index order
        order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
        ranks = torch.empty_like(order).scatter_(
            1, order, torch.arange(tlen, device=order.device)[None, :].expand(b, tlen))
        nmn = next_mask_num[:, None] if torch.is_tensor(next_mask_num) else next_mask_num
        mask = ranks < nmn
        seq = seq.masked_fill(mask, 0)
        return seq, mask

    @torch.no_grad()
    def reverse_diffusion(
        self,
        cond_code,  # [B, P+T] semantic tokens (prompt-aligned + target)
        prompt_code,  # [B, P, Q] acoustic codes of the prompt
        generator: torch.Generator | None = None,
        n_timesteps=(10, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4),
        temperature: float = 1.5,
        filter_thres: float = 0.98,
        cfg: float = 1.0,
        rescale_cfg: float = 1.0,
        cfg_until: float = 1.0,
        unroll: bool = False,
        x_mask=None,
        prompt_mask=None,
        noise=None,
        impl: str | None = None,
    ):
        """Iterative per-layer confidence unmasking. Returns [B, T, Q] int64.

        The uniform draws come from ``generator`` (serving) or from
        ``noise(layer, step, draw, shape)`` (parity tests: draw 0 is the
        ``[B,T,V]`` Gumbel draw of the sampling, draw 1 the ``[B,T]`` draw of
        the re-masking scores; values in [1e-9, 1)). Exactly one of the two.

        Variable-length batching: pass ``x_mask`` [B, T] / ``prompt_mask``
        [B, P] to batch requests of different lengths padded to common T/P;
        padded positions are excluded from attention, sampling and the
        per-row re-masking counts ``floor(schedule * row_len)``. With both
        None the fixed-length path runs.

        ``cfg_until``: classifier-free guidance only on the first
        ``ceil(cfg_until * steps)`` steps of each layer; later steps skip the
        unconditional denoiser call.
        """
        del unroll  # eager PyTorch runs every step as written
        if (generator is None) == (noise is None):
            raise ValueError("reverse_diffusion: pass exactly one of generator= and noise=")
        c = self.cfg
        device = self.mask_emb.device
        b, p, _ = prompt_code.shape
        tlen = cond_code.shape[1] - p
        if len(n_timesteps) != c.num_quantizers:
            raise ValueError(f"n_timesteps needs {c.num_quantizers} entries, got {n_timesteps}")

        variable = x_mask is not None or prompt_mask is not None
        if x_mask is None:
            x_mask = torch.ones((b, tlen), dtype=torch.int32, device=device)
        x_mask = x_mask.to(torch.int32)
        if prompt_mask is None:
            prompt_mask = torch.ones((b, p), dtype=torch.int32, device=device)
        prompt_mask = prompt_mask.to(torch.int32)
        tlen_rows = torch.sum(x_mask, dim=1).float()  # [B]

        cond_full = self.cond_emb[cond_code]  # [B,P+T,H]
        prompt_sum = self.embed_tokens_upto_stacked(prompt_code)  # [B,P,H]
        full_mask = torch.cat([prompt_mask, x_mask], dim=1) if p > 0 else x_mask
        topk_keep = max(1, int((1.0 - filter_thres) * c.codebook_size))

        cum = torch.zeros((b, tlen, c.hidden_size), dtype=torch.float32, device=device)
        codes = torch.zeros((b, tlen, c.num_quantizers), dtype=torch.long, device=device)

        for layer, steps in enumerate(n_timesteps):
            t_list = [1.0 - i / steps for i in range(steps)] + [0.0]
            sin_next = [np.float32(float(np.sin(t * np.pi / 2))) for t in t_list[1:]]
            # static CFG cutoff: uncond calls only on the first cfg_steps
            cfg_steps = steps if cfg <= 0 else min(steps, int(np.ceil(cfg_until * steps)))
            emb_l, w_l, b_l = self.token_emb[layer], self.to_logits_w[layer], self.to_logits_b[layer]
            layer_cond = cond_full + self.layer_emb[layer][None, None, :]
            cond_in = layer_cond.to(c.dtype)
            uncond_in = layer_cond[:, p:].to(c.dtype)

            seq = torch.zeros((b, tlen), dtype=torch.long, device=device)
            mask = x_mask.bool()
            for i in range(steps):
                if variable:
                    nmn = torch.floor(float(sin_next[i]) * tlen_rows).to(torch.int32)
                else:
                    nmn = int(float(np.sin(t_list[i + 1] * np.pi / 2)) * tlen)
                if noise is not None:
                    draw = lambda j, shape, i=i: noise(layer, i, j, tuple(shape))
                else:
                    draw = lambda j, shape: torch.rand(
                        tuple(shape), generator=generator, dtype=torch.float32,
                        device=device) * (1.0 - 1e-9) + 1e-9
                seq, mask = self._sample_step(
                    layer, seq, mask, cum, emb_l, w_l, b_l, cond_in, uncond_in, prompt_sum,
                    full_mask, x_mask, t_now=np.float32(t_list[i]), next_mask_num=nmn,
                    is_last=i == steps - 1, draw=draw, p=p, tlen=tlen,
                    temperature=temperature, topk_keep=topk_keep,
                    cfg_scale=cfg if i < cfg_steps else 0.0, rescale_cfg=rescale_cfg,
                    steps_is_one=steps == 1, all_valid=not variable, impl=impl,
                )
            cum = cum + emb_l[seq]
            codes[:, :, layer] = seq
        return codes
