"""Reference (MaskGCT) torch checkpoints -> this package's audio state dicts.

Counterpart of the JAX package's ``audio/torch_ckpt.py``, with the same
functions and the same arithmetic (numpy; weight norms folded in float64):

- ``repcodec_params_from_torch``: the RepCodec (VocosBackbone encoder and
  decoder + 1-stage factorized RVQ), for ``audio.repcodec.RepCodec``;
- ``codec_encoder_params_from_torch`` / ``codec_decoder_params_from_torch``:
  the acoustic CodecEncoder / CodecDecoder (Vocos or conv decoder), for
  ``audio.acoustic.CodecEncoder`` / ``CodecDecoder``;
- ``s2a_params_from_torch`` / ``diffllama_params_from_torch``: MaskGCT_S2A and
  its DiffLlama (HF-Llama-named q/k/v/o + gate/up/down, adaptive RMSNorms,
  cond / diffusion-step MLPs), for ``audio.s2a.S2AModel`` (float) / its
  denoiser;
- ``*_kwargs_from_torch``: the constructor sizes a state dict implies.

All take ``{name: tensor}`` state dicts (torch tensors or numpy arrays) and
return the module's state dict (flat names, kernels in the flax layout the
port keeps: ``Dense`` ``[in, out]``, ``Conv1d`` ``[k, in / groups, out]``).
Weight-normed convolutions are folded to plain weights; both the legacy
``weight_g`` / ``weight_v`` and the parametrize-style
``parametrizations.weight.original0/1`` keys are read.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

__all__ = [
    "fold_weight_norm",
    "repcodec_params_from_torch",
    "codec_encoder_params_from_torch",
    "codec_decoder_params_from_torch",
    "s2a_params_from_torch",
]


def _array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def _np(sd):
    return {k: _array(v) for k, v in sd.items()}


def _state_dict(tree, prefix: str = "", out=None) -> dict[str, torch.Tensor]:
    """Nested dict of numpy leaves -> flat ``a.b.c`` state dict (tensors own
    their memory)."""
    out = {} if out is None else out
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            _state_dict(val, name + ".", out)
        else:
            out[name] = torch.from_numpy(np.array(val))
    return out


def fold_weight_norm(sd: dict) -> dict:
    """Fold torch weight_norm parameter pairs into plain ``<p>.weight`` keys:
    W = g * v / ||v||, the norm over every axis but 0 (torch's default dim=0),
    in float64, rounded to float32."""
    sd = dict(sd)
    folded = {}
    for key in list(sd):
        if key.endswith(".weight_v"):
            p = key[: -len(".weight_v")]
            g, v = sd.pop(f"{p}.weight_g"), sd.pop(key)
        elif key.endswith(".parametrizations.weight.original1"):
            p = key[: -len(".parametrizations.weight.original1")]
            g = sd.pop(f"{p}.parametrizations.weight.original0")
            v = sd.pop(key)
        else:
            continue
        v = np.asarray(v, np.float64)
        norm = np.sqrt(np.sum(np.square(v), axis=tuple(range(1, v.ndim)), keepdims=True))
        folded[f"{p}.weight"] = (np.asarray(g, np.float64) * v / norm).astype(np.float32)
    sd.update(folded)
    return sd


def _dense(sd, p):
    """torch Linear [out, in] -> Dense {kernel [in, out], bias}."""
    out = {"kernel": sd[f"{p}.weight"].T}
    if f"{p}.bias" in sd:
        out["bias"] = sd[f"{p}.bias"]
    return out


def _conv(sd, p):
    """torch Conv1d [out, in, k] -> Conv1d {kernel [k, in, out], bias}."""
    out = {"kernel": sd[f"{p}.weight"].transpose(2, 1, 0)}
    if f"{p}.bias" in sd:
        out["bias"] = sd[f"{p}.bias"]
    return out


def _conv1x1_as_dense(sd, p):
    """torch Conv1d k=1 [out, in, 1] -> Dense {kernel [in, out], bias}."""
    out = {"kernel": sd[f"{p}.weight"][:, :, 0].T}
    if f"{p}.bias" in sd:
        out["bias"] = sd[f"{p}.bias"]
    return out


def _ln(sd, p):
    return {"scale": sd[f"{p}.weight"], "bias": sd[f"{p}.bias"]}


def _snake(sd, p):
    """torch Snake1d alpha [1, C, 1] -> {alpha [C]}."""
    return {"alpha": sd[f"{p}.alpha"].reshape(-1)}


def _vocos_backbone(sd, prefix):
    """Reference VocosBackbone -> audio/vocos.py VocosBackbone: embed (Conv1d
    k=7), norm, convnext.{i}.{dwconv,norm,pwconv1,pwconv2,gamma},
    final_layer_norm."""
    p = {
        "embed": _conv(sd, f"{prefix}embed"),
        "norm": _ln(sd, f"{prefix}norm"),
        "final_layer_norm": _ln(sd, f"{prefix}final_layer_norm"),
    }
    i = 0
    while f"{prefix}convnext.{i}.gamma" in sd:
        c = f"{prefix}convnext.{i}"
        p[f"convnext_{i}"] = {
            "dwconv": _conv(sd, f"{c}.dwconv"),
            "norm": _ln(sd, f"{c}.norm"),
            "pwconv1": _dense(sd, f"{c}.pwconv1"),
            "pwconv2": _dense(sd, f"{c}.pwconv2"),
            "gamma": sd[f"{c}.gamma"],
        }
        i += 1
    return p


def _fvq(sd, prefix, input_dim, codebook_dim):
    """Reference FactorizedVectorQuantize: in_project / out_project are
    weight-normed 1x1 convs (folded before), absent when input_dim ==
    codebook_dim."""
    p = {"codebook": sd[f"{prefix}codebook.weight"]}
    if input_dim != codebook_dim:
        p["in_proj"] = _conv1x1_as_dense(sd, f"{prefix}in_project")
        p["out_proj"] = _conv1x1_as_dense(sd, f"{prefix}out_project")
    return p


def _rvq(sd, prefix, input_dim, codebook_dim):
    """Reference ResidualVQ (quantizers.{i}.*)."""
    p = {}
    i = 0
    while f"{prefix}quantizers.{i}.codebook.weight" in sd:
        p[f"vq_{i}"] = _fvq(sd, f"{prefix}quantizers.{i}.", input_dim, codebook_dim)
        i += 1
    return p


def repcodec_kwargs_from_torch(state_dict) -> dict:
    """RepCodec constructor kwargs implied by a reference state dict."""
    sd = _np({k: v for k, v in state_dict.items() if "parametriz" not in k})
    cb = sd["quantizer.quantizers.0.codebook.weight"]
    hidden, vocos_dim = sd["encoder.1.weight"].shape
    num_layers = 0
    while f"encoder.0.convnext.{num_layers}.gamma" in sd:
        num_layers += 1
    nq = 0
    while f"quantizer.quantizers.{nq}.codebook.weight" in sd:
        nq += 1
    return dict(
        hidden_size=hidden,
        codebook_size=cb.shape[0],
        codebook_dim=cb.shape[1],
        vocos_dim=vocos_dim,
        vocos_intermediate_dim=sd["encoder.0.convnext.0.pwconv1.weight"].shape[0],
        vocos_num_layers=num_layers,
        num_quantizers=nq,
    )


def codec_encoder_kwargs_from_torch(state_dict) -> dict:
    """CodecEncoder kwargs implied by a reference state dict (each
    EncoderBlock's down-conv has kernel_size = 2 * stride)."""
    sd = fold_weight_norm(_np(state_dict))
    d_model = sd["block.0.weight"].shape[0]
    strides = []
    i = 1
    while f"block.{i}.block.4.weight" in sd:
        strides.append(sd[f"block.{i}.block.4.weight"].shape[-1] // 2)
        i += 1
    return dict(d_model=d_model, strides=tuple(strides),
                out_channels=sd[f"block.{i + 1}.weight"].shape[0])


def codec_decoder_kwargs_from_torch(state_dict) -> dict:
    """CodecDecoder kwargs implied by a reference state dict (either
    variant; the conv variant's up_ratios from its transposed-conv kernels,
    k = 2 * stride)."""
    sd = fold_weight_norm(_np(state_dict))
    cb = sd["quantizer.quantizers.0.codebook.weight"]
    nq = 0
    while f"quantizer.quantizers.{nq}.codebook.weight" in sd:
        nq += 1
    common = dict(num_quantizers=nq, codebook_size=cb.shape[0], codebook_dim=cb.shape[1])
    if "model.embed.weight" in sd:  # vocos variant
        nl = 0
        while f"model.convnext.{nl}.gamma" in sd:
            nl += 1
        return dict(
            in_channels=sd["model.embed.weight"].shape[1],
            vocos_dim=sd["model.embed.weight"].shape[0],
            vocos_intermediate_dim=sd["model.convnext.0.pwconv1.weight"].shape[0],
            vocos_num_layers=nl,
            **common,
        )
    ratios = []
    i = 1
    while f"model.{i}.block.1.weight" in sd:
        ratios.append(sd[f"model.{i}.block.1.weight"].shape[-1] // 2)
        i += 1
    return dict(
        in_channels=sd["model.0.weight"].shape[1],
        use_vocos=False,
        upsample_initial_channel=sd["model.0.weight"].shape[0],
        up_ratios=tuple(ratios),
        **common,
    )


def s2a_kwargs_from_torch(state_dict) -> dict:
    """S2AConfig kwargs implied by a MaskGCT_S2A state dict. ``num_heads``
    cannot be read off ``[H, H]`` projections: callers keep their own."""
    sd = _np(state_dict)
    q = 0
    while f"token_emb.{q}.weight" in sd:
        q += 1
    nl = 0
    while f"diff_estimator.layers.{nl}.self_attn.q_proj.weight" in sd:
        nl += 1
    k, h = sd["token_emb.0.weight"].shape
    return dict(num_quantizers=q, hidden_size=h, num_layers=nl, codebook_size=k,
                cond_codebook_size=sd["cond_emb.weight"].shape[0])


def repcodec_params_from_torch(state_dict) -> dict[str, torch.Tensor]:
    """RepCodec state dict -> state dict of ``audio.repcodec.RepCodec``.
    Reference layout: encoder / decoder are Sequential(VocosBackbone, Linear)
    (``encoder.0.*`` / ``encoder.1.*``); the quantizer is the factorized
    ResidualVQ."""
    sd = fold_weight_norm(_np(state_dict))
    cb = sd["quantizer.quantizers.0.codebook.weight"]
    input_dim = sd["encoder.1.weight"].shape[0]
    return _state_dict({
        "encoder": _vocos_backbone(sd, "encoder.0."),
        "enc_proj": _dense(sd, "encoder.1"),
        "quantizer": _rvq(sd, "quantizer.", input_dim, cb.shape[1]),
        "decoder": _vocos_backbone(sd, "decoder.0."),
        "dec_proj": _dense(sd, "decoder.1"),
    })


def codec_encoder_params_from_torch(state_dict, num_blocks: int = 4) -> dict[str, torch.Tensor]:
    """CodecEncoder state dict -> state dict of ``audio.acoustic.CodecEncoder``.
    Reference layout: one Sequential ``block``: [0] WNConv1d k=7, [1..n]
    EncoderBlock ([ResidualUnit x 3, Snake1d, down WNConv1d]), [n+1] Snake1d,
    [n+2] WNConv1d k=3; ResidualUnit.block = [Snake1d, conv k=7 dilated,
    Snake1d, conv k=1]."""
    sd = fold_weight_norm(_np(state_dict))

    def res_unit(p):
        return {"snake1": _snake(sd, f"{p}.block.0"), "conv1": _conv(sd, f"{p}.block.1"),
                "snake2": _snake(sd, f"{p}.block.2"), "conv2": _conv(sd, f"{p}.block.3")}

    params = {"conv_in": _conv(sd, "block.0")}
    for i in range(num_blocks):
        b = f"block.{i + 1}.block"
        params[f"block_{i}"] = {
            "res1": res_unit(f"{b}.0"),
            "res2": res_unit(f"{b}.1"),
            "res3": res_unit(f"{b}.2"),
            "snake": _snake(sd, f"{b}.3"),
            "down": _conv(sd, f"{b}.4"),
        }
    params["snake_out"] = _snake(sd, f"block.{num_blocks + 1}")
    params["conv_out"] = _conv(sd, f"block.{num_blocks + 2}")
    return _state_dict(params)


def _conv_transpose(sd, p):
    """torch ConvTranspose1d [in, out, k] -> UpsampleConv {kernel [k, in, out]}:
    a transposed convolution is an input-dilated correlation with the kernel
    flipped in time, so the k axis is reversed."""
    out = {"kernel": np.ascontiguousarray(sd[f"{p}.weight"].transpose(2, 0, 1)[::-1])}
    if f"{p}.bias" in sd:
        out["bias"] = sd[f"{p}.bias"]
    return out


def _conv_decoder(sd, prefix):
    """Reference conv decoder Sequential -> ConvDecoder."""

    def res_unit(p):
        return {"snake1": _snake(sd, f"{p}.block.0"), "conv1": _conv(sd, f"{p}.block.1"),
                "snake2": _snake(sd, f"{p}.block.2"), "conv2": _conv(sd, f"{p}.block.3")}

    params = {"conv_in": _conv(sd, f"{prefix}0")}
    i = 1
    while f"{prefix}{i}.block.1.weight" in sd:
        b = f"{prefix}{i}.block"
        params[f"block_{i - 1}"] = {
            "snake": _snake(sd, f"{b}.0"),
            "up": _conv_transpose(sd, f"{b}.1"),
            "res1": res_unit(f"{b}.2"),
            "res2": res_unit(f"{b}.3"),
            "res3": res_unit(f"{b}.4"),
        }
        i += 1
    params["snake_out"] = _snake(sd, f"{prefix}{i}")
    params["conv_out"] = _conv(sd, f"{prefix}{i + 1}")
    return params


def codec_decoder_params_from_torch(state_dict) -> dict[str, torch.Tensor]:
    """CodecDecoder state dict -> state dict of ``audio.acoustic.CodecDecoder``
    (either variant). The Vocos variant's reference stops at the backbone's
    hidden states and has no waveform head: load the result with
    ``strict=False`` so that the module keeps its own ``head``. The conv
    variant converts completely."""
    sd = fold_weight_norm(_np(state_dict))
    cb = sd["quantizer.quantizers.0.codebook.weight"]
    if "model.embed.weight" in sd:  # vocos variant
        input_dim = sd["model.embed.weight"].shape[1]
        model = _vocos_backbone(sd, "model.")
    else:
        input_dim = sd["model.0.weight"].shape[1]
        model = _conv_decoder(sd, "model.")
    return _state_dict({"quantizer": _rvq(sd, "quantizer.", input_dim, cb.shape[1]),
                        "model": model})


def _diffllama(sd: dict, prefix: str) -> dict:
    """DiffLlama / DiffLlamaPrefix weights under ``prefix`` -> the denoiser's
    tree (cond_mlp is optional: DiffLlamaPrefix without phone conditioning
    has none); q/k/v fused into one ``qkv`` kernel."""
    denoiser = {
        "t0": _dense(sd, f"{prefix}diff_step_mlp.0"),
        "t1": _dense(sd, f"{prefix}diff_step_mlp.2"),
        "final_norm": {"to_weight": _dense(sd, f"{prefix}norm.to_weight")},
    }
    if f"{prefix}cond_mlp.0.weight" in sd:
        denoiser["c0"] = _dense(sd, f"{prefix}cond_mlp.0")
        denoiser["c1"] = _dense(sd, f"{prefix}cond_mlp.2")
    i = 0
    while f"{prefix}layers.{i}.self_attn.q_proj.weight" in sd:
        L = f"{prefix}layers.{i}"
        qkv = np.concatenate([sd[f"{L}.self_attn.q_proj.weight"].T,
                              sd[f"{L}.self_attn.k_proj.weight"].T,
                              sd[f"{L}.self_attn.v_proj.weight"].T], axis=1)
        denoiser[f"layers_{i}"] = {
            "qkv": {"kernel": qkv},
            "out": {"kernel": sd[f"{L}.self_attn.o_proj.weight"].T},
            "gate": {"kernel": sd[f"{L}.mlp.gate_proj.weight"].T},
            "up": {"kernel": sd[f"{L}.mlp.up_proj.weight"].T},
            "down": {"kernel": sd[f"{L}.mlp.down_proj.weight"].T},
            "input_norm": {"to_weight": _dense(sd, f"{L}.input_layernorm.to_weight")},
            "post_attn_norm": {"to_weight": _dense(sd, f"{L}.post_attention_layernorm.to_weight")},
        }
        i += 1
    return denoiser


def diffllama_params_from_torch(state_dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """A standalone DiffLlama / DiffLlamaPrefix state dict -> the denoiser's
    state dict."""
    return _state_dict(_diffllama(_np(state_dict), prefix))


def s2a_params_from_torch(state_dict) -> dict[str, torch.Tensor]:
    """MaskGCT_S2A state dict -> FLOAT state dict of ``audio.s2a.S2AModel``
    (``int8_matmul=False``; ``audio.s2a.quantize_s2a_params`` makes the
    offline-int8 form). Per-quantizer ``token_emb.{l}`` / ``to_logits.{l}``
    are stacked into ``[Q, ...]``, ``mask_emb`` (a 1-row Embedding) is
    squeezed, and the ``diff_estimator`` DiffLlama becomes ``denoiser``."""
    sd = _np(state_dict)
    q = 0
    while f"token_emb.{q}.weight" in sd:
        q += 1
    return _state_dict({
        "layer_emb": sd["layer_emb.weight"],
        "mask_emb": sd["mask_emb.weight"][0],
        "token_emb": np.stack([sd[f"token_emb.{l}.weight"] for l in range(q)]),
        "to_logits_w": np.stack([sd[f"to_logits.{l}.weight"].T for l in range(q)]),
        "to_logits_b": np.stack([sd[f"to_logits.{l}.bias"] for l in range(q)]),
        "cond_emb": sd["cond_emb.weight"],
        "denoiser": _diffllama(sd, "diff_estimator."),
    })
