"""This package's audio weights as the reference-named state dicts that the
checkpoint converters read: the inverse of ``audio/torch_ckpt.py`` and of
``audio/conformer.params_from_hf``.

A helper for checks, not a feature: tests and ``chip_smoke.py`` use it to
make full-width checkpoints from seeded modules where there is neither
``transformers`` nor the reference's source. Names and layouts:

- ``hf_w2vbert_state_dict``: HF ``Wav2Vec2BertModel`` names (the layers this
  package builds, up to the tap), with ``semantic_stats`` the
  ``wav2vec2bert_stats.pt`` dict ``{"mean", "var"}`` (var = std ** 2);
- ``repcodec_state_dict``: the reference RepCodec (``encoder.0`` Vocos,
  ``encoder.1`` Linear, factorized RVQ ``quantizer.quantizers.{i}``);
- ``codec_encoder_state_dict`` / ``codec_decoder_state_dict``: the acoustic
  codec's ``block.*`` / ``quantizer.*`` + ``model.*`` (the Vocos decoder has
  no waveform head in the reference, so the ISTFT head is not written);
- ``s2a_state_dict``: ``MaskGCT_S2A`` with its ``diff_estimator`` DiffLlama
  (HF-Llama q/k/v/o, gate/up/down), from a FLOAT S2A state dict.

The LM's HF (``LlamaForCausalLM``-style) names are the export direction of
``utils/ckpt_conversion.py``.

Convolutions the reference wraps in ``weight_norm`` are written as weight-norm
pairs, ``weight_norm="legacy"`` (``weight_g`` / ``weight_v``) or
``"parametrize"`` (``parametrizations.weight.original0/1``), or plain with
``None``. The pair is v = W and g = ||v|| in float64, the norm taken as
``fold_weight_norm`` takes it, so that folding gives W back bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

WEIGHT_NORM_STYLES = ("legacy", "parametrize", None)


def _numpy(module_or_state_dict) -> dict[str, np.ndarray]:
    sd = (module_or_state_dict.state_dict() if isinstance(module_or_state_dict, nn.Module)
          else module_or_state_dict)
    out = {}
    for k, v in sd.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            v = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        out[k] = np.asarray(v)
    return out


def _tensors(sd: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


class _Writer:
    """Accumulates reference names from this package's leaves."""

    def __init__(self, src: dict[str, np.ndarray], weight_norm):
        if weight_norm not in WEIGHT_NORM_STYLES:
            raise ValueError(f"weight_norm must be one of {WEIGHT_NORM_STYLES}")
        self.src, self.weight_norm, self.out = src, weight_norm, {}

    def weight(self, p: str, w: np.ndarray, normed: bool):
        if not (normed and self.weight_norm):
            self.out[f"{p}.weight"] = w
            return
        v = np.asarray(w, np.float32)
        g = np.sqrt(np.sum(np.square(v.astype(np.float64)), axis=tuple(range(1, v.ndim)),
                           keepdims=True))
        if self.weight_norm == "legacy":
            self.out[f"{p}.weight_g"], self.out[f"{p}.weight_v"] = g, v
        else:
            self.out[f"{p}.parametrizations.weight.original0"] = g
            self.out[f"{p}.parametrizations.weight.original1"] = v

    def bias(self, p: str, src: str):
        if f"{src}.bias" in self.src:
            self.out[f"{p}.bias"] = self.src[f"{src}.bias"]

    def dense(self, p: str, src: str):
        """Dense {kernel [in, out], bias} -> Linear [out, in]."""
        self.weight(p, self.src[f"{src}.kernel"].T, False)
        self.bias(p, src)

    def conv(self, p: str, src: str, normed: bool = False):
        """Conv1d {kernel [k, in, out], bias} -> Conv1d [out, in, k]."""
        self.weight(p, self.src[f"{src}.kernel"].transpose(2, 1, 0), normed)
        self.bias(p, src)

    def conv1x1(self, p: str, src: str, normed: bool):
        """Dense {kernel [in, out]} -> Conv1d k=1 [out, in, 1]."""
        self.weight(p, self.src[f"{src}.kernel"].T[:, :, None], normed)
        self.bias(p, src)

    def conv_transpose(self, p: str, src: str, normed: bool):
        """UpsampleConv {kernel [k, in, out]} -> ConvTranspose1d [in, out, k]
        (the time axis flipped back)."""
        self.weight(p, np.ascontiguousarray(self.src[f"{src}.kernel"][::-1].transpose(1, 2, 0)),
                    normed)
        self.bias(p, src)

    def ln(self, p: str, src: str):
        self.out[f"{p}.weight"] = self.src[f"{src}.scale"]
        self.out[f"{p}.bias"] = self.src[f"{src}.bias"]

    def snake(self, p: str, src: str):
        self.out[f"{p}.alpha"] = self.src[f"{src}.alpha"].reshape(1, -1, 1)

    def vocos(self, p: str, src: str):
        self.conv(f"{p}embed", f"{src}embed")
        self.ln(f"{p}norm", f"{src}norm")
        self.ln(f"{p}final_layer_norm", f"{src}final_layer_norm")
        i = 0
        while f"{src}convnext_{i}.gamma" in self.src:
            c, s = f"{p}convnext.{i}", f"{src}convnext_{i}"
            self.conv(f"{c}.dwconv", f"{s}.dwconv")
            self.ln(f"{c}.norm", f"{s}.norm")
            self.dense(f"{c}.pwconv1", f"{s}.pwconv1")
            self.dense(f"{c}.pwconv2", f"{s}.pwconv2")
            self.out[f"{c}.gamma"] = self.src[f"{s}.gamma"]
            i += 1

    def rvq(self, p: str, src: str):
        """Factorized RVQ; in / out projections weight-normed 1x1 convs."""
        i = 0
        while f"{src}vq_{i}.codebook" in self.src:
            q, s = f"{p}quantizers.{i}", f"{src}vq_{i}"
            self.out[f"{q}.codebook.weight"] = self.src[f"{s}.codebook"]
            if f"{s}.in_proj.kernel" in self.src:
                self.conv1x1(f"{q}.in_project", f"{s}.in_proj", True)
                self.conv1x1(f"{q}.out_project", f"{s}.out_proj", True)
            i += 1

    def res_unit(self, p: str, src: str):
        self.snake(f"{p}.block.0", f"{src}.snake1")
        self.conv(f"{p}.block.1", f"{src}.conv1", True)
        self.snake(f"{p}.block.2", f"{src}.snake2")
        self.conv(f"{p}.block.3", f"{src}.conv2", True)


def hf_w2vbert_state_dict(encoder) -> dict[str, torch.Tensor]:
    """A ``SemanticEncoder`` (module or state dict) -> HF ``Wav2Vec2BertModel``
    names (feature projection and the built layers; the statistics are
    :func:`semantic_stats`')."""
    w = _Writer(_numpy(encoder), None)
    w.ln("feature_projection.layer_norm", "encoder.fp_layer_norm")
    w.dense("feature_projection.projection", "encoder.fp_projection")
    i = 0
    while f"encoder.layers_{i}.final_layer_norm.scale" in w.src:
        hf, s = f"encoder.layers.{i}", f"encoder.layers_{i}"
        for ffn in ("ffn1", "ffn2"):
            w.ln(f"{hf}.{ffn}_layer_norm", f"{s}.{ffn}_layer_norm")
            w.dense(f"{hf}.{ffn}.intermediate_dense", f"{s}.{ffn}.intermediate_dense")
            w.dense(f"{hf}.{ffn}.output_dense", f"{s}.{ffn}.output_dense")
        w.ln(f"{hf}.self_attn_layer_norm", f"{s}.self_attn_layer_norm")
        for lin in ("linear_q", "linear_k", "linear_v", "linear_out"):
            w.dense(f"{hf}.self_attn.{lin}", f"{s}.self_attn.{lin}")
        w.out[f"{hf}.self_attn.distance_embedding.weight"] = w.src[
            f"{s}.self_attn.distance_embedding"]
        cm, sc = f"{hf}.conv_module", f"{s}.conv_module"
        w.ln(f"{cm}.layer_norm", f"{sc}.layer_norm")
        w.conv1x1(f"{cm}.pointwise_conv1", f"{sc}.pointwise_conv1", False)
        w.conv(f"{cm}.depthwise_conv", f"{sc}.depthwise_conv")
        w.ln(f"{cm}.depthwise_layer_norm", f"{sc}.depthwise_layer_norm")
        w.conv1x1(f"{cm}.pointwise_conv2", f"{sc}.pointwise_conv2", False)
        w.ln(f"{hf}.final_layer_norm", f"{s}.final_layer_norm")
        i += 1
    return _tensors(w.out)


def semantic_stats(encoder) -> dict[str, torch.Tensor]:
    """The ``wav2vec2bert_stats.pt`` dict of a ``SemanticEncoder``: mean and
    var = std ** 2 in float32 (sqrt(fl(s * s)) == s in binary floating point,
    so the loader's std = sqrt(var) gives std back)."""
    src = _numpy(encoder)
    std = src["stat_std"].astype(np.float32)
    return _tensors({"mean": src["stat_mean"].astype(np.float32), "var": std * std})


def repcodec_state_dict(repcodec, weight_norm="legacy") -> dict[str, torch.Tensor]:
    """A ``RepCodec`` (module or state dict) -> reference RepCodec names."""
    w = _Writer(_numpy(repcodec), weight_norm)
    w.vocos("encoder.0.", "encoder.")
    w.dense("encoder.1", "enc_proj")
    w.rvq("quantizer.", "quantizer.")
    w.vocos("decoder.0.", "decoder.")
    w.dense("decoder.1", "dec_proj")
    return _tensors(w.out)


def codec_encoder_state_dict(encoder, weight_norm="legacy") -> dict[str, torch.Tensor]:
    """A ``CodecEncoder`` (module or state dict) -> reference CodecEncoder
    names (weight-normed convolutions)."""
    w = _Writer(_numpy(encoder), weight_norm)
    w.conv("block.0", "conv_in", True)
    n = 0
    while f"block_{n}.down.kernel" in w.src:
        b, s = f"block.{n + 1}.block", f"block_{n}"
        for j, res in enumerate(("res1", "res2", "res3")):
            w.res_unit(f"{b}.{j}", f"{s}.{res}")
        w.snake(f"{b}.3", f"{s}.snake")
        w.conv(f"{b}.4", f"{s}.down", True)
        n += 1
    w.snake(f"block.{n + 1}", "snake_out")
    w.conv(f"block.{n + 2}", "conv_out", True)
    return _tensors(w.out)


def codec_decoder_state_dict(decoder, weight_norm="legacy") -> dict[str, torch.Tensor]:
    """A ``CodecDecoder`` (module or state dict; Vocos or conv variant) ->
    reference CodecDecoder names. The Vocos variant's ISTFT head is not
    written: the reference has none."""
    w = _Writer(_numpy(decoder), weight_norm)
    w.rvq("quantizer.", "quantizer.")
    if "model.embed.kernel" in w.src:
        w.vocos("model.", "model.")
        return _tensors(w.out)
    w.conv("model.0", "model.conv_in", True)
    i = 0
    while f"model.block_{i}.up.kernel" in w.src:
        b, s = f"model.{i + 1}.block", f"model.block_{i}"
        w.snake(f"{b}.0", f"{s}.snake")
        w.conv_transpose(f"{b}.1", f"{s}.up", True)
        for j, res in enumerate(("res1", "res2", "res3")):
            w.res_unit(f"{b}.{j + 2}", f"{s}.{res}")
        i += 1
    w.snake(f"model.{i + 1}", "model.snake_out")
    w.conv(f"model.{i + 2}", "model.conv_out", True)
    return _tensors(w.out)


def s2a_state_dict(s2a_float) -> dict[str, torch.Tensor]:
    """A FLOAT ``S2AModel`` (module or state dict, ``int8_matmul=False``) ->
    ``MaskGCT_S2A`` names."""
    src = _numpy(s2a_float)
    if any(k.endswith("kernel_scale") for k in src):
        raise ValueError("an int8-served S2A state dict: export the float weights")
    w = _Writer(src, None)
    q = src["token_emb"].shape[0]
    w.out["layer_emb.weight"] = src["layer_emb"]
    w.out["mask_emb.weight"] = src["mask_emb"][None]
    w.out["cond_emb.weight"] = src["cond_emb"]
    for l in range(q):
        w.out[f"token_emb.{l}.weight"] = src["token_emb"][l]
        w.out[f"to_logits.{l}.weight"] = src["to_logits_w"][l].T
        w.out[f"to_logits.{l}.bias"] = src["to_logits_b"][l]
    d, s = "diff_estimator.", "denoiser."
    w.dense(f"{d}diff_step_mlp.0", f"{s}t0")
    w.dense(f"{d}diff_step_mlp.2", f"{s}t1")
    if f"{s}c0.kernel" in src:
        w.dense(f"{d}cond_mlp.0", f"{s}c0")
        w.dense(f"{d}cond_mlp.2", f"{s}c1")
    w.dense(f"{d}norm.to_weight", f"{s}final_norm.to_weight")
    i = 0
    while f"{s}layers_{i}.qkv.kernel" in src:
        L, sl = f"{d}layers.{i}", f"{s}layers_{i}"
        qkv = src[f"{sl}.qkv.kernel"]
        h = qkv.shape[1] // 3
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            w.out[f"{L}.self_attn.{name}.weight"] = qkv[:, j * h:(j + 1) * h].T
        w.dense(f"{L}.self_attn.o_proj", f"{sl}.out")
        w.dense(f"{L}.mlp.gate_proj", f"{sl}.gate")
        w.dense(f"{L}.mlp.up_proj", f"{sl}.up")
        w.dense(f"{L}.mlp.down_proj", f"{sl}.down")
        w.dense(f"{L}.input_layernorm.to_weight", f"{sl}.input_norm.to_weight")
        w.dense(f"{L}.post_attention_layernorm.to_weight", f"{sl}.post_attn_norm.to_weight")
        i += 1
    return _tensors(w.out)
