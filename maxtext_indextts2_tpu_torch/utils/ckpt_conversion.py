"""HF <-> this package's checkpoint conversion for the dense decoder families.

Counterpart of the JAX package's ``utils/ckpt_conversion.py``. One
table-driven converter covers the llama-family layout (llama2/3, mistral,
qwen3, gemma v1, and any qk-norm block such as ``tts``: the per-head
``q_norm`` / ``k_norm`` are converted when the state dict holds them);
gemma2 / gemma3 group 2 / 6 HF layers into one decoder unit. The weights land
directly in this package's state dict: unrolled ``decoder.layers_{i}`` names,
every kernel in the JAX layout ``[in..., out...]``, float32 as the JAX
converters make them (``utils/param_bridge.py`` docstring). The export
direction keeps each tensor's dtype.

The families of ROADMAP item 6 (mixtral, deepseek, gpt2 / paxml gpt3,
llama4, qwen3_moe and the vision towers) raise ``NotImplementedError`` with
that item.

CLI, both directions, with ``key=value`` config overrides after the flags::

    python -m maxtext_indextts2_tpu_torch.utils.ckpt_conversion \\
        --hf_path <dir> --out_path <params-only ckpt> --model_name X [key=value ...]
    python -m maxtext_indextts2_tpu_torch.utils.ckpt_conversion --direction to_hf \\
        --ckpt_path <ckpt> --out_path <dir> --model_name X [key=value ...]

The HF directory is read without ``transformers``: its ``pytorch_model*.bin``
files with ``torch.load(weights_only=True)`` and its ``*.safetensors`` files
where ``safetensors`` is installed. The output of ``to_framework`` is a
params-only checkpoint of ``train/checkpointing.py``.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from maxtext_indextts2_tpu_torch.config import Config
from maxtext_indextts2_tpu_torch.unported import _unsupported

_ITEM6 = "6, other model families"


def _t(x) -> torch.Tensor:
    """A float32 CPU tensor of a torch leaf (numpy leaves keep their dtype),
    as the JAX converters' ``_t``."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x))
    return x.detach().to(torch.float32).cpu()


def _c(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous()


def _pad_vocab(emb: torch.Tensor, vocab_size: int) -> torch.Tensor:
    if emb.shape[0] == vocab_size:
        return emb
    if emb.shape[0] > vocab_size:
        return _c(emb[:vocab_size])
    out = torch.zeros((vocab_size, emb.shape[1]), dtype=emb.dtype)
    out[: emb.shape[0]] = emb
    return out


def _dims(cfg: Config):
    return cfg.emb_dim, cfg.num_query_heads, cfg.num_kv_heads, cfg.head_dim


def _import_sublayer(get, hf: int, pre: str, sub: int, cfg: Config, *, mlp: bool,
                     qk_norm: bool, sandwich: bool) -> dict[str, torch.Tensor]:
    """HF layer ``hf`` -> sub-layer ``sub`` of the unit named by ``pre``."""
    E, nq, nkv, hd = _dims(cfg)
    h = f"model.layers.{hf}."
    a = f"{pre}self_attention_{sub}."
    out = {
        a + "query.kernel": _c(get(h + "self_attn.q_proj.weight").T.reshape(E, nq, hd)),
        a + "key.kernel": _c(get(h + "self_attn.k_proj.weight").T.reshape(E, nkv, hd)),
        a + "value.kernel": _c(get(h + "self_attn.v_proj.weight").T.reshape(E, nkv, hd)),
        a + "out.kernel": _c(get(h + "self_attn.o_proj.weight").T.reshape(nq, hd, E)),
        f"{pre}pre_self_attention_norm_{sub}.scale": get(h + "input_layernorm.weight"),
    }
    if qk_norm:
        out[a + "query_norm.scale"] = get(h + "self_attn.q_norm.weight")
        out[a + "key_norm.scale"] = get(h + "self_attn.k_norm.weight")
    if mlp:
        m = f"{pre}mlp_{sub}."
        out[m + "wi_0.kernel"] = _c(get(h + "mlp.gate_proj.weight").T)
        out[m + "wi_1.kernel"] = _c(get(h + "mlp.up_proj.weight").T)
        out[m + "wo.kernel"] = _c(get(h + "mlp.down_proj.weight").T)
    if sandwich:
        out[f"{pre}post_self_attention_norm_{sub}.scale"] = get(
            h + "post_attention_layernorm.weight")
        out[f"{pre}pre_mlp_norm_{sub}.scale"] = get(h + "pre_feedforward_layernorm.weight")
        out[f"{pre}post_ffw_norm_{sub}.scale"] = get(h + "post_feedforward_layernorm.weight")
    else:
        out[f"{pre}pre_mlp_norm_{sub}.scale"] = get(h + "post_attention_layernorm.weight")
    return out


def _import_grouped(state_dict: dict, cfg: Config, group: int, *, qk_norm: bool | None,
                    sandwich: bool) -> dict[str, torch.Tensor]:
    """HF flat layer list -> units of ``group`` sub-layers (HF layer
    ``group * u + sub`` is sub-layer ``sub`` of unit ``u``). ``qk_norm=None``:
    convert the q/k norms when the state dict holds them."""
    sd = state_dict

    def get(name):
        return _t(sd[name])

    if qk_norm is None:
        qk_norm = "model.layers.0.self_attn.q_norm.weight" in sd
    # dense MLP (absent for MoE variants, whose converters are item 6)
    mlp = "model.layers.0.mlp.gate_proj.weight" in sd
    out = {"token_embedder.embedding": _pad_vocab(get("model.embed_tokens.weight"),
                                                  cfg.vocab_size)}
    for u in range(cfg.num_decoder_layers // group):
        for sub in range(group):
            out.update(_import_sublayer(get, group * u + sub, f"decoder.layers_{u}.", sub, cfg,
                                        mlp=mlp, qk_norm=qk_norm, sandwich=sandwich))
    out["decoder_norm.scale"] = get("model.norm.weight")
    return out


def convert_hf_llama_to_framework(state_dict: dict, cfg: Config) -> dict[str, torch.Tensor]:
    """HF llama / mistral / qwen3-style state dict -> this package's state
    dict (``Transformer`` / ``Engine.set_params``)."""
    out = _import_grouped(state_dict, cfg, 1, qk_norm=None, sandwich=False)
    if not cfg.logits_via_embedding:
        lm_head = state_dict.get("lm_head.weight")
        if lm_head is None:  # tied embeddings
            lm_head = state_dict["model.embed_tokens.weight"]
        out["logits_dense.kernel"] = _c(_pad_vocab(_t(lm_head), cfg.vocab_size).T)
    return out


def convert_hf_gemma_to_framework(state_dict: dict, cfg: Config) -> dict[str, torch.Tensor]:
    """HF Gemma (v1): llama's tensor layout; the gemma behaviour ((1 + w)
    norms, sqrt(d) embedding scale, gelu, tied unembedding) is the block
    style's and the family defaults', not the weights'."""
    return convert_hf_llama_to_framework(state_dict, cfg)


def convert_hf_gemma2_to_framework(state_dict: dict, cfg: Config) -> dict[str, torch.Tensor]:
    """HF Gemma2 -> units of 2 sub-layers [local_sliding, global], sandwich
    norms, tied embeddings."""
    return _import_grouped(state_dict, cfg, 2, qk_norm=False, sandwich=True)


def convert_hf_gemma3_to_framework(state_dict: dict, cfg: Config) -> dict[str, torch.Tensor]:
    """HF Gemma3 text model -> units of 6 sub-layers [5 x local_sliding,
    global], qk norms, sandwich norms."""
    return _import_grouped(state_dict, cfg, 6, qk_norm=True, sandwich=True)


def _export_grouped(params: dict, cfg: Config, group: int, sandwich: bool,
                    hf_vocab_size: int | None) -> dict[str, torch.Tensor]:
    """This package's state dict -> HF flat layer list (dtypes kept)."""
    E, nq, nkv, hd = _dims(cfg)
    v = hf_vocab_size or cfg.vocab_size

    def g(name):
        return params[name].detach().cpu()

    sd = {"model.embed_tokens.weight": _c(g("token_embedder.embedding")[:v]),
          "model.norm.weight": g("decoder_norm.scale")}
    if "logits_dense.kernel" in params:
        sd["lm_head.weight"] = _c(g("logits_dense.kernel").T[:v])
    for i in range(cfg.num_decoder_layers):
        u, sub = divmod(i, group)
        pre, h = f"decoder.layers_{u}.", f"model.layers.{i}."
        a = f"{pre}self_attention_{sub}."
        sd[h + "self_attn.q_proj.weight"] = _c(g(a + "query.kernel").reshape(E, nq * hd).T)
        sd[h + "self_attn.k_proj.weight"] = _c(g(a + "key.kernel").reshape(E, nkv * hd).T)
        sd[h + "self_attn.v_proj.weight"] = _c(g(a + "value.kernel").reshape(E, nkv * hd).T)
        sd[h + "self_attn.o_proj.weight"] = _c(g(a + "out.kernel").reshape(nq * hd, E).T)
        if a + "query_norm.scale" in params:
            sd[h + "self_attn.q_norm.weight"] = g(a + "query_norm.scale")
            sd[h + "self_attn.k_norm.weight"] = g(a + "key_norm.scale")
        m = f"{pre}mlp_{sub}."
        sd[h + "mlp.gate_proj.weight"] = _c(g(m + "wi_0.kernel").T)
        sd[h + "mlp.up_proj.weight"] = _c(g(m + "wi_1.kernel").T)
        sd[h + "mlp.down_proj.weight"] = _c(g(m + "wo.kernel").T)
        sd[h + "input_layernorm.weight"] = g(f"{pre}pre_self_attention_norm_{sub}.scale")
        if sandwich:
            sd[h + "post_attention_layernorm.weight"] = g(
                f"{pre}post_self_attention_norm_{sub}.scale")
            sd[h + "pre_feedforward_layernorm.weight"] = g(f"{pre}pre_mlp_norm_{sub}.scale")
            sd[h + "post_feedforward_layernorm.weight"] = g(f"{pre}post_ffw_norm_{sub}.scale")
        else:
            sd[h + "post_attention_layernorm.weight"] = g(f"{pre}pre_mlp_norm_{sub}.scale")
    return sd


def convert_framework_to_hf_llama(params: dict, cfg: Config,
                                  hf_vocab_size: int | None = None) -> dict[str, torch.Tensor]:
    """Inverse of :func:`convert_hf_llama_to_framework` (mistral's naming is
    the same; qwen3's q/k norms are exported when present).
    ``hf_vocab_size`` trims rows the import padded."""
    return _export_grouped(params, cfg, 1, False, hf_vocab_size)


def convert_framework_to_hf_gemma2(params: dict, cfg: Config,
                                   hf_vocab_size: int | None = None) -> dict[str, torch.Tensor]:
    """Inverse of :func:`convert_hf_gemma2_to_framework` (tied: no lm_head)."""
    return _export_grouped(params, cfg, 2, True, hf_vocab_size)


def convert_framework_to_hf_gemma3(params: dict, cfg: Config,
                                   hf_vocab_size: int | None = None) -> dict[str, torch.Tensor]:
    """Inverse of :func:`convert_hf_gemma3_to_framework` (text model)."""
    return _export_grouped(params, cfg, 6, True, hf_vocab_size)


def _item6(name: str, what: str):
    def refuse(*args, **kwargs):
        _unsupported(f"{name} ({what})", _ITEM6)

    refuse.__name__ = name
    refuse.__doc__ = f"{what}: not ported (ROADMAP.md, port queue item 6)."
    return refuse


convert_hf_mixtral_to_framework = _item6("convert_hf_mixtral_to_framework", "mixtral MoE")
convert_framework_to_hf_mixtral = _item6("convert_framework_to_hf_mixtral", "mixtral MoE")
convert_hf_deepseek_to_framework = _item6("convert_hf_deepseek_to_framework", "deepseek MLA")
convert_hf_gpt2_to_framework = _item6("convert_hf_gpt2_to_framework", "gpt2 / gpt3 LayerNorm")
convert_paxml_gpt3_to_framework = _item6("convert_paxml_gpt3_to_framework", "paxml gpt3")
load_paxml_gpt3_checkpoint = _item6("load_paxml_gpt3_checkpoint", "paxml gpt3")
convert_hf_llama4_to_framework = _item6("convert_hf_llama4_to_framework", "llama4")
convert_hf_qwen3_moe_to_framework = _item6("convert_hf_qwen3_moe_to_framework", "qwen3 MoE")
convert_hf_siglip_to_framework = _item6("convert_hf_siglip_to_framework", "vision tower")
convert_hf_gemma3_multimodal = _item6("convert_hf_gemma3_multimodal", "vision tower")
convert_hf_llama4_vision_to_framework = _item6("convert_hf_llama4_vision_to_framework",
                                               "vision tower")
convert_hf_llama4_multimodal = _item6("convert_hf_llama4_multimodal", "vision tower")

# decoder_block -> (HF->framework, framework->HF or None), the JAX package's table
_CONVERTERS = {
    "llama2": ("convert_hf_llama_to_framework", "convert_framework_to_hf_llama"),
    "llama3": ("convert_hf_llama_to_framework", "convert_framework_to_hf_llama"),
    "mistral": ("convert_hf_llama_to_framework", "convert_framework_to_hf_llama"),
    "qwen3": ("convert_hf_llama_to_framework", "convert_framework_to_hf_llama"),
    "gemma": ("convert_hf_gemma_to_framework", "convert_framework_to_hf_llama"),
    "gemma2": ("convert_hf_gemma2_to_framework", "convert_framework_to_hf_gemma2"),
    "gemma3": ("convert_hf_gemma3_to_framework", "convert_framework_to_hf_gemma3"),
    "mixtral": ("convert_hf_mixtral_to_framework", "convert_framework_to_hf_mixtral"),
    "deepseek": ("convert_hf_deepseek_to_framework", None),
    "gpt3": ("convert_hf_gpt2_to_framework", None),
    "gpt3_paxml": ("convert_paxml_gpt3_to_framework", None),
    "llama4": ("convert_hf_llama4_to_framework", None),
    "qwen3_moe": ("convert_hf_qwen3_moe_to_framework", None),
}
_ITEM6_BLOCKS = ("mixtral", "deepseek", "gpt3", "gpt3_paxml", "llama4", "qwen3_moe")


def get_converter(decoder_block: str, direction: str = "to_framework"):
    """Converter for a decoder_block family and direction ('to_framework' |
    'to_hf'). Unknown families raise ``ValueError``, item-6 families
    ``NotImplementedError``."""
    if decoder_block not in _CONVERTERS:
        raise ValueError(f"no converters for decoder_block={decoder_block}; "
                         f"supported: {sorted(_CONVERTERS)}")
    if decoder_block in _ITEM6_BLOCKS:
        _unsupported(f"the {decoder_block} checkpoint converters", _ITEM6)
    to_fw, to_hf = _CONVERTERS[decoder_block]
    name = to_fw if direction == "to_framework" else to_hf
    if name is None:
        raise ValueError(f"{decoder_block} has no {direction} converter yet")
    return globals()[name]


def hf_config_for(cfg: Config, hf_vocab_size: int | None = None):
    """A ``transformers`` config matching the exported weights (so the output
    directory loads with ``from_pretrained``); None for families without an
    HF counterpart. Needs ``transformers`` (imported here only)."""
    import transformers as tf

    v = hf_vocab_size or cfg.vocab_size
    common = dict(
        vocab_size=v,
        hidden_size=cfg.emb_dim,
        intermediate_size=cfg.mlp_dim,
        num_hidden_layers=cfg.num_decoder_layers,
        num_attention_heads=cfg.num_query_heads,
        num_key_value_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        max_position_embeddings=cfg.max_target_length,
        rope_theta=cfg.rope_max_timescale,
        tie_word_embeddings=bool(cfg.logits_via_embedding),
    )
    block = cfg.decoder_block
    if block in ("llama2", "llama3", "gemma"):
        return tf.LlamaConfig(**common)
    if block == "mistral":
        return tf.MistralConfig(**{k: v for k, v in common.items() if k != "head_dim"},
                                sliding_window=cfg.sliding_window_size or None)
    if block == "qwen3":
        return tf.Qwen3Config(**common)
    if block == "mixtral":
        return tf.MixtralConfig(**common, num_local_experts=cfg.num_experts,
                                num_experts_per_tok=cfg.num_experts_per_tok,
                                sliding_window=cfg.sliding_window_size or None)
    if block == "gemma2":
        return tf.Gemma2Config(
            **common, sliding_window=cfg.sliding_window_size or 4096,
            query_pre_attn_scalar=cfg.query_pre_attn_scalar or cfg.head_dim,
            attn_logit_softcapping=cfg.attn_logits_soft_cap or None,
            final_logit_softcapping=cfg.final_logits_soft_cap or None)
    if block == "gemma3":
        return tf.Gemma3TextConfig(
            **common, sliding_window=cfg.sliding_window_size or 1024,
            query_pre_attn_scalar=cfg.query_pre_attn_scalar or cfg.head_dim, rope_scaling=None)
    return None


def _read_hf_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The weights of an HF model directory, without ``transformers``, read as
    ``from_pretrained`` reads them: the ``*.safetensors`` files when there are
    any (``safetensors`` is imported only then), else the
    ``pytorch_model*.bin`` files (``torch.load``, weights only; memory-mapped
    only where the file is in the zip format, since a legacy file cannot be)."""
    import zipfile

    sd: dict[str, torch.Tensor] = {}
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if st_files:
        from safetensors.torch import load_file

        for f in st_files:
            sd.update(load_file(f))
        return sd
    for f in sorted(glob.glob(os.path.join(path, "pytorch_model*.bin"))):
        sd.update(torch.load(f, map_location="cpu", weights_only=True,
                             mmap=zipfile.is_zipfile(f)))
    if not sd:
        raise FileNotFoundError(f"no *.safetensors or pytorch_model*.bin weights under {path}")
    return sd


def main(argv=None):
    """CLI: HF checkpoint directory <-> params-only checkpoint, both ways.
    ``key=value`` arguments after the flags override the config of
    ``--model_name`` (a preset under configs/models, or none)."""
    import argparse

    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.train.checkpointing import (
        load_params_only, save_params_only,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--hf_path")
    ap.add_argument("--ckpt_path")
    ap.add_argument("--out_path", required=True)
    ap.add_argument("--model_name", default="")
    ap.add_argument("--direction", default="to_framework", choices=["to_framework", "to_hf"])
    ap.add_argument("--hf_vocab_size", type=int, default=None)
    ap.add_argument("overrides", nargs="*", help="config key=value overrides")
    args = ap.parse_args(argv)

    names = [f"model_name={args.model_name}"] if args.model_name else []
    cfg = load_config(names + list(args.overrides))
    conv = get_converter(cfg.decoder_block, args.direction)

    if args.direction == "to_framework":
        if not args.hf_path:
            raise SystemExit("--hf_path is required for to_framework")
        params = conv(_read_hf_state_dict(args.hf_path), cfg)
        save_params_only(args.out_path, params)
        print(f"converted {args.hf_path} -> {args.out_path} ({len(params)} tensors)")
    else:
        if not args.ckpt_path:
            raise SystemExit("--ckpt_path is required for to_hf")
        sd = conv(load_params_only(args.ckpt_path), cfg, hf_vocab_size=args.hf_vocab_size)
        os.makedirs(args.out_path, exist_ok=True)
        torch.save(sd, os.path.join(args.out_path, "pytorch_model.bin"))
        try:
            hf_cfg = hf_config_for(cfg, args.hf_vocab_size)
        except ImportError:  # transformers is optional: the weights alone are written
            hf_cfg = None
        if hf_cfg is not None:
            hf_cfg.save_pretrained(args.out_path)
        print(f"exported {args.ckpt_path} -> {args.out_path}/pytorch_model.bin ({len(sd)} "
              f"tensors{', +config.json' if hf_cfg is not None else ''})")


if __name__ == "__main__":
    main()
