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

The other families have the JAX package's converters: mixtral (both
directions), deepseek (MLA, dense layers), qwen3_moe, gpt2 and paxml gpt3
(LayerNorm biases, learned positions), the llama4 text model (units of 4
sub-layers, experts and a shared expert), and the vision towers: SigLIP
(gemma3) and Llama 4's, alone or split out of the multimodal checkpoints
with their projectors (state dicts of ``models/vision.py``'s modules).

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


def _stack_experts(get, fmt: str, layer: int, n_exp: int, transform) -> torch.Tensor:
    """``[E, in, out]``: expert ``e``'s HF weight ``fmt.format(layer, e)``, transformed."""
    return torch.stack([transform(get(fmt.format(layer, e))) for e in range(n_exp)])


def _attention(get, h: str, a: str, cfg: Config) -> dict[str, torch.Tensor]:
    """The llama layout's q / k / v / o projections of HF layer prefix ``h``."""
    E, nq, nkv, hd = _dims(cfg)
    return {
        a + "query.kernel": _c(get(h + "self_attn.q_proj.weight").T.reshape(E, nq, hd)),
        a + "key.kernel": _c(get(h + "self_attn.k_proj.weight").T.reshape(E, nkv, hd)),
        a + "value.kernel": _c(get(h + "self_attn.v_proj.weight").T.reshape(E, nkv, hd)),
        a + "out.kernel": _c(get(h + "self_attn.o_proj.weight").T.reshape(nq, hd, E)),
    }


def _lm_head(state_dict: dict, cfg: Config) -> torch.Tensor:
    return _c(_pad_vocab(_t(state_dict["lm_head.weight"]), cfg.vocab_size).T)


def convert_hf_mixtral_to_framework(state_dict: dict, cfg: Config) -> dict[str, torch.Tensor]:
    """HF Mixtral -> this package's state dict: llama attention, per-layer
    stacked experts (w1 -> ``wi_0`` gate, w3 -> ``wi_1`` up, w2 -> ``wo``) and
    the router as ``moe_0.gate``."""
    sd = state_dict

    def get(name):
        return _t(sd[name])

    out = {"token_embedder.embedding": _pad_vocab(get("model.embed_tokens.weight"),
                                                  cfg.vocab_size)}
    fmt = "model.layers.{}.block_sparse_moe.experts.{}.%s.weight"
    for i in range(cfg.num_decoder_layers):
        h, pre = f"model.layers.{i}.", f"decoder.layers_{i}."
        out.update(_attention(get, h, pre + "self_attention_0.", cfg))
        m = pre + "moe_0."
        out[m + "gate.kernel"] = _c(get(h + "block_sparse_moe.gate.weight").T)
        for name, hf in (("wi_0", "w1"), ("wi_1", "w3"), ("wo", "w2")):
            out[m + name] = _stack_experts(get, fmt % hf, i, cfg.num_experts, lambda w: w.T)
        out[pre + "pre_self_attention_norm_0.scale"] = get(h + "input_layernorm.weight")
        out[pre + "pre_mlp_norm_0.scale"] = get(h + "post_attention_layernorm.weight")
    out["decoder_norm.scale"] = get("model.norm.weight")
    out["logits_dense.kernel"] = _lm_head(sd, cfg)
    return out


def convert_framework_to_hf_mixtral(params: dict, cfg: Config,
                                    hf_vocab_size: int | None = None) -> dict[str, torch.Tensor]:
    """Inverse of :func:`convert_hf_mixtral_to_framework` (dtypes kept).
    ``hf_vocab_size`` trims rows the import padded."""
    E, nq, nkv, hd = _dims(cfg)
    v = hf_vocab_size or cfg.vocab_size

    def g(name):
        return params[name].detach().cpu()

    sd = {"model.embed_tokens.weight": _c(g("token_embedder.embedding")[:v]),
          "model.norm.weight": g("decoder_norm.scale"),
          "lm_head.weight": _c(g("logits_dense.kernel").T[:v])}
    for i in range(cfg.num_decoder_layers):
        h, pre = f"model.layers.{i}.", f"decoder.layers_{i}."
        a, m = pre + "self_attention_0.", pre + "moe_0."
        sd[h + "self_attn.q_proj.weight"] = _c(g(a + "query.kernel").reshape(E, nq * hd).T)
        sd[h + "self_attn.k_proj.weight"] = _c(g(a + "key.kernel").reshape(E, nkv * hd).T)
        sd[h + "self_attn.v_proj.weight"] = _c(g(a + "value.kernel").reshape(E, nkv * hd).T)
        sd[h + "self_attn.o_proj.weight"] = _c(g(a + "out.kernel").reshape(nq * hd, E).T)
        sd[h + "block_sparse_moe.gate.weight"] = _c(g(m + "gate.kernel").T)
        for e in range(cfg.num_experts):
            ep = f"{h}block_sparse_moe.experts.{e}."
            sd[ep + "w1.weight"] = _c(g(m + "wi_0")[e].T)
            sd[ep + "w3.weight"] = _c(g(m + "wi_1")[e].T)
            sd[ep + "w2.weight"] = _c(g(m + "wo")[e].T)
        sd[h + "input_layernorm.weight"] = g(pre + "pre_self_attention_norm_0.scale")
        sd[h + "post_attention_layernorm.weight"] = g(pre + "pre_mlp_norm_0.scale")
    return sd


def convert_hf_deepseek_to_framework(state_dict: dict, cfg: Config) -> dict[str, torch.Tensor]:
    """HF DeepseekV2 / V3 (dense layers) -> this package's MLA state dict:
    q_a / q_b (or q_proj), kv_a_proj_with_mqa, kv_b_proj and o_proj onto
    ``wq_a`` / ``wq_b`` (``wq``), ``wkv_a``, ``wkv_b`` and ``out``; every
    layer's MLP dense, in the ``layers`` region (the JAX package's converter
    has no expert layers either)."""
    sd = state_dict
    n = cfg.num_query_heads
    d_qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    d_kv_out = cfg.qk_nope_head_dim + cfg.v_head_dim

    def get(name):
        return _t(sd[name])

    out = {"token_embedder.embedding": _pad_vocab(get("model.embed_tokens.weight"),
                                                  cfg.vocab_size)}
    for i in range(cfg.num_decoder_layers):
        h, pre = f"model.layers.{i}.", f"decoder.layers_{i}."
        a = pre + "self_attention_0."
        out[a + "wkv_a.kernel"] = _c(get(h + "self_attn.kv_a_proj_with_mqa.weight").T)
        out[a + "kv_norm.scale"] = get(h + "self_attn.kv_a_layernorm.weight")
        out[a + "wkv_b.kernel"] = _c(get(h + "self_attn.kv_b_proj.weight").T.reshape(
            cfg.kv_lora_rank, n, d_kv_out))
        out[a + "out.kernel"] = _c(get(h + "self_attn.o_proj.weight").T.reshape(
            n, cfg.v_head_dim, -1))
        if cfg.q_lora_rank > 0:
            out[a + "wq_a.kernel"] = _c(get(h + "self_attn.q_a_proj.weight").T)
            out[a + "q_norm.scale"] = get(h + "self_attn.q_a_layernorm.weight")
            out[a + "wq_b.kernel"] = _c(get(h + "self_attn.q_b_proj.weight").T.reshape(
                cfg.q_lora_rank, n, d_qk))
        else:
            out[a + "wq.kernel"] = _c(get(h + "self_attn.q_proj.weight").T.reshape(-1, n, d_qk))
        m = pre + "mlp_0."
        out[m + "wi_0.kernel"] = _c(get(h + "mlp.gate_proj.weight").T)
        out[m + "wi_1.kernel"] = _c(get(h + "mlp.up_proj.weight").T)
        out[m + "wo.kernel"] = _c(get(h + "mlp.down_proj.weight").T)
        out[pre + "pre_self_attention_norm_0.scale"] = get(h + "input_layernorm.weight")
        out[pre + "pre_mlp_norm_0.scale"] = get(h + "post_attention_layernorm.weight")
    out["decoder_norm.scale"] = get("model.norm.weight")
    out["logits_dense.kernel"] = _lm_head(sd, cfg)
    return out


def convert_hf_qwen3_moe_to_framework(state_dict: dict,
                                      cfg: Config) -> dict[str, torch.Tensor]:
    """HF Qwen3MoeForCausalLM -> this package's state dict: the qwen3 block
    (q / k norms) through the llama mapping, every layer's MLP a
    ``RoutedMoE`` (per-expert Linear weights stacked ``[E, in, out]``, the
    gate as the router's kernel)."""
    sd = state_dict

    def get(name):
        return _t(sd[name])

    dense_keys = {k: v for k, v in sd.items() if ".mlp." not in k}
    out = convert_hf_llama_to_framework(dense_keys, cfg)
    fmt = "model.layers.{}.mlp.experts.{}.%s.weight"
    for i in range(cfg.num_decoder_layers):
        m = f"decoder.layers_{i}.moe_0."
        out[m + "gate.kernel"] = _c(get(f"model.layers.{i}.mlp.gate.weight").T)
        for name, hf in (("wi_0", "gate_proj"), ("wi_1", "up_proj"), ("wo", "down_proj")):
            out[m + name] = _stack_experts(get, fmt % hf, i, cfg.num_experts, lambda w: w.T)
    return out


def convert_hf_gpt2_to_framework(state_dict: dict, cfg: Config) -> dict[str, torch.Tensor]:
    """HF GPT-2 -> this package's gpt3-family state dict: LayerNorms with
    bias, the fused qkv Conv1D split, attention and MLP biases, learned
    positions, tied unembedding (HF's Conv1D stores ``[in, out]``: no
    transpose)."""
    sd = state_dict
    E, nq, nkv, hd = _dims(cfg)

    def get(name):
        return _t(sd[name])

    out = {"token_embedder.embedding": _pad_vocab(get("transformer.wte.weight"), cfg.vocab_size),
           "position_embedder.embedding": _pad_vocab(get("transformer.wpe.weight"),
                                                     cfg.max_target_length)}
    for i in range(cfg.num_decoder_layers):
        h, pre = f"transformer.h.{i}.", f"decoder.layers_{i}."
        a = pre + "self_attention_0."
        w, b = get(h + "attn.c_attn.weight"), get(h + "attn.c_attn.bias")
        for part, name in enumerate(("query", "key", "value")):
            heads = nq if part == 0 else nkv
            out[a + name + ".kernel"] = _c(w[:, part * E:(part + 1) * E].reshape(E, heads, hd))
            out[a + name + ".bias"] = _c(b[part * E:(part + 1) * E].reshape(heads, hd))
        out[a + "out.kernel"] = _c(get(h + "attn.c_proj.weight").reshape(nq, hd, E))
        out[a + "out.bias"] = get(h + "attn.c_proj.bias")
        out[pre + "mlp_0.wi.kernel"] = get(h + "mlp.c_fc.weight")
        out[pre + "mlp_0.wi.bias"] = get(h + "mlp.c_fc.bias")
        out[pre + "mlp_0.wo.kernel"] = get(h + "mlp.c_proj.weight")
        out[pre + "mlp_0.wo.bias"] = get(h + "mlp.c_proj.bias")
        for norm, hf in (("pre_self_attention_norm_0", "ln_1"), ("pre_mlp_norm_0", "ln_2")):
            out[f"{pre}{norm}.scale"] = get(f"{h}{hf}.weight")
            out[f"{pre}{norm}.bias"] = get(f"{h}{hf}.bias")
    out["decoder_norm.scale"] = get("transformer.ln_f.weight")
    out["decoder_norm.bias"] = get("transformer.ln_f.bias")
    return out


def convert_paxml_gpt3_to_framework(get, cfg: Config) -> dict[str, torch.Tensor]:
    """paxml-format GPT-3 (the MLPerf reference checkpoint) -> this package's
    gpt3-family state dict. ``get(name)`` returns the paxml variable of a
    dotted name such as
    ``.params.lm.transformer.repeat.sub.x_layers_0.self_attention.combined_qkv.w``
    (a tensorstore reader, :func:`load_paxml_gpt3_checkpoint`, or a dict):
    every layer variable carries a leading layer axis, ``combined_qkv.w``
    ``[L, 3, E, nq, hd]``, ``post.w`` ``[L, E, nq, hd]`` (-> ``out`` ``[nq, hd,
    E]``), the tied ``softmax.logits_ffn.linear.w`` ``[E, V]``."""
    E, nq, hd = cfg.emb_dim, cfg.num_query_heads, cfg.head_dim
    P = ".params.lm"
    X = P + ".transformer.repeat.sub.x_layers_0"

    def g(name):
        return _t(np.asarray(get(name)))

    w, b = g(f"{X}.self_attention.combined_qkv.w"), g(f"{X}.self_attention.combined_qkv.b")
    out_w = g(f"{X}.self_attention.post.w")
    per_layer = {
        "self_attention_0.out.bias": g(f"{X}.self_attention.post.b"),
        "mlp_0.wi.kernel": g(f"{X}.ff_layer.ffn_layer1.linear.w"),
        "mlp_0.wi.bias": g(f"{X}.ff_layer.ffn_layer1.bias.b"),
        "mlp_0.wo.kernel": g(f"{X}.ff_layer.ffn_layer2.linear.w"),
        "mlp_0.wo.bias": g(f"{X}.ff_layer.ffn_layer2.bias.b"),
        "pre_self_attention_norm_0.scale": g(f"{X}.layer_norm.scale"),
        "pre_self_attention_norm_0.bias": g(f"{X}.layer_norm.bias"),
        "pre_mlp_norm_0.scale": g(f"{X}.ff_layer.layer_norm.scale"),
        "pre_mlp_norm_0.bias": g(f"{X}.ff_layer.layer_norm.bias"),
    }
    out = {"token_embedder.embedding": _pad_vocab(
               _c(g(f"{P}.softmax.logits_ffn.linear.w").T), cfg.vocab_size),
           "position_embedder.embedding": _pad_vocab(g(f"{P}.position_emb.emb_var"),
                                                     cfg.max_target_length)}
    for i in range(w.shape[0]):
        pre = f"decoder.layers_{i}."
        for part, name in enumerate(("query", "key", "value")):
            out[f"{pre}self_attention_0.{name}.kernel"] = _c(w[i, part].reshape(E, nq, hd))
            out[f"{pre}self_attention_0.{name}.bias"] = _c(b[i, part].reshape(nq, hd))
        out[f"{pre}self_attention_0.out.kernel"] = _c(torch.movedim(out_w[i], 0, -1))
        out.update({pre + k: _c(v[i]) for k, v in per_layer.items()})
    out["decoder_norm.scale"] = g(f"{P}.final_ln.scale")
    out["decoder_norm.bias"] = g(f"{P}.final_ln.bias")
    return out


def load_paxml_gpt3_checkpoint(path: str, cfg: Config) -> dict[str, torch.Tensor]:
    """Read a paxml GPT-3 checkpoint (its ``state`` directory: each variable a
    zarr tensorstore in a directory named ``mdl_vars<dotted name>``, local or
    ``gs://``) and convert it. Needs ``tensorstore`` (imported here only)."""
    import tensorstore as ts

    def get(name):
        full = f"mdl_vars{name}"
        if path.startswith("gs://"):
            bucket, prefix = path[len("gs://"):].split("/", 1)
            kv = {"driver": "gcs", "bucket": bucket, "path": os.path.join(prefix, full)}
        else:
            kv = {"driver": "file", "path": os.path.join(path, full)}
        spec = {"driver": "zarr", "metadata_key": ".zarray", "kvstore": kv}
        return ts.open(ts.Spec(spec), open=True).result().read().result()

    return convert_paxml_gpt3_to_framework(get, cfg)


def convert_hf_llama4_to_framework(state_dict: dict, cfg: Config) -> dict[str, torch.Tensor]:
    """HF Llama4 text model -> this package's llama4-family state dict: units
    of 4 sub-layers (HF layer ``4 u + sub``), each MLP a ``RoutedMoE``: the
    router as its gate, the fused experts ``gate_up_proj`` ``[E, H, 2M]``
    split into ``wi_0`` / ``wi_1``, ``down_proj`` as ``wo``, and the shared
    expert's gated MLP."""
    sd = state_dict
    m = cfg.moe_mlp_dim
    group = 4

    def get(name):
        return _t(sd[name])

    out = {"token_embedder.embedding": _pad_vocab(get("model.embed_tokens.weight"),
                                                  cfg.vocab_size)}
    for u in range(cfg.num_decoder_layers // group):
        pre = f"decoder.layers_{u}."
        for sub in range(group):
            h = f"model.layers.{group * u + sub}."
            out.update(_attention(get, h, f"{pre}self_attention_{sub}.", cfg))
            moe = f"{pre}moe_{sub}."
            ff = h + "feed_forward."
            gate_up = get(ff + "experts.gate_up_proj")
            out[moe + "gate.kernel"] = _c(get(ff + "router.weight").T)
            out[moe + "wi_0"] = _c(gate_up[:, :, :m])
            out[moe + "wi_1"] = _c(gate_up[:, :, m:])
            out[moe + "wo"] = get(ff + "experts.down_proj")
            for name, hf in (("wi_0", "gate_proj"), ("wi_1", "up_proj"), ("wo", "down_proj")):
                out[f"{moe}shared_experts.{name}.kernel"] = _c(
                    get(f"{ff}shared_expert.{hf}.weight").T)
            out[f"{pre}pre_self_attention_norm_{sub}.scale"] = get(h + "input_layernorm.weight")
            out[f"{pre}pre_mlp_norm_{sub}.scale"] = get(h + "post_attention_layernorm.weight")
    out["decoder_norm.scale"] = get("model.norm.weight")
    if not cfg.logits_via_embedding:
        out["logits_dense.kernel"] = _lm_head(sd, cfg)
    return out


def convert_hf_siglip_to_framework(state_dict: dict, num_layers: int) -> dict[str, torch.Tensor]:
    """HF ``SiglipVisionModel`` state dict -> ``models/vision.VisionEncoder``
    state dict (the gemma3 vision tower): the q / k / v projections fused into
    ``qkv``, kernels ``[in, out]``, the patch convolution ``[P, P, 3, E]``."""
    sd = {k.removeprefix("vision_model."): v for k, v in state_dict.items()}

    def get(name):
        return _t(sd[name])

    out = {
        # Conv2d [E, 3, P, P] -> flax's Conv [P, P, 3, E]
        "patch_embed.kernel": _c(get("embeddings.patch_embedding.weight").permute(2, 3, 1, 0)),
        "patch_embed.bias": get("embeddings.patch_embedding.bias"),
        "pos_embedding": get("embeddings.position_embedding.weight")[None],
        "final_ln.scale": get("post_layernorm.weight"),
        "final_ln.bias": get("post_layernorm.bias"),
    }
    for i in range(num_layers):
        pre, b = f"encoder.layers.{i}", f"block_{i}"
        out[f"{b}.qkv.kernel"] = _c(torch.cat(
            [get(f"{pre}.self_attn.{n}_proj.weight").T for n in ("q", "k", "v")], dim=1))
        out[f"{b}.qkv.bias"] = torch.cat(
            [get(f"{pre}.self_attn.{n}_proj.bias") for n in ("q", "k", "v")])
        for ours, theirs in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
            out[f"{b}.{ours}.scale"] = get(f"{pre}.{theirs}.weight")
            out[f"{b}.{ours}.bias"] = get(f"{pre}.{theirs}.bias")
        for ours, theirs in (("proj", "self_attn.out_proj"), ("fc1", "mlp.fc1"),
                             ("fc2", "mlp.fc2")):
            out[f"{b}.{ours}.kernel"] = _c(get(f"{pre}.{theirs}.weight").T)
            out[f"{b}.{ours}.bias"] = get(f"{pre}.{theirs}.bias")
    return out


def convert_hf_gemma3_multimodal(state_dict: dict, cfg: Config, vision_num_layers: int):
    """HF ``Gemma3ForConditionalGeneration`` -> (text, vision, projector)
    state dicts: the gemma3 text converter, the SigLIP tower converter and
    ``models/vision.Gemma3MultiModalProjector``'s weights."""
    text_sd = {"model." + k.removeprefix("model.language_model."): v
               for k, v in state_dict.items() if k.startswith("model.language_model.")}
    if "lm_head.weight" in state_dict:
        text_sd["lm_head.weight"] = state_dict["lm_head.weight"]
    vision_sd = {k.removeprefix("model.vision_tower.vision_model."): v
                 for k, v in state_dict.items() if k.startswith("model.vision_tower.")}
    text = convert_hf_gemma3_to_framework(text_sd, cfg)
    vision = convert_hf_siglip_to_framework(vision_sd, vision_num_layers)
    projector = {
        "mm_soft_emb_norm.scale": _t(
            state_dict["model.multi_modal_projector.mm_soft_emb_norm.weight"]),
        "mm_input_projection": _t(
            state_dict["model.multi_modal_projector.mm_input_projection_weight"]),
    }
    return text, vision, projector


def convert_hf_llama4_vision_to_framework(state_dict: dict,
                                          num_layers: int) -> dict[str, torch.Tensor]:
    """HF ``Llama4VisionModel`` -> ``models/vision.Llama4VisionEncoder`` state
    dict (unfold linear, end-appended CLS, 2D rope blocks, pixel-shuffle
    adapter)."""
    sd = {k.removeprefix("vision_model."): v for k, v in state_dict.items()}

    def get(name):
        return _t(sd[name])

    out = {
        "patch_embed.kernel": _c(get("patch_embedding.linear.weight").T),
        "class_embedding": get("class_embedding"),
        "positional_embedding_vlm": get("positional_embedding_vlm"),
        "adapter_fc1.kernel": _c(get("vision_adapter.mlp.fc1.weight").T),
        "adapter_fc2.kernel": _c(get("vision_adapter.mlp.fc2.weight").T),
    }
    for name in ("layernorm_pre", "layernorm_post"):
        out[f"{name}.scale"] = get(f"{name}.weight")
        out[f"{name}.bias"] = get(f"{name}.bias")
    for i in range(num_layers):
        pre = f"model.layers.{i}"
        for ours, theirs in (("ln1", "input_layernorm"), ("ln2", "post_attention_layernorm")):
            out[f"{ours}_{i}.scale"] = get(f"{pre}.{theirs}.weight")
            out[f"{ours}_{i}.bias"] = get(f"{pre}.{theirs}.bias")
        for ours, theirs in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                             ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj"),
                             ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            out[f"{ours}_{i}.kernel"] = _c(get(f"{pre}.{theirs}.weight").T)
            out[f"{ours}_{i}.bias"] = get(f"{pre}.{theirs}.bias")
    return out


def convert_hf_llama4_multimodal(state_dict: dict, cfg: Config, vision_num_layers: int):
    """HF ``Llama4ForConditionalGeneration`` -> (text, vision, projector)
    state dicts; the projector is one kernel ``[vision_output_dim, emb]``."""
    text_sd = {k.removeprefix("language_model."): v for k, v in state_dict.items()
               if k.startswith("language_model.")}
    vision_sd = {k.removeprefix("vision_model."): v for k, v in state_dict.items()
                 if k.startswith("vision_model.")}
    text = convert_hf_llama4_to_framework(text_sd, cfg)
    vision = convert_hf_llama4_vision_to_framework(vision_sd, vision_num_layers)
    projector = {"kernel": _c(_t(state_dict["multi_modal_projector.linear_1.weight"]).T)}
    return text, vision, projector


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


def get_converter(decoder_block: str, direction: str = "to_framework"):
    """Converter for a decoder_block family and direction ('to_framework' |
    'to_hf'). An unknown family, or a direction the family has no converter
    for, raises ``ValueError``."""
    if decoder_block not in _CONVERTERS:
        raise ValueError(f"no converters for decoder_block={decoder_block}; "
                         f"supported: {sorted(_CONVERTERS)}")
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
