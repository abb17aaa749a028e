"""Model-family registry: block styles + preset configs.

The reference implements each family as a separate layer module
(MaxText/layers/{llama2,gemma,gemma2,gemma3,gpt3,mistral,mixtral,qwen3,
deepseek,simple_layer}.py, registry at decoders.py:334 get_decoder_layers).
Here a family is a :class:`BlockStyle` — pure data consumed by the single
configurable DecoderLayer — plus a yaml preset under configs/models/.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BlockStyle:
    # one entry per sub-layer in the scan unit; values: "global",
    # "local_sliding", "chunk"
    attention_pattern: tuple[str, ...] = ("global",)
    use_pre_norm: bool = True
    use_post_attn_norm: bool = False
    use_post_ffw_norm: bool = False
    rmsnorm_scale_plus_one: bool = False  # gemma convention: param stores scale-1
    scale_embedding: bool = False  # gemma: multiply embedding by sqrt(d)
    use_qk_norm: bool = False
    qk_norm_type: str = "rms"  # rms | l2 (llama4 post-rope, param-free)
    rope_interleave: bool = False  # llama4: complex-pair rope (HF apply_rotary_emb)
    attn_temperature_tuning: bool = False  # llama4 NoPE layers
    moe_sublayers: tuple[int, ...] | None = None  # which sublayers are MoE (None = all)
    query_pre_attn_scalar: float | None = None
    use_attn_bias: bool = False
    use_layer_norm: bool = False  # gpt3: mean-centered norm with bias
    use_mlp_bias: bool = False
    use_mla: bool = False  # DeepSeek multi-head latent attention


BLOCK_STYLES: dict[str, BlockStyle] = {
    "simple": BlockStyle(),
    "llama2": BlockStyle(),
    "llama3": BlockStyle(),
    "mistral": BlockStyle(attention_pattern=("local_sliding",)),
    "mixtral": BlockStyle(),
    "qwen3": BlockStyle(use_qk_norm=True),
    "gpt3": BlockStyle(use_attn_bias=True, use_mlp_bias=True, use_layer_norm=True),
    "gemma": BlockStyle(rmsnorm_scale_plus_one=True, scale_embedding=True),
    "gemma2": BlockStyle(
        attention_pattern=("local_sliding", "global"),
        use_post_attn_norm=True,
        use_post_ffw_norm=True,
        rmsnorm_scale_plus_one=True,
        scale_embedding=True,
        query_pre_attn_scalar=None,
    ),
    "gemma3": BlockStyle(
        attention_pattern=("local_sliding",) * 5 + ("global",),
        use_post_attn_norm=True,
        use_post_ffw_norm=True,
        rmsnorm_scale_plus_one=True,
        scale_embedding=True,
        use_qk_norm=True,
    ),
    "deepseek": BlockStyle(use_mla=True),
    # llama4: chunked-causal rope layers + every-4th NoPE global layer with
    # temperature-tuned q; L2 qk-norm; MoE interleave set per model preset
    # (scout: all layers, maverick: moe_sublayers=(1, 3)).
    "llama4": BlockStyle(
        attention_pattern=("chunk", "chunk", "chunk", "global_nope"),
        use_qk_norm=True,
        qk_norm_type="l2",
        attn_temperature_tuning=True,
        rope_interleave=True,
    ),
    "tts": BlockStyle(use_qk_norm=True),  # flagship audio-LM decoder style
}


def get_block_style(name: str) -> BlockStyle:
    if name not in BLOCK_STYLES:
        raise ValueError(
            f"unknown decoder_block {name!r}; known: {sorted(BLOCK_STYLES)}"
        )
    return BLOCK_STYLES[name]

# Config defaults implied by a decoder family (applied by load_config when the
# user did not set the key explicitly; reference: MaxText/configs/models/*.yml
# pin these per model, but a bare decoder_block=gemma* must not silently fall
# back to silu MLPs / untied unembedding).
FAMILY_CONFIG_DEFAULTS: dict[str, dict[str, object]] = {
    "gemma": {
        "mlp_activations": ("gelu", "linear"),
        "logits_via_embedding": True,
        "normalize_embedding_logits": False,
    },
    "gemma2": {
        "mlp_activations": ("gelu", "linear"),
        "logits_via_embedding": True,
        "normalize_embedding_logits": False,
        "attn_logits_soft_cap": 50.0,
        "final_logits_soft_cap": 30.0,
    },
    "gemma3": {
        "mlp_activations": ("gelu", "linear"),
        "logits_via_embedding": True,
        "normalize_embedding_logits": False,
    },
    "llama4": {
        "routed_score_func": "sigmoid",
        "normalize_topk_weights": False,
        "moe_weight_on_input": True,
        "shared_experts": 1,
    },
    "gpt3": {
        "mlp_activations": ("gelu",),
        "logits_via_embedding": True,
        "normalize_embedding_logits": False,
        "use_positional_embedding": True,
        "rope_type": "none",
    },
}
