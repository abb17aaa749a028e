"""Typed configuration for the PyTorch/CUDA package.

One dataclass holds every knob with a default; a yaml file and ``key=value``
overrides are merged on top, ``MTT_<KEY>`` environment variables override
fields, and :func:`finalize` validates and computes the derived quantities.
The field set equals the JAX package's so that any of its yaml presets
loads here; a model that needs a feature this package has not ported raises
``NotImplementedError`` when it is built, not when its config is read.

``num_devices`` is the world of ``torch.distributed`` (one rank a device;
1 without a process group), and the ICI degrees fill it as in the JAX package
(``parallel/mesh.py`` lays the ranks out).
The yaml files are flat ``key: value`` scalars plus ``base_config:`` and are
read by a few lines of this module's own (no PyYAML dependency).

Usage::

    cfg = load_config(["configs/models/tts-1b.yml", "decode_attention=ragged"])
"""

from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass, field
from typing import Any

MESH_AXES = (
    "data",
    "stage",
    "fsdp",
    "fsdp_transpose",
    "sequence",
    "context",
    "context_autoregressive",
    "tensor",
    "tensor_transpose",
    "tensor_sequence",
    "expert",
    "autoregressive",
)


@dataclass
class Config:
    # ---------------------------------------------------------------- run
    run_name: str = "mtt-run"
    base_output_directory: str = "/tmp/mtt"
    log_period: int = 100
    model_name: str = "default"
    seed: int = 0

    # ---------------------------------------------------------------- model
    decoder_block: str = "llama2"  # registry key, models/registry.py
    base_emb_dim: int = 2048
    base_num_query_heads: int = 16
    base_num_kv_heads: int = 16
    base_mlp_dim: int = 7168
    base_num_decoder_layers: int = 16
    head_dim: int = 128
    mlp_activations: tuple[str, ...] = ("silu", "linear")
    global_parameter_scale: int = 1
    vocab_size: int = 32_000
    logits_via_embedding: bool = False
    fused_vocab_ce_chunk: int = 0
    fused_vocab_ce_tile: int = 0
    fused_ce_int8: bool = False
    fused_ce_logits_dtype: str = ""
    normalize_embedding_logits: bool = True
    logits_dot_in_fp32: bool = False
    cast_logits_to_fp32: bool = True
    float32_qk_product: bool = False
    float32_logits: bool = False
    normalization_layer_epsilon: float = 1e-6
    use_post_attn_norm: bool = False  # gemma2/3 style sandwich norms
    use_post_ffw_norm: bool = False
    use_pre_norm: bool = True
    final_logits_soft_cap: float = 0.0
    attn_logits_soft_cap: float = 0.0
    sliding_window_size: int = 0  # 0 = global attention
    chunk_attn_window_size: int = 0  # chunked causal attention (0 = off)
    attention_type: str = "global"  # global | local_sliding | chunk
    query_pre_attn_scalar: float = 0.0  # gemma: replace 1/sqrt(d); 0 = off
    attention: str = "autoselected"  # autoselected | dot_product | flash | ragged
    decode_attention: str = "dot_product"  # dot_product | bucketed (lax.switch KV-prefix) | ragged (pallas)
    spec_num_draft_tokens: int = 0  # K drafts per round; 0 = off
    spec_draft_parameters_path: str = ""  # draft model params-only checkpoint
    serve_params_dtype: str = ""
    serve_unroll_layers: bool = True
    flash_block_sizes: tuple[int, ...] = (512, 512)  # (block_q, block_kv)
    dropout_rate: float = 0.0
    gradient_clipping_threshold: float = 1.0

    rope_type: str = "default"  # default | llama3.1 | yarn | none
    use_positional_embedding: bool = False  # gpt3-style learned positions
    image_token_id: int = -1  # multimodal: placeholder id replaced by vision tokens
    rope_max_timescale: float = 10_000.0
    rope_factor: float = 8.0  # llama3.1 scaling
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192

    dtype: str = "bfloat16"  # activations
    weight_dtype: str = "float32"  # params
    matmul_precision: str = "default"
    quantization: str = ""  # "" | int8 | fp8 | int8w | int8w_serve
    checkpoint_is_quantized: bool = False  # load_parameters_path already int8w_serve
    quantize_kvcache: bool = False
    kv_quant_dtype: str = "int8"

    num_experts: int = 1
    num_experts_per_tok: int = 1
    moe_mlp_dim: int = 0  # 0 -> use base_mlp_dim
    shared_experts: int = 0
    sparse_matmul: bool = True  # grouped matmul (megablox-style) vs dense einsum
    load_balance_loss_weight: float = 0.01
    router_z_loss_weight: float = 0.0
    routed_scaling_factor: float = 1.0
    routed_score_func: str = "softmax"  # softmax | sigmoid
    normalize_topk_weights: bool = False  # mixtral/deepseek: renormalize selected weights
    moe_weight_on_input: bool = False  # llama4: scale expert INPUT by routing weight
    moe_sublayer_pattern: tuple[int, ...] = ()  # llama4 maverick: which sublayers are MoE
    attn_temperature_scale: float = 0.1  # llama4 attn_scale (NoPE layers)
    attn_temperature_floor_scale: float = 8192.0  # llama4 floor_scale
    routed_bias: bool = False
    n_routing_groups: int = -1
    topk_routing_group: int = -1
    moe_capacity_factor: float = -1.0  # <0 = dropless
    first_num_dense_layers: int = 0  # deepseek-style leading dense layers

    q_lora_rank: int = 0
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_only_training: bool = True  # freeze base weights when lora_rank > 0

    mtp_num_layers: int = 0
    mtp_loss_scaling_factor: float = 0.1

    # ---------------------------------------------------------------- parallelism
    mesh_axes: tuple[str, ...] = MESH_AXES
    ici_data_parallelism: int = 1
    ici_stage_parallelism: int = 1
    ici_fsdp_parallelism: int = -1  # -1 = fill remaining devices
    ici_fsdp_transpose_parallelism: int = 1
    ici_sequence_parallelism: int = 1
    ici_context_parallelism: int = 1
    ici_context_autoregressive_parallelism: int = 1
    ici_tensor_parallelism: int = 1
    ici_tensor_transpose_parallelism: int = 1
    ici_tensor_sequence_parallelism: int = 1
    ici_expert_parallelism: int = 1
    ici_autoregressive_parallelism: int = 1
    dcn_data_parallelism: int = -1
    dcn_stage_parallelism: int = 1
    dcn_fsdp_parallelism: int = 1
    dcn_fsdp_transpose_parallelism: int = 1
    dcn_sequence_parallelism: int = 1
    dcn_context_parallelism: int = 1
    dcn_context_autoregressive_parallelism: int = 1
    dcn_tensor_parallelism: int = 1
    dcn_tensor_transpose_parallelism: int = 1
    dcn_tensor_sequence_parallelism: int = 1
    dcn_expert_parallelism: int = 1
    dcn_autoregressive_parallelism: int = 1
    num_slices: int = 1
    enable_single_controller: bool = False
    compile_topology: str = ""
    compile_topology_num_slices: int = 1
    context_parallel_load_balance: bool = True
    context_parallel_algorithm: str = "allgather"
    expert_shard_attention_option: str = "fsdp"  # how EP axis acts in attention
    allow_split_physical_axes: bool = False
    sharding_tolerance: float = 0.02

    num_pipeline_microbatches: int = -1
    num_pipeline_repeats: int = -1
    pipeline_delay_activation_forwarding: bool = False
    pipeline_fsdp_ag_once: bool = False
    scan_pipeline_iterations: bool = True

    # ---------------------------------------------------------------- training
    steps: int = 150
    per_device_batch_size: float = 1.0
    eval_per_device_batch_size: float = 0.0
    eval_interval: int = -1
    eval_steps: int = -1
    max_target_length: int = 2048
    gradient_accumulation_steps: int = 1
    learning_rate: float = 3e-5
    cosine_learning_rate_final_fraction: float = 0.1
    warmup_steps_fraction: float = 0.1
    learning_rate_schedule_steps: int = -1
    z_loss_weight: float = 0.0
    opt_type: str = "adamw"  # adamw | adam_pax | sgd
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    adam_eps_root: float = 0.0  # adam_pax: eps INSIDE the sqrt
    adam_weight_decay: float = 0.1
    scan_layers: bool = True
    param_scan_axis: int = 1
    remat_policy: str = "full"
    zero1_fsdp_ag_once: bool = False
    data_shuffle_seed: int = 0
    init_weights_seed: int = 0
    enable_dropout: bool = False
    enable_data_shuffling: bool = True
    use_iota_embed: bool = True
    record_internal_nn_metrics: int = 0
    target_eval_loss: float = 0.0

    # ---------------------------------------------------------------- checkpointing
    enable_checkpointing: bool = False
    async_checkpointing: bool = True
    checkpoint_period: int = 10_000
    checkpoint_dir: str = ""  # derived: base_output_directory/run_name/checkpoints
    load_parameters_path: str = ""
    load_full_state_path: str = ""
    checkpoint_max_to_keep: int = 5
    save_final_checkpoint: bool = True
    enable_emergency_checkpoint: bool = False
    local_checkpoint_directory: str = ""  # fast local-disk tier
    local_checkpoint_period: int = 0  # 0 -> checkpoint_period // 10 (min 1)

    # ---------------------------------------------------------------- data
    dataset_type: str = "synthetic"  # synthetic | hf | grain | tfds | c4_mlperf | emilia_audio
    dataset_path: str = ""
    dataset_split: str = "train"
    eval_split: str = ""  # hf eval iterator split ("" = no eval data)
    train_data_columns: tuple = ("text", "content")
    eval_data_columns: tuple = ("text", "content")
    grain_file_type: str = "auto"  # auto | arrayrecord | parquet | jsonl
    colocated_python_data_input: bool = False
    eos_id: int = 2  # loss-mask sentinel for c4_mlperf rows (byte tokenizer eos)
    tokenizer_type: str = "none"  # none | sentencepiece | huggingface | tiktoken
    tokenizer_path: str = ""
    add_bos: bool = True
    add_eos: bool = True
    packing: bool = True
    num_epochs: int = 1

    audio_token_mapping_path: str = ""
    audio_batch_size: int = 8
    emilia_language: str = "en"
    audio_sample_rate: int = 16_000
    audio_codebook_size: int = 8192
    audio_bos_token: str = "e_<BT>"
    audio_boa_token: str = "e_<BA>"

    # ---------------------------------------------------------------- inference
    max_prefill_predict_length: int = 64
    decode_sampling_strategy: str = "greedy"  # greedy | weighted | topk | nucleus
    autoregressive_decode_assert: str = ""  # comma-separated expected token ids (e2e tests)
    decode_sampling_nucleus_p: float = 0.95
    decode_sampling_top_k: int = 40
    decode_sampling_temperature: float = 1.0
    attention_kernel_decode: str = "autoselected"
    paged_attention: bool = False
    pagedattn_num_pages: int = 64
    pagedattn_tokens_per_page: int = 32
    pagedattn_pages_per_compute_block: int = 4
    stack_prefill_result_cache: bool = False
    inference_microbenchmark_prefill_lengths: tuple[int, ...] = (64, 128, 256, 512, 1024)
    inference_server_port: int = 9000
    serving_mode: str = "interleaved"  # interleaved | disaggregated (prefill thread)
    serving_steps_per_dispatch: int = 4
    serving_admission_fusion_max: int = 8
    tts_batch_max: int = 8
    tts_batch_window_ms: int = 50
    tts_allow_force_frames: bool = False

    # ---------------------------------------------------------------- s2a / codec
    s2a_num_quantizers: int = 12
    s2a_hidden_size: int = 1024
    s2a_num_layers: int = 16
    s2a_num_heads: int = 16
    s2a_cond_codebook_size: int = 8192
    s2a_codebook_size: int = 1024
    s2a_timesteps: tuple[int, ...] = (10, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4)
    s2a_cfg_scale: float = 2.5
    s2a_cfg_until: float = 1.0
    s2a_mask_schedule: str = "cosine"
    s2a_serving_dtype: str = ""
    codec_hidden_size: int = 128
    codec_strides: tuple[int, ...] = (3, 4, 5, 8)
    codec_codebook_dim: int = 8
    codec_quantizer_dropout: float = 0.0
    semantic_codebook_size: int = 8192
    semantic_codebook_dim: int = 8
    semantic_encoder_layers: int = 17  # w2v-bert tap layer (reference: semantic_utils.py:92)

    jax_cache_dir: str = "/tmp/jax_cache"  # persistent compile cache ("" = off)
    shardy: str = ""

    # ---------------------------------------------------------------- observability
    enable_profiler: bool = False
    profiler_steps: int = 5
    skip_first_n_steps_for_profiler: int = 1
    profile_periodically_period: int = 0
    metrics_file: str = ""
    metrics_upload_dir: str = ""
    enable_tensorboard: bool = False
    enable_goodput_recording: bool = False
    monitor_goodput: bool = False
    report_heartbeat_metric_for_gcp_monitoring: bool = False
    heartbeat_reporting_interval_in_seconds: int = 5
    report_performance_metric_for_gcp_monitoring: bool = False
    use_vertex_tensorboard: bool = False
    vertex_tensorboard_project: str = ""
    vertex_tensorboard_region: str = ""
    optimizer_memory_host_offload: bool = False  # keep opt state in pinned host memory
    dump_hlo: bool = False  # write the train step's lowered HLO to hlo_dump_dir
    hlo_dump_dir: str = ""  # default: <run dir>/hlo
    collect_stack_trace: bool = False  # dump stacks if a step hangs
    stack_trace_interval_seconds: float = 600.0

    # ------------------------------------------------------------ derived (set by finalize)
    num_devices: int = 0
    global_batch_size_to_load: int = 0
    global_batch_size_to_train_on: int = 0
    global_batch_size_to_eval_on: int = 0
    micro_batch_size_to_train_on: int = 0
    emb_dim: int = 0
    num_query_heads: int = 0
    num_kv_heads: int = 0
    mlp_dim: int = 0
    num_decoder_layers: int = 0
    using_pipeline_parallelism: bool = False
    using_tensor_parallelism: bool = False
    using_sequence_parallelism: bool = False
    using_context_parallelism: bool = False
    using_expert_parallelism: bool = False

    def ici_parallelism(self) -> dict[str, int]:
        return {ax: getattr(self, f"ici_{ax}_parallelism") for ax in self.mesh_axes}

    def dcn_parallelism(self) -> dict[str, int]:
        return {ax: getattr(self, f"dcn_{ax}_parallelism") for ax in self.mesh_axes}


_TUPLE_FIELDS = {
    f.name
    for f in dataclasses.fields(Config)
    if "tuple" in str(f.type)
}


def _coerce(name: str, value: Any, target_type: Any) -> Any:
    """Coerce a yaml/CLI string to the dataclass field's type."""
    if name in _TUPLE_FIELDS:
        if isinstance(value, str):
            value = [v.strip() for v in value.strip("[]() ").split(",") if v.strip()]
        items = list(value)
        if name in ("mlp_activations", "train_data_columns", "eval_data_columns"):
            return tuple(str(v).strip("'\"") for v in items)
        return tuple(int(v) for v in items)
    if isinstance(value, str):
        t = str(target_type)
        if "bool" in t:
            if value.lower() in ("true", "1", "yes"):
                return True
            if value.lower() in ("false", "0", "no"):
                return False
            raise ValueError(f"cannot parse bool for {name}: {value!r}")
        if "int" in t and "tuple" not in t:
            return int(value)
        if "float" in t:
            return float(value)
    if isinstance(value, bool):
        return value
    if isinstance(value, float) and "int" in str(target_type):
        if value != int(value):
            raise ValueError(f"{name} expects int, got {value}")
        return int(value)
    return value


def _parse_scalar(text: str) -> Any:
    """One yaml scalar: quoted string, bool, int, float, else the raw text
    (``[a, b]`` lists stay text; :func:`_coerce` splits them)."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "~", ""):
        return None
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i]
    return line


def parse_flat_yaml(text: str) -> dict[str, Any]:
    """Parse the subset of yaml the config files use: one ``key: scalar``
    per line, ``#`` comments, blank lines. Anything nested is an error."""
    out: dict[str, Any] = {}
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if line[0].isspace() or ":" not in line:
            raise ValueError(f"line {n}: expected a flat 'key: value', got {raw!r}")
        key, _, val = line.partition(":")
        out[key.strip()] = _parse_scalar(val.strip())
    return out


def _load_yaml(path: str) -> dict[str, Any]:
    with open(path) as f:
        raw = parse_flat_yaml(f.read())
    base = {}
    if "base_config" in raw:
        parent = raw.pop("base_config")
        if not os.path.isabs(parent):
            parent = os.path.join(os.path.dirname(path), parent)
        base = _load_yaml(parent)
    base.update(raw)
    return base


def load_config(argv: list[str] | None = None, **kwargs: Any) -> Config:
    """Build a Config from [yaml_path] + key=value argv + MTT_* env + kwargs.

    Merge order (later wins): yaml < model preset yaml < env < argv < kwargs.
    A ``model_name`` with a matching configs/models/<name>.yml pulls in that
    preset.
    """
    argv = list(argv or [])
    overrides: dict[str, Any] = {}

    if argv and "=" not in argv[0]:
        overrides.update(_load_yaml(argv.pop(0)))

    late: dict[str, Any] = {}
    fields_by_name = {f.name: f for f in dataclasses.fields(Config)}
    for key, val in os.environ.items():
        if key.startswith("MTT_"):
            name = key[len("MTT_"):].lower()
            if name in fields_by_name:
                late[name] = val

    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"expected key=value override, got {arg!r}")
        key, _, val = arg.partition("=")
        late[key.strip()] = val.strip()

    late.update(kwargs)

    model_name = late.get("model_name", overrides.get("model_name", "default"))
    if model_name not in ("default", "tiny", "tiny_tts", ""):
        preset = os.path.join(
            os.path.dirname(__file__), "configs", "models", f"{model_name}.yml"
        )
        if os.path.exists(preset):
            overrides.update(_load_yaml(preset))

    overrides.update(late)

    clean: dict[str, Any] = {}
    for key, val in overrides.items():
        if key not in fields_by_name:
            raise ValueError(f"unknown config key: {key!r}")
        clean[key] = _coerce(key, val, fields_by_name[key].type)

    block = clean.get("decoder_block", overrides.get("decoder_block"))
    if block:
        from maxtext_indextts2_tpu_torch.models.registry import FAMILY_CONFIG_DEFAULTS

        for key, val in FAMILY_CONFIG_DEFAULTS.get(str(block), {}).items():
            if key not in overrides:
                clean[key] = val

    return finalize(Config(**clean))


def finalize(cfg: Config, num_devices: int | None = None) -> Config:
    """Validate and compute derived quantities for ``num_devices`` ranks
    (default: the world of ``torch.distributed``, or ``WORLD_SIZE`` before it
    is joined, else 1)."""
    if num_devices is None:
        from maxtext_indextts2_tpu_torch.parallel.mesh import world_size

        num_devices = world_size()
    cfg.num_devices = num_devices

    s = cfg.global_parameter_scale
    if s != 1 and (s & (s - 1)) != 0:
        raise ValueError("global_parameter_scale must be a power of 2")
    if s == 1:
        cfg.emb_dim = cfg.base_emb_dim
        cfg.num_query_heads = cfg.base_num_query_heads
        cfg.num_kv_heads = cfg.base_num_kv_heads
        cfg.mlp_dim = cfg.base_mlp_dim
        cfg.num_decoder_layers = cfg.base_num_decoder_layers
    else:
        lin = round(s ** (1 / 3) * 2) / 2
        cfg.emb_dim = _round128(cfg.base_emb_dim * lin)
        cfg.num_query_heads = max(1, _round_even(cfg.base_num_query_heads * lin))
        cfg.num_kv_heads = max(1, _round_even(cfg.base_num_kv_heads * lin))
        cfg.mlp_dim = _round128(cfg.base_mlp_dim * lin)
        cfg.num_decoder_layers = _round_even(cfg.base_num_decoder_layers * lin)

    # the single fill axis (-1) takes what the others leave of the ranks
    _fill_parallelism(cfg, "ici", num_devices // cfg.num_slices)
    _fill_parallelism(cfg, "dcn", cfg.num_slices)

    if cfg.num_query_heads % cfg.num_kv_heads != 0:
        raise ValueError("num_query_heads must be divisible by num_kv_heads")

    cfg.using_pipeline_parallelism = cfg.ici_stage_parallelism > 1 or cfg.dcn_stage_parallelism > 1
    cfg.using_tensor_parallelism = (cfg.ici_tensor_parallelism > 1
                                    or cfg.ici_tensor_transpose_parallelism > 1
                                    or cfg.ici_tensor_sequence_parallelism > 1)
    cfg.using_sequence_parallelism = cfg.ici_sequence_parallelism > 1
    cfg.using_context_parallelism = cfg.ici_context_parallelism > 1
    if cfg.context_parallel_algorithm not in ("allgather", "ring", "ulysses"):
        raise ValueError("context_parallel_algorithm must be 'allgather', 'ring' or "
                         f"'ulysses', got {cfg.context_parallel_algorithm!r}")
    cfg.using_expert_parallelism = cfg.ici_expert_parallelism > 1 or cfg.dcn_expert_parallelism > 1
    if cfg.using_pipeline_parallelism:
        stages = cfg.ici_stage_parallelism * cfg.dcn_stage_parallelism
        if cfg.num_pipeline_repeats == -1:
            layers = cfg.num_decoder_layers - cfg.first_num_dense_layers
            cfg.num_pipeline_repeats = max(1, layers // stages)
        if cfg.num_pipeline_microbatches == -1:
            cfg.num_pipeline_microbatches = stages

    cfg.global_batch_size_to_train_on, cfg.global_batch_size_to_load = (
        _global_batch_sizes(cfg.per_device_batch_size, num_devices)
    )
    if cfg.gradient_accumulation_steps > 1:
        cfg.micro_batch_size_to_train_on = cfg.global_batch_size_to_train_on
        cfg.global_batch_size_to_train_on *= cfg.gradient_accumulation_steps
        cfg.global_batch_size_to_load *= cfg.gradient_accumulation_steps
    else:
        cfg.micro_batch_size_to_train_on = cfg.global_batch_size_to_train_on
    eval_pdb = cfg.eval_per_device_batch_size or cfg.per_device_batch_size
    cfg.global_batch_size_to_eval_on, _ = _global_batch_sizes(eval_pdb, num_devices)

    if cfg.learning_rate_schedule_steps == -1:
        cfg.learning_rate_schedule_steps = cfg.steps

    if not cfg.checkpoint_dir:
        cfg.checkpoint_dir = os.path.join(
            cfg.base_output_directory, cfg.run_name, "checkpoints"
        )

    if cfg.moe_mlp_dim == 0:
        cfg.moe_mlp_dim = cfg.mlp_dim
    if cfg.num_experts > 1 and cfg.num_experts_per_tok > cfg.num_experts:
        raise ValueError("num_experts_per_tok must be <= num_experts")

    if cfg.max_prefill_predict_length >= cfg.max_target_length:
        cfg.max_prefill_predict_length = cfg.max_target_length // 2

    return cfg


def _round128(x: float) -> int:
    return max(128, int(round(x / 128) * 128))


def _round_even(x: float) -> int:
    return max(2, int(round(x / 2) * 2))


def _global_batch_sizes(per_device: float, num_devices: int) -> tuple[int, int]:
    """(batch to train on, batch to load) for ``num_devices`` devices."""
    if per_device < 1:
        train = int(per_device * num_devices)
        if train <= 0 or num_devices * per_device != train:
            raise ValueError(
                f"per_device_batch_size={per_device} must yield integer global batch"
            )
        load = math.ceil(per_device) * num_devices
    else:
        if per_device != int(per_device):
            raise ValueError("per_device_batch_size >= 1 must be an integer")
        train = int(per_device) * num_devices
        load = train
    return train, load


def _fill_parallelism(cfg: Config, prefix: str, total: int) -> None:
    degrees = {ax: getattr(cfg, f"{prefix}_{ax}_parallelism") for ax in cfg.mesh_axes}
    fill_axes = [ax for ax, d in degrees.items() if d == -1]
    if len(fill_axes) > 1:
        raise ValueError(f"at most one {prefix} axis may be -1, got {fill_axes}")
    known = math.prod(d for d in degrees.values() if d != -1)
    if fill_axes:
        if total % known != 0:
            raise ValueError(
                f"{prefix} parallelism product {known} does not divide {total} devices"
            )
        setattr(cfg, f"{prefix}_{fill_axes[0]}_parallelism", total // known)
        known = total
    if known != total:
        raise ValueError(
            f"product of {prefix} parallelism degrees {known} != {total} device(s)"
        )
