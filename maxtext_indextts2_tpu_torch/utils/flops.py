"""TFLOPs accounting and MFU on the H100.

Counterpart of the JAX package's ``utils/flops.py``: the same per-token
matmul and attention FLOPs (causal attention counted at half, 3x the forward
for forward plus backward). The peak is the H100 SXM's dense bf16 rate from
NVIDIA's data sheet; the JAX package's TPU peaks and its fallback to a TPU
peak for an unknown chip are not carried over.

Run: ``python -m maxtext_indextts2_tpu_torch.utils.flops <cfg.yml> key=value ...``
"""

from __future__ import annotations

from maxtext_indextts2_tpu_torch.config import Config

# dense bf16 tensor-core peak of one H100 SXM (NVIDIA data sheet), TFLOP/s
H100_PEAK_BF16_TFLOPS = 989.0


def per_token_matmul_flops(cfg: Config) -> float:
    """Forward matmul FLOPs per token (2*m*n*k accounting)."""
    d = cfg.emb_dim
    nq, nkv, hd = cfg.num_query_heads, cfg.num_kv_heads, cfg.head_dim
    qkvo = 2 * d * hd * (2 * nq + 2 * nkv)
    if cfg.num_experts > 1:
        active = cfg.num_experts_per_tok + cfg.shared_experts
        mlp = 2 * 3 * d * cfg.moe_mlp_dim * active
        dense_frac = cfg.first_num_dense_layers / max(cfg.num_decoder_layers, 1)
        mlp = mlp * (1 - dense_frac) + 2 * 3 * d * cfg.mlp_dim * dense_frac
    else:
        n_act = len(cfg.mlp_activations) + 1  # wi_0, wi_1, wo
        mlp = 2 * n_act * d * cfg.mlp_dim
    per_layer = qkvo + mlp
    embed = 2 * d * cfg.vocab_size  # unembedding
    return per_layer * cfg.num_decoder_layers + embed


def attention_flops_per_token(cfg: Config, seq_len: int, causal: bool = True) -> float:
    """Attention score+value FLOPs per token; causal halves the window."""
    window = seq_len / 2 if causal else seq_len
    if cfg.sliding_window_size > 0:
        window = min(window, cfg.sliding_window_size)
    return 2 * 2 * cfg.num_query_heads * cfg.head_dim * window * cfg.num_decoder_layers


def training_tflops_per_step(cfg: Config, seq_len: int | None = None) -> float:
    """Total (fwd+bwd = 3x fwd) TFLOPs per train step."""
    seq = seq_len or cfg.max_target_length
    tokens = cfg.global_batch_size_to_train_on * seq
    fwd = tokens * (per_token_matmul_flops(cfg) + attention_flops_per_token(cfg, seq))
    return 3 * fwd / 1e12


def mfu(tflops_per_step: float, step_time_s: float) -> float:
    """Model FLOPs utilisation of one H100 against its dense bf16 peak."""
    return tflops_per_step / step_time_s / H100_PEAK_BF16_TFLOPS


def main(argv=None):
    import sys

    from maxtext_indextts2_tpu_torch.config import load_config

    cfg = load_config(list(sys.argv[1:] if argv is None else argv))
    total = training_tflops_per_step(cfg)
    print(f"TFLOPs per training step: {total:.3f} (one device; MFU peak "
          f"{H100_PEAK_BF16_TFLOPS} TFLOP/s bf16, H100 SXM)")


if __name__ == "__main__":
    main()
