"""Where one training step spends its time on the GPU: the ``tts-1b`` LM, the
S2A model, the acoustic codec or the MoE LM.

``model=lm`` builds the recipe of ``chip_smoke.py``'s ``train`` phase (full
width, seeded random bf16 weights, 4 x 2048 tokens a step, ``attention=flash``,
remat ``save_attn_and_mlp``) on synthetic tokens or (``data=emilia_audio``) on
one batch of packed emilia_audio rows; ``model=s2a`` the S2A step of
``s2a_train`` (the published MaskGCT widths, bfloat16 compute with float32
parameters and AdamW moments, clipping, 8 x 512 synthetic frames, one set of
draws), on the materialised attention or (``seq_flash=true``) the
sequence-flash route; ``model=codec`` the acoustic codec's step of
``chip_smoke.py``'s ``codec_train`` phase (``AcousticCodec()`` at its published
widths, float32, quantizer dropout 0.5, 16 rows of 0.5 s at 24 kHz; convolutions,
FFTs and products through cuDNN, cuFFT and cuBLAS, no kernel of this package),
grouped as convolutions, FFT, products, copies and the rest; ``model=moe`` the
recipe of ``chip_smoke.py``'s ``moe_train`` phase (qwen3-30b-a3b at full width,
2 of its 48 layers, 4 x 1024 tokens a step, float32 weights and AdamW moments,
bf16 compute, remat ``full``; the sparse route), with the grouped products
apart: the forward, dgrad and wgrad kernels of ``csrc/grouped_matmul*.cu``
each a group of its own. It reports, as one JSON object: the host-clock
step time (median of ``steps`` steps, each ending in a synchronise), and from
``torch.profiler`` over one more step the device-busy time, the device's idle
share, the GPU launches, the device time per launch of this package's kernels
(K9-K11, K5 in the S2A, the grouped kernels in the MoE LM), the device time
by group (flash attention, the row kernels, the grouped products, cuBLAS
products, copies, the rest) and the kernels that take the
most device time; beside them tokens/s and MFU at the H100's 989 TFLOP/s
(``utils/flops.py``; the LM), the wrappers' launch counts of the traced step
and the peak memory.

Run on the machine with the GPU::

    python -m maxtext_indextts2_tpu_torch.tools.profile_train [model=lm] [layers=20] \\
        [batch=4] [remat=save_attn_and_mlp] [data=synthetic] [steps=3]
    python -m maxtext_indextts2_tpu_torch.tools.profile_train model=s2a [layers=16] \\
        [batch=8] [seq_flash=false] [steps=3]
    python -m maxtext_indextts2_tpu_torch.tools.profile_train model=codec [batch=16] [steps=3]
    python -m maxtext_indextts2_tpu_torch.tools.profile_train model=moe [layers=2] [batch=4] \\
        [remat=full] [steps=3]
"""

from __future__ import annotations

import json
import os
import sys

import torch

from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.ops import ada_rmsnorm, flash_attention, grouped_matmul
from maxtext_indextts2_tpu_torch.tools.profile_decode import _card
from maxtext_indextts2_tpu_torch.tools.profile_s2a import profiled, row_kernel_name
from maxtext_indextts2_tpu_torch.train import train
from maxtext_indextts2_tpu_torch.utils import flops

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TTS_1B = os.path.join(_PKG, "configs", "models", "tts-1b.yml")

# kernel of csrc/flash_attention.cuh -> the wrapper that launches it (the
# float32 kernels on the CUDA cores; the bfloat16 ones on the tensor cores)
FLASH_KERNELS = {"fwd_kernel": "flash_fwd", "dq_kernel": "flash_bwd_dq",
                 "dkv_kernel": "flash_bwd_dkv", "fwd_mma_kernel": "flash_fwd",
                 "dq_mma_kernel": "flash_bwd_dq", "dkv_mma_kernel": "flash_bwd_dkv"}


def flash_kernel_name(event_name: str) -> str | None:
    """The wrapper a profiler event of ``flash::<kernel><...>`` belongs to."""
    if "flash::" not in event_name:
        return None
    for kernel, wrapper in FLASH_KERNELS.items():
        if f"flash::{kernel}" in event_name:
            return wrapper
    return None


# kernel of csrc/grouped_matmul*.cu and grouped_wgmma.cuh -> the wrapper that
# launches it (``gmm_f32::rows_kernel`` runs both the float32 forward and
# dgrad; ``gmm_wg::rows_kernel<true>`` is the bf16 forward where the groups
# hold many rows, ``<false>`` dgrad); the older kernels' names (a parent
# checkout's) map too
GROUPED_KERNELS = {"grouped_matmul_bf16_kernel": "grouped_matmul_bf16",
                   "grouped_matmul_bf16_few_rows_kernel": "grouped_matmul_bf16",
                   "gmm_wg::rows_kernel<true>": "grouped_matmul_bf16",
                   "gmm_wg::rows_kernel<false>": "grouped_matmul_dgrad",
                   "grouped_matmul_int8_kernel": "grouped_matmul_int8",
                   "grouped_matmul_int8_few_rows_kernel": "grouped_matmul_int8",
                   "grouped_matmul_int8_rows_kernel": "grouped_matmul_int8",
                   "gmm_bwd::dgrad_kernel": "grouped_matmul_dgrad",
                   "gmm_bwd::wgrad_kernel": "grouped_matmul_wgrad",
                   "gmm_f32::rows_kernel": "grouped_matmul_f32 (forward and dgrad)",
                   "gmm_f32::wgrad_kernel": "grouped_matmul_f32_wgrad"}


def grouped_kernel_name(event_name: str) -> str | None:
    """The wrapper a profiler event of a grouped-product kernel belongs to."""
    for kernel, wrapper in GROUPED_KERNELS.items():
        if kernel in event_name:
            return wrapper
    return None


def own_kernel_name(event_name: str) -> str | None:
    """The wrapper of a flash-attention, row-kernel or grouped-product
    event, else None."""
    return (flash_kernel_name(event_name) or row_kernel_name(event_name)
            or grouped_kernel_name(event_name))


def kernel_category(event_name: str) -> str:
    """A coarse group for a profiler event: this package's flash kernels and
    row kernels, the library's matrix products, copies, and the rest
    (elementwise passes, reductions, the optimizer)."""
    if flash_kernel_name(event_name):
        return "flash_attention (K9-K11)"
    if row_kernel_name(event_name):
        return "row kernels (K5-K8)"
    low = event_name.lower()
    if any(key in low for key in ("gemm", "cutlass", "xmma", "cublas", "nvjet", "sm90_")):
        return "matrix products (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "elementwise and reductions"


def codec_category(event_name: str) -> str:
    """A coarse group for a profiler event of the codec's step: cuDNN's
    convolutions, cuFFT, cuBLAS's products, copies, and the rest."""
    low = event_name.lower()
    if "fft" in low:
        return "FFT (cuFFT)"
    if any(key in low for key in ("conv", "fprop", "dgrad", "wgrad", "winograd", "cudnn")):
        return "convolutions (cuDNN)"
    return kernel_category(event_name)


def moe_category(event_name: str) -> str:
    """A coarse group for a profiler event of the MoE step: each grouped
    product's kernel apart, then as :func:`kernel_category`."""
    wrapper = grouped_kernel_name(event_name)
    return f"grouped: {wrapper}" if wrapper else kernel_category(event_name)


def _counts() -> dict:
    return {"ada_rmsnorm": ada_rmsnorm.launch_count, **flash_attention.launch_counts,
            **grouped_matmul.launch_counts}


def _reset_counts():
    ada_rmsnorm.launch_count = 0
    for counts in (flash_attention.launch_counts, grouped_matmul.launch_counts):
        for k in counts:
            counts[k] = 0


def lm_step(opts):
    """(step function, fields): one LM training step on one batch."""
    cfg = load_config([TTS_1B, f"dataset_type={opts['data']}",
                       f"per_device_batch_size={opts['batch'] or 4}",
                       f"remat_policy={opts['remat'] or 'save_attn_and_mlp'}", "attention=flash",
                       "weight_dtype=bfloat16", "scan_layers=false", "cast_logits_to_fp32=false",
                       f"base_num_decoder_layers={opts['layers'] or 20}"])
    state = train.setup_train_state(cfg)
    batch = next(train.create_data_iterator(cfg, state.device))
    tokens = cfg.global_batch_size_to_train_on * cfg.max_target_length
    seg = batch["inputs_segmentation"][:cfg.global_batch_size_to_train_on]
    fields = dict(model="lm", data=cfg.dataset_type, layers=cfg.num_decoder_layers,
                  batch=cfg.global_batch_size_to_train_on, seq=cfg.max_target_length,
                  remat=cfg.remat_policy, tokens_per_step=tokens,
                  real_tokens_per_step=int((seg > 0).sum()),
                  documents_a_row=[int(r.max()) for r in seg],
                  tflops_per_step=flops.training_tflops_per_step(cfg))
    return (lambda: train.train_step(cfg, state, batch)), fields


def s2a_step(opts):
    """(step function, fields): one S2A training step on one batch and one
    set of draws, on the route ``seq_flash`` names."""
    from maxtext_indextts2_tpu_torch.audio.s2a import draw_s2a_noise
    from maxtext_indextts2_tpu_torch.train import s2a_train

    cfg = load_config(["dataset_type=synthetic", "dtype=bfloat16",
                       f"per_device_batch_size={opts['batch'] or 8}", "max_target_length=512",
                       f"s2a_num_layers={opts['layers'] or 16}",
                       "gradient_clipping_threshold=1.0"])
    state = s2a_train.setup_s2a_state(cfg)
    raw = s2a_train.synthetic_s2a_batch(cfg, 0)
    batch = s2a_train.batch_to_device(raw, state.device)
    b, tlen = raw["semantic"].shape
    noise = draw_s2a_noise(state.model.cfg, b, tlen, torch.Generator().manual_seed(0))
    fields = dict(model="s2a", seq_flash=opts["seq_flash"] == "true",
                  layers=state.model.cfg.num_layers, batch=b, frames=tlen,
                  mask_layer=noise.mask_layer)
    return (lambda: s2a_train.s2a_train_step(cfg, state, batch, noise)), fields


def codec_step(opts):
    """(step function, fields): one acoustic-codec training step on one batch
    and one quantizer-dropout draw."""
    import math

    from maxtext_indextts2_tpu_torch.train import codec_train

    cfg = load_config([f"per_device_batch_size={opts['batch'] or 16}", "dtype=float32",
                       "codec_quantizer_dropout=0.5"])
    codec = codec_train.build_acoustic_codec(cfg)
    state = codec_train.setup_codec_state(cfg, codec)
    wav = torch.from_numpy(codec_train.acoustic_batch(
        cfg, 0, math.prod(codec.strides))["wav"]).to(state.device)
    draw = codec.decoder.quantizer.draw_dropout(
        wav.shape[0], torch.Generator(device=state.device).manual_seed(1))
    fields = dict(model="codec", batch=wav.shape[0], samples=wav.shape[1],
                  audio_seconds_per_step=wav.numel() / 24000,
                  params=sum(p.numel() for p in codec.parameters()))
    return (lambda: codec_train.codec_train_step(
        cfg, state, lambda: codec_train.acoustic_loss(codec, wav, draw))), fields


# chip_smoke.py's moe_train recipe (MOE_TRAIN_ARGS; layers and batch apart)
MOE_ARGS = ["model_name=qwen3-30b-a3b", "dataset_type=synthetic", "weight_dtype=float32",
            "dtype=bfloat16", "scan_layers=false", "max_target_length=1024",
            "max_prefill_predict_length=1024"]


def moe_step(opts):
    """(step function, fields): one MoE LM training step on one batch."""
    cfg = load_config(MOE_ARGS + [f"base_num_decoder_layers={opts['layers'] or 2}",
                                  f"per_device_batch_size={opts['batch'] or 4}",
                                  f"remat_policy={opts['remat'] or 'full'}"])
    state = train.setup_train_state(cfg)
    batch = next(train.create_data_iterator(cfg, state.device))
    tokens = cfg.global_batch_size_to_train_on * cfg.max_target_length
    fields = dict(model="moe", model_name=cfg.model_name, layers=cfg.num_decoder_layers,
                  batch=cfg.global_batch_size_to_train_on, seq=cfg.max_target_length,
                  remat=cfg.remat_policy, experts=[cfg.num_experts, cfg.num_experts_per_tok],
                  rows_a_grouped_product=tokens * cfg.num_experts_per_tok,
                  tokens_per_step=tokens, tflops_per_step=flops.training_tflops_per_step(cfg))
    return (lambda: train.train_step(cfg, state, batch)), fields


STEPS = {"lm": lm_step, "s2a": s2a_step, "codec": codec_step, "moe": moe_step}
CATEGORIES = {"codec": codec_category, "moe": moe_category}


def main(argv=None):
    opts = dict(model="lm", layers="", batch="", remat="", data="synthetic",
                seq_flash="false", steps="3")
    for a in (sys.argv[1:] if argv is None else argv):
        k, _, v = a.partition("=")
        if k not in opts:
            raise SystemExit(f"unknown option {k!r}; known: {sorted(opts)}")
        opts[k] = v
    if opts["model"] not in STEPS:
        raise SystemExit(f"model must be one of {sorted(STEPS)}, got {opts['model']!r}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    card = _card()
    if opts["seq_flash"] == "true":
        os.environ["MTT_S2A_SEQ_FLASH"] = "1"  # the S2A's opt-in route
    step_fn, fields = STEPS[opts["model"]](opts)
    torch.cuda.reset_peak_memory_stats()
    counts = {}

    def step():
        _reset_counts()
        step_fn()
        counts.update(_counts())

    category = CATEGORIES.get(opts["model"], kernel_category)
    out = profiled(step, "train_step", card, repeats=int(opts["steps"]),
                   own_kernel_name=own_kernel_name, category=category, **fields)
    seconds = out["ms_host_clock"] / 1e3
    if opts["model"] == "moe":
        out.update(tokens_per_s=fields["tokens_per_step"] / seconds,
                   mfu_at_989_tflops=flops.mfu(fields["tflops_per_step"], seconds))
    elif opts["model"] == "lm":
        out.update(tokens_per_s=fields["tokens_per_step"] / seconds,
                   real_tokens_per_s=fields["real_tokens_per_step"] / seconds,
                   mfu_at_989_tflops=flops.mfu(fields["tflops_per_step"], seconds))
    elif opts["model"] == "s2a":
        out.update(frames_per_s=fields["batch"] * fields["frames"] / seconds)
    else:
        out.update(audio_seconds_per_s=fields["audio_seconds_per_step"] / seconds)
    out.update(wrapper_launches=counts, peak_memory_bytes=torch.cuda.max_memory_allocated())
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
