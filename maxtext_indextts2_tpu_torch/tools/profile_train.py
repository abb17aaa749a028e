"""Where one training step of the ``tts-1b`` LM spends its time on the GPU.

Builds the recipe of ``chip_smoke.py``'s ``train`` phase (full width, seeded
random bf16 weights, 4 x 2048 synthetic tokens a step, ``attention=flash``,
remat ``save_attn_and_mlp``) and reports, as one JSON object: the host-clock
step time (median of ``steps`` steps, each ending in a synchronise), and from
``torch.profiler`` over one more step the device-busy time, the device's idle
share, the GPU launches, the device time per launch of the flash-attention
kernels K9-K11, the device time by group (flash attention, cuBLAS products,
copies, the rest) and the kernels that take the most device time; beside them
tokens/s and MFU at the H100's 989 TFLOP/s (``utils/flops.py``), the
wrappers' launch counts of the traced step and the peak memory.

Run on the machine with the GPU::

    python -m maxtext_indextts2_tpu_torch.tools.profile_train [layers=20] [batch=4] \\
        [remat=save_attn_and_mlp] [steps=3]
"""

from __future__ import annotations

import json
import os
import sys

import torch

from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.ops import flash_attention
from maxtext_indextts2_tpu_torch.tools.profile_decode import _card
from maxtext_indextts2_tpu_torch.tools.profile_s2a import profiled
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


def kernel_category(event_name: str) -> str:
    """A coarse group for a profiler event: this package's flash kernels, the
    library's matrix products, copies, and the rest (elementwise passes,
    reductions, the optimizer)."""
    if flash_kernel_name(event_name):
        return "flash_attention (K9-K11)"
    low = event_name.lower()
    if any(key in low for key in ("gemm", "cutlass", "xmma", "cublas", "nvjet", "sm90_")):
        return "matrix products (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "elementwise and reductions"


def main(argv=None):
    opts = dict(layers="20", batch="4", remat="save_attn_and_mlp", steps="3")
    for a in (sys.argv[1:] if argv is None else argv):
        k, _, v = a.partition("=")
        if k not in opts:
            raise SystemExit(f"unknown option {k!r}; known: {sorted(opts)}")
        opts[k] = v
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    card = _card()
    cfg = load_config([TTS_1B, "dataset_type=synthetic", f"per_device_batch_size={opts['batch']}",
                       f"remat_policy={opts['remat']}", "attention=flash",
                       "weight_dtype=bfloat16", "scan_layers=false", "cast_logits_to_fp32=false",
                       f"base_num_decoder_layers={opts['layers']}"])
    state = train.setup_train_state(cfg)
    batch = next(train.create_data_iterator(cfg, state.device))
    torch.cuda.reset_peak_memory_stats()

    counts = {}

    def step():
        for k in flash_attention.launch_counts:
            flash_attention.launch_counts[k] = 0
        train.train_step(cfg, state, batch)
        counts.update(flash_attention.launch_counts)

    out = profiled(step, "train_step", card, repeats=int(opts["steps"]),
                   own_kernel_name=flash_kernel_name, category=kernel_category,
                   layers=cfg.num_decoder_layers,
                   batch=cfg.global_batch_size_to_train_on, seq=cfg.max_target_length,
                   remat=cfg.remat_policy)
    tokens = cfg.global_batch_size_to_train_on * cfg.max_target_length
    tflops = flops.training_tflops_per_step(cfg)
    seconds = out["ms_host_clock"] / 1e3
    out.update(tokens_per_step=tokens, tokens_per_s=tokens / seconds, tflops_per_step=tflops,
               mfu_at_989_tflops=flops.mfu(tflops, seconds), wrapper_launches=counts,
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
