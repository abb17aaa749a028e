"""Offline checkpoint quantization: float weights -> ``int8w_serve`` weights.

The counterpart of the JAX package's ``tools/quantize_checkpoint.py`` (at the
repository root): an ``int8w_serve`` engine loads the float checkpoint (or,
without ``load_parameters_path``, the seeded weights of the unquantized
model) and quantizes it (int8 kernels, float32 per-output-channel scales;
an MoE layer's experts ``[E, in, out]`` int8 with one scale an (expert,
output channel), ``[E, 1, out]``: ``ops/quantization.quantize_params_for_serving``,
the JAX package's rule); its state dict is written
as a params-only checkpoint in this package's own format
(``train/checkpointing.save_params_only``). A serving job then reads it as it
is with ``quantization=int8w_serve checkpoint_is_quantized=true``, half the
bytes of a bfloat16 checkpoint.

Run: ``python -m maxtext_indextts2_tpu_torch.tools.quantize_checkpoint <config.yml>
[load_parameters_path=<ckpt>] save_path=<out_dir> [key=value ...] [device=cpu]``
(the GPU unless ``device=cpu``). Prints one JSON line.
"""

from __future__ import annotations

import json
import sys

import torch


def run(argv=None, device=None) -> dict:
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.infer.server import split_device_arg
    from maxtext_indextts2_tpu_torch.train.checkpointing import save_params_only

    argv, arg_device = split_device_arg(list(argv or []))
    device = device or arg_device
    save_path = ""
    keep = []
    for a in argv:
        if a.startswith("save_path="):
            save_path = a.split("=", 1)[1]
        else:
            keep.append(a)
    if not save_path:
        raise SystemExit("save_path=<dir> is required")
    cfg = load_config(keep + ["quantization=int8w_serve", "checkpoint_is_quantized=false"])
    eng = Engine(cfg, device=device)
    params = eng.load_params()  # the float weights, quantized
    # a scan-stacked engine writes stacked names, as the JAX engine's tree is
    save_params_only(save_path, eng.checkpoint_params())
    n_int8 = sum(t.numel() for t in params.values() if t.dtype == torch.int8)
    n_total = sum(t.numel() for t in params.values())
    return {
        "metric": "quantize_checkpoint",
        "value": round(n_int8 / max(n_total, 1), 4),
        "unit": "fraction_int8_params",
        "detail": {"save_path": save_path, "total_params": int(n_total)},
    }


if __name__ == "__main__":
    print(json.dumps(run(sys.argv[1:])))
