"""Where one decode step of the served audio LM spends its time on the GPU.

Builds the ``tts-1b`` engine with seeded random weights (bfloat16, ragged
decode attention, or with ``paged=true`` a paged KV cache of ``tpp``-row
pages read by K4, the pool just large enough for the run), fills every slot
with a prompt, and reports, one JSON object per line:

* ``step``: host-clock milliseconds per decode step of ``generate_n`` (ends
  in a device-to-host copy; median of five repeats, all five listed), and
  the same figure for one packed prefill admission;
* ``profile``: from ``torch.profiler`` over a few steady steps -- device-busy
  milliseconds per step, the device's idle share of the step, GPU kernel
  launches per step, the device time per launch of this package's own
  kernels, and the kernels that take the most device time.

Run on the machine with the GPU::

    python -m maxtext_indextts2_tpu_torch.tools.profile_decode [slots=32] [prompt_len=270] \\
        [steps=16] [layers=20] [paged=true] [tpp=128]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer.engine import Engine

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "unknown"


def main(argv=None):
    opts = dict(slots=32, prompt_len=270, steps=16, layers=20, paged=0, tpp=128)
    for a in (sys.argv[1:] if argv is None else argv):
        k, _, v = a.partition("=")
        if k not in opts:
            raise SystemExit(f"unknown option {k!r}; known: {sorted(opts)}")
        opts[k] = int({"true": 1, "false": 0}.get(v.lower(), v))
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")
    card = _card()

    args = [
        os.path.join(_PKG, "configs", "models", "tts-1b.yml"), "decode_attention=ragged",
        "serve_params_dtype=bfloat16", "max_prefill_predict_length=1024", "scan_layers=false",
        f"per_device_batch_size={opts['slots']}", f"base_num_decoder_layers={opts['layers']}"]
    if opts["paged"]:
        # every step this tool takes (4 warm-up, 5 x steps, 2 x 8 profiled) fits
        rows = opts["prompt_len"] + 4 + 5 * opts["steps"] + 16
        pages = opts["slots"] * -(-rows // opts["tpp"]) + 1
        args += ["paged_attention=true", f"pagedattn_tokens_per_page={opts['tpp']}",
                 f"pagedattn_num_pages={pages}"]
    cfg = load_config(args)
    engine = Engine(cfg)
    engine.load_params()
    rng = np.random.default_rng(0)
    state = engine.init_decode_state()
    group = max(1, min(opts["slots"], 1024 // opts["prompt_len"]))
    admit_ms = []
    for first in range(0, opts["slots"], group):
        slots = list(range(first, min(first + group, opts["slots"])))
        prompts = [rng.integers(1, cfg.vocab_size, size=opts["prompt_len"]).astype(np.int32)
                   for _ in slots]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = engine.prefill_insert_many(state, prompts, slots)
        torch.cuda.synchronize()
        admit_ms.append((time.perf_counter() - t0) * 1e3)

    n = opts["steps"]
    state, _ = engine.generate_n(state, 4)  # warm-up: builds the kernels, fills caches
    torch.cuda.synchronize()
    reps_ms = []  # the host clock spreads widely on a shared host: keep every repeat
    for _ in range(5):
        t0 = time.perf_counter()
        state, toks = engine.generate_n(state, n)
        toks.cpu()
        reps_ms.append((time.perf_counter() - t0) * 1e3 / n)
    step_ms = float(np.median(reps_ms))
    print(json.dumps({
        "phase": "step", "card": card, "slots": opts["slots"], "layers": cfg.num_decoder_layers,
        "paged": bool(opts["paged"]), "tokens_per_page": opts["tpp"] if opts["paged"] else None,
        "prompt_len": opts["prompt_len"], "step_ms_host_clock": step_ms,
        "step_ms_host_clock_repeats": reps_ms,
        "tokens_per_s_decode_only": opts["slots"] / step_ms * 1e3,
        "admission_prompts_per_dispatch": group,
        "admission_ms_host_clock_median": float(np.median(admit_ms[1:] or admit_ms))}), flush=True)

    from torch.profiler import ProfilerActivity, profile

    steps = min(n, 8)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, toks = engine.generate_n(state, steps)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.device_time_total)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]
    own = {k: v for k, v in by_name.items() if "ragged_decode_kernel" in k or "row_copy" in k}
    t0 = time.perf_counter()
    state, toks = engine.generate_n(state, steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    busy_ms = busy_us / 1e3 / steps
    print(json.dumps({
        "phase": "profile", "card": card, "steps": steps,
        "device_busy_ms_per_step": busy_ms, "step_ms_host_clock": wall_ms,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if kernels else None,
        "device_launches_per_step": len(kernels) / steps,
        "own_kernels": [{"name": k[:90], "device_ms_per_launch": sum(v) / 1e3 / len(v),
                         "launches_per_step": len(v) / steps} for k, v in own.items()],
        "top_kernels": [{"name": k[:80], "ms_per_step": sum(v) / 1e3 / steps,
                         "launches_per_step": len(v) / steps} for k, v in top]}), flush=True)


if __name__ == "__main__":
    main()
