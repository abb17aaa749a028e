"""Where one decode step of the served audio LM spends its time on the GPU,
captured (one CUDA graph replay a dispatch, as served) and eager (the same
kernels launched one by one from the host).

Builds the ``tts-1b`` engine with seeded random weights (bfloat16, ragged
decode attention, or with ``paged=true`` a paged KV cache of ``tpp``-row
pages read by K4, the pool just large enough for the run), fills every slot
with a prompt, and reports for each route, one JSON object per line:

* ``step``: host-clock milliseconds per decode step of ``generate_n`` (ends
  in a device-to-host copy; median of five repeats, all five listed), and
  the same figure for one packed prefill admission;
* ``profile``: from ``torch.profiler`` over a few steady steps -- device-busy
  milliseconds per step, the device's idle share of the step, GPU kernels
  per step, the host's launch calls per step (``cudaLaunchKernel*`` and
  ``cudaGraphLaunch``), the graph replays, the launches of this package's
  own kernels a step by their counts, the device time per launch of those
  kernels, and the kernels that take the most device time.

Run on the machine with the GPU::

    python -m maxtext_indextts2_tpu_torch.tools.profile_decode [slots=32] [prompt_len=270] \\
        [steps=16] [layers=20] [paged=true] [tpp=128] [int8w=true]

``int8w=true`` serves ``int8w_serve`` weights (quantized from the same
seeded float weights on the card), so every product is ``int8w_matmul``.
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


def parse(argv: list[str]) -> dict:
    opts = dict(slots=32, prompt_len=270, steps=16, layers=20, paged=0, tpp=128, int8w=0)
    for a in argv:
        k, _, v = a.partition("=")
        if k not in opts:
            raise SystemExit(f"unknown option {k!r}; known: {sorted(opts)}")
        opts[k] = int({"true": 1, "false": 0}.get(v.lower(), v))
    return opts


def engine_args(opts: dict) -> list[str]:
    """The engine's config: ``tts-1b`` at the options' slots and layers;
    ``paged``: a page pool just large enough for this tool's steps;
    ``int8w``: ``int8w_serve`` weights (``int8w_matmul`` in every product)."""
    args = [
        os.path.join(_PKG, "configs", "models", "tts-1b.yml"), "decode_attention=ragged",
        "serve_params_dtype=bfloat16", "max_prefill_predict_length=1024", "scan_layers=false",
        f"per_device_batch_size={opts['slots']}", f"base_num_decoder_layers={opts['layers']}"]
    if opts["paged"]:
        # every step this tool takes (9 dispatches of ``steps`` a route) fits
        rows = opts["prompt_len"] + 18 * opts["steps"] + 1
        pages = opts["slots"] * -(-rows // opts["tpp"]) + 1
        args += ["paged_attention=true", f"pagedattn_tokens_per_page={opts['tpp']}",
                 f"pagedattn_num_pages={pages}"]
    if opts["int8w"]:
        args.append("quantization=int8w_serve")
    return args


def main(argv=None):
    opts = parse(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")
    card = _card()

    cfg = load_config(engine_args(opts))
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

    route_args = {"card": card, "slots": opts["slots"], "layers": cfg.num_decoder_layers,
                  "quantization": cfg.quantization or None,
                  "paged": bool(opts["paged"]),
                  "tokens_per_page": opts["tpp"] if opts["paged"] else None,
                  "prompt_len": opts["prompt_len"], "admission_prompts_per_dispatch": group,
                  "admission_ms_host_clock_median": float(np.median(admit_ms[1:] or admit_ms))}
    for route in ("captured", "eager"):
        step, prof = measure(engine, state, opts["steps"], eager=route == "eager")
        print(json.dumps({"phase": "step", **route_args, **step}), flush=True)
        print(json.dumps({"phase": "profile", "card": card, **prof}), flush=True)


OWN_KERNELS = ("ragged_decode_kernel", "row_copy", "int8w", "grouped_matmul")
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx",
                 "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch")


def measure(engine, state, steps: int = 16, eager: bool = False) -> tuple[dict, dict]:
    """(step, profile) of ``generate_n`` over the populated decode ``state``:
    captured (``eager=False``: one graph replay a dispatch of ``steps``) or
    eager (the kernels launched one by one). Runs 9 dispatches of ``steps``
    steps: a warm-up (the capture), 5 timed, a warm-up and a profiled one,
    and one timed with the profiler off."""
    from torch.profiler import ProfilerActivity, profile

    from maxtext_indextts2_tpu_torch.ops import launch_counts

    route = "eager" if eager else "captured"
    n = steps
    state, _ = engine.generate_n(state, n, _eager=eager)  # warm-up: captures the graph
    torch.cuda.synchronize()
    reps_ms = []  # the host clock spreads widely on a shared host: keep every repeat
    for _ in range(5):
        t0 = time.perf_counter()
        state, toks = engine.generate_n(state, n, _eager=eager)
        toks.cpu()
        reps_ms.append((time.perf_counter() - t0) * 1e3 / n)
    step_ms = float(np.median(reps_ms))
    step = {"route": route, "step_ms_host_clock": step_ms, "step_ms_host_clock_repeats": reps_ms,
            "tokens_per_s_decode_only": engine.num_slots / step_ms * 1e3}

    state, _ = engine.generate_n(state, n, _eager=eager)  # the window's own depth, warm
    torch.cuda.synchronize()
    replays0, counts0 = engine.graphs.replays, launch_counts.snapshot()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, toks = engine.generate_n(state, n, _eager=eager)
        torch.cuda.synchronize()
    replays = engine.graphs.replays - replays0
    own_counts = {".".join((k[0].rsplit(".", 1)[-1], *map(str, k[1:]))): v / n for k, v in
                  launch_counts.diff(launch_counts.snapshot(), counts0).items()}
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    host_launches = sum(1 for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CPU
                        and e.name in HOST_LAUNCHES)
    busy_us = sum(e.device_time_total for e in kernels)
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.device_time_total)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]
    own = {k: v for k, v in by_name.items() if any(o in k for o in OWN_KERNELS)}
    t0 = time.perf_counter()
    state, toks = engine.generate_n(state, n, _eager=eager)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    busy_ms = busy_us / 1e3 / n
    return step, {
        "route": route, "steps": n, "graph_replays": replays,
        "device_busy_ms_per_step": busy_ms, "step_ms_host_clock": wall_ms,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if kernels else None,
        "device_kernels_per_step": len(kernels) / n,
        "host_launch_calls_per_step": host_launches / n,
        "own_kernel_launches_per_step": own_counts,
        "own_kernels": [{"name": k[:90], "device_ms_per_launch": sum(v) / 1e3 / len(v),
                         "launches_per_step": len(v) / n} for k, v in own.items()],
        "top_kernels": [{"name": k[:80], "ms_per_step": sum(v) / 1e3 / n,
                         "launches_per_step": len(v) / n} for k, v in top]}


if __name__ == "__main__":
    main()
