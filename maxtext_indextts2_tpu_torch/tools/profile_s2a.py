"""Where the TTS back end (S2A sampler + vocoder) spends its time on the GPU.

Builds the back end at its full published width with seeded random weights
(S2A: hidden 1024, 16 layers, 12 quantizers; codec decoder: 12-layer RVQ,
Vocos 512 / 2048 x 30, ISTFT 1920 / 480), makes a batch of 8 requests
(prompts of 100-250 frames, targets of 200-500 frames at 50 Hz) and reports,
one JSON object per line:

* ``forward``: one conditional denoiser forward at the batch's shape
  (``[8, 256 + 512, 1024]``) -- host-clock milliseconds (median of five, each
  ending in a synchronise), and from ``torch.profiler`` the device-busy
  milliseconds, the device's idle share, the GPU launches, the device time per
  launch of this package's own row kernels and the kernels that take the most
  device time;
* ``batch``: the same for one whole ``TTSPipeline.s2a_vocoder_batch`` call,
  with the seconds of its two stages and the seconds of audio it made.

Run on the machine with the GPU::

    python -m maxtext_indextts2_tpu_torch.tools.profile_s2a [mode=int8_offline] \\
        [layers=16] [steps=0] [requests=8]

``mode`` is the ``s2a_serving_dtype``; ``steps`` > 0 replaces the config's
schedule (10, 4 x 11) by that many steps for every quantizer.
"""

from __future__ import annotations

import json
import re
import sys
import time

import numpy as np
import torch

from maxtext_indextts2_tpu_torch.audio.pipeline import backend_requests, build_backend
from maxtext_indextts2_tpu_torch.tools.profile_decode import _card

# template argument of csrc/row_kernels.cuh's kernel -> the wrapper it serves
ROW_KERNEL_MODES = {0: "ada_rmsnorm", 1: "row_quantize_int8", 2: "ada_rmsnorm_quantize",
                    3: "silu_mul_quantize"}


def row_kernel_name(event_name: str) -> str | None:
    """The wrapper a profiler event of ``rowk::row_kernel<T, mode>`` belongs to."""
    if "row_kernel" not in event_name:
        return None
    found = re.search(r"row_kernel<[^,>]+,\s*(?:\(int\))?(\d+)>", event_name)
    return ROW_KERNEL_MODES.get(int(found.group(1)), "row_kernel") if found else "row_kernel"


def profiled(fn, what: str, card: str, repeats: int = 5, own_kernel_name=row_kernel_name,
             category=None, **fields) -> dict:
    """Host-clock time of ``fn`` (median of ``repeats``, each synchronised)
    and one traced run of it: device-busy time, idle share, launches, and the
    device time of this package's own kernels (``own_kernel_name`` maps a
    profiler event's name to its wrapper, or None); with ``category`` (a
    profiler event's name -> a group) the device time by group as well."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up: builds the kernels, fills the allocator's caches
    torch.cuda.synchronize()
    reps = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(reps))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.device_time_total)
    busy_ms = sum(sum(v) for v in by_name.values()) / 1e3
    own: dict[str, list[float]] = {}
    for name, times in by_name.items():
        wrapper = own_kernel_name(name)
        if wrapper:
            own.setdefault(wrapper, []).extend(times)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]
    if category is not None:
        groups: dict[str, list[float]] = {}
        for name, times in by_name.items():
            groups.setdefault(category(name), []).extend(times)
        fields["device_ms_by_category"] = {
            k: {"device_ms": sum(v) / 1e3, "launches": len(v)} for k, v in sorted(groups.items())}
    return {
        "phase": what, "card": card, **fields, "ms_host_clock": wall_ms,
        "ms_host_clock_repeats": reps, "device_busy_ms": busy_ms,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if kernels else None,
        "device_launches": len(kernels),
        "own_kernels": [{"name": k, "launches": len(v), "device_ms_per_launch": sum(v) / 1e3 / len(v),
                         "device_ms": sum(v) / 1e3} for k, v in sorted(own.items())],
        "top_kernels": [{"name": k[:80], "device_ms": sum(v) / 1e3, "launches": len(v)}
                        for k, v in top]}


def main(argv=None):
    opts = dict(mode="int8_offline", layers="16", steps="0", requests="8")
    for a in (sys.argv[1:] if argv is None else argv):
        k, _, v = a.partition("=")
        if k not in opts:
            raise SystemExit(f"unknown option {k!r}; known: {sorted(opts)}")
        opts[k] = v
    if not torch.cuda.is_available():
        raise SystemExit("profile_s2a needs a CUDA device")
    card = _card()
    steps, n = int(opts["steps"]), int(opts["requests"])
    pipe = build_backend(opts["mode"], layers=int(opts["layers"]),
                         timesteps=[steps] * 12 if steps else None)
    requests, sems, acs, gens = backend_requests(0, n)
    c = pipe.s2a.cfg
    common = dict(mode=opts["mode"], layers=c.num_layers, requests=n)

    # one conditional forward at the shape the batch gives the denoiser
    b, s = max(n, 8), 256 + 512
    g = torch.Generator(device=pipe.device).manual_seed(1)
    x = torch.randn((b, s, c.hidden_size), generator=g, device=pipe.device).to(c.dtype)
    cond = torch.randn((b, s, c.hidden_size), generator=g, device=pipe.device).to(c.dtype)
    t = torch.full((b,), 0.5, device=pipe.device)
    pad = torch.ones((b, s), dtype=torch.int32, device=pipe.device)
    with torch.no_grad():
        print(json.dumps(profiled(lambda: pipe.s2a.denoiser(x, t, cond, pad), "forward", card,
                                  shape=[b, s, c.hidden_size], **common)), flush=True)

    def batch():
        return pipe.s2a_vocoder_batch(requests, sems, acs, gens, pad_to_batch=8, length_bucket=64)

    out = profiled(batch, "batch", card, repeats=3, timesteps=list(pipe.cfg.s2a_timesteps),
                   **common)
    infos = [info for _, info in batch()]
    out.update(stage_seconds={"s2a": infos[0]["t_s2a"], "vocoder": infos[0]["t_vocoder"]},
               audio_seconds=sum(info["audio_seconds"] for info in infos))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
