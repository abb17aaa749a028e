"""Where one ``/tts`` batch spends its time on the GPU, stage by stage.

Builds the whole zero-shot pipeline at its full published width with seeded
random weights (``audio.pipeline.build_pipeline``), starts the server's
``Orchestrator`` on its engine and serves one batch of 8 seeded requests the
way ``TTSBatcher`` serves it (prompts of 3-6 s, texts of 40-160 bytes,
200-500 frames each with ``force_frames``): the frontend and the S2A sampler
+ vocoder run on the orchestrator's thread (``run_on_loop``), the LM through
its shared decode slots. After one warm-up batch it serves the same batch
again with each stage under ``torch.profiler`` and prints one JSON object:
per stage the host-clock seconds, the device-busy seconds (summed device
time of every GPU kernel and copy), the device's idle share and the GPU
launches; for the batch the same (the sum over the stages, which run one
after the other), the seconds of audio made, and the launch counts of this
package's own kernels.

Run on the machine with the GPU::

    python -m maxtext_indextts2_tpu_torch.tools.profile_tts [mode=int8_offline] [requests=8]
"""

from __future__ import annotations

import json
import sys
import time

import torch

from maxtext_indextts2_tpu_torch.audio.pipeline import build_pipeline, tts_requests
from maxtext_indextts2_tpu_torch.infer.server import Orchestrator, TTSBatcher
from maxtext_indextts2_tpu_torch.ops import (
    ada_rmsnorm, inplace_update, quant_kernels, ragged_decode_attention, s2a_attention,
)
from maxtext_indextts2_tpu_torch.tools.profile_decode import _card


def _counts() -> dict:
    return {"ragged_decode_attention": ragged_decode_attention.launch_count,
            "inplace_row_update": inplace_update.launch_count,
            "ada_rmsnorm": ada_rmsnorm.launch_count, **quant_kernels.launch_counts,
            "s2a_attention": s2a_attention.launch_count}


def _traced(fn):
    """(result, host seconds, device-busy seconds, GPU launches) of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, wall, sum(e.device_time_total for e in kernels) / 1e6, len(kernels)


def serve_batch(pipe, orch, batcher, requests, trace: bool):
    """One batch through the stages ``TTSBatcher._run_phased`` runs. Returns
    (results, {stage: (host s, busy s, launches)})."""
    run = _traced if trace else (lambda fn: (fn(), 0.0, 0.0, 0))
    stages = {}
    sems_acs, *stages["frontend"] = run(lambda: orch.run_on_loop(
        lambda: pipe.frontend_batch(requests, pad_to_batch=batcher.max_batch)))
    sems, acs = sems_acs
    prompts = [pipe.text_and_prompt_to_lm_prompt(r["text"], s) for r, s in zip(requests, sems)]
    outs, *stages["lm"] = run(lambda: batcher._generate_via_orch(
        prompts, [r["max_new_tokens"] for r in requests]))
    gens = [pipe.map_semantic(o, force_frames=True) for o in outs]
    codes, *stages["s2a"] = run(lambda: orch.run_on_loop(lambda: pipe._sample_codes(
        sems, acs, gens, None, 64, batcher.max_batch, None, None)))
    wavs, *stages["vocoder"] = run(lambda: orch.run_on_loop(
        lambda: pipe.codec.detokenize(codes.permute(2, 0, 1)).float().cpu().numpy()))
    hop = int(torch.tensor(pipe.codec.strides).prod())
    return [wavs[i, :len(g) * hop] for i, g in enumerate(gens)], stages


def main(argv=None):
    opts = dict(mode="int8_offline", requests="8")
    for a in (sys.argv[1:] if argv is None else argv):
        k, _, v = a.partition("=")
        if k not in opts:
            raise SystemExit(f"unknown option {k!r}; known: {sorted(opts)}")
        opts[k] = v
    if not torch.cuda.is_available():
        raise SystemExit("profile_tts needs a CUDA device")
    card = _card()
    n = int(opts["requests"])
    pipe = build_pipeline(opts["mode"])
    orch = Orchestrator(pipe.engine)
    orch.start()
    batcher = TTSBatcher(pipe, max_batch=max(n, 8), orchestrator=orch, allow_force_frames=True)
    requests = tts_requests(60, n)
    try:
        serve_batch(pipe, orch, batcher, requests, trace=False)  # warm-up
        before, steps_before = _counts(), orch.stats["decode_steps_total"]
        wavs, stages = serve_batch(pipe, orch, batcher, requests, trace=True)
        steps = orch.stats["decode_steps_total"] - steps_before
    finally:
        orch.stop()
    launches = {k: v - before[k] for k, v in _counts().items()}
    # the stages run one after the other; reading a trace is not part of the batch
    total = sum(w for w, _, _ in stages.values())
    busy = sum(b for _, b, _ in stages.values())
    audio = sum(len(w) for w in wavs) / 24_000.0
    print(json.dumps({
        "phase": "tts_batch", "card": card, "mode": opts["mode"], "requests": n,
        "frames": [r["max_new_tokens"] for r in requests],
        "stages": {k: {"seconds": w, "device_busy_seconds": b,
                       "device_idle_share": 1.0 - b / w if w else None, "device_launches": c}
                   for k, (w, b, c) in stages.items()},
        "batch_seconds": total, "device_busy_seconds": busy,
        "device_idle_share": 1.0 - busy / total, "audio_seconds": audio,
        "gpu_seconds_per_audio_second": total / audio, "decode_steps": steps,
        "own_kernel_launches": launches}), flush=True)


if __name__ == "__main__":
    main()
