#!/usr/bin/env python3
"""Drives the PyTorch/CUDA package on one NVIDIA Hopper GPU, end to end.

Run from the repository root: ``python3 chip_smoke.py`` (no arguments, one
GPU, no network). It builds the CUDA kernels from ``csrc/`` with ``nvcc``,
holds each against its plain PyTorch version on the GPU, serves the
``tts-1b`` audio LM at its full width (seeded random weights) through the
``Orchestrator`` with more requests than slots, shows with the wrappers'
launch counts that the serving run went through both kernels, compares the
kernel path with the plain path inside the model, and makes one HTTP round
trip. Every phase prints one JSON object on a line; the last line is
``{"ok": true, "device": {...}}``. Any failed phase ends the run with a
non-zero exit code, and so does a machine without a GPU: nothing here falls
back to the CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
TTS_1B = os.path.join(REPO, "maxtext_indextts2_tpu_torch", "configs", "models", "tts-1b.yml")
SERVE_ARGS = [
    TTS_1B, "decode_attention=ragged", "serve_params_dtype=bfloat16",
    "decode_sampling_strategy=greedy", "max_prefill_predict_length=512",
    "per_device_batch_size=32", "scan_layers=false",
]
STEPS_PER_DISPATCH = 4
NUM_REQUESTS = 80

# File and line of the TPU kernel each CUDA kernel replaces (JAX package).
KERNELS = [
    dict(name="ragged_decode_attention", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/ragged_decode_attention.cuh",
         replaces="maxtext_indextts2_tpu/ops/ragged_decode_attention.py:373"),
    dict(name="inplace_row_update", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/inplace_update.cu",
         replaces="maxtext_indextts2_tpu/ops/inplace_update.py:30"),
]

# One decode step through the kernels against one through their plain
# versions, bfloat16 model, 20 layers: the attention outputs differ by at most
# one bfloat16 step (other summation order), which the layers above carry to
# logits of magnitude ~4 as a few bfloat16 steps (2**-6 each there).
TOL_PARITY_BF16_LOGITS = 0.125


def emit(phase: str, t0: float, **fields):
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter() - t0, 3), **fields}),
          flush=True)


def check(ok: bool, what: str):
    if not ok:
        print(json.dumps({"ok": False, "failed": what}), flush=True)
        raise SystemExit(f"chip_smoke: {what}")


def phase_device():
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stdout.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    emit("device", t0, name=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)), torch=torch.__version__,
         cuda=torch.version.cuda, name_and_power_limit=card)
    return card


def phase_build():
    from maxtext_indextts2_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library(verbose=False)
    emit("build", t0, build_seconds=_build.build_seconds, sources=sorted(
        os.path.relpath(s, REPO) for s in _build._sources()))


def phase_kernels():
    from maxtext_indextts2_tpu_torch.ops import smoke

    t0 = time.perf_counter()
    results = smoke.run_all("cuda", timing=True, full_size=True)
    for r in results:
        print(json.dumps({"phase": "kernel_case", **r}), flush=True)
    bad = [r["name"] for r in results if not r["ok"]]
    emit("kernel_checks", t0, cases=len(results), failed=bad)
    check(not bad, f"kernels disagree with their plain versions: {bad}")
    return {r["name"]: r for r in results}


def make_requests(rng, vocab):
    prompts = [rng.integers(1, vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(8, 401, size=NUM_REQUESTS)]
    budgets = [int(n) for n in rng.integers(16, 129, size=NUM_REQUESTS)]
    return prompts, budgets


def phase_serve():
    """The main path: ``tts-1b`` at full width behind the Orchestrator."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.infer.server import Orchestrator
    from maxtext_indextts2_tpu_torch.ops import inplace_update, ragged_decode_attention

    t0 = time.perf_counter()
    cfg = load_config(SERVE_ARGS)
    engine = Engine(cfg)  # no device given: the GPU, or an error
    engine.load_params()
    n_params = sum(p.numel() for p in engine.model.parameters())
    torch.cuda.synchronize()
    emit("load", t0, params=n_params, layers=cfg.num_decoder_layers, emb_dim=cfg.emb_dim,
         slots=engine.num_slots, device=str(engine.device))

    prompts, budgets = make_requests(np.random.default_rng(0), cfg.vocab_size)
    orch = Orchestrator(engine, steps_per_dispatch=STEPS_PER_DISPATCH)
    orch.start()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    # every count to 0 just before the main path, read just after
    ragged_decode_attention.launch_count = 0
    inplace_update.launch_count = 0
    t1 = time.perf_counter()
    reqs = [orch.submit(p, n) for p, n in zip(prompts, budgets)]
    finished = all(r.done.wait(timeout=600) for r in reqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    orch.stop()
    launches = {"ragged_decode_attention": ragged_decode_attention.launch_count,
                "inplace_row_update": inplace_update.launch_count}

    check(finished, "serve: a request did not finish in 600 s")
    errors = [r.error for r in reqs if r.error]
    check(not errors, f"serve: {len(errors)} requests failed, first: {errors[:1]}")
    check(all(len(r.tokens) == n for r, n in zip(reqs, budgets)),
          "serve: a request did not get exactly its token budget")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens),
          "serve: a token outside [0, vocab)")
    steps = orch.stats["decode_steps_total"]
    layers = cfg.num_decoder_layers
    want = {"ragged_decode_attention": layers * steps, "inplace_row_update": 2 * layers * steps}
    check(steps > 0 and launches == want,
          f"serve: kernel launches {launches} != expected {want} ({steps} decode steps)")
    check(orch.stats["admission_dispatches_total"] < NUM_REQUESTS, "serve: admission never fused")
    tokens = sum(len(r.tokens) for r in reqs)
    emit("serve", t0, requests=len(reqs), tokens=tokens, serve_seconds=seconds,
         tokens_per_s=tokens / seconds, decode_steps=steps,
         admission_dispatches=orch.stats["admission_dispatches_total"],
         launches=launches, distinct_tokens=len({t for r in reqs for t in r.tokens}),
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return engine, launches


def _clone_state(state):
    return {"cache": [[c.clone() for c in unit] for unit in state["cache"]],
            "tokens": state["tokens"].clone(), "pos": state["pos"].clone(),
            "active": state["active"].clone()}


def phase_serve_parity(engine):
    """The kernels inside the model against their plain versions."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine

    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    vocab = engine.cfg.vocab_size
    # (a) the bfloat16 20-layer model: one step from one populated state
    state = engine.init_decode_state()
    prompts = [rng.integers(1, vocab, size=int(n)).astype(np.int32)
               for n in (5, 64, 130, 17, 250, 33, 120, 96)]
    for i in (0, 4):
        state, _ = engine.prefill_insert_many(
            state, prompts[i:i + 4], [2 * j for j in range(i, i + 4)])
    state, _ = engine.generate_n(state, 3)
    twin = _clone_state(state)
    _, logits_kernel = engine._generate_step(state)
    _, logits_plain = engine._generate_step(twin, impl="plain")
    torch.cuda.synchronize()
    active = state["active"]
    err = float((logits_kernel[active] - logits_plain[active]).abs().max().item())
    finite = bool(torch.isfinite(logits_kernel).all().item())
    scale = float(logits_plain[active].abs().max().item())
    check(finite and err <= TOL_PARITY_BF16_LOGITS,
          f"serve_parity: bfloat16 logits differ by {err} > {TOL_PARITY_BF16_LOGITS}")
    del state, twin

    # (b) full width, 4 layers, float32: greedy streams must be identical
    cfg4 = load_config([TTS_1B, "decode_attention=ragged", "dtype=float32",
                        "base_num_decoder_layers=4", "per_device_batch_size=8",
                        "max_prefill_predict_length=1024", "scan_layers=false"])
    eng4 = Engine(cfg4)
    eng4.load_params()
    streams = []
    for impl in (None, "plain"):
        st = eng4.init_decode_state()
        st, first = eng4.prefill_insert_many(st, prompts[:4], [0, 1, 2, 3])
        st, second = eng4.prefill_insert_many(st, prompts[4:], [4, 5, 6, 7])
        st, toks = eng4.generate_n(st, 31, impl=impl)
        streams.append(torch.cat([torch.cat([first, second])[None], toks]).cpu().numpy())
        del st
    same = bool((streams[0] == streams[1]).all())
    check(streams[0].shape == (32, 8) and same,
          "serve_parity: float32 greedy streams of the kernel path and the plain path differ")
    emit("serve_parity", t0, bf16_logits_max_abs_err=err, tol=TOL_PARITY_BF16_LOGITS,
         bf16_logits_max_abs=scale, f32_streams_identical=same, f32_tokens_compared=int(streams[0].size),
         f32_distinct_tokens=int(len(np.unique(streams[0]))))


def phase_http(engine):
    from maxtext_indextts2_tpu_torch.infer.server import make_server

    t0 = time.perf_counter()
    server, orch = make_server(engine.cfg, port=0, engine=engine, host="127.0.0.1")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        body = json.dumps({"prompt": list(range(1, 13)), "max_new_tokens": 8}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            tokens = json.loads(resp.read())["tokens"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
            metrics = resp.read().decode()
    finally:
        server.shutdown()
        server.server_close()
        orch.stop()
        thread.join(timeout=30)
    check(len(tokens) == 8 and all(0 <= t < engine.cfg.vocab_size for t in tokens),
          f"http: bad /generate answer {tokens}")
    check("serving_requests_completed 1" in metrics, "http: /metrics does not count the request")
    emit("http", t0, tokens=tokens)


def kernels_line(cases, launches):
    """The summary of every kernel on the main path: times at the shapes the
    serving run gives the kernel, the error as the largest over all cases."""
    from maxtext_indextts2_tpu_torch.ops.smoke import MAIN_PATH_CASES

    out = []
    for k in KERNELS:
        main = cases[MAIN_PATH_CASES[k["name"]]]
        own = [c for c in cases.values() if c["kernel"] == k["name"]]
        out.append(dict(
            k, launches=launches[k["name"]],
            max_abs_err=max(c["max_abs_err"] for c in own),
            tol=main["tol"], ms=main["kernel_ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], bytes_moved=main["bytes_moved"],
            shape=main["shape"], cases=len(own)))
    return {"kernels": out}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    import maxtext_indextts2_tpu_torch  # noqa: F401  (fails here, before any output, if absent)
    t_all = time.perf_counter()
    card = phase_device()
    phase_build()
    cases = phase_kernels()
    engine, launches = phase_serve()
    phase_serve_parity(engine)
    phase_http(engine)
    check(all(n > 0 for n in launches.values()), f"a kernel of the main path never ran: {launches}")
    emit("total", t_all)
    print(json.dumps(kernels_line(cases, launches)), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
