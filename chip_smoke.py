#!/usr/bin/env python3
"""Drives the PyTorch/CUDA package on one NVIDIA Hopper GPU, end to end.

Run from the repository root: ``python3 chip_smoke.py`` (no arguments, one
GPU, no network). It builds the CUDA kernels from ``csrc/`` with ``nvcc``,
holds each against its plain PyTorch version on the GPU, serves the
``tts-1b`` audio LM at its full width (seeded random weights) through the
``Orchestrator`` with more requests than slots, shows with the wrappers'
launch counts that the serving run went through both kernels, compares the
kernel path with the plain path inside the model, and makes one HTTP round
trip. Then it drives the TTS back end at its full width (S2A sampler, RVQ,
Vocos/ISTFT; seeded random weights) through ``TTSPipeline.s2a_vocoder_batch``
for 8 requests, served as ``int8_offline`` and as ``bfloat16``, checks the
launch counts of the four row kernels against what the code predicts, and
compares the kernel path with the plain path inside the denoiser and the
sampler. Last it drives the whole zero-shot pipeline at its full width (the
semantic tokenizer and codec encoder of the prompt, the LM, the S2A sampler,
the vocoder): ``TTSPipeline.synthesize`` for one request, whose fixed-length
sampler runs the S2A attention kernel, compares that kernel and the prompt
tokenizers (card against CPU) with their plain routes, and serves 8
concurrent ``POST /tts`` requests through ``make_server``. Then it trains:
the ``tts-1b`` recipe at full width (4 x 2048 tokens a step, bf16 weights,
``attention=flash``, remat ``save_attn_and_mlp``) for a few steps through
the training entry point, shows with the launch counts that every step ran
the flash-attention kernels K9-K11 as often as the code predicts, and holds
one 2-layer float32 step's loss and gradients through the kernels against the
plain route. Last it serves the ``tts-1b`` audio LM again with a PAGED KV
cache (``paged_attention=true``: 128-row pages, a 32,768-token context, a
97-page pool) through the ``Orchestrator``, whose page reservations hold
requests back, shows with the launch counts that every decode step ran the
paged kernel K4 once a layer (and K1, K2 never), that every page came back,
and holds K4 inside the model against its plain version and the paged
streams against the dense ones. Every phase prints
one JSON object on a line; the last line is
``{"ok": true, "device": {...}}``. Any failed phase ends the run with a
non-zero exit code, and so does a machine without a GPU: nothing here falls
back to the CPU.
"""

from __future__ import annotations

import base64
import dataclasses
import gc
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
# Paged serving: the same model and traffic with a paged KV cache: 128-row
# pages, a 32,768-token context (a dense cache of it for 32 slots would not
# fit the card), 96 usable pages (fewer than 32 slots x 5 worst-case pages).
PAGED_ARGS = SERVE_ARGS + ["paged_attention=true", "pagedattn_tokens_per_page=128",
                           "max_target_length=32768", "pagedattn_num_pages=97"]

# File and line of the TPU kernel each CUDA kernel replaces (JAX package).
KERNELS = [
    dict(name="ragged_decode_attention", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/ragged_decode_attention.cuh",
         replaces="maxtext_indextts2_tpu/ops/ragged_decode_attention.py:373"),
    dict(name="paged_decode_attention", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/paged_decode_attention.cuh",
         replaces="maxtext_indextts2_tpu/ops/ragged_decode_attention.py:581"),
    dict(name="inplace_row_update", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/inplace_update.cu",
         replaces="maxtext_indextts2_tpu/ops/inplace_update.py:30"),
    dict(name="ada_rmsnorm", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/row_kernels.cuh",
         replaces="maxtext_indextts2_tpu/ops/ada_rmsnorm.py:57"),
    dict(name="row_quantize_int8", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/row_kernels.cuh",
         replaces="maxtext_indextts2_tpu/ops/quant_kernels.py:52"),
    dict(name="ada_rmsnorm_quantize", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/row_kernels.cuh",
         replaces="maxtext_indextts2_tpu/ops/quant_kernels.py:98"),
    dict(name="silu_mul_quantize", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/row_kernels.cuh",
         replaces="maxtext_indextts2_tpu/ops/quant_kernels.py:140"),
    dict(name="s2a_attention", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/s2a_attention.cu",
         replaces="maxtext_indextts2_tpu/ops/s2a_attention.py:81"),
    dict(name="flash_fwd", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/flash_attention.cuh",
         replaces="maxtext_indextts2_tpu/ops/flash_attention.py:165"),
    dict(name="flash_bwd_dq", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/flash_attention.cuh",
         replaces="maxtext_indextts2_tpu/ops/flash_attention.py:392"),
    dict(name="flash_bwd_dkv", route="cuda",
         source="maxtext_indextts2_tpu_torch/csrc/flash_attention.cuh",
         replaces="maxtext_indextts2_tpu/ops/flash_attention.py:426"),
]

# One decode step through the kernels against one through their plain
# versions, bfloat16 model, 20 layers: the attention outputs differ by at most
# one bfloat16 step (other summation order), which the layers above carry to
# logits of magnitude ~4 as a few bfloat16 steps (2**-6 each there).
TOL_PARITY_BF16_LOGITS = 0.125

# The TTS back end: 8 requests, prompts of 100-250 frames (padded to 256),
# targets of 200-500 frames (bucketed to 512), the config's sampler schedule.
BACKEND_REQUESTS = 8
BACKEND_SHAPE = (8, 256, 512)  # rows, prompt bucket, target bucket
# the bfloat16 serving mode runs float32 products: two steps per quantizer there
BF16_TIMESTEPS = (2,) * 12

# One full-width denoiser forward through the row kernels against one through
# their plain versions, same weights and inputs, outputs of magnitude ~4.
# int8_offline (bfloat16 residual stream): the kernels sum the squares in
# another order, which can move a row's bfloat16 rsqrt factor or an int8 code
# by one step; 16 layers may carry that to a few bfloat16 steps (2**-5 each
# at that magnitude: 4 steps at most, and 0.005 on average). bfloat16 mode
# (float32 stream, bfloat16 attention):
# float32 last-bit differences that the bfloat16 rounding of a logit can lift
# to 2**-8 of it.
TOL_BACKEND_INT8_MAX, TOL_BACKEND_INT8_MEAN = 0.125, 0.005
TOL_BACKEND_BF16_MODE = 2e-2
# AdaptiveRMSNorm alone, kernels against plain versions, |y| <= ~8: one
# bfloat16 step there where a row's rsqrt factor straddles a rounding boundary
# (float32 rows differ by a few float32 steps only).
TOL_NORM_MODULE = 2.0 ** -5
# The 2-layer float32 sampler, kernels against plain versions, the same
# injected noise: a float32 last-bit difference flips an argmax only when two
# candidates tie to ~1e-6, so nearly every code is equal; where all are, the
# waveforms agree to 1e-3 of the largest sample (both take the same vocoder path).
MIN_BACKEND_F32_CODE_AGREEMENT = 0.995
TOL_BACKEND_F32_WAV = 1e-3

# The whole pipeline: `synthesize` with a 3-s prompt and 256 target frames;
# /tts with 8 concurrent requests, prompts of 3-6 s, texts of 40-160 bytes,
# 200-500 frames each (force_frames), one batch.
SYNTH_PROMPT_SECONDS, SYNTH_FRAMES = 3.0, 256
HTTP_REQUESTS = 8
# K12 against its plain version inside one full-width conditional forward of
# the fixed-length sampler (`all_valid`, [1, P + T, 1024], 16 layers).
# (a) Every K12 call of the kernel route against the plain version on the
# same q, k, v (the model's own tensors): K12's case tolerances, one bfloat16
# step at |o| <= 2 and float32 summation order.
TOL_K12_IN_MODEL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# (b) The forward's output, kernel route against plain route. float32: the
# layers carry K12's last-bit differences on, atol 1e-3 at |y| ~5.
# int8_offline (the served model): where the routes' attention outputs differ
# by one bfloat16 step, the next int8 product's row scale or codes can move by
# one step, and 16 layers of random weights spread that over every row: the
# routes then differ like two int8 roundings of one forward (measured on an
# H100: max 0.21, mean 0.034 at |y| ~5). Bound: max 0.5, mean 0.05; a wrong
# attention moves the mean by the outputs' own scale (~1).
TOL_SYNTH_INT8_MAX, TOL_SYNTH_INT8_MEAN = 0.5, 0.05
TOL_SYNTH_F32 = 1e-3
# The prompt's ids on the card against the same module on the CPU (float32,
# TF32 off on the card): a float32 last-bit difference flips an argmax only
# between near-equal candidates, and a flipped RVQ stage changes the stages
# after it at that frame: at least 0.9 of the ids equal.
MIN_FRONTEND_ID_AGREEMENT = 0.9

# Training: the JAX package's committed 1B recipe (configs/perf/v5e/tts_1b.sh)
# without its TPU tiling flash_block_sizes, through the training entry point.
TRAIN_STEPS = 5
TRAIN_ARGS = [
    TTS_1B, "dataset_type=synthetic", "per_device_batch_size=4",
    "remat_policy=save_attn_and_mlp", "attention=flash", "weight_dtype=bfloat16",
    "scan_layers=false", "cast_logits_to_fp32=false", f"steps={TRAIN_STEPS}",
]
# Launches a step, read from the code before the first run (PERF.md): every
# layer's attention region is recomputed in the backward (no remat anchor
# holds the flash kernel's residuals), so K9 runs twice a layer; K10 and K11
# once a layer.
TRAIN_LAUNCHES_PER_LAYER = {"flash_fwd": 2, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
TRAIN_MAX_PEAK_BYTES = 40e9
# One 2-layer float32 step at full width, kernel route against plain route, the
# same weights and batch (TF32 off). Both routes run the same float32
# arithmetic; only the attention's sums run in another order (~1e-6 relative
# of each row), which the softmax backward and two layers carry to ~1e-5 of a
# gradient: the loss within 1e-4 (values ~9), the global grad norm within
# 1e-4 relative, every gradient within 1e-3 of its own largest entry. A wrong
# mask, scale or group sum moves them by their own size.
TOL_TRAIN_LOSS, TOL_TRAIN_GRAD_NORM_REL, TOL_TRAIN_GRAD_REL = 1e-4, 1e-4, 1e-3


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
    out = {"cache": [[c.clone() for c in unit] for unit in state["cache"]],
           "tokens": state["tokens"].clone(), "pos": state["pos"].clone(),
           "active": state["active"].clone()}
    if "page_state" in state:
        out["page_state"] = type(state["page_state"])(*(t.clone() for t in state["page_state"]))
    return out


def _parity_admissions(engine, state, prompts):
    """Two packed admissions of four prompts each into the even slots 0-14,
    then three decode steps: the populated state of both parity phases."""
    for i in (0, 4):
        state, _ = engine.prefill_insert_many(
            state, prompts[i:i + 4], [2 * j for j in range(i, i + 4)])
    state, _ = engine.generate_n(state, 3)
    return state


PARITY_PROMPT_LENGTHS = (5, 64, 130, 17, 250, 33, 120, 96)


def phase_serve_parity(engine):
    """The kernels inside the model against their plain versions."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine

    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    vocab = engine.cfg.vocab_size
    # (a) the bfloat16 20-layer model: one step from one populated state
    prompts = [rng.integers(1, vocab, size=int(n)).astype(np.int32)
               for n in PARITY_PROMPT_LENGTHS]
    state = _parity_admissions(engine, engine.init_decode_state(), prompts)
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
    server, orch, _ = make_server(engine.cfg, port=0, engine=engine, host="127.0.0.1")
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


def phase_serve_paged():
    """The main path of this slice: ``tts-1b`` at full width behind the
    Orchestrator with a paged KV cache, the serve phase's 80 requests."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.infer.server import Orchestrator

    t0 = time.perf_counter()
    cfg = load_config(PAGED_ARGS)
    engine = Engine(cfg)  # no device given: the GPU, or an error
    engine.load_params()
    prompts, budgets = make_requests(np.random.default_rng(0), cfg.vocab_size)
    orch = Orchestrator(engine, steps_per_dispatch=STEPS_PER_DISPATCH)
    held_back = set()  # requests the page reservations kept waiting at the head of the line
    can_admit = orch._can_admit

    def counted_can_admit(req):
        ok = can_admit(req)
        if not ok:
            held_back.add(id(req))
        return ok

    orch._can_admit = counted_can_admit
    orch.start()
    pools = [c for unit in orch.decode_state["cache"] for c in unit]
    pool_bytes = sum(p.key_pages.nbytes + p.value_pages.nbytes for p in pools)
    # what a dense cache of this configuration would hold (not allocated)
    dense_bytes = (engine.num_slots * cfg.max_target_length * cfg.num_decoder_layers
                   * cfg.num_kv_heads * cfg.head_dim * 2 * pools[0].key_pages.element_size())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()  # every count to 0 just before the main path, read just after
    t1 = time.perf_counter()
    reqs = [orch.submit(p, n) for p, n in zip(prompts, budgets)]
    most_active, deadline = 0, time.monotonic() + 600
    while not all(r.done.is_set() for r in reqs) and time.monotonic() < deadline:
        most_active = max(most_active, orch.active_slots())
        time.sleep(0.005)
    finished = all(r.done.is_set() for r in reqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    orch.stop()
    launches = _all_counts()

    check(finished, "serve_paged: a request did not finish in 600 s")
    errors = [r.error for r in reqs if r.error]
    check(not errors, f"serve_paged: {len(errors)} requests failed, first: {errors[:1]}")
    check(all(len(r.tokens) == n for r, n in zip(reqs, budgets)),
          "serve_paged: a request did not get exactly its token budget")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens),
          "serve_paged: a token outside [0, vocab)")
    steps = orch.stats["decode_steps_total"]
    layers = cfg.num_decoder_layers
    want = {k: 0 for k in launches}
    want["paged_decode_attention"] = layers * steps
    check(steps > 0 and launches == want,
          f"serve_paged: kernel launches {launches} != expected {want} ({steps} decode steps)")
    ps = orch.decode_state["page_state"]
    free = int((ps.page_status == 0).sum().item())
    check(int(orch._pages_reserved.sum()) == 0 and free == cfg.pagedattn_num_pages - 1
          and int(ps.seq_lens.abs().sum().item()) == 0,
          f"serve_paged: pages not all back ({int(orch._pages_reserved.sum())} reserved, "
          f"{free} of {cfg.pagedattn_num_pages - 1} free)")
    worst = max(orch._pages_needed(r) for r in reqs)
    tokens = sum(len(r.tokens) for r in reqs)
    emit("serve_paged", t0, requests=len(reqs), tokens=tokens, serve_seconds=seconds,
         tokens_per_s=tokens / seconds, decode_steps=steps,
         admission_dispatches=orch.stats["admission_dispatches_total"],
         most_active_slots_seen=most_active, requests_held_back_for_pages=len(held_back),
         slots=engine.num_slots,
         usable_pages=cfg.pagedattn_num_pages - 1, worst_request_pages=worst,
         tokens_per_page=cfg.pagedattn_tokens_per_page, context=cfg.max_target_length,
         launches=launches, distinct_tokens=len({t for r in reqs for t in r.tokens}),
         pool_bytes=pool_bytes, dense_cache_bytes_not_allocated=dense_bytes,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return engine, launches["paged_decode_attention"]


def phase_serve_paged_parity(engine):
    """K4 inside the model against its plain version; paged streams against
    the dense ones."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.ops import ragged_decode_attention as rda

    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    vocab = engine.cfg.vocab_size
    prompts = [rng.integers(1, vocab, size=int(n)).astype(np.int32)
               for n in PARITY_PROMPT_LENGTHS]
    # (a) the bfloat16 20-layer paged model: one step from one populated state
    state = _parity_admissions(engine, engine.init_decode_state(), prompts)
    twin = _clone_state(state)
    _reset_all_counts()
    _, logits_kernel = engine._generate_step(state)
    torch.cuda.synchronize()
    k4_step = rda.paged_launch_count
    _, logits_plain = engine._generate_step(twin, impl="plain")
    torch.cuda.synchronize()
    check(k4_step == engine.cfg.num_decoder_layers and rda.paged_launch_count == k4_step,
          f"serve_paged_parity: K4 ran {k4_step} times in the kernel step, "
          f"{rda.paged_launch_count - k4_step} in the plain step")
    active = state["active"]
    err = float((logits_kernel[active] - logits_plain[active]).abs().max().item())
    finite = bool(torch.isfinite(logits_kernel).all().item())
    scale = float(logits_plain[active].abs().max().item())
    check(finite and err <= TOL_PARITY_BF16_LOGITS,
          f"serve_paged_parity: bfloat16 logits differ by {err} > {TOL_PARITY_BF16_LOGITS}")
    del state, twin

    # (b) full width, 4 layers, float32: paged-K4, paged-plain and dense-K1
    # give identical greedy streams
    common = [TTS_1B, "dtype=float32", "base_num_decoder_layers=4", "per_device_batch_size=8",
              "max_prefill_predict_length=1024", "scan_layers=false"]
    paged = Engine(load_config(common + ["paged_attention=true", "pagedattn_tokens_per_page=16",
                                         "pagedattn_num_pages=400"]))
    paged.load_params()
    dense = Engine(load_config(common + ["decode_attention=ragged"]))
    dense.set_params(paged.params)
    streams, counts = {}, {}
    for name, eng, impl in (("paged_k4", paged, None), ("paged_plain", paged, "plain"),
                            ("dense_k1", dense, None)):
        st = eng.init_decode_state()
        st, first = eng.prefill_insert_many(st, prompts[:4], [0, 1, 2, 3])
        st, second = eng.prefill_insert_many(st, prompts[4:], [4, 5, 6, 7])
        _reset_all_counts()
        st, toks = eng.generate_n(st, 31, impl=impl)
        torch.cuda.synchronize()
        counts[name] = {k: v for k, v in _all_counts().items() if v}
        streams[name] = torch.cat([torch.cat([first, second])[None], toks]).cpu().numpy()
        del st
    same = all(bool((streams[n] == streams["dense_k1"]).all()) for n in streams)
    check(streams["paged_k4"].shape == (32, 8) and same,
          "serve_paged_parity: float32 greedy streams of paged-K4, paged-plain and dense-K1 differ")
    check(counts["paged_k4"] == {"paged_decode_attention": 4 * 31} and not counts["paged_plain"],
          f"serve_paged_parity: launches {counts}")
    emit("serve_paged_parity", t0, bf16_logits_max_abs_err=err, tol=TOL_PARITY_BF16_LOGITS,
         bf16_logits_max_abs=scale, f32_streams_identical=same,
         f32_tokens_compared=int(streams["paged_k4"].size),
         f32_distinct_tokens=int(len(np.unique(streams["paged_k4"]))), launches=counts)


def _reset_row_kernel_counts():
    from maxtext_indextts2_tpu_torch.ops import ada_rmsnorm, quant_kernels

    ada_rmsnorm.launch_count = 0
    for name in quant_kernels.launch_counts:
        quant_kernels.launch_counts[name] = 0


def _row_kernel_counts() -> dict:
    from maxtext_indextts2_tpu_torch.ops import ada_rmsnorm, quant_kernels

    return {"ada_rmsnorm": ada_rmsnorm.launch_count, **quant_kernels.launch_counts}


def _denoiser_forwards(pipe) -> int:
    """Denoiser forwards of one sampler pass over prompted rows: one per
    step, two while classifier-free guidance is on."""
    cfg = pipe.cfg
    q = pipe.s2a.cfg.num_quantizers
    total = 0
    for steps in tuple(cfg.s2a_timesteps)[:q]:
        with_cfg = 0
        if cfg.s2a_cfg_scale > 0:
            with_cfg = min(steps, int(np.ceil(cfg.s2a_cfg_until * steps)))
        total += steps + with_cfg
    return total


def _serve_backend(pipe, phase, t0, want_per_forward):
    """One ``s2a_vocoder_batch`` call for 8 seeded requests, with the row
    kernels' launch counts set to 0 just before and read just after. The call
    returns waveforms only, so the acoustic codes are checked on a second
    sampling of the same batch from the same seed, after the counts are read."""
    from maxtext_indextts2_tpu_torch.audio.pipeline import backend_requests

    c = pipe.s2a.cfg
    requests, sems, acs, gens = backend_requests(
        0, BACKEND_REQUESTS, c.cond_codebook_size, c.codebook_size, c.num_quantizers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_row_kernel_counts()
    t1 = time.perf_counter()
    out = pipe.s2a_vocoder_batch(requests, sems, acs, gens, pad_to_batch=BACKEND_SHAPE[0],
                                 length_bucket=64)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    launches = _row_kernel_counts()

    hop = int(np.prod(pipe.codec.strides))
    codes = pipe._sample_codes(sems, acs, gens, None, 64, BACKEND_SHAPE[0], None, None)
    codes = codes[:BACKEND_REQUESTS]
    rewav = pipe.codec.detokenize(codes.permute(2, 0, 1)).float().cpu().numpy()
    peak = max(float(np.abs(w).max()) for w, _ in out)
    resampled_err = max(float(np.abs(w - rewav[i, :len(w)]).max()) for i, (w, _) in enumerate(out))
    check(len(out) == BACKEND_REQUESTS, f"{phase}: {len(out)} waveforms for 8 requests")
    check(tuple(codes.shape) == (BACKEND_REQUESTS, BACKEND_SHAPE[2], c.num_quantizers),
          f"{phase}: acoustic codes of shape {tuple(codes.shape)}")
    check(0 <= int(codes.min()) and int(codes.max()) < c.codebook_size,
          f"{phase}: an acoustic code outside [0, {c.codebook_size})")
    for (wav, info), gen in zip(out, gens):
        check(wav.shape == (len(gen) * hop,) and info["semantic_tokens"] == len(gen),
              f"{phase}: a waveform of {wav.shape} for {len(gen)} frames")
        check(bool(np.isfinite(wav).all()) and float(wav.std()) > 0,
              f"{phase}: a waveform that is not finite or is constant")
    forwards = _denoiser_forwards(pipe)
    want = {k: n * forwards for k, n in want_per_forward.items()}
    check(launches == want, f"{phase}: kernel launches {launches} != expected {want} "
                            f"({forwards} denoiser forwards)")
    audio = sum(info["audio_seconds"] for _, info in out)
    emit(phase, t0, requests=len(out), serving_dtype=pipe.cfg.s2a_serving_dtype,
         timesteps=list(pipe.cfg.s2a_timesteps), denoiser_forwards=forwards,
         denoiser_shape=[BACKEND_SHAPE[0], BACKEND_SHAPE[1] + BACKEND_SHAPE[2], c.hidden_size],
         call_seconds=seconds, sampler_seconds=out[0][1]["t_s2a"],
         vocoder_seconds=out[0][1]["t_vocoder"], audio_seconds=audio,
         gpu_seconds_per_audio_second=seconds / audio, launches=launches,
         distinct_codes=int(codes.unique().numel()),
         resampled_wav_max_err_of_peak=resampled_err / peak,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return launches


def phase_tts_backend():
    """The second main path: the TTS back end at full width, ``int8_offline``."""
    from maxtext_indextts2_tpu_torch.audio.pipeline import build_backend

    t0 = time.perf_counter()
    pipe = build_backend("int8_offline")  # no device given: the GPU, or an error
    layers = pipe.s2a.cfg.num_layers
    emit("tts_backend_load", t0, s2a_params=sum(p.numel() for p in pipe.s2a.parameters()),
         codec_params=sum(p.numel() for p in pipe.codec.parameters()), s2a_layers=layers,
         hidden=pipe.s2a.cfg.hidden_size, device=str(pipe.device))
    per_forward = {"ada_rmsnorm": 1, "row_quantize_int8": layers,
                   "ada_rmsnorm_quantize": 2 * layers, "silu_mul_quantize": layers}
    return pipe, _serve_backend(pipe, "tts_backend", t0, per_forward)


def phase_tts_backend_bf16():
    """The same batch served as ``bfloat16``: every norm is ``ada_rmsnorm``."""
    from maxtext_indextts2_tpu_torch.audio.pipeline import build_backend

    t0 = time.perf_counter()
    pipe = build_backend("bfloat16", timesteps=BF16_TIMESTEPS)
    per_forward = {"ada_rmsnorm": 2 * pipe.s2a.cfg.num_layers + 1, "row_quantize_int8": 0,
                   "ada_rmsnorm_quantize": 0, "silu_mul_quantize": 0}
    _serve_backend(pipe, "tts_backend_bf16", t0, per_forward)
    return pipe


def _denoiser_parity(pipe, seed):
    """One full-width conditional forward at the main path's shape: kernels
    against plain versions. Returns (max, mean) absolute difference and the
    largest output magnitude."""
    c = pipe.s2a.cfg
    b, s = BACKEND_SHAPE[0], BACKEND_SHAPE[1] + BACKEND_SHAPE[2]
    g = torch.Generator(device=pipe.device).manual_seed(seed)
    x = torch.randn((b, s, c.hidden_size), generator=g, device=pipe.device).to(c.dtype)
    cond = torch.randn((b, s, c.hidden_size), generator=g, device=pipe.device).to(c.dtype)
    t = torch.rand((b,), generator=g, device=pipe.device)
    pad = torch.ones((b, s), dtype=torch.int32, device=pipe.device)
    pad[1, 600:] = 0
    pad[7, 1:] = 0  # a dummy row
    _reset_row_kernel_counts()
    with torch.no_grad():
        got = pipe.s2a.denoiser(x, t, cond, pad).float()
        launched = _row_kernel_counts()
        want = pipe.s2a.denoiser(x, t, cond, pad, impl="plain").float()
    torch.cuda.synchronize()
    check(sum(launched.values()) > 0 and _row_kernel_counts() == launched,
          f"tts_backend_parity: the plain route launched a kernel, or the kernel route none "
          f"({launched} -> {_row_kernel_counts()})")
    valid = pad.bool()
    diff = (got - want).abs()[valid]
    check(bool(torch.isfinite(got[valid]).all().item()), "tts_backend_parity: output not finite")
    return float(diff.max().item()), float(diff.mean().item()), float(want[valid].abs().max().item())


def _norm_module_shapes(pipe):
    """``AdaptiveRMSNorm`` on the shapes the denoiser never gives it (x [B,D];
    a condition per position): the kernels again, never the plain versions."""
    norm = pipe.s2a.denoiser.final_norm
    h = pipe.s2a.cfg.hidden_size
    g = torch.Generator(device=pipe.device).manual_seed(14)
    kind = norm.to_weight.kernel.dtype
    worst = 0.0
    for x_shape, cond_shape in (((48, h), (48, h)), ((4, 37, h), (4, 37, h))):
        x = torch.randn(x_shape, generator=g, device=pipe.device).to(kind)
        cond = torch.randn(cond_shape, generator=g, device=pipe.device).to(kind)
        _reset_row_kernel_counts()
        with torch.no_grad():
            y, (q, sc) = norm(x, cond), norm(x, cond, quantize_out=True)
            launched = _row_kernel_counts()
            y_p, (q_p, sc_p) = norm(x, cond, impl="plain"), norm(x, cond, True, impl="plain")
        torch.cuda.synchronize()
        check(launched["ada_rmsnorm"] == 1 and launched["ada_rmsnorm_quantize"] == 1
              and _row_kernel_counts() == launched,
              f"tts_backend_parity: AdaptiveRMSNorm on x {x_shape} launched {launched}")
        err = float((y.float() - y_p.float()).abs().max().item())
        steps = int((q.int() - q_p.int()).abs().max().item())
        check(y.shape == x.shape and q.shape == x.shape and sc.shape == x.shape[:-1]
              and err <= TOL_NORM_MODULE and steps <= 1
              and torch.allclose(sc, sc_p, rtol=2.0 ** -7),
              f"tts_backend_parity: AdaptiveRMSNorm on x {x_shape} differs by {err}, {steps} steps")
        worst = max(worst, err)
    return worst


def phase_tts_backend_parity(pipe_int8, pipe_bf16):
    """The row kernels inside the denoiser and the sampler against their
    plain versions."""
    from maxtext_indextts2_tpu_torch.audio.pipeline import backend_requests, build_backend

    t0 = time.perf_counter()
    i8_max, i8_mean, i8_scale = _denoiser_parity(pipe_int8, 11)
    check(i8_max <= TOL_BACKEND_INT8_MAX and i8_mean <= TOL_BACKEND_INT8_MEAN,
          f"tts_backend_parity: int8_offline forward differs by max {i8_max}, mean {i8_mean}")
    bf_max, bf_mean, bf_scale = _denoiser_parity(pipe_bf16, 12)
    check(bf_max <= TOL_BACKEND_BF16_MODE,
          f"tts_backend_parity: bfloat16-mode forward differs by {bf_max}")

    norm_err = max(_norm_module_shapes(pipe_int8), _norm_module_shapes(pipe_bf16))

    # the dynamic int8 mode (float kernels quantized on every call), 2 layers
    dyn_max, dyn_mean, _ = _denoiser_parity(build_backend("int8", layers=2), 13)
    check(dyn_max <= TOL_BACKEND_INT8_MAX and dyn_mean <= TOL_BACKEND_INT8_MEAN,
          f"tts_backend_parity: int8 (dynamic) forward differs by max {dyn_max}, mean {dyn_mean}")

    # 2 layers, float32, full width: the whole call with the same injected noise
    pipe = build_backend("float32", layers=2, timesteps=(3,) + (2,) * 11)
    c = pipe.s2a.cfg
    requests, sems, acs, gens = backend_requests(
        3, 4, c.cond_codebook_size, c.codebook_size, c.num_quantizers, prompt=(40, 90),
        target=(60, 120))

    def noise(layer, step, draw, shape):
        g = torch.Generator(device=pipe.device).manual_seed(layer * 1000 + step * 10 + draw)
        return torch.rand(shape, generator=g, device=pipe.device) * (1.0 - 1e-9) + 1e-9

    runs = []
    for impl in (None, "plain"):
        out = pipe.s2a_vocoder_batch(requests, sems, acs, gens, length_bucket=64, noise=noise,
                                     impl=impl)
        codes = pipe._sample_codes(sems, acs, gens, None, 64, len(requests), noise, impl)
        runs.append((codes.cpu().numpy(), [w for w, _ in out]))
    valid = np.arange(runs[0][0].shape[1])[None, :] < np.array([len(g) for g in gens])[:, None]
    agree = float((runs[0][0] == runs[1][0])[valid].mean())
    check(agree >= MIN_BACKEND_F32_CODE_AGREEMENT,
          f"tts_backend_parity: float32 codes of the two routes agree only to {agree}")
    wav_err = None
    if agree == 1.0:
        peak = max(float(np.abs(w).max()) for w in runs[1][1])
        wav_err = max(float(np.abs(a - b).max()) for a, b in zip(*[r[1] for r in runs])) / peak
        check(wav_err <= TOL_BACKEND_F32_WAV,
              f"tts_backend_parity: float32 waveforms differ by {wav_err} of the peak")
    emit("tts_backend_parity", t0, int8_offline_max_abs_err=i8_max,
         int8_offline_mean_abs_err=i8_mean, int8_offline_max_abs=i8_scale,
         tol_int8_offline=[TOL_BACKEND_INT8_MAX, TOL_BACKEND_INT8_MEAN],
         int8_dynamic_2_layers_max_abs_err=dyn_max, int8_dynamic_2_layers_mean_abs_err=dyn_mean,
         bf16_mode_max_abs_err=bf_max, bf16_mode_mean_abs_err=bf_mean, bf16_mode_max_abs=bf_scale,
         tol_bf16_mode=TOL_BACKEND_BF16_MODE, norm_module_other_shapes_max_abs_err=norm_err,
         tol_norm_module=TOL_NORM_MODULE, f32_code_agreement=agree,
         f32_codes_compared=int(valid.sum()) * c.num_quantizers,
         tol_f32_code_agreement=MIN_BACKEND_F32_CODE_AGREEMENT,
         f32_wav_max_err_of_peak=wav_err, tol_f32_wav=TOL_BACKEND_F32_WAV)


def _k12_count() -> int:
    from maxtext_indextts2_tpu_torch.ops import s2a_attention

    return s2a_attention.launch_count


def _reset_all_counts():
    from maxtext_indextts2_tpu_torch.ops import (
        flash_attention, inplace_update, ragged_decode_attention, s2a_attention,
    )

    _reset_row_kernel_counts()
    ragged_decode_attention.launch_count = inplace_update.launch_count = 0
    ragged_decode_attention.paged_launch_count = 0
    s2a_attention.launch_count = 0
    for name in flash_attention.launch_counts:
        flash_attention.launch_counts[name] = 0


def _all_counts() -> dict:
    from maxtext_indextts2_tpu_torch.ops import (
        flash_attention, inplace_update, ragged_decode_attention,
    )

    return {"ragged_decode_attention": ragged_decode_attention.launch_count,
            "paged_decode_attention": ragged_decode_attention.paged_launch_count,
            "inplace_row_update": inplace_update.launch_count, **_row_kernel_counts(),
            "s2a_attention": _k12_count(), **flash_attention.launch_counts}


NO_FLASH = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
NO_PAGED = {"paged_decode_attention": 0}


def _audio_only_lm(pipe):
    """Zero the LM's output columns of every id that is not an audio token,
    so that greedy decoding with random weights emits audio tokens only."""
    e2a = pipe.mapping.embedding_to_audio_array(pipe.cfg.vocab_size)
    not_audio = torch.from_numpy((e2a < 0) | (e2a >= pipe.mapping.codebook_size))
    with torch.no_grad():
        pipe.engine.model.logits_dense.kernel[:, not_audio.to(pipe.device)] = 0


def phase_pipeline_load():
    from maxtext_indextts2_tpu_torch.audio.pipeline import build_pipeline

    t0 = time.perf_counter()
    pipe = build_pipeline("int8_offline")  # no device given: the GPU, or an error
    _audio_only_lm(pipe)
    torch.cuda.synchronize()
    enc = pipe.semantic_tokenizer.encoder_cfg
    emit("pipeline_load", t0, lm_params=sum(p.numel() for p in pipe.engine.model.parameters()),
         semantic_tokenizer_params=sum(p.numel() for p in pipe.semantic_tokenizer.parameters()),
         s2a_params=sum(p.numel() for p in pipe.s2a.parameters()),
         codec_params=sum(p.numel() for p in pipe.codec.parameters()),
         conformer=[enc.hidden_size, enc.num_heads, enc.intermediate_size, enc.conv_kernel_size,
                    enc.output_layer], slots=pipe.engine.num_slots,
         tf32={"cudnn": torch.backends.cudnn.allow_tf32,
               "matmul": torch.backends.cuda.matmul.allow_tf32})
    return pipe


def phase_tts_synthesize(pipe):
    """The main path of this slice: one request through ``synthesize``; its
    fixed-length sampler runs every denoiser attention through K12."""
    from maxtext_indextts2_tpu_torch.audio.pipeline import prompt_signal

    t0 = time.perf_counter()
    w16 = prompt_signal(40, SYNTH_PROMPT_SECONDS, 16_000)
    w24 = prompt_signal(40, SYNTH_PROMPT_SECONDS, 24_000)
    text = "A zero-shot voice reads this sentence aloud on the card."
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    t1 = time.perf_counter()
    wav, info = pipe.synthesize(text, w16, w24, max_new_tokens=SYNTH_FRAMES)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    launches = _all_counts()

    c = pipe.s2a.cfg
    forwards = _denoiser_forwards(pipe)
    hop = int(np.prod(pipe.codec.strides))
    check(info["semantic_tokens"] == SYNTH_FRAMES,
          f"tts_synthesize: {info['semantic_tokens']} frames for max_new_tokens={SYNTH_FRAMES}")
    check(wav.shape == (SYNTH_FRAMES * hop,) and bool(np.isfinite(wav).all())
          and float(wav.std()) > 0, f"tts_synthesize: a waveform of {wav.shape}, not finite "
                                    "or constant")
    want_k12 = c.num_layers * forwards
    check(launches["s2a_attention"] == want_k12,
          f"tts_synthesize: s2a_attention launched {launches['s2a_attention']} times, predicted "
          f"{want_k12} ({c.num_layers} layers x {forwards} denoiser forwards)")
    layers = pipe.engine.cfg.num_decoder_layers
    want = {"ragged_decode_attention": layers * (SYNTH_FRAMES - 1),
            "inplace_row_update": 2 * layers * (SYNTH_FRAMES - 1),
            "ada_rmsnorm": forwards, "row_quantize_int8": c.num_layers * forwards,
            "ada_rmsnorm_quantize": 2 * c.num_layers * forwards,
            "silu_mul_quantize": c.num_layers * forwards, "s2a_attention": want_k12,
            **NO_FLASH, **NO_PAGED}
    check(launches == want, f"tts_synthesize: launches {launches} != predicted {want}")
    emit("tts_synthesize", t0, call_seconds=seconds, info=info, denoiser_forwards=forwards,
         prompt_seconds=SYNTH_PROMPT_SECONDS, launches=launches,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return launches


def _k12_forward_parity(s2a, seed):
    """One conditional denoiser forward at the ``synthesize`` shape with every
    key valid, the kernel route against the plain route; in the kernel route
    each K12 output is also held against the plain version on the same
    q, k, v. Returns the forward's (max, mean) absolute difference, its
    largest output, the largest in-model K12 difference and K12's launches in
    the kernel route (the plain route must launch none)."""
    from maxtext_indextts2_tpu_torch.audio import s2a as s2a_mod
    from maxtext_indextts2_tpu_torch.ops.s2a_attention import s2a_attention_plain

    c = s2a.cfg
    s = 149 + SYNTH_FRAMES  # P + T of the synthesize phase
    device = s2a.mask_emb.device
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((1, s, c.hidden_size), generator=g, device=device).to(c.dtype)
    cond = torch.randn((1, s, c.hidden_size), generator=g, device=device).to(c.dtype)
    t = torch.rand((1,), generator=g, device=device)
    ones = torch.ones((1, s), dtype=torch.int32, device=device)
    kernel, in_model = s2a_mod.s2a_attention, []

    def compared(q, k, v, impl=None):
        o = kernel(q, k, v, impl=impl)
        if impl is None:
            err = (o.float() - s2a_attention_plain(q, k, v).float()).abs().max()
            in_model.append((float(err.item()), TOL_K12_IN_MODEL[q.dtype]))
        return o

    _reset_all_counts()
    s2a_mod.s2a_attention = compared
    try:
        with torch.no_grad():
            got = s2a.denoiser(x, t, cond, ones, all_valid=True).float()
            launched = _k12_count()
            want = s2a.denoiser(x, t, cond, ones, impl="plain", all_valid=True).float()
    finally:
        s2a_mod.s2a_attention = kernel
    torch.cuda.synchronize()
    check(launched == c.num_layers and _k12_count() == launched,
          f"tts_synthesize_parity: K12 launched {launched} times in the kernel route "
          f"(want {c.num_layers}), {_k12_count() - launched} in the plain route")
    check(len(in_model) == c.num_layers and all(e <= tol for e, tol in in_model),
          f"tts_synthesize_parity: K12 inside the model against its plain version: {in_model}")
    check(bool(torch.isfinite(got).all().item()), "tts_synthesize_parity: output not finite")
    diff = (got - want).abs()
    return (float(diff.max().item()), float(diff.mean().item()), float(want.abs().max().item()),
            max(e for e, _ in in_model), launched)


def phase_tts_synthesize_parity(pipe):
    """K12 inside full-width conditional denoiser forwards against the plain
    route, and the prompt tokenizers on the card against the CPU."""
    from maxtext_indextts2_tpu_torch.audio.pipeline import build_serving_s2a, s2a_config_from

    t0 = time.perf_counter()
    c = pipe.s2a.cfg
    err, mean, scale, k12_err, k12_kernel = _k12_forward_parity(pipe.s2a, 15)
    check(err <= TOL_SYNTH_INT8_MAX and mean <= TOL_SYNTH_INT8_MEAN,
          f"tts_synthesize_parity: int8_offline all_valid forward differs by max {err}, "
          f"mean {mean}")
    f32 = build_serving_s2a(s2a_config_from(pipe.cfg), "float32", device=pipe.device,
                            generator=torch.Generator(device=pipe.device).manual_seed(16))
    f32_err, f32_mean, f32_scale, f32_k12_err, _ = _k12_forward_parity(f32, 16)
    check(f32_err <= TOL_SYNTH_F32,
          f"tts_synthesize_parity: float32 all_valid forward differs by {f32_err}")
    del f32
    torch.cuda.empty_cache()

    # the prompt tokenizers: the same modules and wav on the card and the CPU
    import copy

    from maxtext_indextts2_tpu_torch.audio.pipeline import prompt_signal

    w16 = prompt_signal(41, SYNTH_PROMPT_SECONDS, 16_000)
    w24 = prompt_signal(41, SYNTH_PROMPT_SECONDS, 24_000)
    sem_gpu, _ = pipe.semantic_tokenizer.tokenize(w16[None])
    ac_gpu = pipe.codec.tokenize(torch.from_numpy(w24[None]).to(pipe.device))
    tok_cpu = copy.deepcopy(pipe.semantic_tokenizer).to("cpu")
    enc_cpu = copy.deepcopy(pipe.codec.encoder).to("cpu")
    quant_cpu = copy.deepcopy(pipe.codec.decoder.quantizer).to("cpu")
    with torch.no_grad():
        sem_cpu, _ = tok_cpu.tokenize(w16[None])
        _, ac_cpu = quant_cpu.quantize(enc_cpu(torch.from_numpy(w24[None])))
    check(sem_gpu.shape == sem_cpu.shape and ac_gpu.shape == ac_cpu.shape,
          "tts_synthesize_parity: frontend ids of different shapes on the card and the CPU")
    sem_share = float((sem_gpu.cpu() == sem_cpu).float().mean().item())
    ac_share = float((ac_gpu.cpu() == ac_cpu).float().mean().item())
    check(min(sem_share, ac_share) >= MIN_FRONTEND_ID_AGREEMENT,
          f"tts_synthesize_parity: frontend ids agree only {sem_share} / {ac_share}")
    emit("tts_synthesize_parity", t0, denoiser_shape=[1, 149 + SYNTH_FRAMES, c.hidden_size],
         int8_offline_max_abs_err=err, int8_offline_mean_abs_err=mean, int8_offline_max_abs=scale,
         tol_int8_offline=[TOL_SYNTH_INT8_MAX, TOL_SYNTH_INT8_MEAN],
         int8_offline_k12_in_model_max_abs_err=k12_err,
         f32_max_abs_err=f32_err, f32_mean_abs_err=f32_mean, f32_max_abs=f32_scale,
         tol_f32=TOL_SYNTH_F32, f32_k12_in_model_max_abs_err=f32_k12_err,
         tol_k12_in_model={str(k): v for k, v in TOL_K12_IN_MODEL.items()},
         k12_launches_kernel_route=k12_kernel,
         semantic_ids=int(sem_cpu.numel()), semantic_ids_equal_share=sem_share,
         acoustic_ids=int(ac_cpu.numel()), acoustic_ids_equal_share=ac_share,
         min_id_agreement=MIN_FRONTEND_ID_AGREEMENT,
         tf32_in_force={"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32})


def _tts_bodies(seed: int):
    """``tts_requests`` as JSON bodies: the first with float32 base64 both
    ways, the others with JSON lists."""
    from maxtext_indextts2_tpu_torch.audio.pipeline import tts_requests

    bodies, seconds = [], []
    for i, r in enumerate(tts_requests(seed, HTTP_REQUESTS)):
        w16, w24 = r.pop("prompt_wav_16k"), r.pop("prompt_wav_24k")
        seconds.append(len(w16) / 16_000.0)
        if i == 0:
            r.update(prompt_wav_16k_b64=base64.b64encode(w16.astype("<f4").tobytes()).decode(),
                     prompt_wav_24k_b64=base64.b64encode(w24.astype("<f4").tobytes()).decode(),
                     wav_encoding="b64")
        else:
            r.update(prompt_wav_16k=w16.tolist(), prompt_wav_24k=w24.tolist())
        bodies.append(r)
    return bodies, [r["max_new_tokens"] for r in bodies], seconds


def phase_tts_http(pipe):
    """8 concurrent ``POST /tts`` at full width through ``make_server``: the
    batched path (masked sampler), so K12 must not launch."""
    from maxtext_indextts2_tpu_torch.infer.server import make_server

    t0 = time.perf_counter()
    cfg = dataclasses.replace(pipe.cfg, tts_allow_force_frames=True,
                              tts_batch_max=HTTP_REQUESTS, tts_batch_window_ms=2000)
    bodies, frames, prompt_seconds = _tts_bodies(60)
    payloads = [json.dumps(b).encode() for b in bodies]
    server, orch, batcher = make_server(cfg, port=0, tts_pipeline=pipe, host="127.0.0.1")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    answers = [None] * HTTP_REQUESTS

    def post(i):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/tts", data=payloads[i],
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=900) as resp:
            answers[i] = json.loads(resp.read())

    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_all_counts()
        t1 = time.perf_counter()
        posts = [threading.Thread(target=post, args=(i,)) for i in range(HTTP_REQUESTS)]
        for p in posts:
            p.start()
        for p in posts:
            p.join(timeout=900)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        launches = _all_counts()
        steps = orch.stats["decode_steps_total"]
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
        orch.stop()
        thread.join(timeout=30)

    check(all(a is not None and "error" not in a for a in answers),
          f"tts_http: failed answers {[a for a in answers if a is None or 'error' in a][:1]}")
    hop = int(np.prod(pipe.codec.strides))
    for i, (a, n) in enumerate(zip(answers, frames)):
        wav = (np.frombuffer(base64.b64decode(a["wav_b64"]), "<f4") if i == 0
               else np.asarray(a["wav"], np.float32))
        check(a["info"]["semantic_tokens"] == n and wav.shape == (n * hop,),
              f"tts_http: request {i} got {wav.shape} samples for {n} frames")
        check(bool(np.isfinite(wav).all()) and float(wav.std()) > 0,
              f"tts_http: request {i}'s waveform is not finite or is constant")
    info = answers[0]["info"]
    forwards = _denoiser_forwards(pipe) * batcher.batches
    c, layers = pipe.s2a.cfg, pipe.engine.cfg.num_decoder_layers
    want = {"ragged_decode_attention": layers * steps, "inplace_row_update": 2 * layers * steps,
            "ada_rmsnorm": forwards, "row_quantize_int8": c.num_layers * forwards,
            "ada_rmsnorm_quantize": 2 * c.num_layers * forwards,
            "silu_mul_quantize": c.num_layers * forwards, "s2a_attention": 0, **NO_FLASH,
            **NO_PAGED}
    check(launches == want, f"tts_http: launches {launches} != predicted {want} "
                            f"({steps} decode steps, {batcher.batches} batches)")
    audio = sum(n * hop for n in frames) / 24_000.0
    emit("tts_http", t0, requests=HTTP_REQUESTS, batches=batcher.batches, frames=frames,
         prompt_seconds=prompt_seconds, text_bytes=[len(b["text"]) for b in bodies],
         http_seconds=seconds, audio_seconds=audio, t_frontend=info["t_frontend"],
         t_lm=info["t_lm"], t_s2a=info["t_s2a"], t_vocoder=info["t_vocoder"],
         t_total=info["t_total"], batch_rtf=info["batch_rtf"], decode_steps=steps,
         launches=launches, peak_memory_bytes=torch.cuda.max_memory_allocated())


def phase_train():
    """The main path of this slice: the tts-1b recipe at full width through
    the training entry point; K9-K11 launch counts a step, losses, memory."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.models import Transformer
    from maxtext_indextts2_tpu_torch.train import train
    from maxtext_indextts2_tpu_torch.utils import flops

    t0 = time.perf_counter()
    cfg = load_config(TRAIN_ARGS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    out = train.main(list(TRAIN_ARGS))  # no device given: the GPU, or an error
    torch.cuda.synchronize()
    launches = _all_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    check(len(hist) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"train: losses {losses} over {len(hist)} of {TRAIN_STEPS} steps")
    check(losses[-1] < losses[0], f"train: the loss did not fall: {losses}")
    check(all(np.isfinite(h["grad_norm"]) for h in hist), "train: a grad norm is not finite")
    layers = cfg.num_decoder_layers
    want = {k: 0 for k in _all_counts()}
    want.update({k: n * layers * TRAIN_STEPS for k, n in TRAIN_LAUNCHES_PER_LAYER.items()})
    check(launches == want, f"train: launches {launches} != predicted {want} "
                            f"({TRAIN_STEPS} steps x {layers} layers)")
    check(peak < TRAIN_MAX_PEAK_BYTES, f"train: peak memory {peak / 1e9:.1f} GB")
    steady = hist[1:]  # the first step pays for the allocator's warm-up
    step_s = float(np.median([h["step_time_s"] for h in steady]))
    tflops = flops.training_tflops_per_step(cfg)
    emit("train", t0, steps=TRAIN_STEPS, losses=losses,
         grad_norms=[h["grad_norm"] for h in hist], param_norm=hist[-1]["param_norm"],
         step_seconds=[h["step_time_s"] for h in hist], median_step_seconds=step_s,
         tokens_per_step=cfg.global_batch_size_to_train_on * cfg.max_target_length,
         tokens_per_s=cfg.global_batch_size_to_train_on * cfg.max_target_length / step_s,
         tflops_per_step=tflops, mfu_at_989_tflops=flops.mfu(tflops, step_s),
         launches=launches, launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
         params=sum(p.numel() for p in Transformer(cfg, device="meta").parameters()),
         peak_memory_bytes=peak)
    return {k: launches[k] for k in TRAIN_LAUNCHES_PER_LAYER}


def phase_train_parity():
    """One 2-layer float32 step at full width: the kernel route against the
    plain route (the materialised flash-attention versions) from one set of
    seeded weights and one batch: loss, grad norm, every gradient."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.train import train

    t0 = time.perf_counter()
    cfg = load_config(TRAIN_ARGS + ["base_num_decoder_layers=2", "weight_dtype=float32",
                                    "dtype=float32"])
    state = train.setup_train_state(cfg)
    batch = next(train.create_data_iterator(cfg, state.device))
    names, leaves = list(state.params), list(state.params.values())
    out = {}
    for impl in (None, "plain"):
        _reset_all_counts()
        loss, _ = train.loss_fn(state.model, cfg, batch, impl=impl)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        out[impl] = (float(loss.detach()), grads, float(train._global_norm(grads)),
                     dict(_all_counts()))
    (loss_k, g_k, norm_k, n_k), (loss_p, g_p, norm_p, n_p) = out[None], out["plain"]
    want = {"flash_fwd": 2 * cfg.num_decoder_layers, "flash_bwd_dq": cfg.num_decoder_layers,
            "flash_bwd_dkv": cfg.num_decoder_layers}
    check({k: n_k[k] for k in want} == want and not any(n_p[k] for k in want),
          f"train_parity: kernel route launched {n_k}, plain route {n_p}")
    rel = {name: float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
           for name, a, b in zip(names, g_k, g_p)}
    worst = max(rel, key=rel.get)
    check(all(np.isfinite([loss_k, norm_k])), "train_parity: loss or grad norm not finite")
    check(abs(loss_k - loss_p) <= TOL_TRAIN_LOSS,
          f"train_parity: loss {loss_k} (kernels) vs {loss_p} (plain)")
    check(abs(norm_k - norm_p) <= TOL_TRAIN_GRAD_NORM_REL * norm_p,
          f"train_parity: grad norm {norm_k} (kernels) vs {norm_p} (plain)")
    check(rel[worst] <= TOL_TRAIN_GRAD_REL,
          f"train_parity: gradient {worst} differs by {rel[worst]:.3g} of its largest entry")
    emit("train_parity", t0, layers=cfg.num_decoder_layers, loss_kernels=loss_k,
         loss_plain=loss_p, grad_norm_kernels=norm_k, grad_norm_plain=norm_p,
         worst_grad=worst, worst_grad_rel_err=rel[worst], tol_grad_rel=TOL_TRAIN_GRAD_REL,
         grads_compared=len(rel), launches_kernel_route={k: n_k[k] for k in want})


def kernels_line(cases, launches):
    """The summary of every kernel on a main path: error, tolerance and times
    of the case at the shapes that path's run gives the kernel (the error in
    the case's ``unit``), and beside them the case of that kernel that came
    closest to its own tolerance."""
    from maxtext_indextts2_tpu_torch.ops.smoke import MAIN_PATH_CASES

    def err(c):  # the error in the case's unit: ``max_err`` where that is not output values
        return c.get("max_err", c["max_abs_err"])

    def closeness(c):
        return err(c) / c["tol"] if c["tol"] else err(c)

    out = []
    for k in KERNELS:
        main = cases[MAIN_PATH_CASES[k["name"]]]
        own = [c for c in cases.values() if c["kernel"] == k["name"]]
        worst = max(own, key=closeness)
        accuracy = {key: main[key] for key in ("mismatch_share", "scale_max_rel_err",
                                                "tol_scale_rel") if key in main}
        out.append(dict(
            k, launches=launches[k["name"]],
            max_abs_err=main["max_abs_err"], max_err=err(main), tol=main["tol"],
            unit=main.get("unit", "output values"), **accuracy,
            worst_case=dict(name=worst["name"], max_abs_err=worst["max_abs_err"],
                            max_err=err(worst), tol=worst["tol"],
                            unit=worst.get("unit", "output values")),
            ms=main["kernel_ms"], device_ms=main["device_ms"],
            plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], library_call=main.get("library_call"),
            bytes_moved=main["bytes_moved"],
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
    del engine
    # serve_paged's counting hook (orch._can_admit, a closure over orch) holds
    # what that phase built in a reference cycle, and a phase may leave others:
    # collect them, so that each phase's peak memory is its own
    gc.collect()
    torch.cuda.empty_cache()
    engine, launches["paged_decode_attention"] = phase_serve_paged()
    phase_serve_paged_parity(engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    pipe_int8, backend_launches = phase_tts_backend()
    launches.update(backend_launches)
    pipe_bf16 = phase_tts_backend_bf16()
    phase_tts_backend_parity(pipe_int8, pipe_bf16)
    del pipe_int8, pipe_bf16
    gc.collect()
    torch.cuda.empty_cache()
    pipe = phase_pipeline_load()
    launches["s2a_attention"] = phase_tts_synthesize(pipe)["s2a_attention"]
    phase_tts_synthesize_parity(pipe)
    phase_tts_http(pipe)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(phase_train())
    phase_train_parity()
    check(set(launches) == {k["name"] for k in KERNELS} and all(n > 0 for n in launches.values()),
          f"a kernel of a main path never ran: {launches}")
    emit("total", t_all)
    print(json.dumps(kernels_line(cases, launches)), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
