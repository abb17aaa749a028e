"""Inference microbenchmark: prefill latency by prompt length, the decode
step with every slot full, and a chunked prefill.

Counterpart of the JAX package's ``infer/microbenchmark.py``: the same JSON
document (``prefill_ms`` by length, ``decode`` with ``slots``, ``step_ms``,
``tokens_per_s``, ``per_stream_tokens_per_s``, and ``chunked_prefill_ms``).
Where the JAX module syncs by fetching a result to the host, this one waits
for the device with ``torch.cuda.synchronize``. The decode step is timed as
served: ``generate_n`` replays a captured CUDA graph (``infer/cuda_graphs.py``;
each depth's first dispatch, which captures, is the warm-up), and the slope
between 4 and 20 steps a dispatch cancels the fixed cost of a dispatch and
its copy of the tokens to the host.

Run::

    python -m maxtext_indextts2_tpu_torch.infer.microbenchmark <config.yml> [key=value ...] \\
        [device=cpu]

(the GPU unless ``device=cpu``; prints one JSON line).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from maxtext_indextts2_tpu_torch.config import Config, load_config
from maxtext_indextts2_tpu_torch.infer.engine import Engine


def _sync(engine: Engine, x=None):
    """Wait for the device's queued work (the JAX module's host fetch)."""
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return x


def run_microbenchmark(cfg: Config, engine: Engine | None = None, iters: int = 8,
                       device=None) -> dict:
    engine = engine or Engine(cfg, device=device)
    if engine.params is None:
        engine.load_params()

    results: dict = {"prefill_ms": {}, "decode": {}}
    rng = np.random.default_rng(0)

    # ---- prefill latency per prompt length
    for plen in cfg.inference_microbenchmark_prefill_lengths:
        if plen > cfg.max_prefill_predict_length:
            continue
        prompt = rng.integers(1, cfg.vocab_size, size=plen).astype(np.int32)
        prefix, first = engine.prefill(prompt, plen)  # warm-up
        _sync(engine)
        t0 = time.perf_counter()
        for _ in range(iters):
            prefix, first = engine.prefill(prompt, plen)
        _sync(engine)
        dt = (time.perf_counter() - t0) / iters
        results["prefill_ms"][str(plen)] = round(dt * 1e3, 3)

    # ---- decode throughput with full slots
    state = engine.init_decode_state()
    plen = min(cfg.inference_microbenchmark_prefill_lengths[0], cfg.max_prefill_predict_length)
    prompt = rng.integers(1, cfg.vocab_size, size=plen).astype(np.int32)
    for slot in range(engine.num_slots):
        prefix, _ = engine.prefill(prompt, plen)
        state = engine.insert(prefix, state, slot)
    times = {}
    for n in (4, 20):
        state, toks = engine.generate_n(state, n)  # warm-up: captures n steps
        toks.cpu()
        t0 = time.perf_counter()
        state, toks = engine.generate_n(state, n)
        toks.cpu()
        times[n] = time.perf_counter() - t0
    dt = max((times[20] - times[4]) / 16, 1e-6)
    results["decode"] = {
        "slots": engine.num_slots,
        "step_ms": round(dt * 1e3, 3),
        "tokens_per_s": round(engine.num_slots / dt, 1),
        "per_stream_tokens_per_s": round(1.0 / dt, 1),
    }

    # ---- chunked prefill: a long prompt split into prefill-limit chunks
    chunk = cfg.max_prefill_predict_length
    long_len = min(chunk * 2, cfg.max_target_length - 8)
    if long_len > chunk:
        prompt = rng.integers(1, cfg.vocab_size, size=long_len).astype(np.int32)
        prefix, first = engine.prefill_chunked(prompt, long_len, chunk)  # warm-up
        _sync(engine)
        reps = max(iters // 2, 1)
        t0 = time.perf_counter()
        for _ in range(reps):
            prefix, first = engine.prefill_chunked(prompt, long_len, chunk)
        _sync(engine)
        dt = (time.perf_counter() - t0) / reps
        results["chunked_prefill_ms"] = {
            "prompt_len": int(long_len),
            "chunk": int(chunk),
            "total_ms": round(dt * 1e3, 3),
        }
    return results


def main(argv=None):
    import sys

    from maxtext_indextts2_tpu_torch.infer.server import split_device_arg

    argv, device = split_device_arg(list(sys.argv[1:] if argv is None else argv))
    out = run_microbenchmark(load_config(argv), device=device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
