"""Device time of ``int8w_matmul`` (int8w_serve's decode product), case by case.

Times ``int8w_matmul`` (``ops/int8w_matmul.py``) at the shapes of
:data:`CASES` (the decode products of ``tts-1b`` at 32 slots and of the
flagship at 8, the speculative verify span, odd shapes), and cuBLAS on the
dequantised bfloat16 weight (``x @ w``: not the same function, the yardstick
of a product that reads twice the bytes), with ``torch.profiler`` (the device
time of ``iters`` launches, as ``ops/smoke.device_ms``: CUDA events over
back-to-back calls would read the host's cost of a call for a kernel of tens
of microseconds), ``repeats`` readings each. The int8
weight (and the bf16 one) is rotated through enough copies that each timed
launch reads it from device memory, not the L2. Each case prints one JSON
object with both times and the byte bound (the int8 weight, its scales, x and
y once over 3.35 TB/s); then the card's name and power limit. Inputs come
from a seed on the GPU and only the public wrapper is called, so the same
script times any checkout of the package: put the checkout first on
``PYTHONPATH`` and run this file by its path, e.g. the parent commit unpacked
under ``_scratch/parent``, in turns (parent, change, change, parent)::

    python -m maxtext_indextts2_tpu_torch.tools.bench_int8w [repeats=2] [cases=a,b]
    (cd _scratch/parent && PYTHONPATH=$PWD python \\
        ../../maxtext_indextts2_tpu_torch/tools/bench_int8w.py tag=parent)

``cases``: only the cases whose names contain one of these substrings.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys

import torch

L2_BYTES = 50e6
HBM_BYTES_PER_S = 3.35e12
# (name, M, K, N, bias)
CASES = [
    ("main_path", 32, 2048, 8192, False),
    ("tts1b_2048x2048", 32, 2048, 2048, False),
    ("tts1b_2048x1024", 32, 2048, 1024, False),
    ("tts1b_8192x2048", 32, 8192, 2048, False),
    ("flagship", 8, 3840, 15360, False),
    ("flagship_15360x3840", 8, 15360, 3840, False),
    ("flagship_3840x4096", 8, 3840, 4096, False),
    ("flagship_3840x2048", 8, 3840, 2048, False),
    ("flagship_4096x3840", 8, 4096, 3840, False),
    ("m1", 1, 2048, 2048, False),
    ("m160_verify", 160, 2048, 8192, False),
    ("m256", 256, 2048, 2048, False),
    ("odd_n_bias", 32, 2048, 1001, True),
    ("qwen3_moe_decode", 8, 2048, 4096, False),
]


def cases(wanted: list[str]) -> list[tuple]:
    """:data:`CASES` whose names contain one of ``wanted`` (all if empty)."""
    return [c for c in CASES if not wanted or any(w in c[0] for w in wanted)]


def parse(argv: list[str]) -> dict:
    opts = dict(tag="", repeats="2", iters="50", cases="")
    for a in argv:
        k, _, v = a.partition("=")
        if k not in opts:
            raise SystemExit(f"unknown option {k!r}; known: {sorted(opts)}")
        opts[k] = v
    return opts


def timed(fn, iters: int) -> float:
    """Device milliseconds a call, from ``torch.profiler`` over ``iters``
    calls (``ops/smoke.device_ms``; -1 where the trace lost its events)."""
    from maxtext_indextts2_tpu_torch.ops.smoke import device_ms

    ms = device_ms(fn, iters=iters)
    return -1.0 if ms is None else ms


def main(argv=None):
    opts = parse(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_int8w needs a CUDA device")
    from maxtext_indextts2_tpu_torch.ops import int8w_matmul as iw

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, timeout=60).stdout.strip().splitlines()[0]
    reps, iters = int(opts["repeats"]), int(opts["iters"])
    for i, (name, m, k, n, bias) in enumerate(cases([c for c in opts["cases"].split(",") if c])):
        g = torch.Generator(device=dev).manual_seed(400 + i)
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        q = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                          dtype=torch.int32).to(torch.int8)
        scale = (torch.rand((n,), generator=g, device=dev) + 0.5) / (127 * math.sqrt(k / 3))
        b = torch.randn((n,), generator=g, device=dev).to(torch.bfloat16) if bias else None
        copies = max(2, int(math.ceil(2 * L2_BYTES / (k * n))) + 1)
        qs = [q] + [q.clone() for _ in range(copies - 1)]
        w = iw.dequantize(q, scale, torch.bfloat16)
        ws = [w] + [w.clone() for _ in range(max(2, copies // 2) - 1)]
        turn = [0, 0]

        def nxt_q():
            turn[0] = (turn[0] + 1) % len(qs)
            return qs[turn[0]]

        def nxt_w():
            turn[1] = (turn[1] + 1) % len(ws)
            return ws[turn[1]]

        nbytes = k * n + 4 * n + 2 * (m * k + m * n + (n if bias else 0))
        ms = [timed(lambda: iw.int8w_matmul(x, nxt_q(), scale, b), iters) for _ in range(reps)]
        cublas = [timed(lambda: x @ nxt_w(), iters) for _ in range(reps)]
        print(json.dumps(dict(tag=opts["tag"], case=name, kernel="int8w_matmul", m=m, k=k, n=n,
                              bias=bias, ms=ms, cublas_bf16_weight_ms=cublas,
                              bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)), flush=True)
        del x, q, qs, w, ws
        torch.cuda.empty_cache()
    print(json.dumps(dict(tag=opts["tag"], card=card)), flush=True)


if __name__ == "__main__":
    main()
