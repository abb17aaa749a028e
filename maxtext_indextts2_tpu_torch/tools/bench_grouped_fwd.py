"""Device time of the grouped product's forward, bfloat16 and int8, case by case.

Times ``grouped_matmul`` (``ops/grouped_matmul.py``) on bfloat16 operands at
the shapes of :data:`CASES` (the MoE training step's forward, prefills,
decodes and the few-rows edges), and ``torch._grouped_mm`` on the same
operands where this PyTorch has it (a yardstick, used nowhere in the port);
the ``int8_*`` cases time ``grouped_matmul_int8`` with its scales (the
``int8w_serve`` experts: int8 rows and weights, a bfloat16 result; no
PyTorch call computes an int8 ragged product). Device time comes from
``torch.profiler`` (the device time of ``iters`` launches, as
``ops/smoke.device_ms``: CUDA events over back-to-back calls would read the
host's cost of a call for a kernel of tens of microseconds), ``repeats``
readings each. Each case prints one JSON object with the times and the bound
(the touched experts' weights, the rows in and out, over 3.35 TB/s, against
2 R K N operations over 989 TFLOP/s, or 1,979 TOP/s in int8); then the
card's name and power limit. Operands larger than the L2 are read from
device memory; the decode cases' experts are rotated through enough copies
that each timed launch finds its weights outside the L2. Inputs come from a
seed on the GPU and only the wrappers' public entry points are called, so
the same script times any checkout of the package: put the checkout first
on ``PYTHONPATH`` and run this file by its path, e.g. the parent commit
unpacked under ``_scratch/parent``, in turns (parent, change, change,
parent)::

    python -m maxtext_indextts2_tpu_torch.tools.bench_grouped_fwd [repeats=2] [cases=a,b]
    (cd _scratch/parent && PYTHONPATH=$PWD python \\
        ../../maxtext_indextts2_tpu_torch/tools/bench_grouped_fwd.py tag=parent)

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
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
# (name, rows R, groups G, K, N, routing): routing a kind of
# ops/smoke._gmm_groups ("uniform": each row's group drawn uniformly) or the
# groups' row counts; an ``int8_`` name times grouped_matmul_int8
CASES = [
    ("qwen3_train_wi", 4096 * 8, 128, 2048, 768, "uniform"),
    ("qwen3_train_wo", 4096 * 8, 128, 768, 2048, "uniform"),
    ("qwen3_prefill_wi", 2048 * 8, 128, 2048, 768, "uniform"),
    ("qwen3_prefill_wo", 2048 * 8, 128, 768, 2048, "uniform"),
    ("mixtral_prefill_wi", 2048 * 2, 8, 4096, 14336, "uniform"),
    ("main_path", 64, 128, 2048, 768, "uniform"),
    ("single_rows", 8, 128, 2048, 768, "uniform"),
    ("mixtral_decode_wi", 16, 8, 4096, 14336, "uniform"),
    ("mixtral_decode_wo", 16, 8, 14336, 4096, "uniform"),
    ("llama4_decode_wo", 8, 16, 8192, 5120, "uniform"),
    ("deepseek_decode_wi", 48, 64, 2048, 1408, "uniform"),
    ("few_rows_split_edges", 100, 24, 2056, 136,
     (1, 9, 0, 16, 3, 1, 1, 7, 0, 2, 12, 1, 5, 0, 1, 1, 14, 2, 3, 1, 0, 6, 13, 1)),
    # int8w_serve's experts: qwen3 decode (the main path) and prefill, the
    # other models' decodes, 8 rows over 128 experts (K split)
    ("int8_main_path", 64, 128, 2048, 768, "uniform"),
    ("int8_qwen3_decode_wo", 64, 128, 768, 2048, "uniform"),
    ("int8_qwen3_prefill_wi", 2048 * 8, 128, 2048, 768, "uniform"),
    ("int8_qwen3_prefill_wo", 2048 * 8, 128, 768, 2048, "uniform"),
    ("int8_mixtral_decode_wi", 16, 8, 4096, 14336, "uniform"),
    ("int8_mixtral_decode_wo", 16, 8, 14336, 4096, "uniform"),
    ("int8_deepseek_decode_wi", 48, 64, 2048, 1408, "uniform"),
    ("int8_llama4_decode_wo", 8, 16, 8192, 5120, "uniform"),
    ("int8_single_rows", 8, 128, 2048, 768, "uniform"),
]


def cases(wanted: list[str]) -> list[tuple]:
    """:data:`CASES` whose names contain one of ``wanted`` (all if empty)."""
    return [c for c in CASES if not wanted or any(w in c[0] for w in wanted)]


def parse(argv: list[str]) -> dict:
    opts = dict(tag="", repeats="2", iters="20", cases="")
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
        raise SystemExit("bench_grouped_fwd needs a CUDA device")
    from maxtext_indextts2_tpu_torch.ops import grouped_matmul as gm
    from maxtext_indextts2_tpu_torch.ops import smoke

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, timeout=60).stdout.strip().splitlines()[0]
    reps, iters = int(opts["repeats"]), int(opts["iters"])
    library = getattr(torch, "_grouped_mm", None)
    for i, (name, rows, groups, k, n, routing) in enumerate(cases(
            [c for c in opts["cases"].split(",") if c])):
        g = torch.Generator(device=dev).manual_seed(300 + i)
        counts = torch.bincount(smoke._gmm_groups(rows, groups, routing, g, dev),
                                minlength=groups)
        offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                             torch.cumsum(counts, 0)]).to(torch.int32)
        touched = int((counts > 0).sum().item())
        int8 = name.startswith("int8_")
        esize = 1 if int8 else 2
        if int8:
            x = torch.randint(-127, 128, (rows, k), generator=g, device=dev,
                              dtype=torch.int32).to(torch.int8)
            w = torch.randint(-127, 128, (groups, k, n), generator=g, device=dev,
                              dtype=torch.int32).to(torch.int8)
            rs = (torch.rand((rows, 1), generator=g, device=dev) + 0.5) / 127
            wsc = (torch.rand((groups, 1, n), generator=g, device=dev) + 0.5) / (127 * k)
        else:
            x = torch.randn((rows, k), generator=g, device=dev).to(torch.bfloat16)
            w = (torch.randn((groups, k, n), generator=g, device=dev)
                 / math.sqrt(k)).to(torch.bfloat16)
        wbytes = touched * k * n * esize
        copies = max(1, int(math.ceil(2 * L2_BYTES / max(wbytes, 1)))) if wbytes < L2_BYTES else 1
        ws = [w] + [w.clone() for _ in range(copies - 1)]
        turn = [0]

        def nxt():
            turn[0] = (turn[0] + 1) % copies
            return ws[turn[0]]

        # int8: the row scales in, the touched experts' channel scales in
        nbytes = (wbytes + rows * k * esize + rows * n * 2 + 4 * (groups + 1)
                  + (4 * rows + 4 * touched * n if int8 else 0))
        peak = INT8_OPS_PER_S if int8 else BF16_OPS_PER_S
        bound = max(nbytes / HBM_BYTES_PER_S, 2 * rows * k * n / peak) * 1e3
        if int8:
            ms = [timed(lambda: gm.grouped_matmul_int8(x, nxt(), offsets, rs, wsc), iters)
                  for _ in range(reps)]
        else:
            ms = [timed(lambda: gm.grouped_matmul(x, nxt(), offsets), iters) for _ in range(reps)]
        lib = None
        if library is not None and not int8:
            ends = offsets[1:].contiguous()
            try:
                lib = [timed(lambda: library(x, nxt(), offs=ends), iters) for _ in range(reps)]
            except (RuntimeError, NotImplementedError, TypeError):
                lib = None
        print(json.dumps(dict(tag=opts["tag"], case=name,
                              kernel="grouped_matmul_int8" if int8 else "grouped_matmul_bf16",
                              rows=rows, groups=groups, touched=touched, k=k, n=n, ms=ms,
                              library_ms=lib, bound_ms=bound)), flush=True)
        del x, w, ws
        torch.cuda.empty_cache()
    print(json.dumps(dict(tag=opts["tag"], card=card)), flush=True)


if __name__ == "__main__":
    main()
