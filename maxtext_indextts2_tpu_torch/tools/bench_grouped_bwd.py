"""Device time of the grouped product's backward kernels, case by case.

Times ``grouped_matmul_dgrad`` and ``grouped_matmul_wgrad`` (``ops/grouped_matmul.py``)
at every shape of ``ops/smoke.py``'s ``GMM_BWD_CASES`` whose routing is a kind
(the training phases' products, empty groups, one group holding every row,
skewed rows), then the float32 grouped kernels (the forward, dgrad and wgrad
on float32 operands: ``moe_train_parity``'s float32 step, deepseek's
training shapes) at every kind-routed shape of ``GMM_F32_CASES``, with CUDA
events around ``iters`` back-to-back launches after a warm-up, ``repeats``
readings each, and prints one JSON object a case and kind, then the card's
name and power limit. The main-path operands are far larger than the L2;
the small cases' readings are L2-warm. Inputs come from a seed on the GPU
and only the wrappers' public entry points are called, so the same script
times any checkout of the package: put the checkout first on ``PYTHONPATH``
and run this file by its path, e.g. the parent commit unpacked under
``_scratch/parent``, in turns (parent, change, change, parent)::

    python -m maxtext_indextts2_tpu_torch.tools.bench_grouped_bwd [repeats=2] [cases=a,b]
    (cd _scratch/parent && PYTHONPATH=$PWD python \\
        ../../maxtext_indextts2_tpu_torch/tools/bench_grouped_bwd.py tag=parent)

``cases``: only the cases whose names contain one of these substrings.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys

import torch


def cases(wanted: list[str]) -> list[tuple]:
    """The ``GMM_BWD_CASES`` of the checkout on the path whose routing is a
    kind, filtered by name."""
    from maxtext_indextts2_tpu_torch.ops import smoke

    return [c for c in smoke.GMM_BWD_CASES if isinstance(c[5], str)
            and (not wanted or any(w in c[0] for w in wanted))]


def f32_cases(wanted: list[str]) -> list[tuple]:
    """The ``GMM_F32_CASES`` of the checkout on the path whose routing is a
    kind, filtered by name."""
    from maxtext_indextts2_tpu_torch.ops import smoke

    return [c for c in getattr(smoke, "GMM_F32_CASES", []) if isinstance(c[5], str)
            and (not wanted or any(w in c[0] for w in wanted))]


def timed(fn, iters: int) -> float:
    """Milliseconds a launch over ``iters`` back-to-back launches (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    opts = dict(tag="", repeats="2", iters="20", cases="")
    for a in (sys.argv[1:] if argv is None else argv):
        k, _, v = a.partition("=")
        if k not in opts:
            raise SystemExit(f"unknown option {k!r}; known: {sorted(opts)}")
        opts[k] = v
    if not torch.cuda.is_available():
        raise SystemExit("bench_grouped_bwd needs a CUDA device")
    from maxtext_indextts2_tpu_torch.ops import grouped_matmul as gm
    from maxtext_indextts2_tpu_torch.ops import smoke

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, timeout=60).stdout.strip().splitlines()[0]
    reps, iters = int(opts["repeats"]), int(opts["iters"])
    wanted = [c for c in opts["cases"].split(",") if c]
    bf16 = [(c, torch.bfloat16, 200 + i) for i, c in enumerate(cases(wanted))]
    f32 = [(c, torch.float32, 250 + i) for i, c in enumerate(f32_cases(wanted))]
    for (name, rows, groups, k, n, routing), dtype, seed in bf16 + f32:
        g = torch.Generator(device=dev).manual_seed(seed)
        counts = torch.bincount(smoke._gmm_groups(rows, groups, routing, g, dev),
                                minlength=groups)
        offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                             torch.cumsum(counts, 0)]).to(torch.int32)
        x = torch.randn((rows, k), generator=g, device=dev).to(dtype)
        w = (torch.randn((groups, k, n), generator=g, device=dev) / math.sqrt(k)).to(dtype)
        dy = torch.randn((rows, n), generator=g, device=dev).to(dtype)
        runs = (("dgrad", lambda: gm.grouped_matmul_dgrad(dy, w, offsets)),
                ("wgrad", lambda: gm.grouped_matmul_wgrad(x, dy, offsets)))
        if dtype == torch.float32:  # the float32 forward too (no autograd: a plain launch)
            runs = (("fwd", lambda: gm.grouped_matmul(x, w, offsets)),) + runs
        for kind, fn in runs:
            ms = [timed(fn, iters) for _ in range(reps)]
            kernel = (f"grouped_matmul_f32{'' if kind == 'fwd' else '_' + kind}"
                      if dtype == torch.float32 else f"grouped_matmul_{kind}")
            print(json.dumps(dict(tag=opts["tag"], case=name, kernel=kernel, rows=rows,
                                  groups=groups, k=k, n=n, ms=ms)), flush=True)
        del x, w, dy
        torch.cuda.empty_cache()
    print(json.dumps(dict(tag=opts["tag"], card=card)), flush=True)


if __name__ == "__main__":
    main()
