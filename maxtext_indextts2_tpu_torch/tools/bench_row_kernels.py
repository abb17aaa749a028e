"""Device time of the S2A row kernels K5-K8, case by case.

Times every K5-K8 shape of ``ops/smoke.py``'s kernel checks (the main
path's ``[8,768,1024]`` in bfloat16 and float32, the unconditional pass,
widths that are no multiple of 128 or of the vector width, rows of one
batch entry, batch entries that end inside a warp's or a block's rows, rows
of 8 to 20,000 elements, an x off a 16-byte boundary, w in x's type) with
``torch.profiler`` device time (as ``ops.smoke.device_ms`` reads it, with
the count of device events beside each reading), rotating over
copies of the inputs so that a launch reads them from device memory and not
from the L2 that the launch before filled. It also times an empty launch
(``torch.cuda._sleep(0)``), the floor under any kernel's device time. Prints
one JSON object a case and the card's name and power limit. Inputs come from
a seed on the GPU; only the wrappers' public entry points are called, so the
same script times any checkout of the package: put the checkout first on
``PYTHONPATH`` and run this file by its path, e.g. the parent commit
unpacked under ``_scratch/parent``::

    python -m maxtext_indextts2_tpu_torch.tools.bench_row_kernels [repeats=2] [cases=a,b]
    (cd _scratch/parent && PYTHONPATH=$PWD python \\
        ../../maxtext_indextts2_tpu_torch/tools/bench_row_kernels.py tag=parent)

``cases``: only the cases whose names contain one of these substrings. Each
call launches one kernel, so a reading is the summed device time of a trace's
kernels over their count (a trace may lose the first launch of its window).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys

import torch

L2_BYTES = 50e6
S2A_MAIN = dict(b=8, s=768, d=1024)
ROW_KERNELS = ("ada_rmsnorm", "row_quantize_int8", "ada_rmsnorm_quantize", "silu_mul_quantize")


def row_specs() -> list[tuple[str, dict]]:
    """(name, keywords) of every K5-K8 case, as ``ops.smoke.row_case_specs()``
    has them (a test holds the two lists equal)."""
    bf16, f32 = torch.bfloat16, torch.float32
    main = dict(S2A_MAIN)
    out = []
    for i, kernel in enumerate(ROW_KERNELS):
        wide = dict(main, d=4 * main["d"]) if kernel == "silu_mul_quantize" else main
        seed = 100 + 10 * i
        norm = kernel in ("ada_rmsnorm", "ada_rmsnorm_quantize")
        out += [
            (f"{kernel}_bf16_main_path", dict(kernel=kernel, **wide, seed=seed, repeat=norm)),
            (f"{kernel}_f32", dict(kernel=kernel, **wide, dtype=f32, seed=seed + 1)),
            (f"{kernel}_bf16_uncond_512",
             dict(kernel=kernel, **dict(wide, s=min(512, wide["s"])), seed=seed + 2)),
            (f"{kernel}_bf16_d1000_s650", dict(kernel=kernel, b=3, s=650, d=1000, seed=seed + 3)),
            (f"{kernel}_f32_d1001", dict(kernel=kernel, b=2, s=77, d=1001, dtype=f32,
                                         seed=seed + 4)),
            (f"{kernel}_bf16_d1001", dict(kernel=kernel, b=2, s=77, d=1001, seed=seed + 5)),
            (f"{kernel}_bf16_zero_and_half_rows", dict(kernel=kernel, b=4, s=40, d=1024,
                                                       seed=seed + 6, special=True)),
            (f"{kernel}_f32_zero_and_half_rows", dict(kernel=kernel, b=4, s=40, d=256, dtype=f32,
                                                      seed=seed + 7, special=True)),
        ]
        if not norm:
            continue
        out += [
            (f"{kernel}_bf16_one_row_a_batch_entry",
             dict(kernel=kernel, b=300, s=1, d=main["d"], seed=seed + 20)),
            (f"{kernel}_bf16_batch_entries_end_inside_warps",
             dict(kernel=kernel, b=1200, s=7, d=main["d"], seed=seed + 21)),
            (f"{kernel}_bf16_d8192_batch_entries_end_inside_blocks",
             dict(kernel=kernel, b=300, s=5, d=8192, seed=seed + 22)),
            (f"{kernel}_bf16_d8", dict(kernel=kernel, b=3, s=50, d=8, seed=seed + 23)),
            (f"{kernel}_f32_d24", dict(kernel=kernel, b=3, s=50, d=24, dtype=f32, seed=seed + 24)),
            (f"{kernel}_bf16_d2048", dict(kernel=kernel, b=2, s=300, d=2048, seed=seed + 25)),
            (f"{kernel}_f32_d2048_two_warps",
             dict(kernel=kernel, b=2, s=200, d=2048, dtype=f32, seed=seed + 26)),
            (f"{kernel}_bf16_zero_and_half_rows_d2048",
             dict(kernel=kernel, b=4, s=40, d=2048, seed=seed + 27, special=True)),
            (f"{kernel}_bf16_x_off_16_bytes",
             dict(kernel=kernel, b=2, s=77, d=main["d"], seed=seed + 28, misaligned=True)),
            (f"{kernel}_bf16_w_bf16",
             dict(kernel=kernel, b=4, s=300, d=main["d"], seed=seed + 29, w_dtype=bf16)),
            (f"{kernel}_bf16_rounds_d20000",
             dict(kernel=kernel, b=2, s=5, d=20000, seed=seed + 30)),
            (f"{kernel}_f32_rounds_d9001",
             dict(kernel=kernel, b=2, s=5, d=9001, dtype=f32, seed=seed + 31)),
        ]
    return out


def _call(kernel, *, b, s, d, seed, dtype=torch.bfloat16, w_dtype=torch.float32,
          misaligned=False, dev, **_):
    """A call of the kernel's public entry point, rotating over enough copies
    of its inputs that each launch reads them from device memory."""
    from maxtext_indextts2_tpu_torch.ops import ada_rmsnorm as arn
    from maxtext_indextts2_tpu_torch.ops import quant_kernels as qk

    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((b, s, d), generator=g, device=dev) * 1.5).to(dtype)
    second = None
    if kernel in ("ada_rmsnorm", "ada_rmsnorm_quantize"):
        second = (1.0 + 0.3 * torch.randn((b, d), generator=g, device=dev)).to(w_dtype)
    elif kernel == "silu_mul_quantize":
        second = torch.randn((b, s, d), generator=g, device=dev).to(dtype)
    nbytes = 2 * x.numel() * x.element_size() + (0 if second is None else
                                                  second.numel() * second.element_size())
    copies = max(2, int(math.ceil(2 * L2_BYTES / nbytes)) + 1)

    def make():
        if not misaligned:
            return x.clone()
        base = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
        base[1:] = x.reshape(-1)
        return base[1:].view(b, s, d)

    xs = [make() for _ in range(copies)]
    ss = [second.clone() if second is not None and second.ndim == 3 else second
          for _ in range(copies)]
    fn = {"ada_rmsnorm": lambda x, w: arn.ada_rmsnorm(x, w),
          "row_quantize_int8": lambda x, _: qk.row_quantize_int8(x),
          "ada_rmsnorm_quantize": lambda x, w: qk.ada_rmsnorm_quantize(x, w),
          "silu_mul_quantize": lambda g, u: qk.silu_mul_quantize(g, u)}[kernel]
    turn = [0]

    def run():
        i = turn[0] = (turn[0] + 1) % copies
        return fn(xs[i], ss[i])

    return run


def device_ms(fn, iters: int = 20) -> dict:
    """Device milliseconds of one kernel of ``fn`` from ``torch.profiler``:
    the summed device time of the GPU events of ``iters`` calls over their
    count, with that count and, where it is not ``iters``, their names."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    out = dict(ms=sum(e.device_time_total for e in on_device) / 1e3 / max(1, len(on_device)),
               events=len(on_device))
    if len(on_device) != iters:
        out["names"] = sorted({e.name[:60] for e in on_device})
    return out


def main(argv=None):
    opts = dict(tag="", repeats="2", cases="")
    for a in (sys.argv[1:] if argv is None else argv):
        k, _, v = a.partition("=")
        if k not in opts:
            raise SystemExit(f"unknown option {k!r}; known: {sorted(opts)}")
        opts[k] = v
    if not torch.cuda.is_available():
        raise SystemExit("bench_row_kernels needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, timeout=60).stdout.strip().splitlines()[0]
    reps = int(opts["repeats"])
    empty = [device_ms(lambda: torch.cuda._sleep(0), iters=20) for _ in range(reps)]
    print(json.dumps(dict(tag=opts["tag"], case="empty_launch", kernel="torch.cuda._sleep(0)",
                          device_ms=empty)), flush=True)
    wanted = [c for c in opts["cases"].split(",") if c]
    for name, kw in row_specs():
        if wanted and not any(c in name for c in wanted):
            continue
        run = _call(dev=dev, **kw)
        ms = [device_ms(run, iters=20) for _ in range(reps)]
        print(json.dumps(dict(tag=opts["tag"], case=name, kernel=kw["kernel"], device_ms=ms)),
              flush=True)
        del run
        torch.cuda.empty_cache()
    print(json.dumps(dict(tag=opts["tag"], card=card)), flush=True)


if __name__ == "__main__":
    main()
