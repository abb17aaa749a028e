"""Device time of the decode-attention kernels K1 / K3 / K4, case by case.

Times every K1 / K3 / K4 shape of ``ops/smoke.py``'s kernel checks (the
serving path's, 128 slots x 2048 rows in each cache type, the window, the v1
entry, other head dims and groups, the edges of the cluster's split, pages
of 1 to 128 rows) with ``torch.profiler`` device time (``ops.smoke.device_ms``),
and prints one JSON object a case and the card's name and power limit.
Inputs come from a seed on the GPU; only the wrappers' public entry points
are called, so the same script times any checkout of the package: put the
checkout first on ``PYTHONPATH`` and run this file by its path, e.g. the
parent commit unpacked under ``_scratch/parent``::

    python -m maxtext_indextts2_tpu_torch.tools.bench_decode_attention [repeats=2]
    (cd _scratch/parent && PYTHONPATH=$PWD python \\
        ../../maxtext_indextts2_tpu_torch/tools/bench_decode_attention.py tag=parent)
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

# lengths at the edges of a split over 1, 2, 4 and 8 blocks (ops.smoke.split_edge_lengths)
_EDGES = list(range(1, 10)) + [4, 5, 9, 32, 35, 8, 9, 19, 64, 67, 16, 17, 39, 128, 131]


def _edges(max_len: int) -> list[int]:
    out = _EDGES + [max_len - 1, max_len, max_len + 1, 3 * max_len, 0]
    return sorted(set(out), key=out.index)


def _serving_lengths(b: int, top: int, seed: int) -> list[int]:
    return np.random.default_rng(seed).integers(8, top + 1, size=b).tolist()


def _spread_lengths(b: int, s: int, seed: int) -> list[int]:
    lengths = np.random.default_rng(seed).integers(1, s + 1, size=b)
    fixed = [0, 1, s, s + 7, 3 * s, 0, 17, s - 1]
    lengths[: min(b, len(fixed))] = fixed[:b]
    return lengths.tolist()


# (name, b, s, nq, nkv, d, q dtype, int8 cache, window, v1 entry, lengths)
def ragged_shapes():
    bf16, f32 = torch.bfloat16, torch.float32
    out = [("ragged_bf16_main_path", 32, 2048, 16, 8, 128, bf16, False, 0, False,
            _serving_lengths(32, 528, 20))]
    big = [("ragged_bf16", bf16, False, 0, False), ("ragged_f32", f32, False, 0, False),
           ("ragged_int8_q_bf16", bf16, True, 0, False),
           ("ragged_bf16_window256", bf16, False, 256, False),
           ("ragged_v1_entry_bf16", bf16, False, 0, True),
           ("ragged_v1_entry_int8_q_f32", f32, True, 0, True)]
    for i, (name, dt, i8, win, v1) in enumerate(big):
        out.append((name, 128, 2048, 16, 8, 128, dt, i8, win, v1, _spread_lengths(128, 2048, i + 1)))
    for name, b, s, nq, nkv, d, dt, i8, win in [
            ("ragged_bf16_d256_group4", 16, 1024, 16, 4, 256, bf16, False, 0),
            ("ragged_bf16_d64_group1", 16, 512, 8, 8, 64, bf16, False, 0),
            ("ragged_f32_d32_group8_window", 5, 300, 8, 1, 32, f32, False, 50),
            ("ragged_int8_d32_group3", 6, 100, 6, 2, 32, f32, True, 0)]:
        out.append((name, b, s, nq, nkv, d, dt, i8, win, False, _spread_lengths(b, s, 7)))
    for name, s, nq, nkv, d, dt, i8, win, v1 in [
            ("ragged_bf16_split_edges", 512, 16, 8, 128, bf16, False, 0, False),
            ("ragged_f32_split_edges_d64_group4", 300, 8, 2, 64, f32, False, 0, False),
            ("ragged_int8_split_edges_q_bf16", 256, 16, 8, 128, bf16, True, 0, False),
            ("ragged_bf16_split_window29", 512, 16, 8, 128, bf16, False, 29, False),
            ("ragged_f32_split_window21_d32_group8", 200, 8, 1, 32, f32, False, 21, False),
            ("ragged_v1_entry_int8_split_window13_q_f32", 160, 4, 2, 256, f32, True, 13, True),
            ("ragged_bf16_split_edges_cluster2", 64, 16, 8, 128, bf16, False, 0, False),
            ("ragged_f32_split_edges_cluster1", 31, 4, 4, 64, f32, False, 0, False)]:
        lengths = _edges(s)
        out.append((name, len(lengths), s, nq, nkv, d, dt, i8, win, v1, lengths))
    return out


# (name, b, tpp, max_pages, nq, nkv, d, dtype, lengths)
def paged_shapes():
    bf16, f32 = torch.bfloat16, torch.float32
    out = [("paged_bf16_main_path", 32, 128, 256, 16, 8, 128, bf16,
            _serving_lengths(32, 528, 30))]
    for tpp, mp, nq, nkv, d, dt in [(16, 8, 16, 8, 128, bf16), (16, 8, 16, 8, 128, f32),
                                    (64, 4, 8, 4, 64, bf16), (4, 16, 8, 8, 64, f32),
                                    (7, 9, 8, 1, 128, bf16), (1, 40, 4, 1, 64, f32),
                                    (64, 3, 16, 4, 128, f32)]:
        full = tpp * mp
        out.append((f"paged_{'bf16' if dt == bf16 else 'f32'}_tpp{tpp}_g{nq // nkv}_d{d}", 9,
                    tpp, mp, nq, nkv, d, dt,
                    [0, 1, tpp - 1, tpp, tpp + 1, full, full + 5, 0, 2 * tpp + 3]))
    for tpp, mp, nq, nkv, d, dt in [(16, 16, 16, 8, 128, bf16), (12, 24, 16, 8, 128, bf16),
                                    (12, 20, 8, 2, 64, f32), (5, 40, 16, 8, 128, f32),
                                    (32, 12, 8, 4, 256, bf16)]:
        cap = tpp * mp
        lengths = _edges(cap) + [3 * tpp + 5, 7 * tpp - 2, cap // 2 + 1]
        out.append((f"paged_{'bf16' if dt == bf16 else 'f32'}_split_tpp{tpp}_g{nq // nkv}_d{d}",
                    len(lengths), tpp, mp, nq, nkv, d, dt, lengths))
    return out


def _ragged_call(shape, seed, dev):
    from maxtext_indextts2_tpu_torch.ops import ragged_decode_attention as rda
    from maxtext_indextts2_tpu_torch.ops.quantization import quantize_kv

    _, b, s, nq, nkv, d, dt, i8, win, v1, lengths = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, nq, d), generator=g, device=dev).to(dt)
    k = torch.randn((b, s, nkv, d), generator=g, device=dev)
    v = torch.randn((b, s, nkv, d), generator=g, device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    ks = vs = None
    if i8:
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        ks, vs = ks.contiguous(), vs.contiguous()
    else:
        k, v = k.to(dt), v.to(dt)
    if v1:
        kw = dict(sliding_window=win)
        if i8:
            kw.update(k_scale=ks[..., None], v_scale=vs[..., None])
        return lambda: rda.ragged_decode_attention(q, k, v, lens, **kw)
    return lambda: rda.ragged_decode_attention_v2(q, k, v, lens, sliding_window=win,
                                                  k_scale=ks, v_scale=vs)


def _paged_call(shape, seed, dev):
    from maxtext_indextts2_tpu_torch.ops import ragged_decode_attention as rda

    _, b, tpp, mp, nq, nkv, d, dt, lengths = shape
    rng = np.random.default_rng(seed)
    cap = tpp * mp
    held = [-(-min(max(int(n), 0), cap) // tpp) for n in lengths]
    num_pages = 1 + sum(held) + 8
    order = rng.permutation(np.arange(1, num_pages))
    page_map = rng.integers(0, num_pages, size=(b, mp))
    off = 0
    for i, n in enumerate(held):
        page_map[i, :n] = order[off:off + n]
        off += n
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, nq, d), generator=g, device=dev).to(dt)
    kp = torch.randn((num_pages, tpp, nkv, d), generator=g, device=dev).to(dt)
    vp = torch.randn((num_pages, tpp, nkv, d), generator=g, device=dev).to(dt)
    pm = torch.as_tensor(page_map, dtype=torch.int32, device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return lambda: rda.paged_decode_attention_v2(q, kp, vp, pm, lens)


def main(argv=None):
    from maxtext_indextts2_tpu_torch.ops.smoke import device_ms

    opts = dict(tag="", repeats="2")
    for a in (sys.argv[1:] if argv is None else argv):
        k, _, v = a.partition("=")
        if k not in opts:
            raise SystemExit(f"unknown option {k!r}; known: {sorted(opts)}")
        opts[k] = v
    if not torch.cuda.is_available():
        raise SystemExit("bench_decode_attention needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, timeout=60).stdout.strip().splitlines()[0]
    calls = [(s[0], "K1/K3", _ragged_call(s, 100 + i, dev)) for i, s in enumerate(ragged_shapes())]
    calls += [(s[0], "K4", _paged_call(s, 200 + i, dev)) for i, s in enumerate(paged_shapes())]
    for name, kernel, call in calls:
        ms = [device_ms(call, iters=20) for _ in range(int(opts["repeats"]))]
        print(json.dumps(dict(tag=opts["tag"], case=name, kernel=kernel, device_ms=ms)),
              flush=True)
        del call
    print(json.dumps(dict(tag=opts["tag"], card=card)), flush=True)


if __name__ == "__main__":
    main()
