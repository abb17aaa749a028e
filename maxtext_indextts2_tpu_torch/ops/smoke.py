"""On-device checks of the CUDA kernels against their plain versions.

Each case builds its inputs from a seed on the GPU at the shapes the
``tts-1b`` serving path gives the kernel (128 slots x 2048 cache rows, 16
query / 8 kv heads, head_dim 128) or at one of the other supported head
dims, runs the kernel and the plain PyTorch version on the same inputs,
synchronises so that a fault surfaces where it happened, and reports the
largest absolute difference beside its tolerance. With ``timing=True`` it
also times the kernel, the plain version and one library call for the same
function (a yardstick only; this package never calls it) with CUDA events
around back-to-back calls of the Python wrapper (``kernel_ms``; for a kernel
of a few microseconds that is the host's cost of a call), reads the device
time of the main-path and row-kernel cases from ``torch.profiler``
(``device_ms``), and computes the least time the card could take for the same work from this
run's inputs: bytes moved (each input read once, each output written once,
only the cache rows the lengths make valid) over the memory rate, or
operations over the peak rate of the input type, whichever is larger.

The main-path cases also time the library call on the device
(``library_device_ms``), so that kernel and yardstick compare device time
with device time, and check that two launches of the kernel give bitwise
equal outputs (``repeat_bitwise_equal``; K1, K4, K5 and K7).

Run: ``python -m maxtext_indextts2_tpu_torch.ops.smoke [small]
[ragged | flash | paged | s2a | rows | int8w | gmm]`` (needs the GPU; ``small`` shrinks the
serving and training shapes for a quick first check of a changed kernel,
``ragged`` runs the K1-K3 cases only, ``flash`` the K9-K11 cases only,
``paged`` the K4 cases only, ``s2a`` the K12 cases only, ``rows`` the K5-K8
cases only, ``int8w`` the int8w_matmul cases only, ``gmm`` the grouped
products, their backward and the float32 grouped kernels only; the repo's
``chip_smoke.py`` calls :func:`run_all`).
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from maxtext_indextts2_tpu_torch.ops import ada_rmsnorm as arn
from maxtext_indextts2_tpu_torch.ops import flash_attention as fa
from maxtext_indextts2_tpu_torch.ops import grouped_matmul as gm
from maxtext_indextts2_tpu_torch.ops import inplace_update as iu
from maxtext_indextts2_tpu_torch.ops import int8w_matmul as iw
from maxtext_indextts2_tpu_torch.ops import quant_kernels as qk
from maxtext_indextts2_tpu_torch.ops import ragged_decode_attention as rda
from maxtext_indextts2_tpu_torch.ops import s2a_attention as s2a
from maxtext_indextts2_tpu_torch.ops.quantization import quantize_kv

# Published peaks of one H100 SXM (NVIDIA data sheet, dense).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Tolerances against the plain version ON THE CARD (same arithmetic, other
# summation order). float32 result: 2e-5 on O(1) values. bfloat16 result:
# both sides round a float32 value to bfloat16, so they differ by at most one
# bfloat16 step where the float32 values straddle a rounding boundary;
# |out| < 4 here, one step is 2**-6.
TOL_F32 = 2e-5
TOL_BF16 = 2e-2

TTS_1B = dict(b=128, s=2048, nq=16, nkv=8, d=128)
# The flagship's decode (tts-flagship served whole): 8 slots of a 4096-row
# cache, 16 query / 8 kv heads of 256; prompts of up to 1536 tokens and 64
# generated ones.
FLAGSHIP_DECODE = dict(b=8, s=4096, nq=16, nkv=8, d=256)
FLAGSHIP_SERVING_MAX = 1600
# chip_smoke.py's spec_decode phase: prompts of up to 400 tokens, 64 generated,
# and a verify span past them
SPEC_SERVING_MAX = 480

# Row kernels of the S2A denoiser against their plain versions ON THE CARD.
# Both sides do the same arithmetic; only the order of the float32 sum of
# squares differs, so the variance may differ in its last bit and the rsqrt
# factor with it. float32 results: a few float32 steps of |y| <= 16. bfloat16
# results: where the float32 factor straddles a bfloat16 rounding boundary the
# whole row moves by one bfloat16 step (2**-5 for |y| in [4, 8)); such rows are
# counted and must stay under 1 in 1000 elements. int8 codes: equal, except a
# counted handful (under 1 in 1000) one step apart at a rounding boundary;
# scales: a relative 1e-6 (float32 input) or one bfloat16 step, 2**-7
# (bfloat16 input, a row whose factor flipped). row_quantize_int8 has no
# order-dependent sum and must be exactly equal.
TOL_ROW_F32 = 4e-6
TOL_ROW_BF16 = 2.0 ** -5
TOL_CODE_STEPS = 1
MAX_MISMATCH_SHARE = 1e-3
TOL_SCALE_REL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}
L2_BYTES = 50e6  # inputs are rotated so that a timed launch does not find them in the L2

S2A_MAIN = dict(b=8, s=768, d=1024)  # 8 rows: prompt padded to 256 + target bucketed to 512


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10, tries: int = 3) -> float | None:
    """Device-busy milliseconds of one call of ``fn``, from ``torch.profiler``:
    the summed device time of every GPU kernel and copy the call launches.
    ``time_ms`` above times back-to-back calls through the Python wrapper, so
    for a kernel of a few microseconds it reads the host's cost of a call; this
    reads what the card spent. The trace sometimes loses events or their
    times: a trace whose count of device events is not a positive multiple of
    ``iters``, or whose time is 0, is taken again, up to ``tries`` times, and
    then the time is None (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.device_time_total for e in on_device)
        if busy > 0 and len(on_device) % iters == 0:
            return busy / 1e3 / iters
    return None


def spread_lengths(b: int, s: int, seed: int, serving_max: int = 0) -> torch.Tensor:
    """Lengths over 0..S and beyond: some empty slots, some exactly 1 and S,
    some past the cache (the wrapper must clamp them). With ``serving_max``:
    what a serving run holds instead, every slot between 8 rows and that."""
    rng = np.random.default_rng(seed)
    if serving_max:
        return torch.tensor(rng.integers(8, serving_max + 1, size=b), dtype=torch.int32)
    lengths = rng.integers(1, s + 1, size=b)
    fixed = [0, 1, s, s + 7, 3 * s, 0, 17, s - 1]
    lengths[: min(b, len(fixed))] = fixed[:b]
    return torch.tensor(lengths, dtype=torch.int32)


def split_edge_lengths(max_len: int) -> list[int]:
    """One slot per length at the edges of the kernel's split of a slot's rows
    over a cluster of C blocks (``ceil(n / C)`` rows a block), for every C the
    wrapper may take (1, 2, 4, 8): 1..9 rows (blocks with no row), multiples of
    C and one past them, max_len and past it, 0."""
    out = list(range(1, 10))
    for c in (2, 4, 8):
        out += [2 * c, 2 * c + 1, 5 * c - 1, 16 * c, 16 * c + 3]
    out += [max_len - 1, max_len, max_len + 1, 3 * max_len, 0]
    return sorted(set(out), key=out.index)


def _cluster_info(entry, b, nkv, max_len, d, group, device) -> dict:
    """The cluster a launch takes at these shapes, and the card's occupancy of
    that instantiation (blocks an SM holds, clusters of that size it holds)."""
    c = rda.launch_cluster(entry, b, nkv, max_len, d, group, device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    per_sm, clusters = rda.occupancy(entry, d, group, c, index)
    return dict(cluster=c, blocks_per_sm=per_sm, max_active_clusters=clusters)


def _repeat_equal(run) -> bool:
    """Two launches give bitwise equal outputs (no atomics, a fixed merge order)."""
    a = run(None)
    b = run(None)
    torch.cuda.synchronize()
    return bool(torch.equal(a, b))


def _ragged_inputs(b, s, nq, nkv, d, dtype, seed, device, int8=False, serving_max=0,
                   lengths=None):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, nq, d), generator=g, device=device, dtype=torch.float32).to(dtype)
    k = torch.randn((b, s, nkv, d), generator=g, device=device, dtype=torch.float32)
    v = torch.randn((b, s, nkv, d), generator=g, device=device, dtype=torch.float32)
    if lengths is None:
        lengths = spread_lengths(b, s, seed, serving_max)
    lengths = torch.as_tensor(lengths, dtype=torch.int32).to(device)
    if int8:
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        return q, k, v, lengths, ks.contiguous(), vs.contiguous()
    return q, k.to(dtype), v.to(dtype), lengths, None, None


def _ragged_bound_ms(q, k, lengths, window, quantized, out_dtype):
    b, nq, d = q.shape
    s, nkv = k.shape[1], k.shape[2]
    hi = torch.clamp(lengths.long(), 0, s)
    lo = torch.clamp(hi - window, min=0) if window > 0 else torch.zeros_like(hi)
    rows = int((hi - lo).sum().item())
    nbytes = (
        q.numel() * q.element_size()
        + q.numel() * torch.empty((), dtype=out_dtype).element_size()
        + lengths.numel() * 4
        + rows * nkv * d * 2 * k.element_size()
        + (rows * nkv * 2 * 4 if quantized else 0)
    )
    ops = 4 * rows * nq * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[q.dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes


def _sdpa_library(q, k, v, lengths, window):
    """One PyTorch call for the same function (float cache only)."""
    b, nq, d = q.shape
    s = k.shape[1]
    pos = torch.arange(s, device=q.device)[None, :]
    lens = torch.clamp(lengths.long(), 1, s)[:, None]  # an empty row would be NaN there
    mask = pos < lens
    if window > 0:
        mask &= pos >= torch.clamp(lens - window, min=0)
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    k4, v4 = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, enable_gqa=True)


def ragged_case(name, device, timing, *, b, s, nq, nkv, d, dtype=torch.bfloat16,
                int8=False, window=0, v1_entry=False, seed=0, serving_max=0, lengths=None):
    q, k, v, lengths, ks, vs = _ragged_inputs(b, s, nq, nkv, d, dtype, seed, device, int8,
                                              serving_max, lengths)
    if v1_entry:
        kw = dict(sliding_window=window)
        if int8:
            kw.update(k_scale=ks[..., None], v_scale=vs[..., None])
        run = lambda impl: rda.ragged_decode_attention(q, k, v, lengths, impl=impl, **kw)
    else:
        kw = dict(sliding_window=window, k_scale=ks, v_scale=vs)
        run = lambda impl: rda.ragged_decode_attention_v2(q, k, v, lengths, impl=impl, **kw)
    out = run(None)
    torch.cuda.synchronize()
    ref = run("plain")
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == ref.shape, (out.dtype, ref.dtype)
    finite = bool(torch.isfinite(out).all().item())
    empty_zero = bool((out[lengths <= 0] == 0).all().item())
    err = float((out.float() - ref.float()).abs().max().item())
    tol = TOL_BF16 if out.dtype == torch.bfloat16 else TOL_F32
    res = dict(
        name=name, kernel="ragged_decode_attention", max_abs_err=err, tol=tol,
        ok=bool(err <= tol and finite and empty_zero), finite=finite,
        empty_rows_zero=empty_zero,
        shape=dict(b=b, s=s, nq=nq, nkv=nkv, d=d, q=str(q.dtype), kv=str(k.dtype),
                   window=window, sum_lengths=int(torch.clamp(lengths, 0, s).sum().item())),
        **_cluster_info(rda._ENTRY[k.dtype], b, nkv, rda._max_rows(s, window), d, nq // nkv,
                        device),
    )
    main = name in main_path_case_names()
    if main:
        res["repeat_bitwise_equal"] = _repeat_equal(run)
        res["ok"] = res["ok"] and res["repeat_bitwise_equal"]
    if timing:
        bound, by, nbytes = _ragged_bound_ms(q, k, lengths, window, int8, out.dtype)
        library = None if int8 else _sdpa_library(q, k, v, lengths, window)
        res.update(
            kernel_ms=time_ms(lambda: run(None)),
            plain_ms=time_ms(lambda: run("plain"), warmup=1, iters=3),
            bound_ms=bound, bound_by=by, bytes_moved=nbytes,
            library_ms=None if library is None else time_ms(library, warmup=1, iters=5),
            device_ms=device_ms(lambda: run(None)),
        )
        if main:
            res.update(library_device_ms=device_ms(library, iters=5),
                       library_call="scaled_dot_product_attention with a length mask")
    return res


def _paged_inputs(b, tpp, max_pages, nq, nkv, d, dtype, seed, device, serving_max=0,
                  lengths=None, spare_pages=8):
    """A pool holding every slot's pages in shuffled order (page 0 is the
    null page and holds nobody's rows), q, the page map and the lengths.
    Map entries past a slot's pages point at random pages: never read."""
    g = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    cap = tpp * max_pages
    if lengths is None:
        lengths = spread_lengths(b, cap, seed, serving_max)
    lengths = torch.as_tensor(lengths, dtype=torch.int32)
    held = [-(-min(max(int(n), 0), cap) // tpp) for n in lengths.tolist()]
    num_pages = 1 + sum(held) + spare_pages
    order = rng.permutation(np.arange(1, num_pages))
    page_map = rng.integers(0, num_pages, size=(b, max_pages))
    off = 0
    for i, n in enumerate(held):
        page_map[i, :n] = order[off:off + n]
        off += n
    q = torch.randn((b, nq, d), generator=g, device=device, dtype=torch.float32).to(dtype)
    shape = (num_pages, tpp, nkv, d)
    kp = torch.randn(shape, generator=g, device=device, dtype=torch.float32).to(dtype)
    vp = torch.randn(shape, generator=g, device=device, dtype=torch.float32).to(dtype)
    pm = torch.as_tensor(page_map, dtype=torch.int32, device=device)
    return q, kp, vp, pm, lengths.to(device)


def _paged_library(q, kp, vp, pm, lengths):
    """Two PyTorch calls for the same function: the gather of the pages the
    longest slot reaches, by the page map, and SDPA with a length mask."""
    b, nq, d = q.shape
    tpp, nkv = kp.shape[1], kp.shape[2]
    lens = torch.clamp(lengths.long(), 1, tpp * pm.shape[1])  # an empty row would be NaN
    n_pages = -(-int(lens.max().item()) // tpp)
    idx = pm[:, :n_pages].long()
    mask = (torch.arange(n_pages * tpp, device=q.device)[None, :] < lens[:, None])[:, None, None]
    q4 = q[:, :, None, :]

    def run():
        k = kp[idx].reshape(b, n_pages * tpp, nkv, d).transpose(1, 2)
        v = vp[idx].reshape(b, n_pages * tpp, nkv, d).transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            q4, k, v, attn_mask=mask, enable_gqa=True)
    return run


def paged_case(name, device, timing, *, b, tpp, max_pages, nq, nkv, d, dtype=torch.bfloat16,
               seed=0, serving_max=0, lengths=None):
    q, kp, vp, pm, lengths = _paged_inputs(b, tpp, max_pages, nq, nkv, d, dtype, seed, device,
                                           serving_max, lengths)
    run = lambda impl: rda.paged_decode_attention_v2(q, kp, vp, pm, lengths, impl=impl)
    main = name in main_path_case_names()
    out = run(None)
    torch.cuda.synchronize()
    ref = run("plain")
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == ref.shape, (out.dtype, ref.dtype)
    finite = bool(torch.isfinite(out).all().item())
    empty_zero = bool((out[lengths <= 0] == 0).all().item())
    err = float((out.float() - ref.float()).abs().max().item())
    tol = TOL_BF16 if out.dtype == torch.bfloat16 else TOL_F32
    cap = tpp * max_pages
    valid = torch.clamp(lengths.long(), 0, cap)
    res = dict(
        name=name, kernel="paged_decode_attention", max_abs_err=err, tol=tol,
        ok=bool(err <= tol and finite and empty_zero), finite=finite,
        empty_rows_zero=empty_zero,
        shape=dict(b=b, tpp=tpp, max_pages=max_pages, num_pages=kp.shape[0], nq=nq, nkv=nkv,
                   d=d, dtype=str(dtype), sum_lengths=int(valid.sum().item()),
                   tpp_shift=rda.tpp_shift(tpp)),
        **_cluster_info(rda._PAGED_ENTRY[dtype], b, nkv, cap, d, nq // nkv, device),
    )
    if main:
        res["repeat_bitwise_equal"] = _repeat_equal(run)
        res["ok"] = res["ok"] and res["repeat_bitwise_equal"]
    if timing:
        rows = int(valid.sum().item())
        pages = int((-(-valid // tpp)).sum().item())
        nbytes = (2 * q.numel() * q.element_size() + lengths.numel() * 4 + pages * 4
                  + rows * nkv * d * 2 * kp.element_size())
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = 4 * rows * nq * d / PEAK_OPS_PER_S[dtype]
        library = _paged_library(q, kp, vp, pm, lengths)
        res.update(
            kernel_ms=time_ms(lambda: run(None)),
            plain_ms=time_ms(lambda: run("plain"), warmup=1, iters=3),
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations", bytes_moved=nbytes,
            library_ms=time_ms(library, warmup=1, iters=5),
            library_call="gather by page_map (indexing) + scaled_dot_product_attention "
                         "with a length mask: two calls",
            device_ms=device_ms(lambda: run(None)),
        )
        if main:
            res.update(library_device_ms=device_ms(library, iters=5))
    return res


def paged_cases(device, timing, full_size=True, serve_slots=32):
    """K4 at the serving path's shape (32 slots, 128 rows a page, a 32,768-row
    context, the K1 main path's lengths) and at small shapes that cross
    every edge: lengths 0, 1, tpp-1, tpp, tpp+1, full and past the end; pages
    of 1, 4, 7, 16 and 64 rows; groups 1 to 8; d 64 and 128; both types."""
    bf16, f32 = torch.bfloat16, torch.float32
    main = dict(b=serve_slots, tpp=128, max_pages=256 if full_size else 8, nq=16, nkv=8, d=128)

    def edges(tpp, max_pages):
        full = tpp * max_pages
        return [0, 1, tpp - 1, tpp, tpp + 1, full, full + 5, 0, 2 * tpp + 3]

    out = [paged_case("paged_bf16_main_path", device, timing, **main, serving_max=528, seed=30)]
    for i, (tpp, mp, nq, nkv, d, dtype) in enumerate([
            (16, 8, 16, 8, 128, bf16), (16, 8, 16, 8, 128, f32), (64, 4, 8, 4, 64, bf16),
            (4, 16, 8, 8, 64, f32), (7, 9, 8, 1, 128, bf16), (1, 40, 4, 1, 64, f32),
            (64, 3, 16, 4, 128, f32)]):
        out.append(paged_case(
            f"paged_{'bf16' if dtype == bf16 else 'f32'}_tpp{tpp}_g{nq // nkv}_d{d}", device,
            timing, b=9, tpp=tpp, max_pages=mp, nq=nq, nkv=nkv, d=d, dtype=dtype, seed=31 + i,
            lengths=edges(tpp, mp)))
    # the cluster's split against the pages: lengths whose blocks' row ranges
    # cross page boundaries inside one block, at a power-of-two tpp (shift and
    # mask) and at tpps that are not (the cursor's counter), and the split's edges
    for i, (tpp, mp, nq, nkv, d, dtype) in enumerate([
            (16, 16, 16, 8, 128, bf16), (12, 24, 16, 8, 128, bf16), (12, 20, 8, 2, 64, f32),
            (5, 40, 16, 8, 128, f32), (32, 12, 8, 4, 256, bf16)]):
        cap = tpp * mp
        lengths = split_edge_lengths(cap) + [3 * tpp + 5, 7 * tpp - 2, cap // 2 + 1]
        out.append(paged_case(
            f"paged_{'bf16' if dtype == bf16 else 'f32'}_split_tpp{tpp}_g{nq // nkv}_d{d}",
            device, timing, b=len(lengths), tpp=tpp, max_pages=mp, nq=nq, nkv=nkv, d=d,
            dtype=dtype, seed=40 + i, lengths=lengths))
    return out


def inplace_case(name, device, timing, *, cache_shape, span, cache_dtype,
                 kv_dtype=None, clamp=False, seed=0):
    kv_dtype = kv_dtype or cache_dtype
    b, s = cache_shape[:2]
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(shape, dtype):
        if dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=g, device=device,
                                 dtype=torch.int32).to(torch.int8)
        return torch.randn(shape, generator=g, device=device, dtype=torch.float32).to(dtype)

    cache = rand(cache_shape, cache_dtype)
    kv = rand((b, span) + tuple(cache_shape[2:]), kv_dtype)
    rng = np.random.default_rng(seed)
    idx_np = rng.integers(0, s - span + 1, size=b)
    if clamp:  # spans that run past the cache end: every such row lands on S-1
        idx_np[:4] = [s - 1, s, s + 100, s - span + 1][: min(4, b)]
        if span > 1:
            # rows of one span that clamp onto the same target are written in
            # no fixed order: make them equal so the result is determined
            kv[:4] = kv[:4, :1]
    idx = torch.tensor(idx_np, dtype=torch.int32, device=device)
    got = iu.inplace_row_update(cache.clone(), kv, idx)
    torch.cuda.synchronize()
    want = iu.inplace_row_update(cache.clone(), kv, idx, impl="plain")
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max().item())
    touched = int((got != cache).reshape(b, s, -1).any(-1).sum().item())
    res = dict(
        name=name, kernel="inplace_row_update", max_abs_err=err, tol=0.0,
        ok=bool(err == 0.0 and touched <= b * span),
        shape=dict(cache=list(cache_shape), span=span, cache_dtype=str(cache_dtype),
                   kv_dtype=str(kv_dtype), rows_changed=touched),
    )
    if timing:
        inner = math.prod(cache_shape[2:])
        nbytes = b * span * inner * (kv.element_size() + cache.element_size()) + b * 4
        rows = torch.arange(b, device=device)[:, None]
        offs = torch.clamp(idx.long()[:, None] + torch.arange(span, device=device)[None, :],
                           max=s - 1)
        kv_cast = kv.to(cache_dtype)
        res.update(
            kernel_ms=time_ms(lambda: iu.inplace_row_update(cache, kv, idx)),
            plain_ms=time_ms(lambda: iu.inplace_row_update(cache, kv, idx, impl="plain")),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", bytes_moved=nbytes,
            library_ms=time_ms(lambda: cache.index_put_((rows, offs), kv_cast)),
        )
        if name in main_path_case_names() or name.endswith("_verify"):
            res.update(device_ms=device_ms(lambda: iu.inplace_row_update(cache, kv, idx)),
                       library_device_ms=device_ms(
                           lambda: cache.index_put_((rows, offs), kv_cast)),
                       library_call="index_put_")
    return res


def _row_inputs(kernel, b, s, d, dtype, seed, device, special, w_dtype=torch.float32,
                misaligned=False):
    """(x, second) for one row-kernel case: `second` is w [B,D] (in ``w_dtype``)
    for the norm kernels, u for silu_mul_quantize, None for row_quantize_int8.
    ``misaligned``: x is a contiguous view that starts one element past a
    16-byte boundary."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn((b, s, d), generator=g, device=device, dtype=torch.float32) * 1.5).to(dtype)
    if misaligned:
        base = torch.empty(x.numel() + 1, dtype=dtype, device=device)
        base[1:] = x.reshape(-1)
        x = base[1:].view(b, s, d)
        assert x.is_contiguous() and x.data_ptr() % 16
    if special:
        x[min(1, b - 1)] = 0  # an all-zero batch row (a dummy request, padding)
        # rows whose quotients land on .5: abs-max 127 gives scale 1.0 exactly
        half = (torch.arange(d, device=device) % 126).float() + 0.5
        half[0] = 127.0
        x[0, : min(4, s)] = (half * torch.tensor([1.0, -1.0], device=device)[
            torch.arange(d, device=device) % 2]).to(dtype)
    if kernel in ("ada_rmsnorm", "ada_rmsnorm_quantize"):
        second = (1.0 + 0.3 * torch.randn((b, d), generator=g, device=device,
                                          dtype=torch.float32)).to(w_dtype)
    elif kernel == "silu_mul_quantize":
        second = torch.randn((b, s, d), generator=g, device=device, dtype=torch.float32).to(dtype)
    else:
        second = None
    return x, second


_ROW_FUNCS = {
    "ada_rmsnorm": lambda x, second, impl: arn.ada_rmsnorm(x, second, impl=impl),
    "row_quantize_int8": lambda x, second, impl: qk.row_quantize_int8(x, impl=impl),
    "ada_rmsnorm_quantize": lambda x, second, impl: qk.ada_rmsnorm_quantize(x, second, impl=impl),
    "silu_mul_quantize": lambda x, second, impl: qk.silu_mul_quantize(x, second, impl=impl),
}


def _norm_launch_info(kernel, x, second) -> dict:
    """The launch shape K5 / K7 take for these inputs (chunks a lane, warps a
    row, rows a worker, rounds) and the card's occupancy of that
    instantiation (blocks an SM holds)."""
    rows, d = x.shape[0] * x.shape[1], x.shape[2]
    w_is_f32 = int(second.dtype == torch.float32)
    chunks, warps, per_worker, rounds = arn.norm_launch(kernel, rows, d, x.dtype, w_is_f32,
                                                        x.device)
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    per_sm, threads = arn.norm_occupancy(kernel, arn.FLOAT_DTYPES[x.dtype], w_is_f32, chunks,
                                         warps, bool(rounds), index)
    return dict(chunks_per_lane=chunks, warps_per_row=warps, rows_per_worker=per_worker,
                rounds=bool(rounds), blocks_per_sm=per_sm, threads_per_block=threads)


def row_case(name, device, timing, *, kernel, b, s, d, dtype=torch.bfloat16, seed=0,
             special=False, w_dtype=torch.float32, misaligned=False, repeat=False):
    """One of the four S2A row kernels against its plain version. ``repeat``:
    two launches must also give bitwise-equal outputs."""
    fn = _ROW_FUNCS[kernel]
    x, second = _row_inputs(kernel, b, s, d, dtype, seed, device, special, w_dtype, misaligned)
    got = fn(x, second, None)
    torch.cuda.synchronize()
    want = fn(x, second, "plain")
    torch.cuda.synchronize()
    esz = x.element_size()
    n = x.numel()
    shape = dict(b=b, s=s, d=d, dtype=str(dtype), special_rows=special)
    if second is not None and second.ndim == 2:
        shape["w_dtype"] = str(second.dtype)
    if misaligned:
        shape["x_offset_bytes"] = x.data_ptr() % 16
    if kernel == "ada_rmsnorm":
        assert got.dtype == want.dtype == dtype and got.shape == want.shape
        diff = (got.float() - want.float()).abs()
        err = float(diff.max().item())
        tol = TOL_ROW_F32 if dtype == torch.float32 else TOL_ROW_BF16
        share = float((diff > 0).float().mean().item())
        finite = bool(torch.isfinite(got).all().item())
        ok = finite and err <= tol and (dtype == torch.float32 or share <= MAX_MISMATCH_SHARE)
        res = dict(name=name, kernel=kernel, max_abs_err=err, tol=tol, mismatch_share=share,
                   finite=finite, ok=bool(ok), shape=shape)
        nbytes = 2 * n * esz + second.numel() * second.element_size()
    else:
        (q, sc), (q_ref, sc_ref) = got, want
        assert q.dtype == torch.int8 and sc.dtype == torch.float32
        assert q.shape == x.shape and sc.shape == x.shape[:2]
        steps = (q.int() - q_ref.int()).abs()
        err = float(steps.max().item())
        share = float((steps > 0).float().mean().item())
        rel = float(((sc - sc_ref).abs() / sc_ref.clamp(min=1e-30)).max().item())
        finite = bool(torch.isfinite(sc).all().item())
        exact = kernel == "row_quantize_int8"
        tol_scale = 0.0 if exact else TOL_SCALE_REL[dtype]
        ok = finite and rel <= tol_scale and (
            err == 0 if exact else err <= TOL_CODE_STEPS and share <= MAX_MISMATCH_SHARE)
        if special:  # the all-zero row: zeros and a zero scale, never NaN
            zrow = min(1, b - 1)
            ok = ok and bool((q[zrow] == 0).all().item()) and bool((sc[zrow] == 0).all().item())
        res = dict(name=name, kernel=kernel, max_abs_err=err, tol=0 if exact else TOL_CODE_STEPS,
                   unit="int8 steps", mismatch_share=share, scale_max_rel_err=rel,
                   tol_scale_rel=tol_scale, finite=finite, ok=bool(ok), shape=shape)
        nbytes = n * esz + n + sc.numel() * 4
        if kernel == "silu_mul_quantize":
            nbytes += n * esz
        elif kernel == "ada_rmsnorm_quantize":
            nbytes += second.numel() * second.element_size()
    if kernel in ("ada_rmsnorm", "ada_rmsnorm_quantize"):
        res["launch"] = _norm_launch_info(kernel, x, second)
    if repeat:
        res["repeat_bitwise_equal"] = _repeat_equal(lambda impl: torch.cat([
            t.reshape(-1).view(torch.uint8) for t in (
                fn(x, second, impl) if kernel != "ada_rmsnorm" else (fn(x, second, impl),))]))
        res["ok"] = res["ok"] and res["repeat_bitwise_equal"]
    if timing:
        # rotate over enough copies of the inputs that a launch finds them in
        # device memory, not in the L2 left by the launch before
        copies = max(2, int(math.ceil(2 * L2_BYTES / nbytes)) + 1)
        xs = [x] + [x.clone() for _ in range(copies - 1)]
        big_second = second is not None and second.ndim == 3
        ss = [second] + [second.clone() if big_second else second for _ in range(copies - 1)]
        turn = [0]

        def run(impl):
            i = turn[0] = (turn[0] + 1) % copies
            return fn(xs[i], ss[i], impl)

        res.update(
            kernel_ms=time_ms(lambda: run(None), iters=50),
            plain_ms=time_ms(lambda: run("plain"), warmup=1, iters=5),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", bytes_moved=nbytes,
            library_ms=None,  # no single PyTorch call computes any of these four
            device_ms=device_ms(lambda: run(None)),
            plain_device_ms=device_ms(lambda: run("plain"), iters=3),
        )
    return res


def row_case_specs(full_size=True) -> list[tuple[str, dict]]:
    """(name, :func:`row_case` keywords) of every K5-K8 case: the main-path
    shape in bfloat16 and float32, widths that are no multiple of 128 (1000)
    or of the vector width (1001), a row count that is no multiple of any
    block (650), an all-zero batch row and rows whose quotients land on .5;
    for K5 and K7 also the edges of their kernel's launch shape: one row a
    batch entry (x [B, D] through ``AdaptiveRMSNorm``), batch entries that end
    inside one warp's and one block's rows, rows of 8, 24 and 2048 elements,
    rows split over the warps of a block (8192) and walked in rounds, an x
    that starts off a 16-byte boundary, and w in x's type."""
    bf16, f32 = torch.bfloat16, torch.float32
    main = dict(S2A_MAIN) if full_size else dict(b=2, s=96, d=1024)
    out = []
    for i, kernel in enumerate(_ROW_FUNCS):
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


def row_cases(device, timing, full_size=True):
    """K5-K8, every case of :func:`row_case_specs`, then K5 in training."""
    return [row_case(name, device, timing, **kw) for name, kw in row_case_specs(full_size)] \
        + norm_grad_cases(device, timing, full_size)


# The S2A training step's AdaptiveRMSNorm: 8 x 512 frames of hidden 1024; its
# residual stream is float32 (float32 parameters promote it), the main path.
S2A_TRAIN_NORM = dict(b=8, s=512, d=1024)


def norm_grad_case(name, device, timing, *, b, s, d, dtype, seed):
    """K5 as training calls it: through its ``torch.autograd.Function`` (x
    and w need gradients), one launch a forward; the forward against the
    plain version's, and the backward (plain PyTorch on the saved x and w in
    both routes) EQUAL to the plain route's."""
    x, w = _row_inputs("ada_rmsnorm", b, s, d, dtype, seed, device, False)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    cot = torch.randn(x.shape, generator=g, device=device).to(dtype)

    def run(impl):
        xr, wr = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
        y = arn.ada_rmsnorm(xr, wr, impl=impl)
        return (y,) + torch.autograd.grad(y, (xr, wr), cot)

    before = arn.launch_count
    y, dx, dw = run(None)
    torch.cuda.synchronize()
    launches = arn.launch_count - before
    y_ref, dx_ref, dw_ref = run("plain")
    torch.cuda.synchronize()
    through_function = type(y.grad_fn).__name__.startswith("_AdaRMSNorm")
    diff = (y.float() - y_ref.float()).abs()
    err = float(diff.max().item())
    tol = TOL_ROW_F32 if dtype == torch.float32 else TOL_ROW_BF16
    share = float((diff > 0).float().mean().item())
    backward_equal = bool(torch.equal(dx, dx_ref) and torch.equal(dw, dw_ref))
    finite = all(bool(torch.isfinite(t).all().item()) for t in (y, dx, dw))
    ok = finite and err <= tol and launches == 1 and through_function and backward_equal and (
        dtype == torch.float32 or share <= MAX_MISMATCH_SHARE)
    res = dict(name=name, kernel="ada_rmsnorm", max_abs_err=err, tol=tol, mismatch_share=share,
               backward_equal_to_plain=backward_equal, autograd_function=through_function,
               launches_a_forward=launches, finite=finite, ok=bool(ok),
               shape=dict(b=b, s=s, d=d, dtype=str(dtype), w_dtype=str(w.dtype),
                          requires_grad=True),
               launch=_norm_launch_info("ada_rmsnorm", x, w))
    if timing:
        nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
        # rotate over copies of the inputs, as row_case does, past the L2
        copies = max(2, int(math.ceil(2 * L2_BYTES / nbytes)) + 1)
        xs = [x.detach().clone().requires_grad_(True) for _ in range(copies)]
        wr = w.detach().requires_grad_(True)
        turn = [0]

        def fwd(impl=None):
            i = turn[0] = (turn[0] + 1) % copies
            return arn.ada_rmsnorm(xs[i], wr, impl=impl)

        res.update(
            kernel_ms=time_ms(fwd, iters=50),
            plain_ms=time_ms(lambda: fwd("plain"), warmup=1, iters=5),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", bytes_moved=nbytes,
            library_ms=None,  # no single PyTorch call computes it
            device_ms=device_ms(fwd),
            plain_device_ms=device_ms(lambda: fwd("plain"), iters=3),
        )
    return res


def norm_grad_cases(device, timing, full_size=True):
    """K5 through its autograd Function: the S2A training step's float32
    stream (the main path) and the same rows in bfloat16."""
    main = dict(S2A_TRAIN_NORM) if full_size else dict(S2A_TRAIN_NORM, b=2, s=96)
    return [norm_grad_case("ada_rmsnorm_grad_f32_s2a_train", device, timing, **main,
                           dtype=torch.float32, seed=190),
            norm_grad_case("ada_rmsnorm_grad_bf16", device, timing, **main,
                           dtype=torch.bfloat16, seed=191)]


def _attention_inputs(b, s, n, d, dtype, seed, device, fused):
    """q (scale folded in), k, v [B,S,N,D]; with ``fused`` the three are
    strided views of one [B, S, 3*N*D] projection output, as in the denoiser."""
    g = torch.Generator(device=device).manual_seed(seed)
    if fused:
        qkv = torch.randn((b, s, 3 * n * d), generator=g, device=device).to(dtype)
        qkv[..., : n * d] *= 1.0 / math.sqrt(d)
        q, k, v = (t.reshape(b, s, n, d) for t in torch.split(qkv, n * d, dim=-1))
        return q, k, v
    q = (torch.randn((b, s, n, d), generator=g, device=device) / math.sqrt(d)).to(dtype)
    k = torch.randn((b, s, n, d), generator=g, device=device).to(dtype)
    v = torch.randn((b, s, n, d), generator=g, device=device).to(dtype)
    return q, k, v


def attention_case(name, device, timing, *, b, s, n=16, d=64, dtype=torch.bfloat16, seed=0,
                   fused=False):
    """K12 against its plain version: S non-multiple of the 64-row tile, one
    row, strided views. A bfloat16 case runs every block size of the kernel
    (``s2a.BLOCK_ROWS``, the wrapper's choice first) and holds each to the
    tolerance; with ``timing`` it also times each on the device."""
    q, k, v = _attention_inputs(b, s, n, d, dtype, seed, device, fused)
    want = s2a.s2a_attention(q, k, v, impl="plain")
    torch.cuda.synchronize()
    tilings = [None]
    if dtype == torch.bfloat16:
        chosen = s2a.block_rows(b, s, n)
        tilings = [chosen] + [r for r in s2a.BLOCK_ROWS if r != chosen]
    errs, finite = {}, True
    for rows in tilings:
        got = s2a.s2a_attention(q, k, v, rows=rows)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype == dtype and got.shape == want.shape == (b, s, n, d)
        errs[rows] = float((got.float() - want.float()).abs().max().item())
        finite = finite and bool(torch.isfinite(got).all().item())
    err = max(errs.values())
    tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
    res = dict(name=name, kernel="s2a_attention", max_abs_err=err, tol=tol,
               ok=bool(finite and err <= tol), finite=finite,
               shape=dict(b=b, s=s, n=n, d=d, dtype=str(dtype), strided_views=fused))
    if tilings[0] is not None:
        res.update(block_rows=tilings[0],
                   max_abs_err_by_block_rows={str(r): e for r, e in errs.items()})
    if timing:
        esz = q.element_size()
        nbytes = 4 * b * s * n * d * esz  # q, k, v read once, the output written once
        ops = 4 * b * n * s * s * d
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, scale=1.0)
        if name in main_path_case_names():
            res.update(library_device_ms=device_ms(library, iters=5),
                       library_call="scaled_dot_product_attention")
        res.update(
            kernel_ms=time_ms(lambda: s2a.s2a_attention(q, k, v)),
            plain_ms=time_ms(lambda: s2a.s2a_attention(q, k, v, impl="plain"), warmup=1,
                             iters=5),
            bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops
            else "operations", bytes_moved=nbytes, flops=ops,
            library_ms=time_ms(library, warmup=1, iters=10),
            device_ms=device_ms(lambda: s2a.s2a_attention(q, k, v)),
            plain_device_ms=device_ms(lambda: s2a.s2a_attention(q, k, v, impl="plain"),
                                      iters=3),
        )
        if tilings[0] is not None:
            res["device_ms_by_block_rows"] = {
                str(r): device_ms(lambda r=r: s2a.s2a_attention(q, k, v, rows=r))
                for r in tilings}
    return res


# ``synthesize`` at full width with a 3-s prompt (149 semantic / 150 acoustic
# frames, so P = 149) and 256 target frames: the conditional denoiser forward
# attends over P + T rows, the unconditional one over T.
SYNTH_PROMPT, SYNTH_TARGET = 149, 256


def attention_cases(device, timing, full_size=True):
    """K12: the ``synthesize`` shapes in bfloat16 (the int8 serving modes) and
    float32, short and ragged S, the batched [8, 768] shape, strided views
    (bfloat16 also at the ``synthesize`` shape, as the denoiser hands them
    over), D = 32, 64 and 128 in bfloat16."""
    bf16, f32 = torch.bfloat16, torch.float32
    cond, uncond = SYNTH_PROMPT + SYNTH_TARGET, SYNTH_TARGET
    batched = dict(b=8, s=768) if full_size else dict(b=2, s=200)
    return [
        attention_case("s2a_attention_bf16_main_path", device, timing, b=1, s=cond, seed=200),
        attention_case("s2a_attention_bf16_uncond", device, timing, b=1, s=uncond, seed=201),
        attention_case("s2a_attention_f32_cond", device, timing, b=1, s=cond, dtype=f32,
                       seed=202),
        attention_case("s2a_attention_f32_uncond", device, timing, b=1, s=uncond, dtype=f32,
                       seed=203),
        attention_case("s2a_attention_bf16_s1", device, timing, b=2, s=1, seed=204),
        attention_case("s2a_attention_f32_s63", device, timing, b=2, s=63, dtype=f32, seed=205),
        attention_case("s2a_attention_bf16_s65", device, timing, b=2, s=65, seed=206),
        attention_case("s2a_attention_f32_s130_d128", device, timing, b=1, s=130, n=4, d=128,
                       dtype=f32, seed=207),
        attention_case("s2a_attention_bf16_s130_d32", device, timing, b=3, s=130, n=8, d=32,
                       seed=208),
        attention_case("s2a_attention_bf16_batched", device, timing, **batched, seed=209),
        attention_case("s2a_attention_bf16_strided_views", device, timing, b=2, s=406,
                       fused=True, seed=210),
        attention_case("s2a_attention_f32_strided_views", device, timing, b=1, s=130, fused=True,
                       dtype=f32, seed=211),
        attention_case("s2a_attention_bf16_s130_d128", device, timing, b=1, s=130, n=4, d=128,
                       seed=212),
        attention_case("s2a_attention_bf16_main_path_views", device, timing, b=1, s=cond,
                       fused=True, seed=213),
    ]


# K9-K11 against their plain versions ON THE CARD.
# float32: summation order only, 2e-5 of the largest value of the plain result
# (at least 1).
# bfloat16, element by element: both sides round float32 values that differ in
# their last bits (K9 also rounds its probabilities against a running max, the
# plain version against the row's max), so an element may differ by a bfloat16
# step of itself (2**-8 to 2**-7 relative) plus the rounding noise of its sum,
# a few 2**-9 of the row's scale. The error of each element is taken relative
# to max(|plain|, mean |plain|, 2**-10), the mean standing for that scale where
# a sum cancels to near 0, and may be at most 2**-5 (four bfloat16 steps at the
# coarse end). 2**-10 is a floor far above float32 rounding noise and below
# the values of these cases: where the exact result is 0 (at S = 1, dq and dk:
# a softmax over one key has no gradient) both sides return rounding noise of
# ~1e-7, which has no scale of its own.
# A padding row (segment id 0) is 0 on both sides (o's are checked to be
# exactly 0) and carries no scale, yet the mean over all rows counts it: 72 %
# of the emilia-packed rows are padding, which cuts the mean to 0.28 of the
# scale of a row that attends. The cases of the training and serving paths
# with padding rows (emilia-packed, c4_mlperf, the S2A's pad tails and the
# serving mask) therefore take the mean over the rows that attend
# (``unit_mean="attending"``); the cases before them keep the mean over all
# rows. Every bfloat16 case reports both readings, and both sides' errors
# against the plain version run in float32 on the same inputs (the exact
# value of the function, no bfloat16 rounding point): that shows which side
# is further from it. The flagship's training case (one causal row of 4096
# tokens) takes each element's own row for the mean (``unit_mean="row"``): the
# mean over all rows falls with S (a causal row i averages ~i values: its
# scale is ~1/sqrt(i)), to 0.025 at S = 4096, below the rounding noise of the
# first rows, where a few keys of unit size can cancel to a small output (on
# an H100 80GB HBM3 at 700 W the kernel and the bfloat16 plain version read
# the same distance from the float32 result there, 0.0717 (K9) and 0.0794
# (K10) in the all-rows unit, and 0.041 and 0.034 from each other).
# Both round ds to bfloat16 before ds k (the JAX rounding
# point), so each is further from that float32 dq than from the other.
# lse is float32 in both dtypes, from exact products of the inputs, summed in
# another order: 1e-4 absolute.
TOL_FLASH = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -5}
TOL_FLASH_FLOOR = 2.0 ** -10
TOL_FLASH_UNIT = {torch.float32: "relative to max(1, max |plain|)",
                  torch.bfloat16: "each element relative to max(|plain|, mean |plain|, 2**-10)"}
TOL_FLASH_MEAN_OVER = {"all": "the mean over all rows",
                       "attending": "the mean over the rows that attend (segment id != 0)",
                       "row": "the mean over the element's own row (its D values)"}
TOL_FLASH_LSE = 1e-4
# The training step's attention: per_device_batch_size 4 x 2048 tokens of
# tts-1b, 16 query / 8 kv heads of 128.
FLASH_MAIN = dict(b=4, s=2048, h=16, hkv=8, d=128)
# The flagship's training step (tts-flagship at full width): one row of 4096
# tokens, 16 query / 8 kv heads of 256.
FLASH_FLAGSHIP = dict(b=1, s=4096, h=16, hkv=8, d=256)
# qwen3-30b-a3b's training step (moe_train): 4 x 1024 tokens, 32 query / 4 kv
# heads of 128 (GQA group 8).
FLASH_QWEN3_MOE = dict(b=4, s=1024, h=32, hkv=4, d=128)
# the parallel phases' shapes (chip_smoke.py): a rank's 2 rows of the tts-1b
# recipe (FSDP, the pipeline's microbatch, elastic) and Zero-1's 1 row, the
# context-parallel calls on 16,384 tokens (a ring hop's block at cp 2 and 4,
# all-gathered keys at cp 2, Ulysses' head shard at cp 2), and the
# post-training rows (GRPO's 16 completions and SFT on distillation's
# JSONL, 128 tokens). The long-context cases take the bfloat16 unit of each
# element's own row, as the flagship's 4,096-token case does: a causal row of
# thousands of keys averages its values down, and the mean over all rows
# would measure the rows that see the most keys against the ones that see few
FLASH_RANK_ROWS = dict(b=2, s=2048, h=16, hkv=8, d=128)
CONTEXT_TOKENS = 16384
FLASH_POSTTRAIN = dict(b=16, s=128, h=16, hkv=8, d=128)
POSTTRAIN_DECODE = dict(b=16, s=128, nq=16, nkv=8, d=128)
# The S2A training step on its sequence-flash route: 8 x 512 frames, 16 heads
# of 64 (no grouping).
S2A_TRAIN_FLASH = dict(b=8, s=512, h=16, hkv=16, d=64)
# The masked serving pass on the sequence-flash route: 8 requests, the prompt
# padded to 256 frames and the target bucketed to 512; the pad mask is the
# segment ids (prompt, gap, target, tail in each row).
S2A_SERVING_FLASH = dict(b=8, s=768, h=16, hkv=16, d=64)
SERVING_PROMPT_PAD = 256
# train_c4's documents: the .jsonl the phase writes (seeded word lists).
C4_DOCUMENTS, C4_SEED = 400, 4
_C4_WORDS = ("the", "speech", "model", "learns", "tokens", "from", "text", "and", "audio",
             "on", "one", "card", "with", "packed", "rows")


def _flash_inputs(b, s, h, hkv, d, dtype, seed, device, segments, positions, peak=1.0):
    """q [B,S,H,D], k, v [B,S,Hkv,D] and the output cotangent in the model's
    layout; positions and segment ids [B,S] int32. ``peak`` scales q and k, so
    that the logits' spread is ``peak**2`` times the unit one."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(n, scale=1.0):
        return (torch.randn((b, s, n, d), generator=g, device=device) * scale).to(dtype)

    q, k, v, do = rnd(h, peak), rnd(hkv, peak), rnd(hkv), rnd(h)
    pos = torch.arange(s, dtype=torch.int32, device=device)[None].repeat(b, 1)
    if positions == "reordered":  # a context-parallel load-balanced permutation
        pos = fa.load_balanced_reorder(pos, 2)
    seg = torch.ones((b, s), dtype=torch.int32, device=device)
    if segments == "packed":  # documents of 3/8, 1/2 and the rest of a row, then padding
        cuts = [0, 3 * s // 8, 7 * s // 8, s - max(1, s // 16), s]
        for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
            seg[:, lo:hi] = i + 1 if hi < s else 0
            pos[:, lo:hi] = torch.arange(hi - lo, dtype=torch.int32, device=device)
    elif segments == "emilia":  # the packed rows of the emilia_audio iterator
        pos, seg = emilia_packed_ids(b, s, device)
    elif segments == "pad_tails":  # one segment a row, then a padding tail of its own length
        seg = (torch.arange(s, device=device)[None, :]
               < pad_tail_lengths(b, s, seed).to(device)[:, None]).to(torch.int32)
    elif segments == "serving":  # the masked serving pass: prompt, gap, target, tail
        seg = serving_pad_mask(b, SERVING_PROMPT_PAD, s - SERVING_PROMPT_PAD, device)
    elif segments == "c4_mlperf":  # train_c4's rows: one segment, 0 where a target is EOS
        pos, seg = c4_mlperf_ids(b, s, device)
    return q, k, v, do, pos, seg


def serving_pad_mask(rows: int, p_pad: int, t_pad: int, device) -> torch.Tensor:
    """[rows, p_pad + t_pad] int32 pad mask of the S2A back end's batch of
    ``backend_requests(0, rows)``: each prompt from 0, each target from
    ``p_pad``, padding after either."""
    from maxtext_indextts2_tpu_torch.audio.pipeline import backend_requests

    _, sems, _, gens = backend_requests(0, rows)
    mask = torch.zeros((rows, p_pad + t_pad), dtype=torch.int32)
    for i, (sm, gn) in enumerate(zip(sems, gens)):
        mask[i, :len(sm)] = 1
        mask[i, p_pad:p_pad + len(gn)] = 1
    return mask.to(device)


def write_c4_documents(path: str, n: int = C4_DOCUMENTS, seed: int = C4_SEED) -> None:
    """``n`` seeded documents of 20-80 words as a ``c4_mlperf`` .jsonl."""
    import json

    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for i in range(n):
            words = rng.choice(_C4_WORDS, size=int(rng.integers(20, 80))).tolist()
            fh.write(json.dumps({"text": f"document {i}: " + " ".join(words)}) + "\n")


def c4_mlperf_ids(b: int, s: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(positions, segment ids) [B, S] int32 of the first ``c4_mlperf``
    batch over :func:`write_c4_documents` at the ``tts-1b`` config (byte
    tokenizer): what the ``train_c4`` path gives the flash kernels."""
    import os
    import tempfile

    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.train.data.mlperf_pipeline import make_c4_mlperf_iterator

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory(prefix="c4_ids_") as tmp:
        path = os.path.join(tmp, "c4.jsonl")
        write_c4_documents(path)
        cfg = load_config([os.path.join(pkg, "configs", "models", "tts-1b.yml"),
                           "dataset_type=c4_mlperf", f"dataset_path={path}",
                           f"per_device_batch_size={b}", f"max_target_length={s}"])
        batch = next(make_c4_mlperf_iterator(cfg))
    return (torch.from_numpy(batch["inputs_position"][:b]).to(device),
            torch.from_numpy(batch["inputs_segmentation"][:b]).to(device))


def emilia_packed_ids(b: int, s: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(positions, segment ids) [B, S] int32 of the first batch of the
    ``emilia_audio`` iterator (synthetic text + audio documents of 22-125
    tokens packed first-fit by ``PackedBatcher``) at the ``tts-1b`` vocabulary:
    what the ``train_packed`` path gives the flash kernels."""
    import os

    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.train.data.audio_iterator import (
        make_emilia_audio_train_iterator,
    )

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config([os.path.join(pkg, "configs", "models", "tts-1b.yml"),
                       "dataset_type=emilia_audio", f"per_device_batch_size={b}",
                       f"max_target_length={s}"])
    batch = next(make_emilia_audio_train_iterator(cfg))
    return (torch.from_numpy(batch["inputs_position"][:b]).to(device),
            torch.from_numpy(batch["inputs_segmentation"][:b]).to(device))


def pad_tail_lengths(b: int, s: int, seed: int) -> torch.Tensor:
    """Valid lengths of ``b`` rows of ``s``: the first row full, the others
    spread over [s/4, s) (a batch of requests padded to one length)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(s // 4, s, size=b)
    lengths[0] = s
    return torch.from_numpy(lengths)


def _flash_pairs(pos, seg, causal, window, chunk, kv_pos=None, kv_seg=None) -> int:
    """Visible (query, key) pairs over the batch: the work the data needs."""
    kv_pos = pos if kv_pos is None else kv_pos
    kv_seg = seg if kv_seg is None else kv_seg
    return int(fa._mask(pos, kv_pos, seg, kv_seg, causal, window, chunk).sum().item())


def context_positions(cp: int, s_local: int, rank: int, device) -> torch.Tensor:
    """[1, s_local] global positions of context rank ``rank``'s shard in the
    load-balanced order (chunks ``rank`` and ``2 cp - 1 - rank`` of 2 cp)."""
    n = s_local // 2
    chunks = [torch.arange(c * n, (c + 1) * n, dtype=torch.int32, device=device)
              for c in (rank, 2 * cp - 1 - rank)]
    return torch.cat(chunks)[None]


def _context_kv(context, b, s, device):
    """(q positions, kv positions, kv length) of a context-parallel call on
    context rank 0: ``("ring", cp, hop)``, the block the ring brings at hop
    ``hop`` (rank -hop's); ``("allgather", cp)``, every rank's shard."""
    kind, cp = context[0], context[1]
    q_pos = context_positions(cp, s, 0, device).repeat(b, 1)
    if kind == "ring":
        kv_pos = context_positions(cp, s, (-context[2]) % cp, device)
    else:
        kv_pos = torch.cat([context_positions(cp, s, r, device) for r in range(cp)], dim=1)
    return q_pos, kv_pos.repeat(b, 1), kv_pos.shape[1]


def _flash_library(q, k, v, do, on_device=False, causal=True, mask=None):
    """SDPA with enable_gqa on the same [B,N,S,D] views (``is_causal``, or a
    boolean ``mask`` [B,1,S,S]), forward, and its autograd backward (dq, dk
    and dv in one call): a yardstick only. (forward ms, backward ms), and with
    ``on_device`` their device times too."""
    f = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v))
    kw = dict(is_causal=causal and mask is None, attn_mask=mask, enable_gqa=True)
    out = f(qt, kt, vt, **kw)
    gt = do.transpose(1, 2)
    fwd = lambda: f(qt, kt, vt, **kw)  # noqa: E731
    bwd = lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)  # noqa: E731
    times = (time_ms(fwd, warmup=2, iters=10), time_ms(bwd, warmup=2, iters=10))
    if on_device:
        times += (device_ms(fwd, iters=5), device_ms(bwd, iters=5))
    return times


def flash_case(name, device, timing, *, b, s, h, hkv, d, dtype=torch.bfloat16, causal=True,
               window=0, chunk=0, cap=0.0, segments="one", positions="arange", peak=1.0,
               seed=0, unit_mean="all", context=None):
    """K9, K10 and K11 against their plain versions on the same inputs: three
    results, ``{name}_fwd``, ``{name}_dq`` and ``{name}_dkv``. The backward
    kernels and their plain versions get the same lse and delta (the kernel's).
    ``unit_mean``: the rows whose mean enters the bfloat16 unit, see
    ``TOL_FLASH``. ``context``: a context-parallel call on rank 0's shard of
    ``s`` queries (:func:`_context_kv`): keys of their own length and global
    positions."""
    if unit_mean not in TOL_FLASH_MEAN_OVER:
        raise ValueError(f"flash_case: unit_mean {unit_mean!r}")
    q, k, v, do, pos, seg = _flash_inputs(b, s, h, hkv, d, dtype, seed, device, segments,
                                          positions, peak)
    kv_pos, kv_seg = pos, seg
    if context is not None:
        pos, kv_pos, kv_s = _context_kv(context, b, s, device)
        k, v = _flash_inputs(b, kv_s, hkv, hkv, d, dtype, seed + 1, device, "one", "arange",
                             peak)[1:3]
        kv_seg = torch.ones_like(kv_pos)
    qh, kh, vh, doh = (t.transpose(1, 2) for t in (q, k, v, do))  # [B,N,S,D] views
    ids = (pos, kv_pos, seg, kv_seg)
    mask = (causal, window, chunk, cap, None)
    o, lse = fa.flash_fwd(qh, kh, vh, *ids, *mask)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_fwd(qh, kh, vh, *ids, *mask, impl="plain")
    delta = torch.sum(o.float() * doh.float(), dim=-1)
    dq = fa.flash_bwd_dq(qh, kh, vh, doh, lse, delta, *ids, *mask)
    dk, dv = fa.flash_bwd_dkv(qh, kh, vh, doh, lse, delta, *ids, *mask)
    torch.cuda.synchronize()
    dq_ref = fa.flash_bwd_dq(qh, kh, vh, doh, lse, delta, *ids, *mask, impl="plain")
    dk_ref, dv_ref = fa.flash_bwd_dkv(qh, kh, vh, doh, lse, delta, *ids, *mask, impl="plain")
    torch.cuda.synchronize()

    outs = {"flash_fwd": [o], "flash_bwd_dq": [dq], "flash_bwd_dkv": [dk, dv]}
    plain = {"flash_fwd": [o_ref], "flash_bwd_dq": [dq_ref], "flash_bwd_dkv": [dk_ref, dv_ref]}
    exact = None
    if dtype != torch.float32:  # the same function in float32 on the same inputs
        q32, k32, v32, do32 = (t.float() for t in (qh, kh, vh, doh))
        exact = {"flash_fwd": [fa.flash_fwd(q32, k32, v32, *ids, *mask, impl="plain")[0]],
                 "flash_bwd_dq": [fa.flash_bwd_dq(q32, k32, v32, do32, lse, delta, *ids, *mask,
                                                  impl="plain")],
                 "flash_bwd_dkv": list(fa.flash_bwd_dkv(q32, k32, v32, do32, lse, delta, *ids,
                                                        *mask, impl="plain"))}
        del q32, k32, v32, do32
    rows = (seg != 0)[:, None, :, None]  # [B,1,S,1]: rows that attend to something
    kv_rows = (kv_seg != 0)[:, None, :, None]

    def rel_err(got, want, mean_over="all"):
        """(max |err|, the largest error in the dtype's unit, see ``TOL_FLASH``,
        with the mean over ``mean_over``: all rows, the rows that attend, or
        each element's own row)."""
        diff = (got.float() - want.float()).abs()
        mag = want.float().abs()
        if dtype == torch.float32:
            scale = torch.clamp(mag.max(), min=1.0)
        elif mean_over == "row":
            scale = torch.clamp(torch.maximum(mag, mag.mean(-1, keepdim=True)),
                                min=TOL_FLASH_FLOOR)
        else:
            own = rows if rows.shape[2] == mag.shape[2] else kv_rows  # dk, dv: the keys' rows
            live = mag[own.expand_as(mag)] if mean_over == "attending" else mag
            mean = float((live if live.numel() else mag).mean().item())
            scale = torch.clamp(mag, min=max(mean, TOL_FLASH_FLOOR))
        return float(diff.max().item()), float((diff / scale).max().item())

    def readings(got, want):  # worst over a kernel's outputs, every mean of the unit
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        return dict(max_abs_err=max(e[0] for e in errs), max_err=max(e[1] for e in errs),
                    max_err_attending_rows=max(rel_err(g, w, "attending")[1]
                                               for g, w in zip(got, want)),
                    max_err_own_row=max(rel_err(g, w, "row")[1] for g, w in zip(got, want)))

    shape = dict(b=b, s=s, h=h, hkv=hkv, d=d, dtype=str(dtype), causal=causal, window=window,
                 chunk=chunk, soft_cap=cap, segments=segments, positions=positions, peak=peak)
    if context is not None:
        shape.update(context=list(context), kv_s=int(kv_pos.shape[1]))
    tol = TOL_FLASH[dtype]
    lse_ok = bool(torch.equal(torch.isneginf(lse), torch.isneginf(lse_ref)))
    fin = torch.isfinite(lse_ref)
    lse_err = float((lse[fin] - lse_ref[fin]).abs().max().item()) if fin.any() else 0.0
    padding_zero = bool((o.transpose(1, 2)[seg == 0] == 0).all().item())
    results = []
    for kernel in outs:
        finite = all(bool(torch.isfinite(t).all().item()) for t in outs[kernel])
        vs = {"plain": readings(outs[kernel], plain[kernel])}
        if exact is not None:
            vs["kernel_vs_float32"] = readings(outs[kernel], exact[kernel])
            vs["plain_vs_float32"] = readings(plain[kernel], exact[kernel])
        worst = vs["plain"][{"all": "max_err", "attending": "max_err_attending_rows",
                             "row": "max_err_own_row"}[unit_mean]]
        ok = finite and worst <= tol
        unit = TOL_FLASH_UNIT[dtype] + (
            "" if dtype == torch.float32 else f", {TOL_FLASH_MEAN_OVER[unit_mean]}")
        res = dict(name=f"{name}_{kernel[len('flash_'):].replace('bwd_', '')}", kernel=kernel,
                   max_abs_err=vs["plain"]["max_abs_err"], max_err=worst, tol=tol, unit=unit,
                   finite=finite, shape=shape, readings=vs)
        if kernel == "flash_fwd":
            ok = ok and lse_ok and lse_err <= TOL_FLASH_LSE and padding_zero
            res.update(lse_max_abs_err=lse_err, tol_lse=TOL_FLASH_LSE,
                       lse_minus_inf_rows_equal=lse_ok, padding_rows_zero=padding_zero)
        res["ok"] = bool(ok)
        results.append(res)
    if timing:
        pairs = _flash_pairs(pos, seg, causal, window, chunk, kv_pos, kv_seg)
        esz = q.element_size()
        n_q, n_kv = q.numel(), k.numel()
        stats = b * h * s * 4  # one float32 per query row and head (lse, delta)
        ids_bytes = 4 * 4 * b * s
        work = {  # bytes moved (inputs once, outputs once), flops of the visible pairs
            "flash_fwd": ((2 * n_q + 2 * n_kv) * esz + stats + ids_bytes, 4 * d * h * pairs),
            "flash_bwd_dq": ((3 * n_q + 2 * n_kv) * esz + 2 * stats + ids_bytes,
                             6 * d * h * pairs),
            "flash_bwd_dkv": ((2 * n_q + 4 * n_kv) * esz + 2 * stats + ids_bytes,
                              8 * d * h * pairs),
        }
        calls = {
            "flash_fwd": lambda impl=None: fa.flash_fwd(qh, kh, vh, *ids, *mask, impl=impl),
            "flash_bwd_dq": lambda impl=None: fa.flash_bwd_dq(qh, kh, vh, doh, lse, delta, *ids,
                                                              *mask, impl=impl),
            "flash_bwd_dkv": lambda impl=None: fa.flash_bwd_dkv(qh, kh, vh, doh, lse, delta,
                                                                *ids, *mask, impl=impl),
        }
        library, library_call = (None, None), None
        on_device = f"{name}_fwd" in main_path_case_names() or name in FLASH_LIBRARY_ON_DEVICE
        if not (window or chunk or cap) and segments == "one" and positions == "arange" \
                and context is None:
            library = _flash_library(q, k, v, do, on_device=on_device, causal=causal)
            library_call = f"scaled_dot_product_attention({'is_causal, ' * causal}enable_gqa)"
        elif on_device and not (chunk or cap):
            # the same visibility as a boolean mask (made once, not timed)
            visible = fa._mask(pos, kv_pos, seg, kv_seg, causal, window, chunk)[:, 0]
            library = _flash_library(q, k, v, do, on_device=True, mask=visible)
            library_call = (f"scaled_dot_product_attention(attn_mask of the "
                            f"{'window' if window else 'segments'}, enable_gqa)")
        for res in results:
            kernel = res["kernel"]
            nbytes, ops = work[kernel]
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
            res.update(
                kernel_ms=time_ms(calls[kernel], warmup=1, iters=5),
                device_ms=device_ms(calls[kernel], iters=3),
                plain_ms=time_ms(lambda: calls[kernel]("plain"), warmup=1, iters=2),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations", bytes_moved=nbytes,
                flops=ops, visible_pairs=pairs,
                library_ms=library[0] if kernel == "flash_fwd" else library[1],
                library_call=None if library_call is None else library_call + (
                    "" if kernel == "flash_fwd" else ": its autograd backward (dq, dk, dv)"),
            )
            if len(library) == 4:
                res["library_device_ms"] = library[2] if kernel == "flash_fwd" else library[3]
    return results


# cases off the main paths whose library call is timed on the device too:
# SDPA with enable_gqa at GQA groups 5, 6 and 16, and masked SDPA (the
# visible pairs as a boolean mask) at D = 256 on packed rows and a window
FLASH_LIBRARY_ON_DEVICE = {"flash_bf16_group5", "flash_bf16_group6", "flash_bf16_group16",
                           "flash_bf16_d256_packed", "flash_bf16_d256_window256"}


def flash_cases(device, timing, full_size=True):
    """K9-K11: the training step's shape (bfloat16 and float32), packed
    documents with a segment-0 tail, sliding window, chunks, soft cap,
    non-causal, permuted positions, peaked logits (q and k scaled by 3: the
    logits' spread is 9, so a few keys take most of a row's softmax and the
    running max moves by many units between key tiles), D = 64 at ragged S
    (405; 1000, which the 64- and 32-row tiles do not divide), S = 1 and
    S = 130; the training paths' shapes: ``tts-1b`` on packed ``emilia_audio``
    rows (``PackedBatcher``'s segment ids and restarted positions) and on
    ``c4_mlperf`` rows, the S2A's sequence-flash route in float32 (its main
    path) and with pad tails, and the masked serving pass on that route; at
    D = 256 (the flagship's heads) its training shape, packed documents, a
    sliding window, chunks with a soft cap, and odd-length float32 cases; at
    GQA group 8 qwen3-30b-a3b's training shape and packed documents; at
    groups 5, 6 and 16 (the other presets' heads) a causal step."""
    main = dict(FLASH_MAIN) if full_size else dict(FLASH_MAIN, b=1, s=512)
    flagship = dict(FLASH_FLAGSHIP) if full_size else dict(FLASH_FLAGSHIP, s=512)
    d256 = dict(b=2, s=1000 if full_size else 200, h=16, hkv=8, d=256)
    s2a_main = dict(S2A_TRAIN_FLASH) if full_size else dict(S2A_TRAIN_FLASH, b=2)
    serving = dict(S2A_SERVING_FLASH) if full_size else dict(S2A_SERVING_FLASH, b=2)
    small = dict(b=2, s=1024 if full_size else 256, h=16, hkv=8, d=128)
    qwen3 = dict(FLASH_QWEN3_MOE) if full_size else dict(FLASH_QWEN3_MOE, b=1, s=256)
    rank_rows = dict(FLASH_RANK_ROWS) if full_size else dict(FLASH_RANK_ROWS, s=512)
    tokens = CONTEXT_TOKENS if full_size else 2048

    def cp_shard(cp):  # one context rank's queries of the whole sequence
        return dict(b=1, s=tokens // cp, h=16, hkv=8, d=128)

    f32 = torch.float32
    groups = [
        flash_case("flash_bf16_main_path", device, timing, **main, seed=300),
        flash_case("flash_f32", device, timing, **main, dtype=f32, seed=301),
        flash_case("flash_bf16_packed_padding", device, timing, **dict(small, s=small["s"] - 24),
                   segments="packed", seed=302),
        flash_case("flash_f32_packed_padding", device, timing, **dict(small, s=small["s"] - 24),
                   dtype=f32, segments="packed", seed=303),
        flash_case("flash_bf16_window256", device, timing, **small, window=256, seed=304),
        flash_case("flash_bf16_chunk512", device, timing, **dict(small, s=3 * small["s"] // 2),
                   chunk=512, seed=305),
        flash_case("flash_bf16_softcap30", device, timing, **small, cap=30.0, seed=306),
        flash_case("flash_f32_softcap30", device, timing, **small, cap=30.0, dtype=f32,
                   seed=307),
        flash_case("flash_bf16_noncausal", device, timing, **small, causal=False, seed=308),
        flash_case("flash_bf16_reordered_positions", device, timing, **small,
                   positions="reordered", seed=309),
        flash_case("flash_bf16_d64_s405_group4", device, timing, b=2, s=405, h=8, hkv=2, d=64,
                   seed=310),
        flash_case("flash_f32_d64_s405_group1", device, timing, b=2, s=405, h=4, hkv=4, d=64,
                   dtype=f32, seed=311),
        flash_case("flash_bf16_s1", device, timing, b=3, s=1, h=4, hkv=2, d=128, seed=312),
        flash_case("flash_f32_s130_group4", device, timing, b=2, s=130, h=8, hkv=2, d=128,
                   dtype=f32, seed=313),
        flash_case("flash_bf16_peaked_logits", device, timing, **small, peak=3.0, seed=314),
        flash_case("flash_bf16_d64_s1000_group1", device, timing, b=2, s=1000, h=4, hkv=4,
                   d=64, seed=315),
        # the training paths: tts-1b on packed emilia_audio rows, and
        # the S2A's sequence-flash route (non-causal, D = 64, group 1; its
        # training stream is float32, the pad mask as segment ids)
        flash_case("flash_bf16_emilia_packed", device, timing, **main, segments="emilia",
                   positions="emilia", seed=316, unit_mean="attending"),
        flash_case("flash_f32_s2a_train", device, timing, **s2a_main, dtype=f32, causal=False,
                   seed=317),
        flash_case("flash_f32_s2a_pad_tails", device, timing, **s2a_main, dtype=f32,
                   causal=False, segments="pad_tails", seed=318),
        flash_case("flash_bf16_s2a_pad_tails", device, timing, **s2a_main, causal=False,
                   segments="pad_tails", seed=319, unit_mean="attending"),
        # train_c4 (tts-1b on c4_mlperf rows: positions run on across
        # documents, segment 0 where a target is EOS) and the masked serving
        # pass on the sequence-flash route (a gap between prompt and target)
        flash_case("flash_bf16_c4_mlperf", device, timing, **main, segments="c4_mlperf",
                   positions="c4_mlperf", seed=320, unit_mean="attending"),
        flash_case("flash_bf16_s2a_serving", device, timing, **serving, causal=False,
                   segments="serving", seed=321, unit_mean="attending"),
        # D = 256: the flagship's training step, then its mask modes at a
        # length that no tile divides (packed rows with a segment-0 tail keep
        # the unit's mean over all rows, as the D = 128 packed case does)
        flash_case("flash_bf16_flagship", device, timing, **flagship, seed=330,
                   unit_mean="row"),
        flash_case("flash_bf16_d256_packed", device, timing, **d256, segments="packed",
                   seed=331),
        flash_case("flash_bf16_d256_window256", device, timing, **d256, window=256, seed=332),
        flash_case("flash_bf16_d256_chunk384_softcap30", device, timing, **d256, chunk=384,
                   cap=30.0, seed=333),
        flash_case("flash_f32_d256_s333_group2", device, timing, b=2, s=333, h=4, hkv=2, d=256,
                   dtype=f32, seed=334),
        flash_case("flash_f32_d256_packed", device, timing, **d256, dtype=f32,
                   segments="packed", seed=335),
        # GQA group 8: qwen3-30b-a3b's training step (moe_train), then packed
        # documents with a segment-0 tail in both dtypes at its heads
        flash_case("flash_bf16_qwen3_moe_train", device, timing, **qwen3, seed=340),
        # the parallel and post-training phases
        flash_case("flash_bf16_rank_rows", device, timing, **rank_rows, seed=350),
        flash_case("flash_bf16_one_row", device, timing, **dict(rank_rows, b=1), seed=356),
        flash_case("flash_bf16_ring_cp2", device, timing, **cp_shard(2), context=("ring", 2, 1),
                   seed=351, unit_mean="row"),
        flash_case("flash_bf16_ring_cp4", device, timing, **cp_shard(4), context=("ring", 4, 1),
                   seed=352, unit_mean="row"),
        flash_case("flash_bf16_allgather_cp2", device, timing, **cp_shard(2),
                   context=("allgather", 2), seed=353, unit_mean="row"),
        flash_case("flash_bf16_ulysses_cp2", device, timing,
                   **dict(cp_shard(1), h=8, hkv=4), positions="reordered", seed=354,
                   unit_mean="row"),
        flash_case("flash_bf16_posttrain", device, timing, **FLASH_POSTTRAIN, seed=355),
        flash_case("flash_bf16_group8_packed_padding", device, timing,
                   **dict(qwen3, b=2, s=qwen3["s"] - 24), segments="packed", seed=341),
        flash_case("flash_f32_group8_packed_padding", device, timing,
                   **dict(qwen3, b=2, s=qwen3["s"] - 24), dtype=f32, segments="packed",
                   seed=342),
        # the other GQA groups of the presets: 5 (qwen3-14b, llama4: 40 q / 8
        # kv heads), 6 (mixtral-8x22b: 48 / 8), 16 (llama3-405b: 128 / 8),
        # D = 128, causal; K11's block walks the whole group
        *[flash_case(f"flash_bf16_group{h // 8}", device, timing, b=2,
                     s=512 if full_size else 256, h=h, hkv=8, d=128, seed=343 + i)
          for i, h in enumerate((40, 48, 128))],
    ]
    return [r for g in groups for r in g]


# The cases at the shapes the main paths of ``chip_smoke.py`` give the
# kernels, by the phase that drives each path (the first path first). Serving
# run: 32 slots of the tts-1b cache, each holding a prompt of up to 400 tokens
# plus up to 128 generated ones. TTS back end: 8 requests, the prompt padded to 256 and the target
# bucketed to 512 frames, hidden 1024. ``synthesize``: one request, the
# conditional forward over P + T rows. ``train``: the tts-1b step;
# ``train_packed``: the same on packed emilia_audio rows; ``train_c4``: on
# c4_mlperf rows; ``s2a_train``: the S2A step (float32 residual stream: K5
# through its autograd Function, and on the sequence-flash route K9-K11
# non-causal at D = 64); ``s2a_seq_flash_serving``: K9 in the int8_offline
# denoiser forward of the masked serving pass (bfloat16, the pad mask);
# ``flagship_serve``: tts-flagship's decode (8 slots of 4096 rows, D = 256,
# group 2); ``train_flagship_vocab``: the tts-1b body at the flagship's
# vocabulary (K9-K11 at the train shape); ``train_flagship``: tts-flagship
# at full width (one 4096-token row, D = 256); ``moe_train``: qwen3-30b-a3b's
# step (K9-K11 at group 8, the grouped products and their backward).
# the serving paths of ROADMAP item 5 that run the tts-1b decode step (K1, K2)
# at the serve phase's shapes: scanned, disaggregated, offline, loadgen,
# microbenchmark, the UniServer
SERVE_DECODE_PATHS = ("serve_scanned", "serve_disaggregated", "offline_engine",
                      "loadgen_offline", "loadgen_server", "microbenchmark", "uniserver")
def parallel_paths(suffix: str) -> dict:
    """The K9-K11 main paths of the parallel and post-training phases."""
    return {"parallel_fsdp_train": f"flash_bf16_rank_rows_{suffix}",
            "parallel_zero1": f"flash_bf16_one_row_{suffix}",
            "pipeline_train": f"flash_bf16_rank_rows_{suffix}",
            "elastic_train": f"flash_bf16_rank_rows_{suffix}",
            "ring_attention": f"flash_bf16_ring_cp2_{suffix}",
            "ring_attention_cp4": f"flash_bf16_ring_cp4_{suffix}",
            "allgather_attention": f"flash_bf16_allgather_cp2_{suffix}",
            "ulysses_attention": f"flash_bf16_ulysses_cp2_{suffix}",
            "dpo_train": f"flash_bf16_main_path_{suffix}",
            "grpo_train": f"flash_bf16_posttrain_{suffix}",
            "distillation": f"flash_bf16_posttrain_{suffix}"}


# GRPO's and distillation's engine: 16 slots of a 128-token cache
POSTTRAIN_DECODE_PATHS = ("grpo_train", "distillation")

MAIN_PATH_CASES = {
    "s2a_attention": {"tts_synthesize": "s2a_attention_bf16_main_path"},
    "ragged_decode_attention": {"serve": "ragged_bf16_main_path",
                                "flagship_serve": "ragged_bf16_flagship",
                                "spec_decode": "ragged_f32_spec_draft",
                                **{p: "ragged_bf16_main_path" for p in SERVE_DECODE_PATHS},
                                **{p: "ragged_bf16_posttrain" for p in POSTTRAIN_DECODE_PATHS}},
    "paged_decode_attention": {"serve_paged": "paged_bf16_main_path"},
    "inplace_row_update": {"serve": "inplace_kv_bf16_k1_main_path",
                           "flagship_serve": "inplace_kv_bf16_k1_flagship",
                           "spec_decode": "inplace_kv_f32_k5_verify",
                           **{p: "inplace_kv_bf16_k1_main_path" for p in SERVE_DECODE_PATHS},
                           **{p: "inplace_kv_bf16_k1_posttrain" for p in POSTTRAIN_DECODE_PATHS}},
    "ada_rmsnorm": {"tts_backend": "ada_rmsnorm_bf16_main_path",
                    "s2a_train": "ada_rmsnorm_grad_f32_s2a_train",
                    "uniserver": "ada_rmsnorm_bf16_main_path"},
    "row_quantize_int8": {"tts_backend": "row_quantize_int8_bf16_main_path",
                          "uniserver": "row_quantize_int8_bf16_main_path"},
    "ada_rmsnorm_quantize": {"tts_backend": "ada_rmsnorm_quantize_bf16_main_path",
                             "uniserver": "ada_rmsnorm_quantize_bf16_main_path"},
    "silu_mul_quantize": {"tts_backend": "silu_mul_quantize_bf16_main_path",
                          "uniserver": "silu_mul_quantize_bf16_main_path"},
    "flash_fwd": {"train": "flash_bf16_main_path_fwd",
                  "train_dropout": "flash_bf16_main_path_fwd",
                  "train_packed": "flash_bf16_emilia_packed_fwd",
                  "train_c4": "flash_bf16_c4_mlperf_fwd",
                  "s2a_train": "flash_f32_s2a_train_fwd",
                  "s2a_seq_flash_serving": "flash_bf16_s2a_serving_fwd",
                  "train_flagship_vocab": "flash_bf16_main_path_fwd",
                  "train_flagship": "flash_bf16_flagship_fwd",
                  "train_int8": "flash_bf16_main_path_fwd",
                  "train_lora": "flash_bf16_main_path_fwd",
                  "moe_train": "flash_bf16_qwen3_moe_train_fwd",
                  **parallel_paths("fwd")},
    "flash_bwd_dq": {"train": "flash_bf16_main_path_dq",
                     "train_dropout": "flash_bf16_main_path_dq",
                     "train_packed": "flash_bf16_emilia_packed_dq",
                     "train_c4": "flash_bf16_c4_mlperf_dq",
                     "s2a_train": "flash_f32_s2a_train_dq",
                     "train_flagship_vocab": "flash_bf16_main_path_dq",
                     "train_flagship": "flash_bf16_flagship_dq",
                     "train_int8": "flash_bf16_main_path_dq",
                     "train_lora": "flash_bf16_main_path_dq",
                     "moe_train": "flash_bf16_qwen3_moe_train_dq",
                  **parallel_paths("dq")},
    "int8w_matmul": {"serve_int8w": "int8w_bf16_main_path",
                     "flagship_serve_int8w": "int8w_bf16_flagship",
                     "moe_serve_int8w": "int8w_bf16_qwen3_moe_decode"},
    "grouped_matmul_bf16": {"moe_serve": "gmm_bf16_main_path",
                            "mixtral_serve": "gmm_bf16_mixtral_decode_wi",
                            "mla_serve": "gmm_bf16_deepseek_decode_wi",
                            "llama4_serve": "gmm_bf16_llama4_decode_wi",
                            "moe_train": "gmm_bf16_qwen3_train_wi",
                            "deepseek_train": "gmm_bf16_deepseek_train_wi"},
    "grouped_matmul_int8": {"moe_serve_int8w": "gmm_int8_main_path"},
    "grouped_matmul_dgrad": {"moe_train": "gmm_dgrad_main_path",
                             "deepseek_train": "gmm_dgrad_deepseek_train_wi"},
    "grouped_matmul_wgrad": {"moe_train": "gmm_wgrad_main_path",
                             "deepseek_train": "gmm_wgrad_deepseek_train_wi"},
    # the float32 grouped products: moe_train_parity's float32 sparse step
    "grouped_matmul_f32": {"moe_train_parity": "gmm_f32_fwd_qwen3_parity"},
    "grouped_matmul_f32_dgrad": {"moe_train_parity": "gmm_f32_dgrad_qwen3_parity"},
    "grouped_matmul_f32_wgrad": {"moe_train_parity": "gmm_f32_wgrad_qwen3_parity"},
    "flash_bwd_dkv": {"train": "flash_bf16_main_path_dkv",
                      "train_dropout": "flash_bf16_main_path_dkv",
                      "train_packed": "flash_bf16_emilia_packed_dkv",
                      "train_c4": "flash_bf16_c4_mlperf_dkv",
                      "s2a_train": "flash_f32_s2a_train_dkv",
                      "train_flagship_vocab": "flash_bf16_main_path_dkv",
                      "train_flagship": "flash_bf16_flagship_dkv",
                      "train_int8": "flash_bf16_main_path_dkv",
                      "train_lora": "flash_bf16_main_path_dkv",
                      "moe_train": "flash_bf16_qwen3_moe_train_dkv",
                  **parallel_paths("dkv")},
}


# int8w_matmul (int8w_serve's decode product) against its plain version (the
# dequantised weight, then the product), |y| of a few units: both sides round
# one float32 sum, summed in another order, to the output type, so a bfloat16
# output differs by at most one bfloat16 step, at most 2**-7 of the largest
# |y|; a float32 one by summation order. Measured relative to max(1, max |y|).
TOL_INT8W = {torch.bfloat16: 2.0 ** -7, torch.float32: TOL_F32}
# (name, M, K, N): the tts-1b decode step's products at 32 slots (q / out,
# k / v, wi_0 / wi_1, wo) and the flagship's (E 3840, 16 / 8 heads of 256,
# MLP 15360) at its 8 slots; M = 1, the speculative verify span (32 x 5), an
# odd N and a bias
INT8W_CASES = [
    ("int8w_bf16_tts1b_2048x2048", 32, 2048, 2048, {}),
    ("int8w_bf16_tts1b_2048x1024", 32, 2048, 1024, {}),
    ("int8w_bf16_main_path", 32, 2048, 8192, {}),
    ("int8w_bf16_tts1b_8192x2048", 32, 8192, 2048, {}),
    ("int8w_bf16_flagship_3840x4096", 8, 3840, 4096, {}),
    ("int8w_bf16_flagship_3840x2048", 8, 3840, 2048, {}),
    ("int8w_bf16_flagship", 8, 3840, 15360, {}),
    ("int8w_bf16_flagship_15360x3840", 8, 15360, 3840, {}),
    ("int8w_bf16_flagship_4096x3840", 8, 4096, 3840, {}),
    ("int8w_bf16_m1", 1, 2048, 2048, {}),
    ("int8w_bf16_m160_verify", 160, 2048, 8192, {}),
    ("int8w_bf16_odd_n", 32, 2048, 1001, {}),
    ("int8w_bf16_bias", 32, 2048, 2048, dict(bias=True)),
    ("int8w_f32_odd_k_n_bias", 7, 200, 77, dict(bias=True, dtype=torch.float32)),
    # the edges of the single-launch design: 64 and 256 rows (one and four
    # 64-row blocks), N = 1001 with a bias (byte loads of the weight rows), K
    # no multiple of a 128-row stage or of a 256-row split, bf16 at K 200 and
    # N 77 with a bias (element loads), float32 x split over a cluster
    ("int8w_bf16_m64", 64, 2048, 2048, {}),
    ("int8w_bf16_m256", 256, 2048, 2048, {}),
    ("int8w_bf16_odd_n_bias", 32, 2048, 1001, dict(bias=True)),
    ("int8w_bf16_k_not_a_stage", 8, 2000, 2048, {}),
    ("int8w_bf16_odd_k_n_bias", 7, 200, 77, dict(bias=True)),
    ("int8w_f32_split_bias", 8, 2048, 1024, dict(bias=True, dtype=torch.float32)),
    # qwen3-30b-a3b's attention projections under int8w_serve at 8 slots
    ("int8w_bf16_qwen3_moe_decode", 8, 2048, 4096, {}),
]


def _int8w_library():
    """``torch._weight_int8pack_mm`` (an int8-weight product with its own
    rounding: [N, K] weight, scales applied to the sums) where this PyTorch
    build runs it on the GPU, else None."""
    x = torch.ones((2, 64), dtype=torch.bfloat16, device="cuda")
    w = torch.ones((8, 64), dtype=torch.int8, device="cuda")
    try:
        torch._weight_int8pack_mm(x, w, torch.ones(8, dtype=torch.bfloat16, device="cuda"))
        torch.cuda.synchronize()
        return torch._weight_int8pack_mm
    except (RuntimeError, NotImplementedError):
        return None


def int8w_case(name, device, timing, *, m, k, n, bias=False, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=device, dtype=torch.float32).to(dtype)
    q = torch.randint(-127, 128, (k, n), generator=g, device=device,
                      dtype=torch.int32).to(torch.int8)
    scale = (torch.rand((n,), generator=g, device=device) + 0.5) / (127 * math.sqrt(k / 3))
    b = torch.randn((n,), generator=g, device=device).to(dtype) if bias else None
    before = iw.launch_count
    out = iw.int8w_matmul(x, q, scale, b)
    torch.cuda.synchronize()
    launched = iw.launch_count - before
    ref = iw.int8w_matmul(x, q, scale, b, impl="plain")
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(out).all().item())
    err = float((out.float() - ref.float()).abs().max().item())
    largest = float(ref.float().abs().max().item())
    rel = err / max(1.0, largest)
    tol = TOL_INT8W[dtype]
    splits, per_split = iw._splits(m, k, n, x.device, dtype)
    res = dict(name=name, kernel="int8w_matmul", max_abs_err=err, max_err=rel, tol=tol,
               unit="relative to max(1, max |plain|)",
               ok=bool(rel <= tol and finite and launched == 1 and out.dtype == dtype),
               finite=finite, launched=launched, max_abs_out=largest,
               shape=dict(m=m, k=k, n=n, x=str(dtype), bias=bias, k_splits=splits,
                          k_a_split=per_split))
    res["repeat_bitwise_equal"] = bool(torch.equal(iw.int8w_matmul(x, q, scale, b), out))
    res["ok"] = res["ok"] and res["repeat_bitwise_equal"]
    if timing:
        # the weights of one decode step are far more than the L2 holds, so each
        # timed launch reads its int8 weight from device memory (a rotation of copies)
        copies = max(2, int(math.ceil(2 * L2_BYTES / (k * n))) + 1)
        qs = [q] + [q.clone() for _ in range(copies - 1)]
        turn = [0]

        def nxt():
            turn[0] = (turn[0] + 1) % copies
            return qs[turn[0]]

        esize = torch.tensor([], dtype=dtype).element_size()
        nbytes = k * n + 4 * n + esize * (m * k + m * n + (n if bias else 0))
        ops = 2 * m * k * n
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dtype] * 1e3
        w_bf16 = iw.dequantize(q, scale, dtype)
        ws = [w_bf16] + [w_bf16.clone() for _ in range(max(1, copies // 2) - 1)]
        turn_w = [0]

        def nxt_w():
            turn_w[0] = (turn_w[0] + 1) % len(ws)
            return ws[turn_w[0]]

        library = _int8w_library() if dtype == torch.bfloat16 else None
        qt = [t.t().contiguous() for t in qs] if library is not None else None
        s_lib = scale.to(dtype)
        res.update(
            kernel_ms=time_ms(lambda: iw.int8w_matmul(x, nxt(), scale, b)),
            device_ms=device_ms(lambda: iw.int8w_matmul(x, nxt(), scale, b)),
            plain_ms=time_ms(lambda: iw.int8w_matmul(x, nxt(), scale, b, impl="plain")),
            plain_device_ms=device_ms(lambda: iw.int8w_matmul(x, nxt(), scale, b,
                                                              impl="plain")),
            bf16_weight_ms=time_ms(lambda: x @ nxt_w()),
            bf16_weight_device_ms=device_ms(lambda: x @ nxt_w()),
            bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else
            "operations", bytes_moved=nbytes, ops=ops,
            library_ms=None, library_device_ms=None,
            library_call=None if library is None else "torch._weight_int8pack_mm",
        )
        if library is not None:
            turn_lib = [0]

            def library_call():
                turn_lib[0] = (turn_lib[0] + 1) % copies
                return library(x, qt[turn_lib[0]], s_lib)

            res.update(library_ms=time_ms(library_call), library_device_ms=device_ms(library_call))
    return res


def int8w_cases(device, timing, full_size=True):
    """int8w_matmul at every shape of :data:`INT8W_CASES` (``full_size=False``:
    the flagship's K and N cut by 4)."""
    out = []
    for i, (name, m, k, n, kw) in enumerate(INT8W_CASES):
        if not full_size and "flagship" in name:
            k, n = k // 4, n // 4
        out.append(int8w_case(name, device, timing, m=m, k=k, n=n, seed=60 + i, **kw))
    return out


# grouped_matmul (the MoE layer's grouped products) against its plain version
# (a float32 product a group, exact products of the operands): both sides
# round a float32 sum, summed in another order, to bfloat16, so they differ by
# at most one bfloat16 step, at most 2**-7 of max(1, max |y|). The int8
# variant's int32 sums are exact on both sides: equal; its rescaled bf16
# result within 2**-7 too, and both launched twice bitwise equal.
TOL_GMM_BF16 = 2.0 ** -7
# (name, rows R, groups G, K, N, routing): decode at 8 slots (R = 8 x top-k;
# 32 slots of qwen3 is 256 rows), each model's first product (wi_0 / wi_1:
# emb -> expert mlp) and its last (wo), a prefill of 2048 tokens, and the
# edge cases. Routing "uniform": each row's group drawn uniformly (at decode
# many groups are empty, some hold a single row); "one": every row in one
# group; "skewed": most rows in a few groups, some groups empty.
GMM_CASES = [
    ("gmm_bf16_main_path", 64, 128, 2048, 768, "uniform"),  # qwen3-30b-a3b decode wi
    ("gmm_bf16_qwen3_decode_wo", 64, 128, 768, 2048, "uniform"),
    ("gmm_bf16_qwen3_decode_32_slots", 256, 128, 2048, 768, "uniform"),
    ("gmm_bf16_qwen3_prefill_wi", 2048 * 8, 128, 2048, 768, "uniform"),
    ("gmm_bf16_qwen3_prefill_wo", 2048 * 8, 128, 768, 2048, "uniform"),
    ("gmm_bf16_mixtral_decode_wi", 16, 8, 4096, 14336, "uniform"),
    ("gmm_bf16_mixtral_decode_wo", 16, 8, 14336, 4096, "uniform"),
    ("gmm_bf16_mixtral_prefill_wi", 2048 * 2, 8, 4096, 14336, "uniform"),
    ("gmm_bf16_deepseek_decode_wi", 48, 64, 2048, 1408, "uniform"),
    ("gmm_bf16_deepseek_decode_wo", 48, 64, 1408, 2048, "uniform"),
    ("gmm_bf16_llama4_decode_wi", 8, 16, 5120, 8192, "uniform"),
    ("gmm_bf16_llama4_decode_wo", 8, 16, 8192, 5120, "uniform"),
    ("gmm_bf16_one_group_holds_all", 1000, 16, 512, 384, "one"),
    ("gmm_bf16_skewed_ragged_rows", 1237, 32, 768, 1408, "skewed"),
    ("gmm_bf16_single_rows", 8, 128, 2048, 768, "uniform"),
    # the training step's forward (moe_train: qwen3-30b-a3b at 4 x 1024 tokens,
    # top 8 of 128; deepseek_train: deepseek-v2-lite, top 6 of 64)
    ("gmm_bf16_qwen3_train_wi", 4096 * 8, 128, 2048, 768, "uniform"),
    ("gmm_bf16_qwen3_train_wo", 4096 * 8, 128, 768, 2048, "uniform"),
    ("gmm_bf16_deepseek_train_wi", 4096 * 6, 64, 2048, 1408, "uniform"),
    # the regimes' edges. Many rows: groups of 1-191 rows around the 64-row
    # half tile and the 128-row tile, an empty one, K 640 and N 448 (no
    # multiple of the 256-column tile), then K 200 and N 136 (no multiple of
    # 64: TMA's zeros inside a box). Few rows: groups of 0-17 rows (one ending
    # inside a 16-row tile, one of 16, one of 17), K 520 and N 200 (multiples
    # of 8, not of 64); then K 2056 (a part stage at the end) with N 136; both
    # grids small enough that K is split over a cluster
    ("gmm_bf16_tile_edges", 770, 10, 640, 448, (1, 63, 65, 0, 127, 129, 64, 128, 2, 191)),
    ("gmm_bf16_narrow_edges", 195, 3, 200, 136, (65, 1, 129)),
    ("gmm_bf16_few_rows_edges", 102, 14, 520, 200,
     (1, 0, 3, 16, 17, 0, 5, 2, 8, 15, 1, 0, 30, 4)),
    ("gmm_bf16_few_rows_split_edges", 100, 24, 2056, 136,
     (1, 9, 0, 16, 3, 1, 1, 7, 0, 2, 12, 1, 5, 0, 1, 1, 14, 2, 3, 1, 0, 6, 13, 1)),
    ("gmm_int8_main_path", 64, 128, 2048, 768, "uniform"),
    ("gmm_int8_qwen3_decode_wo", 64, 128, 768, 2048, "uniform"),
    ("gmm_int8_qwen3_prefill_wi", 2048 * 8, 128, 2048, 768, "uniform"),
    ("gmm_int8_mixtral_decode_wi", 16, 8, 4096, 14336, "uniform"),
    ("gmm_int8_one_group_holds_all", 1000, 16, 512, 384, "one"),
    ("gmm_int8_skewed_ragged_rows", 1237, 32, 768, 1408, "skewed"),
    # the other models' decodes under int8w_serve, then the int8 kernels' edges
    # (K and N multiples of 16): few rows, groups of 0-17 rows with K 528 and N
    # 208 (no multiple of the 128-byte stage or the 128-column tile), then K
    # 2064 (a 16-deep last stage) over a grid small enough that K is split
    # over a cluster; many rows, groups of 1-191 rows around the 64-row tile,
    # an empty one, N 448 (a half column tile)
    ("gmm_int8_mixtral_decode_wo", 16, 8, 14336, 4096, "uniform"),
    ("gmm_int8_deepseek_decode_wi", 48, 64, 2048, 1408, "uniform"),
    ("gmm_int8_deepseek_decode_wo", 48, 64, 1408, 2048, "uniform"),
    ("gmm_int8_llama4_decode_wi", 8, 16, 5120, 8192, "uniform"),
    ("gmm_int8_llama4_decode_wo", 8, 16, 8192, 5120, "uniform"),
    ("gmm_int8_few_rows_edges", 102, 14, 528, 208,
     (1, 0, 3, 16, 17, 0, 5, 2, 8, 15, 1, 0, 30, 4)),
    ("gmm_int8_few_rows_split_edges", 100, 24, 2064, 144,
     (1, 9, 0, 16, 3, 1, 1, 7, 0, 2, 12, 1, 5, 0, 1, 1, 14, 2, 3, 1, 0, 6, 13, 1)),
    ("gmm_int8_many_rows_tile_edges", 770, 10, 640, 448,
     (1, 63, 65, 0, 127, 129, 64, 128, 2, 191)),
]


def _gmm_groups(rows, groups, routing, g, device) -> torch.Tensor:
    """Each row's group, sorted (the sparse route's order). ``routing``: a
    kind (below) or a tuple of the groups' row counts."""
    if isinstance(routing, tuple):
        return torch.repeat_interleave(torch.arange(groups, device=device),
                                       torch.tensor(routing, device=device))
    if routing == "one":
        ids = torch.full((rows,), groups // 2, dtype=torch.long, device=device)
    elif routing == "skewed":
        hot = torch.randint(0, groups, (rows,), generator=g, device=device) % 4
        cold = torch.randint(0, groups, (rows,), generator=g, device=device)
        pick = torch.rand((rows,), generator=g, device=device) < 0.8
        ids = torch.where(pick, hot * 3, cold) % groups
        ids = torch.where(ids == groups - 1, ids - 1, ids)  # the last group stays empty
    else:
        ids = torch.randint(0, groups, (rows,), generator=g, device=device)
    return torch.sort(ids).values


def _gmm_library():
    """``torch._grouped_mm`` where this PyTorch build has it and runs it here,
    else None (timed as a yardstick only)."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None
    x = torch.ones((32, 64), dtype=torch.bfloat16, device="cuda")
    w = torch.ones((2, 64, 64), dtype=torch.bfloat16, device="cuda")
    try:
        fn(x, w, offs=torch.tensor([16, 32], dtype=torch.int32, device="cuda"))
        torch.cuda.synchronize()
        return fn
    except (RuntimeError, NotImplementedError, TypeError):
        return None


def gmm_case(name, device, timing, *, rows, groups, k, n, routing, seed=0):
    """grouped_matmul (bf16, the ``gmm_bf16_*`` cases) or grouped_matmul_int8
    (``gmm_int8_*``: the int32 sums equal, the rescaled bf16 result within
    :data:`TOL_GMM_BF16`) against its plain version."""
    from maxtext_indextts2_tpu_torch.ops import _build

    int8 = name.startswith("gmm_int8")
    g = torch.Generator(device=device).manual_seed(seed)
    ids = _gmm_groups(rows, groups, routing, g, device)
    counts = torch.bincount(ids, minlength=groups)
    offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=device),
                         torch.cumsum(counts, 0)]).to(torch.int32)
    touched = int((counts > 0).sum().item())
    if isinstance(routing, tuple):
        routing = list(routing)
    kname = "grouped_matmul_int8" if int8 else "grouped_matmul_bf16"
    count = "grouped_matmul_int8" if int8 else "grouped_matmul"
    before = gm.launch_counts[count]
    if int8:
        x = torch.randint(-127, 128, (rows, k), generator=g, device=device,
                          dtype=torch.int32).to(torch.int8)
        w = torch.randint(-127, 128, (groups, k, n), generator=g, device=device,
                          dtype=torch.int32).to(torch.int8)
        rs = (torch.rand((rows, 1), generator=g, device=device) + 0.5) / 127
        ws = (torch.rand((groups, 1, n), generator=g, device=device) + 0.5) / (127 * k)
        sums = gm.grouped_matmul_int8(x, w, offsets)
        out = gm.grouped_matmul_int8(x, w, offsets, rs, ws, torch.bfloat16)
        torch.cuda.synchronize()
        want_sums = gm.grouped_matmul_int8(x, w, offsets, impl="plain")
        ref = gm.grouped_matmul_int8(x, w, offsets, rs, ws, torch.bfloat16, impl="plain")
        err = float((sums.double() - want_sums.double()).abs().max().item())
        tol = 0.0
        launched = gm.launch_counts[count] - before
        want_launched = 2
    else:
        x = torch.randn((rows, k), generator=g, device=device).to(torch.bfloat16)
        w = (torch.randn((groups, k, n), generator=g, device=device)
             / math.sqrt(k)).to(torch.bfloat16)
        out = gm.grouped_matmul(x, w, offsets)
        torch.cuda.synchronize()
        launched = gm.launch_counts[count] - before
        want_launched = 1
        ref = gm.grouped_matmul(x, w, offsets, impl="plain")
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(out.float()).all().item())
    out_err = float((out.float() - ref.float()).abs().max().item())
    largest = float(ref.float().abs().max().item())
    rel = out_err / max(1.0, largest)
    res = dict(name=name, kernel=kname, finite=finite, launched=launched,
               max_abs_out=largest,
               shape=dict(rows=rows, groups=groups, k=k, n=n, routing=routing,
                          groups_touched=touched, largest_group=int(counts.max().item()),
                          **dict(zip(("splits", "stages"), (gm.int8_plan if int8 else
                                                            gm.forward_plan)(
                              rows, groups, k, n, _build.sm_count(x.device))))))
    if int8:
        res.update(max_abs_err=err, max_err=err, tol=tol, unit="int32 sums",
                   scaled_max_abs_err=out_err, scaled_max_rel_err=rel,
                   scaled_tol=TOL_GMM_BF16,
                   ok=bool(err == 0 and rel <= TOL_GMM_BF16 and finite
                           and launched == want_launched))
    else:
        res.update(max_abs_err=out_err, max_err=rel, tol=TOL_GMM_BF16,
                   unit="relative to max(1, max |plain|)",
                   ok=bool(rel <= TOL_GMM_BF16 and finite and launched == want_launched))
    if int8:  # both epilogues: the int32 sums and the rescaled result
        again = gm.grouped_matmul_int8(x, w, offsets, rs, ws, torch.bfloat16)
        repeat = (torch.equal(again, out)
                  and torch.equal(gm.grouped_matmul_int8(x, w, offsets), sums))
    else:
        repeat = torch.equal(gm.grouped_matmul(x, w, offsets), out)
    res["repeat_bitwise_equal"] = bool(repeat)
    res["ok"] = res["ok"] and res["repeat_bitwise_equal"]
    if timing:
        esize = 1 if int8 else 2
        # the touched groups' weights, the rows in, the result out (bf16), the offsets
        nbytes = (touched * k * n * esize + rows * k * esize + rows * n * 2
                  + 4 * (groups + 1) + (4 * rows + 4 * touched * n if int8 else 0))
        ops = 2 * rows * k * n
        peak = 1979e12 if int8 else PEAK_OPS_PER_S[torch.bfloat16]
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
        if int8:
            def kernel():
                return gm.grouped_matmul_int8(x, w, offsets, rs, ws, torch.bfloat16)

            def plain():
                return gm.grouped_matmul_int8(x, w, offsets, rs, ws, torch.bfloat16,
                                              impl="plain")
        else:
            def kernel():
                return gm.grouped_matmul(x, w, offsets)

            def plain():
                return gm.grouped_matmul(x, w, offsets, impl="plain")
        library = None if int8 else _gmm_library()
        ends = offsets[1:].contiguous()
        res.update(
            kernel_ms=time_ms(kernel), device_ms=device_ms(kernel),
            plain_ms=time_ms(plain, warmup=1, iters=3), plain_device_ms=None,
            bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            bytes_moved=nbytes, ops=ops, library_ms=None, library_device_ms=None,
            library_call=None if library is None else "torch._grouped_mm")
        if library is not None:
            def library_call():
                return library(x, w, offs=ends)

            res.update(library_ms=time_ms(library_call),
                       library_device_ms=device_ms(library_call))
    return res


def gmm_cases(device, timing, full_size=True):
    """grouped_matmul at every shape of :data:`GMM_CASES` (``full_size=False``:
    K and N cut by 4, rows by 8)."""
    out = []
    for i, (name, rows, groups, k, n, routing) in enumerate(GMM_CASES):
        if not full_size and not isinstance(routing, tuple):
            rows, k, n = max(8, rows // 8), max(64, k // 4), max(64, n // 4)
        out.append(gmm_case(name, device, timing, rows=rows, groups=groups, k=k, n=n,
                            routing=routing, seed=80 + i))
    return out


# The grouped product's backward (training's sparse route) against its plain
# version (a float32 product a group, exact products of the operands): both
# sides round a float32 sum, summed in another order, to bfloat16 (dx, dw),
# so they differ by at most one bfloat16 step where the float32 values
# straddle a rounding boundary: 2**-7 of max(1, max |plain|), as the forward.
# (name, rows R, groups G, K, N, routing): the forward's product x [R, K] @
# w [G, K, N]; dgrad takes dy [R, N] to dx [R, K], wgrad x and dy to dw
# [G, K, N]. The training phases' products: qwen3-30b-a3b at 4 x 1024 tokens
# a step, top 8 of 128 experts (wi: 2048 -> 768, wo: 768 -> 2048),
# deepseek-v2-lite at 4,096 tokens, top 6 of 64 (2048 -> 1408), mixtral at
# 4,096 tokens, top 2 of 8 (4096 -> 14336); then empty groups, one group
# holding every row, skewed routing.
GMM_BWD_CASES = [
    ("main_path", 4096 * 8, 128, 2048, 768, "uniform"),
    ("qwen3_train_wo", 4096 * 8, 128, 768, 2048, "uniform"),
    ("deepseek_train_wi", 4096 * 6, 64, 2048, 1408, "uniform"),
    ("deepseek_train_wo", 4096 * 6, 64, 1408, 2048, "uniform"),
    ("mixtral_train_wi", 4096 * 2, 8, 4096, 14336, "uniform"),
    ("mixtral_train_wo", 4096 * 2, 8, 14336, 4096, "uniform"),
    ("empty_groups", 24, 128, 512, 384, "uniform"),
    ("one_group_holds_all", 1000, 16, 512, 384, "one"),
    ("skewed_ragged_rows", 1237, 32, 768, 1408, "skewed"),
    # groups of 1, 63, 65, 127, 129 rows (either side of the 64-row half
    # tile, the 128-row tile and wgrad's 64-row step), an empty one, R = 770
    # (no multiple of 64); K = 640 and N = 448 (no multiple of the 256-column
    # tile); then K = 200 and N = 136 (no multiple of 64 either: TMA's zeros
    # inside a box)
    ("tile_edges", 770, 10, 640, 448, (1, 63, 65, 0, 127, 129, 64, 128, 2, 191)),
    ("narrow_edges", 195, 3, 200, 136, (65, 1, 129)),
]
# float32 operands (``grouped_matmul_f32.cu``, the CUDA cores): each kernel
# against its plain version (a float32 product a group, TF32 off): the same
# exact products summed in another order, so a relative 2e-5 of max(1, max
# |plain|). The cases: the float32 step of ``moe_train_parity`` (qwen3-30b-a3b
# at 1 x 1024 tokens: 8,192 rows over 128 experts, wi), its wo, and the edges.
TOL_GMM_F32 = 2e-5
GMM_F32_CASES = [
    ("qwen3_parity", 1024 * 8, 128, 2048, 768, "uniform"),
    ("qwen3_parity_wo", 1024 * 8, 128, 768, 2048, "uniform"),
    ("empty_groups", 24, 128, 512, 384, "uniform"),
    ("one_group_holds_all", 1000, 16, 512, 384, "one"),
    ("tile_edges", 770, 10, 200, 77, (1, 63, 65, 0, 127, 129, 64, 128, 2, 191)),
    # deepseek-v2-lite's training shapes (384 rows a group: 128-row tiles)
    ("deepseek_train_wi", 4096 * 6, 64, 2048, 1408, "uniform"),
    ("deepseek_train_wo", 4096 * 6, 64, 1408, 2048, "uniform"),
]


def gmm_bwd_case(name, device, timing, *, kind, rows, groups, k, n, routing, seed=0,
                 dtype=torch.bfloat16):
    """grouped_matmul_dgrad (``kind="dgrad"``) or grouped_matmul_wgrad
    against its plain version, and, timed, against ``torch._grouped_mm`` on
    the same product (dgrad: ``dy @ w^T`` a group; wgrad: ``x^T @ dy`` a
    group). ``dtype=torch.float32``: the float32 kernels
    (``grouped_matmul_f32.cu``), ``kind="fwd"`` the forward among them."""
    g = torch.Generator(device=device).manual_seed(seed)
    ids = _gmm_groups(rows, groups, routing, g, device)
    counts = torch.bincount(ids, minlength=groups)
    offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=device),
                         torch.cumsum(counts, 0)]).to(torch.int32)
    touched = int((counts > 0).sum().item())
    f32 = dtype == torch.float32
    kname = ("grouped_matmul_f32" + ("" if kind == "fwd" else f"_{kind}") if f32
             else f"grouped_matmul_{kind}")
    tol = TOL_GMM_F32 if f32 else TOL_GMM_BF16
    x = torch.randn((rows, k), generator=g, device=device).to(dtype)
    w = (torch.randn((groups, k, n), generator=g, device=device) / math.sqrt(k)).to(dtype)
    dy = torch.randn((rows, n), generator=g, device=device).to(dtype)
    if kind == "fwd":
        def kernel():
            return gm.grouped_matmul(x, w, offsets)

        def plain():
            return gm.grouped_matmul(x, w, offsets, impl="plain")
    elif kind == "dgrad":
        def kernel():
            return gm.grouped_matmul_dgrad(dy, w, offsets)

        def plain():
            return gm.grouped_matmul_dgrad(dy, w, offsets, impl="plain")
    else:
        def kernel():
            return gm.grouped_matmul_wgrad(x, dy, offsets)

        def plain():
            return gm.grouped_matmul_wgrad(x, dy, offsets, impl="plain")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain float32 products exact
    try:
        before = gm.launch_counts[kname]
        out = kernel()
        torch.cuda.synchronize()
        launched = gm.launch_counts[kname] - before
        ref = plain()
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    finite = bool(torch.isfinite(out.float()).all().item())
    out_err = float((out.float() - ref.float()).abs().max().item())
    largest = float(ref.float().abs().max().item())
    rel = out_err / max(1.0, largest)
    again = kernel()
    repeat = bool(torch.equal(again, out))
    empty_zero = True
    if kind == "wgrad":  # every empty group's gradient is written as zeros
        empty = counts == 0
        empty_zero = bool((out[empty] == 0).all().item()) if bool(empty.any()) else True
    res = dict(name=f"gmm_{'f32_' if f32 else ''}{kind}_{name}", kernel=kname, finite=finite,
               launched=launched, max_abs_out=largest, max_abs_err=out_err, max_err=rel,
               tol=tol, unit="relative to max(1, max |plain|)", repeat_bitwise_equal=repeat,
               empty_groups_zero=empty_zero,
               shape=dict(rows=rows, groups=groups, k=k, n=n,
                          routing=list(routing) if isinstance(routing, tuple) else routing,
                          groups_touched=touched, largest_group=int(counts.max().item()),
                          out_dtype=str(out.dtype).replace("torch.", "")),
               ok=bool(rel <= tol and finite and launched == 1 and repeat and empty_zero
                       and out.dtype == dtype))
    if timing:
        esize = 4 if f32 else 2
        ops = 2 * rows * k * n
        if kind == "wgrad":  # x and dy in, every expert's dw out (empty ones as zeros)
            nbytes = (rows * k + rows * n + groups * k * n) * esize + 4 * (groups + 1)
        else:  # rows in, the touched experts' weights in, rows out
            nbytes = (rows * n + touched * k * n + rows * k) * esize + 4 * (groups + 1)
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
        library = _gmm_library()
        ends = offsets[1:].contiguous()
        res.update(
            kernel_ms=time_ms(kernel), device_ms=device_ms(kernel),
            plain_ms=time_ms(plain, warmup=1, iters=3), plain_device_ms=None,
            bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            bytes_moved=nbytes, ops=ops, library_ms=None, library_device_ms=None,
            library_call=None)
        if library is not None:
            if kind == "fwd":
                call = "torch._grouped_mm(x, w, offs)"

                def library_call():
                    return library(x, w, offs=ends)
            elif kind == "dgrad":
                call = "torch._grouped_mm(dy, w.transpose(1, 2), offs)"

                def library_call():
                    return library(dy, w.transpose(1, 2), offs=ends)
            else:
                call = "torch._grouped_mm(x.t(), dy, offs)"

                def library_call():
                    return library(x.t(), dy, offs=ends)
            try:
                library_call()
                torch.cuda.synchronize()
            except (RuntimeError, NotImplementedError, TypeError) as e:
                res["library_error"] = str(e)[:200]
            else:
                res.update(library_ms=time_ms(library_call),
                           library_device_ms=device_ms(library_call), library_call=call)
    return res


def gmm_bwd_cases(device, timing, full_size=True):
    """dgrad and wgrad at every shape of :data:`GMM_BWD_CASES`, then the
    float32 kernels at every shape of :data:`GMM_F32_CASES`
    (``full_size=False``: K and N cut by 4, rows by 8, except where the
    routing gives the groups' rows)."""
    out = []
    for i, (name, rows, groups, k, n, routing) in enumerate(GMM_BWD_CASES):
        if not full_size and not isinstance(routing, tuple):
            rows, k, n = max(8, rows // 8), max(64, k // 4), max(64, n // 4)
        for kind in ("dgrad", "wgrad"):
            out.append(gmm_bwd_case(name, device, timing, kind=kind, rows=rows, groups=groups,
                                    k=k, n=n, routing=routing, seed=120 + i))
    for i, (name, rows, groups, k, n, routing) in enumerate(GMM_F32_CASES):
        if not full_size and not isinstance(routing, tuple):
            rows, k, n = max(8, rows // 8), max(64, k // 4), max(64, n // 4)
        for kind in ("fwd", "dgrad", "wgrad"):
            out.append(gmm_bwd_case(name, device, timing, kind=kind, rows=rows, groups=groups,
                                    k=k, n=n, routing=routing, seed=150 + i,
                                    dtype=torch.float32))
    return out


# the part of every K9-K11 instantiation's mangled name (namespace ``flash``)
FLASH_KERNEL_NAMES = "_ZN5flash"


def main_path_case_names() -> set[str]:
    """Every case of :data:`MAIN_PATH_CASES`."""
    return {c for paths in MAIN_PATH_CASES.values() for c in paths.values()}


def ragged_cases(device, timing, full_size=True, serve_slots=32):
    """K1-K3: K1 at the serving path's shape and at 128 slots x 2048 rows in
    every cache type, the window, the v1 entry (K3), other head dims and
    groups; the edges of the cluster's split of a slot's rows (blocks with no
    row, multiples of the cluster size, max_len and past it, windows that are
    no multiple of it, clusters of 8, 4, 2 and 1 block); K2's row updates."""
    big = dict(TTS_1B) if full_size else dict(b=8, s=256, nq=16, nkv=8, d=128)
    flagship = dict(FLAGSHIP_DECODE) if full_size else dict(FLAGSHIP_DECODE, s=512)
    serve = dict(big, b=serve_slots)
    kv4 = (big["b"], big["s"], big["nkv"], big["d"])
    sc3 = (big["b"], big["s"], big["nkv"])
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8

    def split(name, *, s, nq, nkv, d, seed, **kw):
        lengths = split_edge_lengths(s)
        return ragged_case(name, device, timing, b=len(lengths), s=s, nq=nq, nkv=nkv, d=d,
                           lengths=lengths, seed=seed, **kw)

    return [
        ragged_case("ragged_bf16_main_path", device, timing, **serve,
                    serving_max=min(528, big["s"]), seed=20),
        ragged_case("ragged_bf16_flagship", device, timing, **flagship,
                    serving_max=min(FLAGSHIP_SERVING_MAX, flagship["s"]), seed=22),
        # the speculative round's draft steps: float32, the spec_decode phase's prompts
        ragged_case("ragged_f32_spec_draft", device, timing, **serve, dtype=f32,
                    serving_max=min(SPEC_SERVING_MAX, big["s"]), seed=24),
        ragged_case("ragged_bf16", device, timing, **big, seed=1),
        ragged_case("ragged_f32", device, timing, **big, dtype=f32, seed=2),
        ragged_case("ragged_int8_q_bf16", device, timing, **big, int8=True, seed=3),
        ragged_case("ragged_bf16_window256", device, timing, **big, window=256, seed=4),
        ragged_case("ragged_v1_entry_bf16", device, timing, **big, v1_entry=True, seed=5),
        ragged_case("ragged_v1_entry_int8_q_f32", device, timing, **big, dtype=f32,
                    int8=True, v1_entry=True, seed=6),
        ragged_case("ragged_bf16_d256_group4", device, timing, b=16, s=1024, nq=16, nkv=4,
                    d=256, seed=7),
        ragged_case("ragged_bf16_d64_group1", device, timing, b=16, s=512, nq=8, nkv=8,
                    d=64, seed=8),
        ragged_case("ragged_f32_d32_group8_window", device, timing, b=5, s=300, nq=8, nkv=1,
                    d=32, dtype=f32, window=50, seed=9),
        ragged_case("ragged_int8_d32_group3", device, timing, b=6, s=100, nq=6, nkv=2,
                    d=32, dtype=f32, int8=True, seed=10),
        split("ragged_bf16_split_edges", s=512, nq=16, nkv=8, d=128, seed=50),
        split("ragged_f32_split_edges_d64_group4", s=300, nq=8, nkv=2, d=64, dtype=f32, seed=51),
        split("ragged_int8_split_edges_q_bf16", s=256, nq=16, nkv=8, d=128, int8=True, seed=52),
        split("ragged_bf16_split_window29", s=512, nq=16, nkv=8, d=128, window=29, seed=53),
        split("ragged_f32_split_window21_d32_group8", s=200, nq=8, nkv=1, d=32, dtype=f32,
              window=21, seed=54),
        split("ragged_v1_entry_int8_split_window13_q_f32", s=160, nq=4, nkv=2, d=256,
              dtype=f32, int8=True, v1_entry=True, window=13, seed=55),
        split("ragged_bf16_split_edges_cluster2", s=64, nq=16, nkv=8, d=128, seed=56),
        split("ragged_f32_split_edges_cluster1", s=31, nq=4, nkv=4, d=64, dtype=f32, seed=57),
        inplace_case("inplace_kv_bf16_k1_main_path", device, timing,
                     cache_shape=(serve_slots,) + kv4[1:], span=1, cache_dtype=bf16, seed=21),
        # GRPO's and distillation's engine (16 slots, 128 rows)
        ragged_case("ragged_bf16_posttrain", device, timing, **POSTTRAIN_DECODE,
                    serving_max=POSTTRAIN_DECODE["s"], seed=24),
        inplace_case("inplace_kv_bf16_k1_posttrain", device, timing,
                     cache_shape=(POSTTRAIN_DECODE["b"], POSTTRAIN_DECODE["s"],
                                  POSTTRAIN_DECODE["nkv"], POSTTRAIN_DECODE["d"]),
                     span=1, cache_dtype=bf16, seed=25),
        inplace_case("inplace_kv_bf16_k1_flagship", device, timing,
                     cache_shape=(flagship["b"], flagship["s"], flagship["nkv"], flagship["d"]),
                     span=1, cache_dtype=bf16, seed=23),
        inplace_case("inplace_kv_bf16_k1", device, timing, cache_shape=kv4, span=1,
                     cache_dtype=bf16, seed=11),
        # the speculative verify span (K = 4 drafts + 1) on the serving cache:
        # bfloat16, float32 (the spec_decode phase's), int8 codes and their scales
        inplace_case("inplace_kv_bf16_k5_verify", device, timing,
                     cache_shape=(serve_slots,) + kv4[1:], span=5, cache_dtype=bf16, seed=25),
        inplace_case("inplace_kv_f32_k5_verify", device, timing,
                     cache_shape=(serve_slots,) + kv4[1:], span=5, cache_dtype=f32, seed=26),
        inplace_case("inplace_kv_int8_k5_verify", device, timing,
                     cache_shape=(serve_slots,) + kv4[1:], span=5, cache_dtype=i8, seed=27),
        inplace_case("inplace_scale_f32_k5_verify", device, timing,
                     cache_shape=(serve_slots,) + sc3[1:], span=5, cache_dtype=f32, seed=28),
        inplace_case("inplace_kv_bf16_k4_clamped", device, timing, cache_shape=kv4, span=4,
                     cache_dtype=bf16, clamp=True, seed=12),
        inplace_case("inplace_scale_f32_k1_clamped", device, timing, cache_shape=sc3, span=1,
                     cache_dtype=f32, clamp=True, seed=13),
        inplace_case("inplace_scale_f32_k4", device, timing, cache_shape=sc3, span=4,
                     cache_dtype=f32, seed=14),
        inplace_case("inplace_kv_int8_k1", device, timing, cache_shape=kv4, span=1,
                     cache_dtype=i8, seed=15),
        inplace_case("inplace_f32_rows_into_bf16_cache", device, timing,
                     cache_shape=(8, 64, 2, 32), span=2, cache_dtype=bf16, kv_dtype=f32,
                     seed=16),
        inplace_case("inplace_unaligned_rows", device, timing, cache_shape=(4, 16, 3),
                     span=2, cache_dtype=f32, seed=17),
    ]


def run_all(device="cuda", timing: bool = True, full_size: bool = True,
            serve_slots: int = 32) -> list[dict]:
    """Every kernel case. ``full_size=False`` shrinks the serving shapes (a
    quick first check of a changed kernel)."""
    device = torch.device(device)
    return ragged_cases(device, timing, full_size, serve_slots) \
        + paged_cases(device, timing, full_size, serve_slots) \
        + row_cases(device, timing, full_size) + attention_cases(device, timing, full_size) \
        + flash_cases(device, timing, full_size) + int8w_cases(device, timing, full_size) \
        + gmm_cases(device, timing, full_size) + gmm_bwd_cases(device, timing, full_size)


def main(argv=None):
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if not set(argv) <= {"small", "ragged", "flash", "paged", "s2a", "rows", "int8w", "gmm"}:
        raise SystemExit("usage: python -m maxtext_indextts2_tpu_torch.ops.smoke [small] "
                         "[ragged | flash | paged | s2a | rows | int8w | gmm]")
    if not torch.cuda.is_available():
        raise SystemExit("ops.smoke needs a CUDA device")
    full = "small" not in argv
    if "ragged" in argv:  # K1-K3 only
        results = ragged_cases(torch.device("cuda"), timing=True, full_size=full)
    elif "flash" in argv:  # K9-K11 only: a quick first check of a changed flash kernel
        results = flash_cases(torch.device("cuda"), timing=True, full_size=full)
    elif "paged" in argv:  # K4 only
        results = paged_cases(torch.device("cuda"), timing=True, full_size=full)
    elif "s2a" in argv:  # K12 only
        results = attention_cases(torch.device("cuda"), timing=True, full_size=full)
    elif "rows" in argv:  # K5-K8 only
        results = row_cases(torch.device("cuda"), timing=True, full_size=full)
    elif "int8w" in argv:  # int8w_matmul only
        results = int8w_cases(torch.device("cuda"), timing=True, full_size=full)
    elif "gmm" in argv:  # grouped_matmul and its backward only
        results = (gmm_cases(torch.device("cuda"), timing=True, full_size=full)
                   + gmm_bwd_cases(torch.device("cuda"), timing=True, full_size=full))
    else:
        results = run_all(full_size=full)
    for r in results:
        print(json.dumps(r))
    from maxtext_indextts2_tpu_torch.ops import _build

    selected = set(argv) - {"small"}
    reports = []  # registers and spills of the instantiations these cases ran
    if not selected & {"flash", "s2a", "rows", "int8w", "gmm"}:
        reports.append("ragged_decode_kernel")  # K1 / K3 / K4
    if not selected or "int8w" in selected:
        reports.append("int8w_matmul")
    if not selected or "gmm" in selected:
        reports += ["grouped_matmul", "gmm_bwd", "gmm_f32"]
    if not selected or "rows" in selected:
        reports.append("norm_rows_kernel")  # K5 / K7
    if not selected or "flash" in selected:
        reports.append(FLASH_KERNEL_NAMES)  # K9-K11
    for kernel in reports:
        for r in _build.ptxas_report(kernel):
            print(json.dumps(dict(ptxas=r)))
    if not all(r["ok"] for r in results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
