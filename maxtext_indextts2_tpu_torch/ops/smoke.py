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
equal outputs (``repeat_bitwise_equal``).

Run: ``python -m maxtext_indextts2_tpu_torch.ops.smoke [small] [ragged | flash | paged | s2a]``
(needs the GPU; ``small`` shrinks the serving and training shapes for a
quick first check of a changed kernel, ``ragged`` runs the K1-K3 cases only,
``flash`` the K9-K11 cases only, ``paged`` the K4 cases only, ``s2a`` the K12
cases only; the repo's ``chip_smoke.py`` calls :func:`run_all`).
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from maxtext_indextts2_tpu_torch.ops import ada_rmsnorm as arn
from maxtext_indextts2_tpu_torch.ops import flash_attention as fa
from maxtext_indextts2_tpu_torch.ops import inplace_update as iu
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
    main = name in MAIN_PATH_CASES.values()
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
    main = name in MAIN_PATH_CASES.values()
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
        if name in MAIN_PATH_CASES.values():
            res.update(device_ms=device_ms(lambda: iu.inplace_row_update(cache, kv, idx)),
                       library_device_ms=device_ms(
                           lambda: cache.index_put_((rows, offs), kv_cast)),
                       library_call="index_put_")
    return res


def _row_inputs(kernel, b, s, d, dtype, seed, device, special):
    """(x, second) for one row-kernel case: `second` is w [B,D] for the norm
    kernels, u for silu_mul_quantize, None for row_quantize_int8."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn((b, s, d), generator=g, device=device, dtype=torch.float32) * 1.5).to(dtype)
    if special:
        x[min(1, b - 1)] = 0  # an all-zero batch row (a dummy request, padding)
        # rows whose quotients land on .5: abs-max 127 gives scale 1.0 exactly
        half = (torch.arange(d, device=device) % 126).float() + 0.5
        half[0] = 127.0
        x[0, : min(4, s)] = (half * torch.tensor([1.0, -1.0], device=device)[
            torch.arange(d, device=device) % 2]).to(dtype)
    if kernel in ("ada_rmsnorm", "ada_rmsnorm_quantize"):
        second = 1.0 + 0.3 * torch.randn((b, d), generator=g, device=device, dtype=torch.float32)
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


def row_case(name, device, timing, *, kernel, b, s, d, dtype=torch.bfloat16, seed=0,
             special=False):
    """One of the four S2A row kernels against its plain version."""
    fn = _ROW_FUNCS[kernel]
    x, second = _row_inputs(kernel, b, s, d, dtype, seed, device, special)
    got = fn(x, second, None)
    torch.cuda.synchronize()
    want = fn(x, second, "plain")
    torch.cuda.synchronize()
    esz = x.element_size()
    n = x.numel()
    shape = dict(b=b, s=s, d=d, dtype=str(dtype), special_rows=special)
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


def row_cases(device, timing, full_size=True):
    """K5-K8: the main-path shape in bfloat16 and float32, widths that are no
    multiple of 128 (1000) or of the vector width (1001), a row count that is
    no multiple of any block (650), an all-zero batch row and rows whose
    quotients land on .5."""
    bf16, f32 = torch.bfloat16, torch.float32
    main = dict(S2A_MAIN) if full_size else dict(b=2, s=96, d=1024)
    out = []
    for i, kernel in enumerate(_ROW_FUNCS):
        wide = dict(main, d=4 * main["d"]) if kernel == "silu_mul_quantize" else main
        seed = 100 + 10 * i
        out += [
            row_case(f"{kernel}_bf16_main_path", device, timing, kernel=kernel, **wide,
                     seed=seed),
            row_case(f"{kernel}_f32", device, timing, kernel=kernel, **wide, dtype=f32,
                     seed=seed + 1),
            row_case(f"{kernel}_bf16_uncond_512", device, timing, kernel=kernel,
                     **dict(wide, s=min(512, wide["s"])), seed=seed + 2),
            row_case(f"{kernel}_bf16_d1000_s650", device, timing, kernel=kernel, b=3, s=650,
                     d=1000, seed=seed + 3),
            row_case(f"{kernel}_f32_d1001", device, timing, kernel=kernel, b=2, s=77, d=1001,
                     dtype=f32, seed=seed + 4),
            row_case(f"{kernel}_bf16_d1001", device, timing, kernel=kernel, b=2, s=77, d=1001,
                     seed=seed + 5),
            row_case(f"{kernel}_bf16_zero_and_half_rows", device, timing, kernel=kernel, b=4,
                     s=40, d=1024, seed=seed + 6, special=True),
            row_case(f"{kernel}_f32_zero_and_half_rows", device, timing, kernel=kernel, b=4,
                     s=40, d=256, dtype=f32, seed=seed + 7, special=True),
        ]
    return out


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
        if name in MAIN_PATH_CASES.values():
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
# lse is float32 in both dtypes, from exact products of the inputs, summed in
# another order: 1e-4 absolute.
TOL_FLASH = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -5}
TOL_FLASH_FLOOR = 2.0 ** -10
TOL_FLASH_UNIT = {torch.float32: "relative to max(1, max |plain|)",
                  torch.bfloat16: "each element relative to max(|plain|, mean |plain|, 2**-10)"}
TOL_FLASH_LSE = 1e-4
# The training step's attention: per_device_batch_size 4 x 2048 tokens of
# tts-1b, 16 query / 8 kv heads of 128.
FLASH_MAIN = dict(b=4, s=2048, h=16, hkv=8, d=128)


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
    return q, k, v, do, pos, seg


def _flash_pairs(pos, seg, causal, window, chunk) -> int:
    """Visible (query, key) pairs over the batch: the work the data needs."""
    return int(fa._mask(pos, pos, seg, seg, causal, window, chunk).sum().item())


def _flash_library(q, k, v, do, on_device=False):
    """SDPA with is_causal and enable_gqa on the same [B,N,S,D] views, forward,
    and its autograd backward (dq, dk and dv in one call): a yardstick only.
    (forward ms, backward ms), and with ``on_device`` their device times too."""
    f = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v))
    out = f(qt, kt, vt, is_causal=True, enable_gqa=True)
    gt = do.transpose(1, 2)
    fwd = lambda: f(qt, kt, vt, is_causal=True, enable_gqa=True)  # noqa: E731
    bwd = lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)  # noqa: E731
    times = (time_ms(fwd, warmup=2, iters=10), time_ms(bwd, warmup=2, iters=10))
    if on_device:
        times += (device_ms(fwd, iters=5), device_ms(bwd, iters=5))
    return times


def flash_case(name, device, timing, *, b, s, h, hkv, d, dtype=torch.bfloat16, causal=True,
               window=0, chunk=0, cap=0.0, segments="one", positions="arange", peak=1.0,
               seed=0):
    """K9, K10 and K11 against their plain versions on the same inputs: three
    results, ``{name}_fwd``, ``{name}_dq`` and ``{name}_dkv``. The backward
    kernels and their plain versions get the same lse and delta (the kernel's)."""
    q, k, v, do, pos, seg = _flash_inputs(b, s, h, hkv, d, dtype, seed, device, segments,
                                          positions, peak)
    qh, kh, vh, doh = (t.transpose(1, 2) for t in (q, k, v, do))  # [B,N,S,D] views
    ids = (pos, pos, seg, seg)
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

    def rel_err(got, want):
        """(max |err|, the largest error in the dtype's unit, see ``TOL_FLASH``)."""
        diff = (got.float() - want.float()).abs()
        mag = want.float().abs()
        if dtype == torch.float32:
            scale = torch.clamp(mag.max(), min=1.0)
        else:
            scale = torch.clamp(mag, min=max(float(mag.mean().item()), TOL_FLASH_FLOOR))
        return float(diff.max().item()), float((diff / scale).max().item())

    shape = dict(b=b, s=s, h=h, hkv=hkv, d=d, dtype=str(dtype), causal=causal, window=window,
                 chunk=chunk, soft_cap=cap, segments=segments, positions=positions, peak=peak)
    tol = TOL_FLASH[dtype]
    lse_ok = bool(torch.equal(torch.isneginf(lse), torch.isneginf(lse_ref)))
    fin = torch.isfinite(lse_ref)
    lse_err = float((lse[fin] - lse_ref[fin]).abs().max().item()) if fin.any() else 0.0
    padding_zero = bool((o.transpose(1, 2)[seg == 0] == 0).all().item())
    checks = {
        "flash_fwd": [rel_err(o, o_ref)],
        "flash_bwd_dq": [rel_err(dq, dq_ref)],
        "flash_bwd_dkv": [rel_err(dk, dk_ref), rel_err(dv, dv_ref)],
    }
    outs = {"flash_fwd": [o], "flash_bwd_dq": [dq], "flash_bwd_dkv": [dk, dv]}
    results = []
    for kernel, errs in checks.items():
        finite = all(bool(torch.isfinite(t).all().item()) for t in outs[kernel])
        worst = max(e[1] for e in errs)
        ok = finite and worst <= tol
        res = dict(name=f"{name}_{kernel[len('flash_'):].replace('bwd_', '')}", kernel=kernel,
                   max_abs_err=max(e[0] for e in errs), max_err=worst, tol=tol,
                   unit=TOL_FLASH_UNIT[dtype], finite=finite, shape=shape)
        if kernel == "flash_fwd":
            ok = ok and lse_ok and lse_err <= TOL_FLASH_LSE and padding_zero
            res.update(lse_max_abs_err=lse_err, tol_lse=TOL_FLASH_LSE,
                       lse_minus_inf_rows_equal=lse_ok, padding_rows_zero=padding_zero)
        res["ok"] = bool(ok)
        results.append(res)
    if timing:
        pairs = _flash_pairs(pos, seg, causal, window, chunk)
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
        library = (None, None)
        if causal and not (window or chunk or cap) and segments == "one" \
                and positions == "arange":
            library = _flash_library(q, k, v, do, on_device=name in {
                c[:-len("_fwd")] for c in MAIN_PATH_CASES.values() if c.endswith("_fwd")})
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
                library_call=None if library[0] is None else (
                    "scaled_dot_product_attention(is_causal, enable_gqa)" + (
                        "" if kernel == "flash_fwd" else ": its autograd backward (dq, dk, dv)")),
            )
            if len(library) == 4:
                res["library_device_ms"] = library[2] if kernel == "flash_fwd" else library[3]
    return results


def flash_cases(device, timing, full_size=True):
    """K9-K11: the training step's shape (bfloat16 and float32), packed
    documents with a segment-0 tail, sliding window, chunks, soft cap,
    non-causal, permuted positions, peaked logits (q and k scaled by 3: the
    logits' spread is 9, so a few keys take most of a row's softmax and the
    running max moves by many units between key tiles), D = 64 at ragged S
    (405; 1000, which the 64- and 32-row tiles do not divide), S = 1 and
    S = 130."""
    main = dict(FLASH_MAIN) if full_size else dict(FLASH_MAIN, b=1, s=512)
    small = dict(b=2, s=1024 if full_size else 256, h=16, hkv=8, d=128)
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
    ]
    return [r for g in groups for r in g]


# The cases at the shapes the main paths of ``chip_smoke.py`` give the
# kernels. Serving run: 32 slots of the tts-1b cache, each holding a prompt of
# up to 400 tokens plus up to 128 generated ones. TTS back end: 8 requests, the
# prompt padded to 256 and the target bucketed to 512 frames, hidden 1024.
# ``synthesize``: one request, the conditional forward over P + T rows.
MAIN_PATH_CASES = {
    "s2a_attention": "s2a_attention_bf16_main_path",
    "ragged_decode_attention": "ragged_bf16_main_path",
    "paged_decode_attention": "paged_bf16_main_path",
    "inplace_row_update": "inplace_kv_bf16_k1_main_path",
    "ada_rmsnorm": "ada_rmsnorm_bf16_main_path",
    "row_quantize_int8": "row_quantize_int8_bf16_main_path",
    "ada_rmsnorm_quantize": "ada_rmsnorm_quantize_bf16_main_path",
    "silu_mul_quantize": "silu_mul_quantize_bf16_main_path",
    "flash_fwd": "flash_bf16_main_path_fwd",
    "flash_bwd_dq": "flash_bf16_main_path_dq",
    "flash_bwd_dkv": "flash_bf16_main_path_dkv",
}


def ragged_cases(device, timing, full_size=True, serve_slots=32):
    """K1-K3: K1 at the serving path's shape and at 128 slots x 2048 rows in
    every cache type, the window, the v1 entry (K3), other head dims and
    groups; the edges of the cluster's split of a slot's rows (blocks with no
    row, multiples of the cluster size, max_len and past it, windows that are
    no multiple of it, clusters of 8, 4, 2 and 1 block); K2's row updates."""
    big = dict(TTS_1B) if full_size else dict(b=8, s=256, nq=16, nkv=8, d=128)
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
        inplace_case("inplace_kv_bf16_k1", device, timing, cache_shape=kv4, span=1,
                     cache_dtype=bf16, seed=11),
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
        + flash_cases(device, timing, full_size)


def main(argv=None):
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if not set(argv) <= {"small", "ragged", "flash", "paged", "s2a"}:
        raise SystemExit("usage: python -m maxtext_indextts2_tpu_torch.ops.smoke [small] "
                         "[ragged | flash | paged | s2a]")
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
    else:
        results = run_all(full_size=full)
    for r in results:
        print(json.dumps(r))
    if "flash" not in argv and "s2a" not in argv:  # K1 / K3 / K4: registers and spills
        from maxtext_indextts2_tpu_torch.ops import _build

        for r in _build.ptxas_report("ragged_decode_kernel"):
            print(json.dumps(dict(ptxas=r)))
    if not all(r["ok"] for r in results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
