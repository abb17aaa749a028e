"""On-device checks of the CUDA kernels against their plain versions.

Each case builds its inputs from a seed on the GPU at the shapes the
``tts-1b`` serving path gives the kernel (128 slots x 2048 cache rows, 16
query / 8 kv heads, head_dim 128) or at one of the other supported head
dims, runs the kernel and the plain PyTorch version on the same inputs,
synchronises so that a fault surfaces where it happened, and reports the
largest absolute difference beside its tolerance. With ``timing=True`` it
also times the kernel, the plain version and one library call for the same
function (a yardstick only; this package never calls it) with CUDA events,
and computes the least time the card could take for the same work from this
run's inputs: bytes moved (each input read once, each output written once,
only the cache rows the lengths make valid) over the memory rate, or
operations over the peak rate of the input type, whichever is larger.

Run: ``python -m maxtext_indextts2_tpu_torch.ops.smoke [small]`` (needs the
GPU; ``small`` shrinks the serving shapes for a quick first check of a
changed kernel; the repo's ``chip_smoke.py`` calls :func:`run_all`).
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from maxtext_indextts2_tpu_torch.ops import inplace_update as iu
from maxtext_indextts2_tpu_torch.ops import ragged_decode_attention as rda
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


def _ragged_inputs(b, s, nq, nkv, d, dtype, seed, device, int8=False, serving_max=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, nq, d), generator=g, device=device, dtype=torch.float32).to(dtype)
    k = torch.randn((b, s, nkv, d), generator=g, device=device, dtype=torch.float32)
    v = torch.randn((b, s, nkv, d), generator=g, device=device, dtype=torch.float32)
    lengths = spread_lengths(b, s, seed, serving_max).to(device)
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
                int8=False, window=0, v1_entry=False, seed=0, serving_max=0):
    q, k, v, lengths, ks, vs = _ragged_inputs(b, s, nq, nkv, d, dtype, seed, device, int8,
                                              serving_max)
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
    )
    if timing:
        bound, by, nbytes = _ragged_bound_ms(q, k, lengths, window, int8, out.dtype)
        res.update(
            kernel_ms=time_ms(lambda: run(None)),
            plain_ms=time_ms(lambda: run("plain"), warmup=1, iters=3),
            bound_ms=bound, bound_by=by, bytes_moved=nbytes,
            library_ms=None if int8 else time_ms(_sdpa_library(q, k, v, lengths, window),
                                                 warmup=1, iters=5),
        )
    return res


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
    return res


# The two cases at the shapes the serving run of ``chip_smoke.py`` gives the
# kernels: 32 slots of the tts-1b cache, each holding a prompt of up to 400
# tokens plus up to 128 generated ones.
MAIN_PATH_CASES = {
    "ragged_decode_attention": "ragged_bf16_main_path",
    "inplace_row_update": "inplace_kv_bf16_k1_main_path",
}


def run_all(device="cuda", timing: bool = True, full_size: bool = True,
            serve_slots: int = 32) -> list[dict]:
    """Every kernel case. ``full_size=False`` shrinks the serving shapes (a
    quick first check of a changed kernel)."""
    device = torch.device(device)
    big = dict(TTS_1B) if full_size else dict(b=8, s=256, nq=16, nkv=8, d=128)
    serve = dict(big, b=serve_slots)
    kv4 = (big["b"], big["s"], big["nkv"], big["d"])
    sc3 = (big["b"], big["s"], big["nkv"])
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
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


def main(argv=None):
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["small"]):
        raise SystemExit("usage: python -m maxtext_indextts2_tpu_torch.ops.smoke [small]")
    if not torch.cuda.is_available():
        raise SystemExit("ops.smoke needs a CUDA device")
    results = run_all(full_size=not argv)
    for r in results:
        print(json.dumps(r))
    if not all(r["ok"] for r in results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
