"""K5 (``ada_rmsnorm``) and K7 (``ada_rmsnorm_quantize``) at the edges of the
launch shape of their CUDA kernel (``rowk::norm_rows_kernel``): the pure
function that picks the shape from static shapes, the arguments the wrappers
hand to the C entry points, and the plain versions (what the wrappers run on
the CPU) against the JAX package at those edge shapes -- its Pallas kernels
in interpret mode where D % 128 == 0, its unfused jnp form otherwise.
Inputs come from a numpy seed and go to both sides.

Tolerances, and why (as in ``test_torch_s2a_kernels_plain.py``): float32
outputs rtol 2e-6 (the sum of squares in another order moves the variance by
its last bit); bfloat16 outputs rtol 2**-7 with at most 1 element in 100
moved (a last-bit difference of the float32 rsqrt factor moves a whole row
by one bfloat16 step); int8 codes equal but for a share under 1e-3 one step
apart, scales rtol 1e-6 (float32) or 2**-7 (bfloat16). The JAX side is
compiled without XLA's excess precision, so that every bfloat16 operation
rounds as written.
"""

import inspect
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.audio import s2a as jax_s2a
from maxtext_indextts2_tpu.ops import ada_rmsnorm as jax_arn
from maxtext_indextts2_tpu.ops import quant_kernels as jax_qk
from maxtext_indextts2_tpu_torch.audio import s2a as s2a_lib
from maxtext_indextts2_tpu_torch.ops import _build, smoke
from maxtext_indextts2_tpu_torch.ops import ada_rmsnorm as arn
from maxtext_indextts2_tpu_torch.ops import quant_kernels as qk
from maxtext_indextts2_tpu_torch.tools import bench_row_kernels, profile_s2a

torch.set_num_threads(1)

ELEM_BYTES = {"f32": 4, "bf16": 2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
BF16_STEP = 2.0 ** -7


def _split_edge(elem_bytes: int) -> int:
    """The widest row the kernel holds in registers: MAX_WARPS_PER_ROW warps
    of 32 lanes, MAX_CHUNKS 16-byte chunks a lane."""
    return arn.MAX_WARPS_PER_ROW * 32 * arn.MAX_CHUNKS * (arn.CHUNK_BYTES // elem_bytes)


# ---------------------------------------------------------------------------
# the launch shape


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_norm_row_shape_takes_every_width_up_to_the_split_edge(dtype):
    """Every D from 1 to the widest row the registers hold: the lanes cover
    the row, no lane holds more than the register cap, the count is one the
    kernel has an instantiation for and the smallest that covers, and the
    row takes the fewest warps that can hold it (one while one can)."""
    eb = ELEM_BYTES[dtype]
    vec = arn.CHUNK_BYTES // eb
    edge = _split_edge(eb)
    for d in range(1, edge + 1):
        chunks, warps, rounds = arn.norm_row_shape(d, eb)
        assert not rounds, d
        assert chunks in arn.CHUNK_COUNTS and chunks <= arn.MAX_CHUNKS, d
        assert 1 <= warps <= arn.MAX_WARPS_PER_ROW, d
        assert 32 * warps * chunks * vec >= d, d  # the lanes cover the row
        smaller = [c for c in arn.CHUNK_COUNTS if c < chunks]
        assert not smaller or 32 * warps * smaller[-1] * vec < d, d
        assert warps == 1 or 32 * (warps - 1) * arn.MAX_CHUNKS * vec < d, d
    for d in (edge + 1, edge + vec, 2 * edge, 58112):  # walked in rounds
        assert arn.norm_row_shape(d, eb) == (arn.MAX_CHUNKS, arn.MAX_WARPS_PER_ROW, True)


@pytest.mark.parametrize("d,elem_bytes,want", [
    (1024, 2, (4, 1, False)),   # the denoiser's rows in bfloat16: 4 chunks a lane
    (1024, 4, (8, 1, False)),   # ... in float32 (the bfloat16 serving mode)
    (1000, 2, (4, 1, False)), (1001, 2, (4, 1, False)),
    (8, 2, (1, 1, False)), (24, 4, (1, 1, False)), (256, 4, (2, 1, False)),
    (2048, 2, (8, 1, False)),   # the widest row one warp holds
    (2049, 2, (8, 2, False)), (2048, 4, (8, 2, False)),
    (4096, 2, (8, 2, False)),   # silu_mul_quantize's width, were K7 given it
    (8192, 2, (8, 4, False)), (3000, 4, (8, 3, False)),
    (16384, 2, (8, 8, False)), (16385, 2, (8, 8, True)),
    (20000, 2, (8, 8, True)), (9001, 4, (8, 8, True)),
])
def test_norm_row_shape_at_the_smoke_cases(d, elem_bytes, want):
    assert arn.norm_row_shape(d, elem_bytes) == want


@pytest.mark.parametrize("warps_per_row", [1, 2, 4, 8])
@pytest.mark.parametrize("resident_warps", [8, 132 * 8, 132 * 24, 132 * 64])
def test_rows_per_worker_is_one_wave(warps_per_row, resident_warps):
    """As few rows a worker as let one wave of the resident warps take every
    row: the workers cover the rows, and one row fewer a worker would not."""
    workers = resident_warps // warps_per_row
    for rows in (1, 7, 300, 6144, 4096 + 1, 7000, 10 ** 6):
        n = arn.rows_per_worker(rows, warps_per_row, resident_warps)
        assert n >= 1 and n * workers >= rows
        assert n == 1 or (n - 1) * workers < rows


def test_launch_shape_reads_static_shapes_only():
    """The shape functions take integers, not tensors (nothing a call would
    have to read back from the device), and the launch shape is worked out
    once for each set of static shapes."""
    for fn in (arn.norm_row_shape, arn.rows_per_worker):
        params = inspect.signature(fn).parameters.values()
        assert all(p.annotation in (int, "int") for p in params), fn
    assert hasattr(arn.norm_launch, "cache_info") and hasattr(arn.norm_occupancy, "cache_info")


@pytest.fixture
def fake_card(monkeypatch):
    """A fake kernel library that records what the wrappers hand the C entry
    points, on a card of 132 SMs that holds 5 blocks of 4 warps of every
    instantiation."""
    calls = []

    def entry(name):
        def call(*args):
            calls.append((name, args))
            return 0
        return call

    lib = types.SimpleNamespace(ada_rmsnorm=entry("ada_rmsnorm"),
                                ada_rmsnorm_quantize=entry("ada_rmsnorm_quantize"))
    monkeypatch.setattr(_build, "load_library", lambda *a, **k: lib)
    monkeypatch.setattr(arn, "route", lambda *a, **k: "cuda")
    monkeypatch.setattr(qk, "route", lambda *a, **k: "cuda")
    monkeypatch.setattr(arn, "norm_occupancy", lambda *a: (5, 128))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=7))
    arn.norm_launch.cache_clear()
    yield calls
    arn.norm_launch.cache_clear()


@pytest.mark.parametrize("b,s,d,dtype,w_dtype", [
    (8, 768, 1024, "bf16", "f32"),  # the main path: 3 rows a warp
    (8, 768, 1024, "f32", "f32"),
    (300, 1, 1024, "bf16", "bf16"),  # one row a batch entry
    (300, 5, 8192, "bf16", "f32"),  # 4 warps a row
    (2, 5, 20000, "bf16", "f32"),  # rounds
])
@pytest.mark.parametrize("entry", ["ada_rmsnorm", "ada_rmsnorm_quantize"])
def test_wrappers_hand_the_launch_shape_to_the_entry_points(fake_card, entry, b, s, d, dtype,
                                                             w_dtype):
    x, w = torch.zeros((b, s, d), dtype=TDT[dtype]), torch.ones((b, d), dtype=TDT[w_dtype])
    launches = (arn.launch_count, qk.launch_counts["ada_rmsnorm_quantize"])
    if entry == "ada_rmsnorm":
        out = arn.ada_rmsnorm(x, w)
        assert out.shape == x.shape and out.dtype == x.dtype
    else:
        q, sc = qk.ada_rmsnorm_quantize(x, w)
        assert q.shape == x.shape and q.dtype == torch.int8 and sc.shape == (b, s)
    ((name, args),) = fake_card
    assert name == entry and len(args) == len(_build.SIGNATURES[entry])
    rows, s_len, d_arg, code, w_is_f32, chunks, warps, per_worker, rounds, stream = args[-10:]
    assert (rows, s_len, d_arg, code, stream) == (b * s, s, d, arn.FLOAT_DTYPES[x.dtype], 7)
    assert w_is_f32 == int(w.dtype == torch.float32)
    assert (chunks, warps, bool(rounds)) == arn.norm_row_shape(d, x.element_size())
    assert per_worker == arn.rows_per_worker(b * s, warps, 5 * 4 * 132)
    after = (arn.launch_count, qk.launch_counts["ada_rmsnorm_quantize"])
    assert sum(after) - sum(launches) == 1


def test_main_path_launch_shape(fake_card):
    """[8,768,1024] bfloat16 on a card that holds 5 blocks of 4 warps an SM:
    2,640 warps, 3 rows each, one wave."""
    assert arn.norm_launch("ada_rmsnorm_quantize", 6144, 1024, torch.bfloat16, 1,
                           torch.device("cuda")) == (4, 1, 3, 0)


def test_entry_points_take_the_launch_shape():
    for entry in ("ada_rmsnorm", "ada_rmsnorm_quantize"):
        sig = _build.SIGNATURES[entry]
        assert sig[-5:-1] == [_build._I] * 4 and sig[-1] is _build._P
        assert _build.SIGNATURES[f"{entry}_occupancy"] == [_build._P] + [_build._I] * 5 + [
            _build._P]


# ---------------------------------------------------------------------------
# the plain versions against the JAX package at the new edge shapes


def strict(fn, *args):
    """``fn(*args)`` compiled without XLA's excess precision."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _jnp_norm(x, w):
    var = jnp.mean(jnp.square(x.astype(jnp.float32)), axis=-1, keepdims=True)
    return x * jax.lax.rsqrt(var + 1e-6).astype(x.dtype) * w[:, None, :].astype(x.dtype)


def _jnp_quant(y):
    yf = y.astype(jnp.float32)
    xs = jnp.max(jnp.abs(yf), axis=-1) / 127.0
    return jnp.round(yf / jnp.maximum(xs[..., None], 1e-9)).astype(jnp.int8), xs


def _f32(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(
        jnp.asarray(a).astype(jnp.float32))


def _inputs(seed, b, s, d, dtype, w_dtype, special=False):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, s, d)) * 1.5).astype(np.float32)
    w = (1.0 + 0.3 * rng.normal(size=(b, d))).astype(np.float32)
    if special:
        x[min(1, b - 1)] = 0.0  # an all-zero batch entry
        half = (np.arange(d) % 126).astype(np.float32) + 0.5  # abs-max 127: scale 1.0
        half[0] = 127.0
        x[0, : min(4, s)] = half * np.where(np.arange(d) % 2, -1.0, 1.0)
    jx, jw = jnp.asarray(x).astype(JDT[dtype]), jnp.asarray(w).astype(JDT[w_dtype])
    tx, tw = torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(w).to(TDT[w_dtype])
    return (jx, jw), (tx, tw)


def _check_norm(got, want, dtype):
    assert got.dtype == TDT[dtype]
    rtol = 2e-6 if dtype == "f32" else BF16_STEP
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=1e-30)
    if dtype == "bf16":
        assert (_f32(got) != _f32(want)).mean() <= 0.01


def _check_codes(got, want, dtype):
    (q, sc), (qw, sw) = got, want
    assert q.dtype == torch.int8 and sc.dtype == torch.float32
    steps = np.abs(q.detach().numpy().astype(np.int32) - np.asarray(qw).astype(np.int32))
    assert steps.max() <= 1 and (steps > 0).mean() <= 1e-3
    np.testing.assert_allclose(sc.detach().numpy(), np.asarray(sw).reshape(sc.shape),
                               rtol=1e-6 if dtype == "f32" else BF16_STEP, atol=1e-30)


# (b, s, d, dtype, w dtype): rows of 8 / 24 / 1000 elements (jnp), of 2048 and
# 8192 (Pallas), one row a batch entry, batch entries of 5 and 7 rows, w in
# x's type
EDGE_SHAPES = [
    pytest.param(3, 50, 8, "bf16", "f32", id="d8_bf16"),
    pytest.param(3, 50, 24, "f32", "f32", id="d24_f32"),
    pytest.param(2, 9, 1000, "bf16", "bf16", id="d1000_bf16_w_bf16"),
    pytest.param(2, 6, 2048, "bf16", "f32", id="d2048_bf16"),
    pytest.param(2, 6, 2048, "f32", "f32", id="d2048_f32"),
    pytest.param(2, 3, 8192, "bf16", "f32", id="d8192_bf16"),
    pytest.param(12, 1, 256, "bf16", "f32", id="one_row_a_batch_entry"),
    pytest.param(3, 7, 128, "bf16", "bf16", id="s7_w_bf16"),
    pytest.param(4, 5, 384, "f32", "f32", id="s5_f32"),
]


@pytest.mark.parametrize("b,s,d,dtype,w_dtype", EDGE_SHAPES)
def test_ada_rmsnorm_plain_at_the_launch_edges(b, s, d, dtype, w_dtype):
    (jx, jw), (tx, tw) = _inputs(10 + d + s, b, s, d, dtype, w_dtype)
    got = arn.ada_rmsnorm(tx, tw)
    _check_norm(got, strict(_jnp_norm, jx, jw), dtype)
    if d % 128 == 0:  # the TPU kernel's own width rule
        _check_norm(got, strict(lambda x, w: jax_arn.ada_rmsnorm(x, w, True), jx, jw), dtype)


@pytest.mark.parametrize("b,s,d,dtype,w_dtype", EDGE_SHAPES)
def test_ada_rmsnorm_quantize_plain_at_the_launch_edges(b, s, d, dtype, w_dtype):
    (jx, jw), (tx, tw) = _inputs(20 + d + s, b, s, d, dtype, w_dtype)
    got = qk.ada_rmsnorm_quantize(tx, tw)
    _check_codes(got, strict(lambda x, w: _jnp_quant(_jnp_norm(x, w)), jx, jw), dtype)
    if d % 128 == 0:
        _check_codes(got, strict(
            lambda x, w: jax_qk.ada_rmsnorm_quantize(x, w, interpret=True), jx, jw), dtype)
    two = qk.row_quantize_int8(arn.ada_rmsnorm(tx, tw))  # fused == two-step, exactly
    assert torch.equal(got[0], two[0]) and torch.equal(got[1], two[1])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_zero_rows_and_half_quotients_at_d2048(dtype):
    """An all-zero batch entry gives zeros and scale 0 (no NaN). Rows of ones
    have rms 1, so in bfloat16 the factor rounds to 1.0 and y = w: with w on
    k + 0.5 and an abs-max of 127 the scale is 1.0 and every quotient a tie,
    rounded half to even as the Pallas kernel rounds it. (In float32 the
    factor is 1 - 5e-7 and the quotients only near ties, which XLA's
    reciprocal for / 127 moves by a step: float32 keeps random rows.)"""
    b, s, d = 3, 8, 2048
    rng = np.random.default_rng(31)
    x = (rng.normal(size=(b, s, d)) * 1.5).astype(np.float32)
    w = (1.0 + 0.3 * rng.normal(size=(b, d))).astype(np.float32)
    x[1] = 0.0
    half = ((np.arange(d) % 126) + 0.5).astype(np.float32)
    half[0] = 127.0
    half *= np.where(np.arange(d) % 2, -1.0, 1.0).astype(np.float32)
    if dtype == "bf16":
        x[0, :4], w[0] = 1.0, half
    jx, jw = jnp.asarray(x).astype(JDT[dtype]), jnp.asarray(w)
    tx, tw = torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(w)
    q, sc = qk.ada_rmsnorm_quantize(tx, tw)
    y = arn.ada_rmsnorm(tx, tw)
    assert (q[1] == 0).all() and (sc[1] == 0).all() and (y[1] == 0).all()
    assert torch.isfinite(sc).all() and torch.isfinite(y).all()
    _check_codes((q, sc), strict(
        lambda x, w: jax_qk.ada_rmsnorm_quantize(x, w, interpret=True), jx, jw), dtype)
    _check_norm(y, strict(lambda x, w: jax_arn.ada_rmsnorm(x, w, True), jx, jw), dtype)
    if dtype == "bf16":
        assert (sc[0, :4] == 1.0).all() and torch.equal(y[0, :4].float(),
                                                        torch.from_numpy(half).expand(4, d))
        np.testing.assert_array_equal(q[0, :4].numpy(),
                                      np.broadcast_to(np.rint(half).astype(np.int8), (4, d)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_zero_and_half_rows_through_the_quantizer_at_d2048(dtype):
    """The quantizer's own .5 rows at D = 2048: abs-max 127 gives scale 1.0
    exactly, so k + 0.5 quotients are ties, rounded to even."""
    x = torch.zeros((2, 3, 2048))
    half = (torch.arange(2048) % 126).float() + 0.5
    half[0] = 127.0
    x[0] = half * torch.where(torch.arange(2048) % 2 == 1, -1.0, 1.0)
    x = x.to(TDT[dtype])
    q, sc = qk.row_quantize_int8(x)
    assert (sc[0] == 1.0).all() and (sc[1] == 0).all() and (q[1] == 0).all()
    np.testing.assert_array_equal(q[0].numpy(), np.rint(x[0].float().numpy()).astype(np.int8))
    jq, js = jax_qk.row_quantize_int8(jnp.asarray(x.float().numpy()).astype(JDT[dtype]),
                                      interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


@pytest.mark.parametrize("quantize_out", [False, True], ids=["float_out", "quantize_out"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adaptive_rmsnorm_x_b_d_is_one_row_a_batch_entry(dtype, quantize_out):
    """x [B, D] through ``AdaptiveRMSNorm``: the module hands the wrappers
    [B, 1, D] rows (s_len = 1, every row its own w), equal to the JAX
    module's unfused arithmetic on those [B, 1, D] rows (the JAX module
    itself would broadcast a 2-D x against its [B, 1, D] weight)."""
    rng = np.random.default_rng(41)
    h = 256
    kernel = (0.05 * rng.normal(size=(h, h))).astype(np.float32)
    bias = (1.0 + 0.1 * rng.normal(size=(h,))).astype(np.float32)
    x = (1.5 * rng.normal(size=(9, h))).astype(np.float32)
    cond = rng.normal(size=(9, h)).astype(np.float32)
    tn = s2a_lib.AdaptiveRMSNorm(h, device="cpu")
    tn.load_state_dict({"to_weight.kernel": torch.from_numpy(kernel),
                        "to_weight.bias": torch.from_numpy(bias)})
    jparams = {"params": {"to_weight": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}}
    want = jax_s2a.AdaptiveRMSNorm(h).apply(
        jparams, jnp.asarray(x[:, None, :]).astype(JDT[dtype]), jnp.asarray(cond), quantize_out)
    got = tn(torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(cond), quantize_out)
    # w comes from each package's own float32 Dense (256 products summed in
    # another order): a few float32 steps of w, so float32 outputs within 2e-5
    # and, as test_torch_s2a.py's module test has it, codes one step apart in
    # under 1 in 100
    if quantize_out:
        (q, sc), (qw, sw) = got, want
        assert q.shape == (9, h) and sc.shape == (9,)
        steps = np.abs(q.numpy().astype(int) - np.asarray(qw)[:, 0].astype(int))
        assert steps.max() <= 1 and (steps > 0).mean() <= 1e-2
        np.testing.assert_allclose(sc.detach().numpy(), np.asarray(sw)[:, 0],
                                   rtol=2e-5 if dtype == "f32" else BF16_STEP)
    else:
        assert got.shape == (9, h)
        np.testing.assert_allclose(_f32(got), _f32(want)[:, 0],
                                   rtol=2e-5 if dtype == "f32" else BF16_STEP, atol=1e-6)


# ---------------------------------------------------------------------------
# the card checks and the tools around them


def test_bench_times_exactly_the_smoke_row_cases():
    assert bench_row_kernels.row_specs() == smoke.row_case_specs(True)
    names = [n for n, _ in smoke.row_case_specs(True)]
    assert len(names) == len(set(names)) == 56
    repeated = [n for n, kw in smoke.row_case_specs(True) if kw.get("repeat")]
    assert repeated == ["ada_rmsnorm_bf16_main_path", "ada_rmsnorm_quantize_bf16_main_path"]


@pytest.mark.parametrize("kernel", ["ada_rmsnorm", "ada_rmsnorm_quantize"])
def test_smoke_covers_the_launch_edges(kernel):
    """Each regime of the launch shape has a K5 and a K7 case: 1, 2, 4 and 8
    chunks a lane, 1, 2, 4 and 8 warps a row (8 in rounds), a batch entry of
    one row, x off a 16-byte boundary, w in x's type."""
    specs = [kw for _, kw in smoke.row_case_specs(True) if kw["kernel"] == kernel]
    shapes = {arn.norm_row_shape(kw["d"], torch.empty((), dtype=kw.get(
        "dtype", torch.bfloat16)).element_size()) for kw in specs}
    assert {c for c, _, _ in shapes} >= {1, 2, 4, 8}
    assert {w for _, w, _ in shapes} >= {1, 2, 4, 8} and any(r for _, _, r in shapes)
    assert any(kw["s"] == 1 for kw in specs) and any(kw.get("misaligned") for kw in specs)
    assert any(kw.get("w_dtype") == torch.bfloat16 for kw in specs)
    # batch entries that end inside one worker's rows, on a card of 132 SMs
    # that holds 2 to 5 blocks of the instantiation
    inside = [kw for n, kw in smoke.row_case_specs(True) if kw["kernel"] == kernel
              and "end_inside" in n]
    assert len(inside) == 2
    for kw in inside:
        _, warps, _ = arn.norm_row_shape(kw["d"], 2)
        for per_sm in range(2, 6):  # blocks of 4 warps, or of `warps` for a split row
            per_worker = arn.rows_per_worker(kw["b"] * kw["s"], warps,
                                             132 * per_sm * max(4, warps))
            assert per_worker > 1 and kw["s"] % per_worker != 0, (kw, per_sm)


def test_smoke_rows_selector_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        smoke.main(["rows"])
    with pytest.raises(SystemExit, match="usage"):
        smoke.main(["norms"])


@pytest.mark.parametrize("event,wrapper", [
    ("void rowk::norm_rows_kernel<__nv_bfloat16, float, true, 4, false>(void const*, void "
     "const*, void*, signed char*, float*, long long, int, int, int, int, int)",
     "ada_rmsnorm_quantize"),
    ("void rowk::norm_rows_kernel<float, float, false, 8, false>(void const*)", "ada_rmsnorm"),
    ("void rowk::norm_rows_kernel<__nv_bfloat16, __nv_bfloat16, false, 8, true>(void const*)",
     "ada_rmsnorm"),
    ("void rowk::row_kernel<__nv_bfloat16, 1>(__nv_bfloat16 const*)", "row_quantize_int8"),
    ("void rowk::row_kernel<float, 3>(float const*)", "silu_mul_quantize"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", None),
])
def test_profile_names_the_wrapper_of_each_row_kernel_event(event, wrapper):
    assert profile_s2a.row_kernel_name(event) == wrapper


def test_bench_row_kernels_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        bench_row_kernels.main(["tag=x"])
    with pytest.raises(SystemExit, match="unknown option"):
        bench_row_kernels.main(["bogus=1"])


def test_split_edges_are_what_the_kernel_holds():
    """The constants the wrapper shapes launches by, and the register cap."""
    assert arn.CHUNK_COUNTS == (1, 2, 4, 8) and arn.MAX_CHUNKS == 8
    assert _split_edge(2) == 16384 and _split_edge(4) == 8192
    assert math.prod((arn.MAX_WARPS_PER_ROW, 32)) <= 1024  # one block a split row
