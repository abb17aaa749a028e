"""The plain versions of the S2A row kernels (what the wrappers run on the
CPU) against the JAX package's Pallas kernels in interpret mode and against
its unfused jnp forms. Inputs come from a numpy seed and go to both sides.

Tolerances, and why:

* ``row_quantize_int8``: exactly equal to the rule written out in numpy
  (abs-max, two IEEE divisions and a half-to-even rounding; nothing depends
  on summation order). Against the JAX package as XLA compiles it for the
  CPU: XLA rewrites the division by the constant 127 into a multiplication by
  its rounded reciprocal, which moves a scale by at most one float32 step
  (rtol 2.4e-7) and with it a counted handful of codes (under 1e-3) by one step.
* bfloat16 in general: by default XLA on the CPU keeps float32 precision
  between fused bfloat16 operations (``xla_allow_excess_precision``), where
  the contract, the TPU kernels' text and PyTorch round after every
  operation. The JAX side is therefore compiled with that option off
  (:func:`strict`); nothing in the JAX package changes.
* ``ada_rmsnorm`` float32: the sum of squares is taken in another order, so
  the variance can differ in its last bit: rtol 2e-6. bfloat16: the float32
  rsqrt factor is rounded to bfloat16 before it multiplies, so a last-bit
  difference can move a whole row by one bfloat16 step: rtol 2**-7, and at
  most 1 element in 100 differs at all.
* ``ada_rmsnorm_quantize`` / ``silu_mul_quantize``: int8 codes equal except a
  counted share (under 1e-3) that differ by exactly one step; scales rtol 1e-6
  (float32) or one bfloat16 step (bfloat16).
* K5's backward against ``jax.grad``: atol 2e-5, as the JAX package's own test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.ops import ada_rmsnorm as jax_arn
from maxtext_indextts2_tpu.ops import quant_kernels as jax_qk
from maxtext_indextts2_tpu_torch.ops import ada_rmsnorm as arn
from maxtext_indextts2_tpu_torch.ops import quant_kernels as qk

# tiny shapes: one thread is enough, and the cores stay free for the other test workers
torch.set_num_threads(1)

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}
BF16_STEP = 2.0 ** -7
MAX_CODE_MISMATCH = {"f32": 1e-3, "bf16": 1e-3}


def strict(fn, *args):
    """``fn(*args)`` compiled without XLA's excess precision: every bfloat16
    operation rounds to bfloat16, as written."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _inputs(seed, b, s, d, dtype):
    rng = np.random.default_rng(seed)
    _, jdt, tdt = DTYPES[dtype]
    x = (rng.normal(size=(b, s, d)) * 1.5).astype(np.float32)
    w = (1.0 + 0.3 * rng.normal(size=(b, d))).astype(np.float32)
    u = rng.normal(size=(b, s, d)).astype(np.float32)
    x[0, 1] = 0.0  # an all-zero row: scale 0, codes 0, no NaN
    jx, ju = jnp.asarray(x).astype(jdt), jnp.asarray(u).astype(jdt)
    tx, tu = torch.from_numpy(x).to(tdt), torch.from_numpy(u).to(tdt)
    return (jx, jnp.asarray(w), ju), (tx, torch.from_numpy(w), tu)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


def _jnp_unfused_norm(x, w):
    var = jnp.mean(jnp.square(x.astype(jnp.float32)), axis=-1, keepdims=True)
    return x * jax.lax.rsqrt(var + 1e-6).astype(x.dtype) * w[:, None, :].astype(x.dtype)


def _jnp_quant(y):
    yf = y.astype(jnp.float32)
    xs = jnp.max(jnp.abs(yf), axis=-1) / 127.0
    return jnp.round(yf / jnp.maximum(xs[..., None], 1e-9)).astype(jnp.int8), xs


def _numpy_quant(x):
    """The rule, division by division, in numpy float32."""
    xf = x.astype(np.float32)
    xs = (np.abs(xf).max(-1) / np.float32(127.0)).astype(np.float32)
    q = np.rint(xf / np.maximum(xs, np.float32(1e-9))[..., None])
    return q.astype(np.int8), xs


def _check_codes(got, want, dtype, exact=False, max_mismatch=None, scale_rtol=None,
                 max_steps=1):
    (q, s), (qr, sr) = got, want
    q, qr = q.numpy().astype(np.int32), np.asarray(qr).astype(np.int32)
    assert q.shape == qr.shape and tuple(s.shape) == tuple(sr.shape)
    assert s.dtype == torch.float32 and got[0].dtype == torch.int8
    if exact:
        np.testing.assert_array_equal(q, qr)
        np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
        return
    diff = np.abs(q - qr)
    assert diff.max() <= max_steps, "codes differ by more steps than allowed"
    assert (diff > 0).mean() <= (max_mismatch or MAX_CODE_MISMATCH[dtype]), (diff > 0).mean()
    rtol = scale_rtol or (1e-6 if dtype == "f32" else BF16_STEP)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=rtol, atol=1e-30)
    assert np.isfinite(s.numpy()).all()


WIDTHS = [pytest.param(128, True, id="d128"), pytest.param(200, False, id="d200_not_128")]


@pytest.mark.parametrize("d,pallas", WIDTHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ada_rmsnorm_plain_matches_pallas_and_jnp(dtype, d, pallas):
    (jx, jw, _), (tx, tw, _) = _inputs(1, 2, 37, d, dtype)
    got = arn.ada_rmsnorm(tx, tw)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    rtol = 2e-6 if dtype == "f32" else BF16_STEP
    wants = [strict(_jnp_unfused_norm, jx, jw)]
    if pallas:  # the TPU kernel wants D % 128 == 0; the port takes any D
        wants.append(strict(lambda x, w: jax_arn.ada_rmsnorm(x, w, True), jx, jw))
    for want in wants:
        np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=1e-30)
        if dtype == "bf16":
            assert (_np(got) != _np(want)).mean() <= 0.01
    assert (got[0, 1] == 0).all()


@pytest.mark.parametrize("d,pallas", WIDTHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_row_quantize_plain_matches_pallas_and_jnp(dtype, d, pallas):
    (jx, _, _), (tx, _, _) = _inputs(2, 2, 37, d, dtype)
    got = qk.row_quantize_int8(tx)
    _check_codes(got, _numpy_quant(tx.float().numpy()), dtype, exact=True)
    near = dict(max_mismatch=1e-3, scale_rtol=2.4e-7)
    _check_codes(got, strict(_jnp_quant, jx), dtype, **near)
    if pallas:
        _check_codes(got, strict(lambda x: jax_qk.row_quantize_int8(x, interpret=True), jx),
                     dtype, **near)
    assert (got[0][0, 1] == 0).all() and got[1][0, 1] == 0


def test_row_quantize_rounds_half_to_even():
    # abs-max 127 gives scale 1.0 exactly, so k + 0.5 quotients are exact ties
    x = torch.tensor([[[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]]])
    q, s = qk.row_quantize_int8(x)
    assert q[0, 0].tolist() == [127, 0, 2, 2, 0, -2, -2, 126] and s.item() == 1.0
    jq, _ = jax_qk.row_quantize_int8(jnp.tile(jnp.asarray(x.numpy()), (1, 8, 16)), interpret=True)
    assert np.asarray(jq)[0, 0, :8].tolist() == q[0, 0].tolist()


@pytest.mark.parametrize("d,pallas", WIDTHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ada_rmsnorm_quantize_plain_matches_pallas_and_jnp(dtype, d, pallas):
    (jx, jw, _), (tx, tw, _) = _inputs(3, 2, 37, d, dtype)
    got = qk.ada_rmsnorm_quantize(tx, tw)
    _check_codes(got, strict(lambda x, w: _jnp_quant(_jnp_unfused_norm(x, w)), jx, jw), dtype)
    if pallas:
        _check_codes(got, strict(
            lambda x, w: jax_qk.ada_rmsnorm_quantize(x, w, interpret=True), jx, jw), dtype)
    # fused == two-step, exactly, as the JAX package demands of its kernels
    two = qk.row_quantize_int8(arn.ada_rmsnorm(tx, tw))
    assert torch.equal(got[0], two[0]) and torch.equal(got[1], two[1])


@pytest.mark.parametrize("d,pallas", WIDTHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_silu_mul_quantize_plain_matches_pallas_and_jnp(dtype, d, pallas):
    (jg, _, ju), (tg, _, tu) = _inputs(4, 2, 37, d, dtype)
    got = qk.silu_mul_quantize(tg, tu)
    # the unfused jnp form leaves the sigmoid's precision to XLA (the kernel
    # fixes it: float32, rounded once), so in bfloat16 it is only near: a few
    # codes in 100 one or two steps apart
    loose = dict(max_mismatch=5e-2, max_steps=2, scale_rtol=2.0 ** -6) if dtype == "bf16" else {}
    _check_codes(got, _jnp_quant(jax.nn.silu(jg) * ju), dtype, **loose)
    if pallas:
        _check_codes(got, strict(
            lambda g, u: jax_qk.silu_mul_quantize(g, u, interpret=True), jg, ju), dtype)


def test_ada_rmsnorm_backward_matches_jax_grad():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, 128)).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=(2, 128))).astype(np.float32)
    gx, gw = jax.grad(lambda x, w: jnp.sum(jnp.sin(jax_arn.ada_rmsnorm(x, w, True))),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    torch.sum(torch.sin(arn.ada_rmsnorm(tx, tw))).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=2e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), atol=2e-5)
    # the hand-written backward, not autograd through the plain forward
    assert type(arn.ada_rmsnorm(tx, tw).grad_fn).__name__.startswith("_AdaRMSNorm")


def test_wrappers_reject_what_no_kernel_takes():
    x = torch.zeros((2, 4, 16))
    w = torch.ones((2, 16))
    with pytest.raises(ValueError):
        arn.ada_rmsnorm(x, torch.ones((3, 16)))
    with pytest.raises(ValueError):
        arn.ada_rmsnorm(x[0], w)
    with pytest.raises(TypeError):
        arn.ada_rmsnorm(x.half(), w)
    with pytest.raises(TypeError):
        arn.ada_rmsnorm(x, w.to(torch.bfloat16))  # w: float32 or x's dtype
    with pytest.raises(TypeError):
        qk.row_quantize_int8(x.to(torch.int32))
    with pytest.raises(ValueError):
        qk.silu_mul_quantize(x, x[:, :2])
    with pytest.raises(ValueError):
        qk.silu_mul_quantize(x, x.to(torch.bfloat16))
    for call in (lambda i: arn.ada_rmsnorm(x, w, impl=i),
                 lambda i: qk.row_quantize_int8(x, impl=i),
                 lambda i: qk.ada_rmsnorm_quantize(x, w, impl=i),
                 lambda i: qk.silu_mul_quantize(x, x, impl=i)):
        with pytest.raises(ValueError):  # a CPU tensor cannot go to the CUDA kernel
            call("cuda")
        with pytest.raises(ValueError):
            call("triton")


def test_cpu_calls_launch_no_kernel():
    before = (arn.launch_count, dict(qk.launch_counts))
    x = torch.ones((1, 3, 8))
    arn.ada_rmsnorm(x, torch.ones((1, 8)))
    qk.row_quantize_int8(x)
    qk.ada_rmsnorm_quantize(x, torch.ones((1, 8)))
    qk.silu_mul_quantize(x, x)
    assert (arn.launch_count, qk.launch_counts) == before
