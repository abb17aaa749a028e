"""The PyTorch package's vocabulary-fused cross-entropy against the JAX package's.

Each variant (``chunked_unembed_cross_entropy``, ``streaming_unembed_cross_
entropy``, ``chunked_unembed_cross_entropy_int8``) takes the same numpy
hidden states, unembedding kernel, targets and weights in both packages; the
loss, the total weight and the gradients with respect to y and the kernel
(through ``jax.grad`` of the JAX function, its custom VJP where it has one,
and autograd in the port) are compared. Shapes: 2 x 13 rows (not a multiple
of the chunk of 8), E = 32, V = 384 (three 128-wide tiles under
``max_tile=256``) or 320 (no 128-aligned divisor: one tile).

Tolerances. float32 operands and logits: the same arithmetic summed in
another order, 1e-5 relative on the loss, 1e-5 of the largest entry on each
gradient. bfloat16 operands (or bfloat16 logits): both sides round the
products' operands, the logits (``logits_dtype``), the gradient of the
logits and the results at the same points, so a gradient agrees to 2**-6 of
its largest entry (a few bfloat16 steps: sums in another order can flip a
rounding, and the chunked dW of a bfloat16 kernel is summed in bfloat16
chunk by chunk) and the loss to 1e-3: XLA's default
``xla_allow_excess_precision`` drops the bfloat16 rounding of the logits
inside the JAX scan (with ``--xla_allow_excess_precision=false`` the chunked
variant's loss and gradients equal the port's bitwise at bfloat16 logits),
which moves the loss by about 1e-4 relative here. int8: the quantized operands are
equal; the port sums the int8 products exactly in int32, XLA on the CPU in
float32 (equal below 2**24, as here), so the int8 variant is held as
tightly as its operand dtypes allow. Against the port's own materialised
``masked_cross_entropy`` over the same logits: float32 within 1e-5; the int8
variant within its quantization error (2e-2 relative on the loss and 8e-2
of the largest entry on a gradient; a per-row / per-column int8 code is good
to 1/254 of its row's or column's largest value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.ops import losses as jlosses
from maxtext_indextts2_tpu_torch.ops import losses as tlosses

torch.set_num_threads(1)

B, S, E, CHUNK = 2, 13, 32, 8
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _data(seed, vocab, y_dtype="float32", k_dtype="float32"):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(B, S, E)).astype(np.float32)
    kernel = (rng.normal(size=(E, vocab)) / np.sqrt(E)).astype(np.float32)
    targets = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    weights = (rng.random((B, S)) > 0.2).astype(np.float32)
    # both packages get the same (rounded) values in the working dtypes
    y = np.asarray(jnp.asarray(y).astype(JNP[y_dtype]).astype(jnp.float32))
    kernel = np.asarray(jnp.asarray(kernel).astype(JNP[k_dtype]).astype(jnp.float32))
    return y, kernel, targets, weights


def _jax(fn, y, kernel, targets, weights, y_dtype, k_dtype, **kw):
    def loss(yy, kk):
        return fn(yy, kk, jnp.asarray(targets), jnp.asarray(weights), **kw)[0]

    yj = jnp.asarray(y).astype(JNP[y_dtype])
    kj = jnp.asarray(kernel).astype(JNP[k_dtype])
    value, (gy, gk) = jax.value_and_grad(loss, argnums=(0, 1))(yj, kj)
    _, denom = fn(yj, kj, jnp.asarray(targets), jnp.asarray(weights), **kw)
    return (float(value), float(denom), np.asarray(gy.astype(jnp.float32)),
            np.asarray(gk.astype(jnp.float32)))


def _torch(fn, y, kernel, targets, weights, y_dtype, k_dtype, **kw):
    yt = torch.tensor(y).to(TORCH[y_dtype]).requires_grad_(True)
    kt = torch.tensor(kernel).to(TORCH[k_dtype]).requires_grad_(True)
    loss, denom = fn(yt, kt, torch.tensor(targets), torch.tensor(weights), **kw)
    loss.backward()
    loss = loss.detach()
    assert yt.grad.dtype == yt.dtype and kt.grad.dtype == kt.dtype
    return float(loss), float(denom), yt.grad.float().numpy(), kt.grad.float().numpy()


def _close(got, want, loss_rtol, grad_rel):
    assert got[1] == want[1], "total weights"
    np.testing.assert_allclose(got[0], want[0], rtol=loss_rtol, atol=0)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, atol=grad_rel * np.abs(w).max(), rtol=0)


def _tols(*dtypes):
    return (1e-5, 1e-5) if set(dtypes) <= {"float32", None} else (1e-3, 2.0 ** -6)


CHUNKED = [  # (y / kernel dtype, compute dtype, logits dtype, z_loss, soft cap, scale)
    ("float32", "float32", None, 0.0, 0.0, 1.0),
    ("float32", "float32", None, 1e-3, 1.5, 1.0 / np.sqrt(E)),
    ("bfloat16", "bfloat16", None, 1e-4, 0.0, 1.0 / np.sqrt(E)),
    ("bfloat16", "bfloat16", "bfloat16", 1e-4, 1.5, 1.0),
    ("float32", "bfloat16", "bfloat16", 1e-3, 0.0, 1.0),
]


@pytest.mark.parametrize("dtype,dt,ldt,z_loss,cap,scale", CHUNKED)
def test_chunked_matches_jax(dtype, dt, ldt, z_loss, cap, scale):
    y, kernel, targets, weights = _data(0, 384, dtype, dtype)
    kw = dict(z_loss=z_loss, chunk=CHUNK, soft_cap=cap, scale=scale)
    want = _jax(jlosses.chunked_unembed_cross_entropy, y, kernel, targets, weights, dtype,
                dtype, compute_dtype=JNP[dt], logits_dtype=ldt and JNP[ldt], **kw)
    got = _torch(tlosses.chunked_unembed_cross_entropy, y, kernel, targets, weights, dtype,
                 dtype, compute_dtype=TORCH[dt], logits_dtype=ldt, **kw)
    _close(got, want, *_tols(dtype, dt, ldt))


STREAMING = [  # (y / kernel dtype, compute dtype, vocab, z_loss, soft cap, scale)
    ("float32", "float32", 384, 0.0, 0.0, 1.0),
    ("float32", "float32", 320, 1e-3, 1.5, 1.0 / np.sqrt(E)),
    ("bfloat16", "bfloat16", 384, 1e-4, 1.5, 1.0 / np.sqrt(E)),
    ("float32", "bfloat16", 320, 1e-3, 0.0, 1.0),
]


@pytest.mark.parametrize("dtype,dt,vocab,z_loss,cap,scale", STREAMING)
def test_streaming_matches_jax(dtype, dt, vocab, z_loss, cap, scale):
    y, kernel, targets, weights = _data(1, vocab, dtype, dtype)
    kw = dict(z_loss=z_loss, max_tile=256, soft_cap=cap, scale=scale)
    want = _jax(jlosses.streaming_unembed_cross_entropy, y, kernel, targets, weights, dtype,
                dtype, compute_dtype=JNP[dt], **kw)
    got = _torch(tlosses.streaming_unembed_cross_entropy, y, kernel, targets, weights, dtype,
                 dtype, compute_dtype=TORCH[dt], **kw)
    _close(got, want, *_tols(dtype, dt))


def test_streaming_tiles_as_the_jax_package():
    for v, t in ((264192, 8192), (384, 256), (320, 256), (8704, 8192), (127, 64)):
        assert tlosses._pick_vocab_tile(v, t) == jlosses._pick_vocab_tile(v, t)


INT8 = [  # (y dtype, kernel dtype, logits dtype, z_loss, soft cap, scale)
    ("float32", "float32", "float32", 0.0, 0.0, 1.0),
    ("bfloat16", "bfloat16", "bfloat16", 1e-4, 0.0, 1.0 / np.sqrt(E)),
    ("float32", "bfloat16", "bfloat16", 1e-3, 1.5, 1.0),
]


@pytest.mark.parametrize("y_dtype,k_dtype,ldt,z_loss,cap,scale", INT8)
def test_int8_matches_jax_straight_through(y_dtype, k_dtype, ldt, z_loss, cap, scale):
    y, kernel, targets, weights = _data(2, 384, y_dtype, k_dtype)
    kw = dict(z_loss=z_loss, chunk=CHUNK, soft_cap=cap, scale=scale, logits_dtype=ldt)
    want = _jax(jlosses.chunked_unembed_cross_entropy_int8, y, kernel, targets, weights,
                y_dtype, k_dtype, **kw)
    got = _torch(tlosses.chunked_unembed_cross_entropy_int8, y, kernel, targets, weights,
                 y_dtype, k_dtype, **kw)
    # the kernel's gradient is a bfloat16 product whatever the dtypes
    _close(got, want, *_tols(y_dtype, k_dtype, ldt))
    if k_dtype == "float32":
        np.testing.assert_allclose(got[3], want[3], atol=2.0 ** -6 * np.abs(want[3]).max())


def test_int8_products_sum_exactly():
    """Sums past 2**24 (E = 3840 codes near 127): the int32 product is exact,
    and its bfloat16 rounding equals what JAX gives on the CPU."""
    rng = np.random.default_rng(3)
    a = rng.integers(100, 128, size=(40, 3840)).astype(np.int8)
    b = rng.integers(100, 128, size=(3840, 256)).astype(np.int8)
    exact = a.astype(np.int64) @ b.astype(np.int64)
    assert exact.max() > 2 ** 24
    got = tlosses._int8_mm(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), exact)
    want = jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b), (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.bfloat16)
    np.testing.assert_array_equal(got.to(torch.bfloat16).float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _materialised(y, kernel, targets, weights, z_loss, cap, scale):
    yt = torch.tensor(y, requires_grad=True)
    kt = torch.tensor(kernel, requires_grad=True)
    logits = (yt.reshape(-1, E) @ kt) * scale
    if cap > 0:
        logits = cap * torch.tanh(logits / cap)
    loss, denom = tlosses.masked_cross_entropy(logits, torch.tensor(targets).reshape(-1),
                                               torch.tensor(weights).reshape(-1), z_loss)
    loss.backward()
    return float(loss.detach()), float(denom), yt.grad.numpy(), kt.grad.numpy()


@pytest.mark.parametrize("variant", ["chunked", "streaming", "int8"])
@pytest.mark.parametrize("z_loss,cap,scale", [(0.0, 0.0, 1.0), (1e-3, 1.5, 1.0 / np.sqrt(E))])
def test_fused_variants_match_the_materialised_cross_entropy(variant, z_loss, cap, scale):
    y, kernel, targets, weights = _data(4, 384)
    want = _materialised(y, kernel, targets, weights, z_loss, cap, scale)
    kw = dict(z_loss=z_loss, soft_cap=cap, scale=scale)
    fn = {"chunked": lambda *a: tlosses.chunked_unembed_cross_entropy(*a, chunk=CHUNK, **kw),
          "streaming": lambda *a: tlosses.streaming_unembed_cross_entropy(*a, max_tile=256,
                                                                          **kw),
          "int8": lambda *a: tlosses.chunked_unembed_cross_entropy_int8(
              *a, chunk=CHUNK, logits_dtype="float32", **kw)}[variant]
    got = _torch(fn, y, kernel, targets, weights, "float32", "float32")
    _close(got, want, *((2e-2, 8e-2) if variant == "int8" else (1e-5, 1e-5)))


def test_fused_variants_never_hold_all_logits():
    """Besides kernel-shaped [E, V] tensors (the kernel's copies, codes and
    gradient), the largest tensor any variant makes holds one chunk's or one
    tile's logits, never the [B*S, V] ones (every op's outputs, forward and
    backward, seen by a dispatch mode)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    vocab = 2048

    class Largest(TorchDispatchMode):
        biggest = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and sorted(t.shape) != sorted((E, vocab)):
                    Largest.biggest = max(Largest.biggest, t.numel())
            return out

    y, kernel, targets, weights = _data(5, vocab)
    for fn, most in ((lambda *a: tlosses.chunked_unembed_cross_entropy(*a, chunk=CHUNK),
                      CHUNK * vocab),
                     (lambda *a: tlosses.streaming_unembed_cross_entropy(*a, max_tile=256),
                      max(B * S, E) * 256),
                     (lambda *a: tlosses.chunked_unembed_cross_entropy_int8(*a, chunk=CHUNK),
                      CHUNK * vocab)):
        Largest.biggest = 0
        with Largest():
            _torch(fn, y, kernel, targets, weights, "float32", "float32")
        assert Largest.biggest <= most < B * S * vocab, Largest.biggest
