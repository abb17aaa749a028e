"""The PyTorch package's cross-entropy with z-loss against the JAX package's.

Same numpy logits and targets on both sides; values and gradients (through
the custom VJP on the JAX side, the ``autograd.Function`` on the PyTorch
side) with random cotangents for both outputs. float32 throughout: 1e-5 on
values of a few units (summation order only), 1e-6 on gradients (softmax
entries below 1). bfloat16 logits: the forward casts to float32 on both
sides (equal values); the gradient is handed back in bfloat16 by PyTorch,
so it is compared after rounding the JAX gradient to bfloat16, within one
bfloat16 step of the largest entry (2**-8 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.ops import losses as jlosses
from maxtext_indextts2_tpu_torch.ops import losses as tlosses

torch.set_num_threads(1)

TOL_VALUE, TOL_GRAD = 1e-5, 1e-6


def _data(seed=0, shape=(2, 8), vocab=64, scale=3.0):
    rng = np.random.default_rng(seed)
    logits = (scale * rng.normal(size=shape + (vocab,))).astype(np.float32)
    targets = rng.integers(0, vocab, size=shape).astype(np.int32)
    g_total = rng.normal(size=shape).astype(np.float32)
    g_ce = rng.normal(size=shape).astype(np.float32)
    weights = (rng.random(shape) > 0.25).astype(np.float32)
    return logits, targets, g_total, g_ce, weights


@pytest.mark.parametrize("z_loss", [0.0, 1e-4, 0.1])
def test_cross_entropy_values_and_grads_match_jax(z_loss):
    logits, targets, g_total, g_ce, _ = _data()
    (jt, jce), vjp = jax.vjp(lambda x: jlosses.cross_entropy_with_logits(
        x, jnp.asarray(targets), z_loss), jnp.asarray(logits))
    (jgrad,) = vjp((jnp.asarray(g_total), jnp.asarray(g_ce)))

    x = torch.tensor(logits, requires_grad=True)
    total, ce = tlosses.cross_entropy_with_logits(x, torch.tensor(targets), z_loss)
    torch.autograd.backward((total, ce), (torch.tensor(g_total), torch.tensor(g_ce)))
    assert total.dtype == ce.dtype == torch.float32
    np.testing.assert_allclose(total.detach().numpy(), np.asarray(jt), atol=TOL_VALUE, rtol=0)
    np.testing.assert_allclose(ce.detach().numpy(), np.asarray(jce), atol=TOL_VALUE, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), atol=TOL_GRAD, rtol=0)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_masked_cross_entropy_matches_jax(z_loss):
    logits, targets, _, _, weights = _data(seed=1, shape=(3, 16), vocab=128)

    def jloss(x):
        return jlosses.masked_cross_entropy(x, jnp.asarray(targets), jnp.asarray(weights),
                                            z_loss)

    (jl, jw), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    loss, w = tlosses.masked_cross_entropy(x, torch.tensor(targets), torch.tensor(weights),
                                           z_loss)
    loss.backward()
    assert float(w) == float(jw) == weights.sum()
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=TOL_VALUE, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), atol=TOL_GRAD, rtol=0)
    # padding tokens get no gradient at all
    assert (x.grad.numpy()[weights == 0] == 0).all()


def test_bfloat16_logits_give_a_bfloat16_gradient():
    logits, targets, _, _, weights = _data(seed=2, shape=(2, 12), vocab=96)
    lb = jnp.asarray(logits).astype(jnp.bfloat16)

    def jloss(x):
        return jlosses.masked_cross_entropy(x, jnp.asarray(targets), jnp.asarray(weights),
                                            1e-4)[0]

    jl, jgrad = jax.value_and_grad(jloss)(lb)
    x = torch.tensor(np.asarray(lb.astype(jnp.float32))).to(torch.bfloat16).requires_grad_(True)
    loss, _ = tlosses.masked_cross_entropy(x, torch.tensor(targets), torch.tensor(weights), 1e-4)
    loss.backward()
    assert x.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=TOL_VALUE, rtol=0)
    want = np.asarray(jgrad.astype(jnp.bfloat16).astype(jnp.float32))
    step = 2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(x.grad.float().numpy(), want, atol=step, rtol=0)


@pytest.mark.parametrize("name", ["chunked_unembed_cross_entropy",
                                  "chunked_unembed_cross_entropy_int8",
                                  "streaming_unembed_cross_entropy"])
def test_fused_vocab_variants_name_their_queue_item(name):
    with pytest.raises(NotImplementedError, match="port queue: 4b"):
        getattr(tlosses, name)()
