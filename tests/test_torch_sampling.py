"""Token sampling of the PyTorch package against the JAX package's.

Greedy is exact. A categorical draw is ``argmax(logits + Gumbel noise)`` on
both sides (``jax.random.categorical`` is defined so), therefore the tests
draw the Gumbel noise once with JAX's key and feed the same noise to the
PyTorch function: the sampled ids are then equal, not merely alike. The
generator-driven path is held to the distribution instead: over 4000 draws
the empirical frequencies are within 0.03 of the softmax probabilities
(four standard deviations of a frequency at p = 0.5 are 0.032).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.infer import sampling as jax_sampling
from maxtext_indextts2_tpu_torch.infer import sampling

# tiny shapes: one thread is enough, and the cores stay free for the other test workers
torch.set_num_threads(1)


def _logits(seed, b=6, v=50):
    return (np.random.default_rng(seed).normal(size=(b, v)) * 2.0).astype(np.float32)


def test_greedy_is_exact():
    logits = _logits(0)
    want = jax_sampling.sample_tokens(jnp.asarray(logits), jax.random.PRNGKey(0), "greedy")
    got = sampling.sample_tokens(torch.from_numpy(logits), None, "greedy")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("strategy,noise_width", [("weighted", 50), ("topk", 5), ("nucleus", 50)])
@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_random_strategies_with_jax_noise(strategy, noise_width, temperature):
    logits = _logits(1)
    key = jax.random.PRNGKey(7)
    want = jax_sampling.sample_tokens(jnp.asarray(logits), key, strategy, temperature, 5, 0.8)
    noise = np.array(jax.random.gumbel(key, (logits.shape[0], noise_width), jnp.float32))
    got = sampling.sample_tokens(torch.from_numpy(logits), None, strategy, temperature, 5, 0.8,
                                 noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generator_draws_follow_the_distribution_and_the_seed():
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0]]).repeat(4000, 1)
    gen = torch.Generator().manual_seed(3)
    draws = sampling.sample_tokens(logits, gen, "weighted", 1.0)
    freq = np.bincount(draws.numpy(), minlength=4) / 4000
    np.testing.assert_allclose(freq, torch.softmax(logits[0], -1).numpy(), atol=0.03)
    again = sampling.sample_tokens(logits, torch.Generator().manual_seed(3), "weighted", 1.0)
    np.testing.assert_array_equal(draws.numpy(), again.numpy())
    top2 = sampling.sample_tokens(logits, gen, "topk", 1.0, top_k=2)
    assert set(np.unique(top2.numpy())) == {1, 2}
    nucleus = sampling.sample_tokens(logits, gen, "nucleus", 1.0, nucleus_p=0.5)
    assert set(np.unique(nucleus.numpy())) == {2}  # the top token alone holds 0.64
    with pytest.raises(ValueError):
        sampling.sample_tokens(logits, gen, "beam")


def test_log_probs_from_logits():
    logits = _logits(2, 3, 20).reshape(3, 1, 20)
    tokens = np.array([[4], [0], [19]], np.int32)
    want = jax_sampling.log_probs_from_logits(jnp.asarray(logits), jnp.asarray(tokens))
    got = sampling.log_probs_from_logits(torch.from_numpy(logits), torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
