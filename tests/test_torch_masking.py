"""``audio/masking.py`` of the PyTorch package against the JAX package's,
function by function. The random masks get the JAX package's own draws (its
uniforms, its span lengths and starts), so every mask must be EQUAL; the
float schedules and the masked loss within 1e-6 (float32 on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.audio import masking as jm
from maxtext_indextts2_tpu_torch.audio import masking as tm

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["linear", "cosine", "arccos"])
@pytest.mark.parametrize("n", [1, 2, 5, 12])
def test_layer_schedules_equal(kind, n):
    got, want = tm.get_mask_layer_schedule(kind, n), jm.get_mask_layer_schedule(kind, n)
    assert len(got) == len(want) == n
    np.testing.assert_allclose(got, want, atol=1e-6)
    for i in range(n + 1):  # past the schedule too: the base probability
        assert abs(tm.get_layer_mask_prob(i, got, 0.25)
                   - jm.get_layer_mask_prob(i, want, 0.25)) <= 1e-6


def test_unknown_schedule_raises_in_both():
    with pytest.raises(ValueError, match="Unknown schedule"):
        tm.get_mask_layer_schedule("square", 4)
    with pytest.raises(ValueError, match="Unknown schedule"):
        jm.get_mask_layer_schedule("square", 4)


@pytest.mark.parametrize("prob", [0.0, 0.3, 0.75, 1.0])
def test_random_mask_from_the_jax_uniforms_is_equal(prob):
    key = jax.random.PRNGKey(3)
    want = np.asarray(jm.create_random_mask(key, (4, 37), prob))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (4, 37))))
    got = tm.create_random_mask((4, 37), prob, uniforms=u)
    np.testing.assert_array_equal(got.numpy(), want)
    # per-row probabilities broadcast as in the JAX package
    p = jnp.asarray([0.1, 0.5, 0.9, 0.0])[:, None]
    want = np.asarray(jm.create_random_mask(key, (4, 37), p))
    got = tm.create_random_mask((4, 37), torch.from_numpy(np.array(p)), uniforms=u)
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_mask_from_a_generator():
    g = torch.Generator().manual_seed(0)
    m = tm.create_random_mask((64, 64), 0.3, generator=g)
    assert m.dtype == torch.bool and abs(float(m.float().mean()) - 0.3) < 0.03
    with pytest.raises(ValueError, match="uniforms of shape"):
        tm.create_random_mask((2, 3), 0.5, uniforms=torch.zeros(3, 2))


@pytest.mark.parametrize("s", [1, 5, 16])
def test_causal_mask_equal(s):
    np.testing.assert_array_equal(tm.create_causal_mask(s).numpy(),
                                  np.asarray(jm.create_causal_mask(s)))


def test_padding_mask_equal():
    lengths = np.array([0, 3, 7, 9], np.int32)
    np.testing.assert_array_equal(
        tm.create_padding_mask(torch.from_numpy(lengths), 9).numpy(),
        np.asarray(jm.create_padding_mask(jnp.asarray(lengths), 9)))


def test_apply_mask_to_sequence_equal():
    rng = np.random.default_rng(0)
    seq = rng.integers(0, 100, (3, 11)).astype(np.int32)
    mask = rng.random((3, 11)) < 0.4
    got = tm.apply_mask_to_sequence(torch.from_numpy(seq), torch.from_numpy(mask), 1023)
    want = jm.apply_mask_to_sequence(jnp.asarray(seq), jnp.asarray(mask), 1023)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("masked_share", [0.0, 0.3, 1.0])
def test_masked_loss_equal(masked_share):
    rng = np.random.default_rng(1)
    logits = (3 * rng.normal(size=(2, 13, 32))).astype(np.float32)
    targets = rng.integers(0, 32, (2, 13)).astype(np.int32)
    mask = rng.random((2, 13)) < masked_share
    got = tm.compute_masked_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                                 torch.from_numpy(mask))
    want = jm.compute_masked_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask))
    assert abs(float(got) - float(want)) <= 1e-6 * max(1.0, abs(float(want)))


@pytest.mark.parametrize("shape,prob,lo,hi", [((3, 50), 0.3, 1, 10), ((2, 7), 0.9, 2, 4),
                                              ((4, 128), 0.15, 3, 12), ((1, 3), 0.5, 1, 1)])
def test_structured_mask_from_the_jax_draws_is_equal(shape, prob, lo, hi):
    key = jax.random.PRNGKey(11)
    want = np.asarray(jm.create_structured_mask(key, shape, prob, lo, hi))
    b, s = shape
    n = max(1, int(np.ceil(prob * s / max(lo, 1))))
    r_len, r_start = jax.random.split(key)
    lens = np.array(jax.random.randint(r_len, (b, n), lo, hi + 1))
    starts = np.array(jax.random.randint(r_start, (b, n), 0, max(s - lo, 1)))
    got = tm.create_structured_mask(shape, prob, lo, hi,
                                    spans=(torch.from_numpy(lens), torch.from_numpy(starts)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_structured_mask_from_a_generator_covers_about_its_share():
    g = torch.Generator().manual_seed(0)
    m = tm.create_structured_mask((64, 200), 0.3, 1, 10, generator=g)
    assert m.shape == (64, 200) and m.dtype == torch.bool
    assert 0.15 < float(m.float().mean()) < 0.35  # spans may overlap, as in the JAX package
    with pytest.raises(ValueError, match="spans must be"):
        tm.create_structured_mask((2, 10), 0.3, spans=(torch.ones(2, 1), torch.ones(2, 1)))
