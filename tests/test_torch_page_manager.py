"""The PyTorch package's page manager against the JAX package's, exactly.

Every function of ``infer/page_manager.py`` runs in both packages on the same
state, over seeded sequences of operations (prefills, decode steps across page
boundaries, releases, slot reuse, an exhausted pool); ``page_status``,
``page_map`` and ``seq_lens`` must be EQUAL after each one. The one
difference on purpose is the saturation at ``max_pages * tokens_per_page``
tokens, held here on its own: up to the cap both agree, past it the JAX
function leaves the map and the port stays put.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.infer import page_manager as jpm
from maxtext_indextts2_tpu_torch.infer import page_manager as pm

torch.set_num_threads(1)


def _np(state):
    return tuple(np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
                 for x in (state.page_status, state.page_map, state.seq_lens))


def _assert_same(state, jstate, what=""):
    for name, a, b in zip(("page_status", "page_map", "seq_lens"), _np(state), _np(jstate)):
        np.testing.assert_array_equal(a, b, err_msg=f"{name} {what}")


def _both(num_pages, slots, max_pages):
    return pm.init_page_state(num_pages, slots, max_pages), \
        jpm.init_page_state(num_pages, slots, max_pages)


def test_init_page_state_matches_jax():
    state, jstate = _both(12, 3, 5)
    _assert_same(state, jstate)
    assert state.num_pages == 12 and state.page_status.dtype == torch.int32
    assert int(pm.num_free_pages(state)) == int(jpm.num_free_pages(jstate)) == 11


@pytest.mark.parametrize("seed", range(4))
def test_take_free_pages_matches_jax(seed):
    rng = np.random.default_rng(seed)
    status = (rng.random(20) < 0.5).astype(np.int32)
    status[0] = 1
    for k_max, need in ((6, 0), (6, 3), (6, 6), (12, 12)):  # 12 > the free pages: null beyond
        s, ids = pm._take_free_pages(torch.as_tensor(status), k_max, need)
        js, jids = jpm._take_free_pages(jnp.asarray(status), k_max, jnp.asarray(need))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


def test_prefill_release_and_reuse_match_jax():
    tpp, max_pages = 4, 6
    state, jstate = _both(16, 3, max_pages)
    for slot, n in ((0, 9), (2, 1), (1, 4), (0, 13), (2, 24)):  # slot 0 and 2 re-filled
        state, ids = pm.allocate_prefill(state, slot, n, tpp, max_pages)
        jstate, jids = jpm.allocate_prefill(jstate, slot, jnp.asarray(n, jnp.int32), tpp,
                                            max_pages)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        _assert_same(state, jstate, f"after prefill of {n} into slot {slot}")
    for slot in (1, 0, 1):  # releasing an empty slot changes nothing
        state = pm.release_slot(state, slot)
        jstate = jpm.release_slot(jstate, slot)
        _assert_same(state, jstate, f"after release of slot {slot}")
    assert int(pm.num_free_pages(state)) == int(jpm.num_free_pages(jstate))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("tpp", [1, 4, 16])
def test_seeded_operation_sequences_match_jax(seed, tpp):
    """Prefills, decode steps (with and without ``active``), releases and
    reuse, in a seeded order, through a pool small enough to run dry."""
    rng = np.random.default_rng(seed)
    slots, max_pages = 5, max(2, 48 // tpp)
    num_pages = 2 + int(rng.integers(slots, 3 * slots))
    state, jstate = _both(num_pages, slots, max_pages)
    cap = tpp * max_pages
    for step in range(40):
        op = rng.choice(["prefill", "decode", "decode_active", "release"], p=[.2, .4, .25, .15])
        if op == "prefill":
            slot, n = int(rng.integers(slots)), int(rng.integers(1, cap // 2 + 1))
            state, _ = pm.allocate_prefill(state, slot, n, tpp, max_pages)
            jstate, _ = jpm.allocate_prefill(jstate, slot, jnp.asarray(n, jnp.int32), tpp,
                                             max_pages)
        elif op == "release":
            slot = int(rng.integers(slots))
            state, jstate = pm.release_slot(state, slot), jpm.release_slot(jstate, slot)
        else:
            if int(state.seq_lens.max()) >= cap:  # past the cap the two differ on purpose
                continue
            active = None
            if op == "decode_active":
                active = rng.random(slots) < 0.6
            state = pm.allocate_decode_step(
                state, tpp, None if active is None else torch.as_tensor(active))
            jstate = jpm.allocate_decode_step(
                jstate, tpp, None if active is None else jnp.asarray(active))
        _assert_same(state, jstate, f"step {step} ({op})")
        assert int(pm.num_free_pages(state)) == int(jpm.num_free_pages(jstate))


def test_growth_across_several_boundaries_matches_jax():
    """tpp=4: three slots grow page by page together (the j-th slot that needs
    a page takes the j-th free page), one of them inactive for a while."""
    tpp, max_pages = 4, 8
    state, jstate = _both(30, 3, max_pages)
    for slot, n in ((0, 3), (1, 4), (2, 5)):
        state, _ = pm.allocate_prefill(state, slot, n, tpp, max_pages)
        jstate, _ = jpm.allocate_prefill(jstate, slot, jnp.asarray(n, jnp.int32), tpp, max_pages)
    for step in range(20):
        active = np.array([True, step % 3 != 0, True])
        state = pm.allocate_decode_step(state, tpp, torch.as_tensor(active))
        jstate = jpm.allocate_decode_step(jstate, tpp, jnp.asarray(active))
        _assert_same(state, jstate, f"step {step}")
    assert int(state.seq_lens[0]) == 23 and (state.page_map[0, :6] > 0).all()


def test_exhausted_pool_hands_out_the_null_page_as_jax_does():
    tpp, max_pages = 2, 10
    state, jstate = _both(6, 4, max_pages)  # 5 usable pages
    for slot in range(4):
        state, _ = pm.allocate_prefill(state, slot, 2, tpp, max_pages)
        jstate, _ = jpm.allocate_prefill(jstate, slot, jnp.asarray(2, jnp.int32), tpp, max_pages)
    state = pm.allocate_decode_step(state, tpp)  # four slots need a page, one is free
    jstate = jpm.allocate_decode_step(jstate, tpp)
    _assert_same(state, jstate)
    assert state.page_map[:, 1].tolist() == [5, 0, 0, 0]


def test_a_slot_saturates_at_the_end_of_its_page_map():
    """Up to ``max_pages * tpp`` tokens the port equals JAX; there it stays:
    no page taken, no column past the map, the length held."""
    tpp, max_pages = 4, 3
    state, jstate = _both(10, 2, max_pages)
    state, _ = pm.allocate_prefill(state, 0, 5, tpp, max_pages)
    jstate, _ = jpm.allocate_prefill(jstate, 0, jnp.asarray(5, jnp.int32), tpp, max_pages)
    for _ in range(tpp * max_pages - 5):  # to the cap
        state = pm.allocate_decode_step(state, tpp)
        jstate = jpm.allocate_decode_step(jstate, tpp)
    _assert_same(state, jstate)
    assert int(state.seq_lens[0]) == tpp * max_pages
    before = _np(state)
    for _ in range(2 * tpp + 1):  # past it
        state = pm.allocate_decode_step(state, tpp)
    after = _np(state)
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)
    # the JAX function takes a page it cannot map and counts on
    jstate = jpm.allocate_decode_step(jstate, tpp)
    assert int(jstate.seq_lens[0]) == tpp * max_pages + 1
    assert int(jpm.num_free_pages(jstate)) == int(pm.num_free_pages(state)) - 1
