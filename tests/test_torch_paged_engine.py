"""The paged serving engine (``paged_attention=true``) of the PyTorch package
against the JAX package's paged engine and against the port's own dense
engine, on the CPU, from one set of numpy weights (float32, greedy).

On the CPU both paged engines take the gather route of
``infer/paged_attention.py``; the dense engine takes K1's plain version.
Token streams are compared exactly, and the page state (``page_status``,
``page_map``, ``seq_lens``) must equal the JAX engine's after every run.
Slots that hold no request are left out of the token comparisons.
"""

import dataclasses

import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.infer.engine import Engine as JaxEngine
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.utils.param_bridge import paged_decode_state_from_jax
from torch_port_helpers import TINY_TTS, configs, jax_tree, numpy_weights, prompt

TPP = 4
PAGED = ["paged_attention=true", f"pagedattn_tokens_per_page={TPP}", "pagedattn_num_pages=40"]


def _engines(slots=4, extra=PAGED, seed=0):
    """(port paged engine, JAX paged engine, port dense K1 engine): same weights."""
    cfg, jcfg = configs(extra, slots)
    weights = numpy_weights(cfg, seed)
    tensors = {k: torch.from_numpy(v) for k, v in weights.items()}
    eng = Engine(cfg, device="cpu")
    eng.set_params(tensors)
    jeng = JaxEngine(dataclasses.replace(jcfg, scan_layers=False), params=jax_tree(weights))
    dense = Engine(load_config(TINY_TTS + ["decode_attention=ragged",
                                           f"per_device_batch_size={slots}"]), device="cpu")
    dense.set_params(tensors)
    return eng, jeng, dense


@pytest.fixture(scope="module")
def engines():
    return _engines()


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _assert_page_state_equal(state, jstate):
    ps, jps = state["page_state"], jstate["page_state"]
    for name in ("page_status", "page_map", "seq_lens"):
        np.testing.assert_array_equal(_np(getattr(ps, name)), _np(getattr(jps, name)),
                                      err_msg=name)


def test_decode_state_holds_page_pools(engines):
    eng, _, _ = engines
    state = eng.init_decode_state()
    pools = [c for unit in state["cache"] for c in unit]
    assert len(pools) == eng.cfg.num_decoder_layers
    assert all(tuple(p.key_pages.shape) == (40, TPP, 2, 32) for p in pools)
    assert tuple(state["page_state"].page_map.shape) == (4, 64 // TPP)
    assert int(state["page_state"].page_status.sum()) == 1  # only the null page


def test_two_slots_decoding_together_match_jax_and_dense(engines):
    """The counterpart of the JAX package's paged-vs-dense engine test: two
    prompts inserted into slots 0 and 1, ten tokens each."""
    eng, jeng, dense = engines
    a, b = prompt(1, 5), prompt(2, 3)
    want = [dense.generate_stream(a, 10), dense.generate_stream(b, 10)]
    state, jstate = eng.init_decode_state(), jeng.init_decode_state()
    got, jgot = [[], []], [[], []]
    for slot, p in ((0, a), (1, b)):
        prefix, first = eng.prefill(p, len(p))
        jprefix, jfirst = jeng.prefill(p, len(p))
        state = eng.insert(prefix, state, slot)
        jstate = jeng.insert(jprefix, jstate, slot)
        got[slot].append(int(first[0]))
        jgot[slot].append(int(_np(jfirst)[0]))
    for _ in range(9):
        state, toks = eng.generate(state)
        jstate, jtoks = jeng.generate(jstate)
        for slot in (0, 1):
            got[slot].append(int(toks[slot]))
            jgot[slot].append(int(_np(jtoks)[slot]))
    assert got == jgot == want
    assert len(set(got[0])) > 2, "a degenerate stream would prove little"
    _assert_page_state_equal(state, jstate)


def test_growth_across_page_boundaries_matches_jax_and_dense(engines):
    eng, jeng, dense = engines
    p = prompt(3, 5)  # 2 pages; 12 more tokens cross three boundaries
    want = dense.generate_stream(p, 13)
    assert eng.generate_stream(p, 13) == jeng.generate_stream(p, 13) == want


def test_fused_admission_release_and_reuse_match_jax_and_dense(engines):
    eng, jeng, dense = engines
    state, jstate, dstate = eng.init_decode_state(), jeng.init_decode_state(), \
        dense.init_decode_state()
    long_a, short_b = prompt(4, 9), prompt(5, 4)
    outs = []
    for e, s in ((eng, state), (jeng, jstate), (dense, dstate)):
        s, first = e.prefill_insert_many(s, [long_a, short_b], [0, 2])
        s, toks = e.generate_n(s, 6)
        outs.append((s, _np(first), _np(toks)))
    (state, f, t), (jstate, jf, jt), (dstate, df, dt) = outs
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(f, df)
    np.testing.assert_array_equal(t[:, [0, 2]], jt[:, [0, 2]])
    np.testing.assert_array_equal(t[:, [0, 2]], dt[:, [0, 2]])
    _assert_page_state_equal(state, jstate)

    # release slot 0: its pages go back; slot 2 decodes on
    state = eng.release_slots(state, [0])
    jstate = jeng.release_slots(jstate, [0])
    dstate = dense.release_slots(dstate, [0])
    _assert_page_state_equal(state, jstate)
    assert int(state["page_state"].seq_lens[0]) == 0 and not bool(state["active"][0])
    state, t = eng.generate_n(state, 5)
    jstate, jt = jeng.generate_n(jstate, 5)
    dstate, dt = dense.generate_n(dstate, 5)
    np.testing.assert_array_equal(_np(t)[:, 2], _np(jt)[:, 2])
    np.testing.assert_array_equal(_np(t)[:, 2], _np(dt)[:, 2])
    _assert_page_state_equal(state, jstate)

    # reuse: a shorter prompt into slot 0 takes the freed pages first
    short_c, mid_d = prompt(6, 3), prompt(7, 6)
    outs = []
    for e, s in ((eng, state), (jeng, jstate), (dense, dstate)):
        s, first = e.prefill_insert_many(s, [short_c, mid_d], [0, 1])
        s, toks = e.generate_n(s, 7)
        outs.append((s, _np(first), _np(toks)))
    (state, f, t), (jstate, jf, jt), (dstate, df, dt) = outs
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(t[:, :3], jt[:, :3])
    np.testing.assert_array_equal(t[:, :3], dt[:, :3])
    _assert_page_state_equal(state, jstate)
    stream_c = [int(f[0])] + t[:, 0].tolist()
    assert stream_c == dense.generate_stream(short_c, 8)


def test_a_slot_driven_past_max_target_length_raises_no_index_error(engines):
    """Nobody releases slot 0: 70 steps past a prompt of 5 take it beyond the
    64-row context. Its length saturates at the page map's end (16 pages of
    4), its position at the last row; no index leaves the map or the pool."""
    eng, jeng, _ = engines
    p = prompt(8, 5)
    state, _ = eng.prefill_insert_many(eng.init_decode_state(), [p], [0])
    jstate, _ = jeng.prefill_insert_many(jeng.init_decode_state(), [p], [0])
    in_range = eng.cfg.max_target_length - len(p) - 1
    got, want = [], []
    for _ in range(14):  # 70 steps
        state, toks = eng.generate_n(state, 5)
        got.append(_np(toks)[:, 0])
        if sum(len(g) for g in want) < in_range:
            jstate, jtoks = jeng.generate_n(jstate, 5)
            want.append(_np(jtoks)[:, 0])
    got, want = np.concatenate(got), np.concatenate(want)
    np.testing.assert_array_equal(got[:in_range], want[:in_range])
    ps = state["page_state"]
    assert int(ps.seq_lens[0]) == eng.cfg.max_target_length == 16 * TPP
    assert int(state["pos"][0]) == eng.cfg.max_target_length - 1
    assert int(ps.page_status.sum()) == 1 + 16, "the slot holds its 16 pages and no more"
    assert ((got >= 0) & (got < eng.cfg.vocab_size)).all()
    for pool in (c for unit in state["cache"] for c in unit):
        assert torch.isfinite(pool.key_pages).all()


def test_guards():
    cfg, _ = configs(PAGED)
    with pytest.raises(ValueError, match="quantize_kvcache"):
        Engine(dataclasses.replace(cfg, quantize_kvcache=True), device="cpu")
    with pytest.raises(ValueError, match="scan_layers=false"):
        Engine(dataclasses.replace(cfg, scan_layers=True, serve_unroll_layers=False),
               device="cpu")
    # scan-stacked weights served unrolled: per-layer pools all the same
    eng = Engine(dataclasses.replace(cfg, scan_layers=True), device="cpu")
    assert not eng.cfg.scan_layers
    eng = Engine(dataclasses.replace(cfg, pagedattn_num_pages=4), device="cpu")  # 4 slots
    eng.load_params()
    with pytest.raises(ValueError, match="page pool must exceed the slot count"):
        eng.init_decode_state()


def test_a_jax_paged_state_carried_to_the_port_decodes_alike(engines):
    """``utils.param_bridge.paged_decode_state_from_jax``: both packages
    continue from ONE populated JAX paged state."""
    eng, jeng, _ = engines
    jstate, _ = jeng.prefill_insert_many(jeng.init_decode_state(),
                                         [prompt(9, 7), prompt(10, 5)], [1, 3])
    jstate, _ = jeng.generate_n(jstate, 6)
    cache_tree = {"decoder": {unit: {sub: {"kv_cache": {k: np.asarray(v) for k, v in
                                                       leaves["kv_cache"].items()}}
                                     for sub, leaves in subs.items()}
                              for unit, subs in jstate["cache"]["decoder"].items()}}
    cache, page_state = paged_decode_state_from_jax(
        cache_tree, {k: np.asarray(getattr(jstate["page_state"], k))
                     for k in ("page_status", "page_map", "seq_lens")})
    state = {"cache": cache, "page_state": page_state,
             **{k: torch.from_numpy(np.array(jstate[k])) for k in ("tokens", "pos", "active")}}
    _assert_page_state_equal(state, jstate)
    state, toks = eng.generate_n(state, 6)
    jstate, jtoks = jeng.generate_n(jstate, 6)
    np.testing.assert_array_equal(_np(toks)[:, [1, 3]], _np(jtoks)[:, [1, 3]])
    _assert_page_state_equal(state, jstate)
