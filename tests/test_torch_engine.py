"""The serving slice as a whole: greedy token streams of the PyTorch
package's ``Engine`` (on the CPU, so through the kernels' plain versions)
equal the JAX package's ``Engine`` token for token, in float32 with
``decode_attention=ragged`` (the JAX side then runs its Pallas kernels in
interpret mode), through admission, ``generate_n``, release and slot reuse.

Token streams are compared exactly; there is no tolerance. Slots that hold
no request are left out: their logits come from an empty cache, where the
TPU kernel returns a mean of masked rows and this package zeros.
"""

import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from torch_port_helpers import TINY_TTS, engine_pair, prompt

RAGGED = ["decode_attention=ragged"]


@pytest.fixture(scope="module")
def ragged_pair():
    return engine_pair(RAGGED, slots=4)


def _tokens(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def test_generate_stream_matches_jax(ragged_pair):
    eng, jeng = ragged_pair
    p = prompt(1, 7)
    want = jeng.generate_stream(p, 12)
    got = eng.generate_stream(p, 12)
    assert got == want
    assert len(set(got)) > 2, "a degenerate stream would prove little"


def test_admission_generate_release_and_slot_reuse_match_jax(ragged_pair):
    eng, jeng = ragged_pair
    state, jstate = eng.init_decode_state(), jeng.init_decode_state()
    long_a, short_b = prompt(2, 9), prompt(3, 4)

    # two prompts, one packed prefill, into slots 0 and 2 of a live state
    state, first = eng.prefill_insert_many(state, [long_a, short_b], [0, 2])
    jstate, jfirst = jeng.prefill_insert_many(jstate, [long_a, short_b], [0, 2])
    np.testing.assert_array_equal(_tokens(first), _tokens(jfirst))
    state, toks = eng.generate_n(state, 4)
    jstate, jtoks = jeng.generate_n(jstate, 4)
    assert tuple(toks.shape) == (4, 4)
    np.testing.assert_array_equal(_tokens(toks)[:, [0, 2]], _tokens(jtoks)[:, [0, 2]])
    stream_a = [int(_tokens(first)[0])] + _tokens(toks)[:, 0].tolist()

    # release slot 0 (the long one); slot 2 keeps decoding
    state = eng.release_slots(state, [0])
    jstate = jeng.release_slots(jstate, [0])
    assert _tokens(state["active"]).tolist() == [False, False, True, False]
    pos_before = int(state["pos"][0])
    state, toks = eng.generate_n(state, 4)
    jstate, jtoks = jeng.generate_n(jstate, 4)
    np.testing.assert_array_equal(_tokens(toks)[:, 2], _tokens(jtoks)[:, 2])
    assert int(state["pos"][0]) == pos_before, "a released slot's position stops"

    # re-admit into the freed slot 0 a SHORTER prompt than its last occupant,
    # and a second one into slot 1
    short_c, mid_d = prompt(4, 3), prompt(5, 6)
    state, first = eng.prefill_insert_many(state, [short_c, mid_d], [0, 1])
    jstate, jfirst = jeng.prefill_insert_many(jstate, [short_c, mid_d], [0, 1])
    np.testing.assert_array_equal(_tokens(first), _tokens(jfirst))
    state, toks = eng.generate_n(state, 4)
    jstate, jtoks = jeng.generate_n(jstate, 4)
    np.testing.assert_array_equal(_tokens(toks)[:, :3], _tokens(jtoks)[:, :3])
    np.testing.assert_array_equal(_tokens(state["pos"])[:3], _tokens(jstate["pos"])[:3])

    # slot reuse sees nothing of the previous occupant: the stream equals the
    # single-stream decode of the same prompt from a fresh state
    stream_c = [int(_tokens(first)[0])] + _tokens(toks)[:, 0].tolist()
    assert stream_c == eng.generate_stream(short_c, 5)
    assert stream_a == eng.generate_stream(long_a, 5)
    for cache in (c for unit in state["cache"] for c in unit):
        seg = cache.cached_segment_ids[0]
        n = int(cache.cache_index[0])
        assert n == len(short_c) + 4
        assert seg[:n].eq(1).all() and seg[n:].eq(0).all()


def test_prefill_then_insert_matches_fused_admission(ragged_pair):
    eng, jeng = ragged_pair
    p = prompt(6, 5)
    prefix, first = eng.prefill(p, len(p))
    jprefix, jfirst = jeng.prefill(p, len(p))
    np.testing.assert_array_equal(_tokens(first), _tokens(jfirst))
    np.testing.assert_allclose(prefix["logits"].numpy(), np.asarray(jprefix["logits"]), atol=1e-4)
    state = eng.insert(prefix, eng.init_decode_state(), 3)
    fused, ffirst = eng.prefill_insert_many(eng.init_decode_state(), [p], [3])
    assert int(ffirst[0]) == int(first[0])
    state, a = eng.generate_n(state, 3)
    fused, b = eng.generate_n(fused, 3)
    np.testing.assert_array_equal(_tokens(a)[:, 3], _tokens(b)[:, 3])
    with pytest.raises(ValueError):
        eng.prefill(prompt(7, 40), 40)  # longer than max_prefill_predict_length
    for bad_prompts, bad_slots in (([p, p], [1, 1]), ([p], [4]), ([p, p], [0]),
                                   ([prompt(7, 9), prompt(7, 9)], [0, 1])):  # 18 > 16
        with pytest.raises(ValueError):
            eng.prefill_insert_many(eng.init_decode_state(), bad_prompts, bad_slots)
    with pytest.raises(ValueError):
        eng.insert(prefix, eng.init_decode_state(), 4)


def test_position_saturates_for_a_slot_nobody_released(ragged_pair):
    eng, jeng = ragged_pair
    cfg = eng.cfg
    p = prompt(8, 5)
    state, _ = eng.prefill_insert_many(eng.init_decode_state(), [p, p], [0, 1])
    jstate, _ = jeng.prefill_insert_many(jeng.init_decode_state(), [p, p], [0, 1])
    in_range = cfg.max_target_length - len(p) - 1  # steps before the cache is full
    got, want = [], []
    for _ in range(17):  # 68 steps: past the end of the 64-row cache
        state, toks = eng.generate_n(state, 4)
        jstate, jtoks = jeng.generate_n(jstate, 4)
        got.append(_tokens(toks)[:, 0])
        want.append(_tokens(jtoks)[:, 0])
    got, want = np.concatenate(got), np.concatenate(want)
    np.testing.assert_array_equal(got[:in_range], want[:in_range])
    assert int(state["pos"][0]) == cfg.max_target_length - 1 == int(_tokens(jstate["pos"])[0])
    assert ((got >= 0) & (got < cfg.vocab_size)).all()
    for cache in (c for unit in state["cache"] for c in unit):
        assert torch.isfinite(cache.cached_key).all()


@pytest.mark.parametrize("extra", [
    ["decode_attention=ragged", "quantize_kvcache=true"],
    ["decode_attention=dot_product"],
    ["decode_attention=dot_product", "quantize_kvcache=true"],
], ids=["ragged_int8", "dot_product", "dot_product_int8"])
def test_generate_stream_other_decode_paths_match_jax(extra):
    eng, jeng = engine_pair(extra, slots=1, seed=2)
    p = prompt(9, 6)
    assert eng.generate_stream(p, 10) == jeng.generate_stream(p, 10)


def test_serving_cast_keeps_scales_float32():
    cfg = load_config(TINY_TTS + ["serve_params_dtype=bfloat16", "dtype=bfloat16",
                                  "per_device_batch_size=2", "decode_attention=ragged"])
    eng = Engine(cfg, device="cpu")
    params = eng.load_params()
    for name, p in params.items():
        assert p.dtype == (torch.float32 if "scale" in name else torch.bfloat16), name
    out = eng.generate_stream(prompt(10, 5), 6)
    assert len(out) == 6 and all(0 <= t < cfg.vocab_size for t in out)
    # the same seed gives the same weights and the same stream
    eng2 = Engine(cfg, device="cpu")
    eng2.load_params()
    assert eng2.generate_stream(prompt(10, 5), 6) == out


def test_engine_refuses_what_is_not_ported():
    for extra in (["spec_num_draft_tokens=2"],
                  ["decode_attention=bucketed"], ["quantization=int8"],
                  ["load_parameters_path=/nonexistent"]):
        cfg = load_config(TINY_TTS + extra)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Engine(cfg, device="cpu").load_params()
    eng = Engine(load_config(TINY_TTS), device="cpu")
    with pytest.raises(RuntimeError, match="load_params"):
        eng.generate(eng.init_decode_state())
    eng.refresh_decode()
    eng.refresh_prefill()
