"""The PyTorch package's ``Orchestrator`` on a paged engine, on the CPU:
paged admission control (each request reserves the pages it can reach, the
head of the line waits for them), streams equal to the port's dense engine
and to the JAX package's paged engine (exact: greedy float32, one set of
numpy weights), and every reservation and every device page back once the
requests are done.
"""

import dataclasses

import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.infer.engine import Engine as JaxEngine
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.infer.server import Orchestrator, _Request
from torch_port_helpers import TINY_TTS, configs, jax_tree, numpy_weights, prompt

SLOTS = 3


def _paged(num_pages, tpp):
    return ["paged_attention=true", f"pagedattn_num_pages={num_pages}",
            f"pagedattn_tokens_per_page={tpp}"]


@pytest.fixture(scope="module")
def weights():
    cfg = load_config(TINY_TTS + [f"per_device_batch_size={SLOTS}"])
    return numpy_weights(cfg, seed=3)


def _engine(weights, extra):
    eng = Engine(load_config(TINY_TTS + [f"per_device_batch_size={SLOTS}"] + list(extra)),
                 device="cpu")
    eng.set_params({k: torch.from_numpy(v) for k, v in weights.items()})
    return eng


@pytest.fixture(scope="module")
def dense(weights):
    return _engine(weights, ["decode_attention=ragged"])


def _serve(orch, jobs, timeout=120):
    reqs = [orch.submit(p, n) for p, n in jobs]
    for r in reqs:
        assert r.done.wait(timeout), "request did not finish"
    for r in reqs:
        assert r.error is None, r.error
    return reqs


def _all_back(orch):
    assert int(orch._pages_reserved.sum()) == 0
    ps = orch.decode_state["page_state"]
    assert int(ps.page_status.sum()) == 1, "every page but the null page is free"
    assert int(ps.seq_lens.sum()) == 0 and int(ps.page_map.abs().sum()) == 0


def test_paged_orchestrator_gives_the_dense_and_the_jax_paged_streams(weights, dense):
    eng = _engine(weights, _paged(40, 4))
    _, jcfg = configs(_paged(40, 4), SLOTS)
    jeng = JaxEngine(dataclasses.replace(jcfg, scan_layers=False), params=jax_tree(weights))
    jobs = [(prompt(20 + i, 3 + (5 * i) % 11), 1 + (7 * i) % 13) for i in range(7)]
    orch = Orchestrator(eng, steps_per_dispatch=4)
    orch.start()
    try:
        reqs = _serve(orch, jobs)
    finally:
        orch.stop()
    for (p, n), r in zip(jobs, reqs):
        want = dense.generate_stream(p, n)
        assert r.tokens == want, "stream differs from the dense engine's"
        assert r.tokens == jeng.generate_stream(p, n), "stream differs from the JAX paged engine's"
    assert orch.stats["admission_dispatches_total"] == 7, "paged admission is one by one"
    _all_back(orch)


def test_six_waves_through_a_twelve_page_pool(weights, dense):
    """The counterpart of the JAX package's recycling test: 6 waves of
    ``num_slots`` concurrent requests through 11 usable pages of 8 rows."""
    eng = _engine(weights, _paged(12, 8))
    orch = Orchestrator(eng, steps_per_dispatch=2)
    orch.start()
    try:
        p = np.array([3, 5, 7], np.int32)
        want = dense.generate_stream(p, 6)
        for _ in range(6):
            for r in _serve(orch, [(p, 6)] * eng.num_slots):
                assert r.tokens == want
    finally:
        orch.stop()
    _all_back(orch)
    assert orch.stats["requests_completed"] == 6 * SLOTS


def test_reservation_covers_the_dispatch_overshoot(weights):
    eng = _engine(weights, _paged(32, 8))
    req = _Request(np.zeros(3, np.int32), 5)  # 8 tokens: one page of 8 ...
    assert Orchestrator(eng, steps_per_dispatch=4)._pages_needed(req) == 2  # ... + 3 overshoot
    assert Orchestrator(eng, steps_per_dispatch=1)._pages_needed(req) == 1


def test_a_request_that_does_not_fit_waits_and_then_completes(weights, dense):
    """11 usable pages of 4 rows: A reserves 8 (10 + 20 + 1 rows), B 5
    (5 + 12 + 1): B waits at the head of the line until A has finished and
    given its pages back, and then gets its exact stream."""
    eng = _engine(weights, _paged(12, 4))
    orch = Orchestrator(eng, steps_per_dispatch=2)
    a, b = (prompt(50, 10), 20), (prompt(51, 5), 12)
    assert [orch._pages_needed(_Request(p, n)) for p, n in (a, b)] == [8, 5]
    seen = []
    admit = orch._admit_bookkeeping

    def spy(slot, req, tok):
        seen.append((len(req.prompt), orch.active_slots()))
        admit(slot, req, tok)

    orch._admit_bookkeeping = spy
    reqs = [orch.submit(*a), orch.submit(*b)]  # both queued before the loop starts
    orch.start()
    try:
        for r in reqs:
            assert r.done.wait(120), "request did not finish"
    finally:
        orch.stop()
    assert [r.error for r in reqs] == [None, None]
    assert seen == [(10, 0), (5, 0)], "B was admitted only after A had finished"
    assert reqs[0].tokens == dense.generate_stream(*a)
    assert reqs[1].tokens == dense.generate_stream(*b)
    _all_back(orch)


def test_a_request_larger_than_the_pool_fails_at_submit(weights):
    eng = _engine(weights, _paged(6, 4))  # 5 usable pages: 20 rows
    orch = Orchestrator(eng, steps_per_dispatch=1)
    req = orch.submit(prompt(52, 12), 12)  # 24 rows
    assert req.done.is_set() and "pages" in req.error
    assert orch.queue.qsize() == 0
