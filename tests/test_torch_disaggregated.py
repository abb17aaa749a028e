"""Disaggregated serving (``Orchestrator(mode="disaggregated")``, ROADMAP item 5.9).

A prefill thread drains the request queue into prefixes and the decode loop
inserts them and decodes (JAX ``infer/server.py``). On the CPU, at tiny
width: the greedy streams equal interleaved mode's and the JAX disaggregated
``Orchestrator``'s, dense and paged; a prefill that fails is retried, then
failed; a sticky CUDA error fails everything; ``stop()`` joins both threads;
``stats["prefills_total"]`` counts every prefill.
"""

import dataclasses

import pytest
import torch

from maxtext_indextts2_tpu.infer.engine import Engine as JaxEngine
from maxtext_indextts2_tpu.infer.server import Orchestrator as JaxOrchestrator
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.infer.server import Orchestrator
from torch_port_helpers import configs, jax_tree, numpy_weights, prompt

PAGED = ["paged_attention=true", "pagedattn_tokens_per_page=4", "pagedattn_num_pages=40"]
JOBS = [(prompt(60 + i, 3 + (5 * i) % 11), 2 + (7 * i) % 9) for i in range(7)]


def _pair(extra):
    cfg, jcfg = configs(extra, slots=3)
    weights = numpy_weights(cfg, seed=2)
    eng = Engine(cfg, device="cpu")
    eng.set_params({k: torch.from_numpy(v) for k, v in weights.items()})
    jeng = JaxEngine(dataclasses.replace(jcfg, scan_layers=False), params=jax_tree(weights))
    return eng, jeng


@pytest.fixture(scope="module", params=["dense", "paged"])
def pair(request):
    return _pair(["decode_attention=ragged"] if request.param == "dense" else PAGED)


def _serve(orch, jobs=JOBS):
    orch.start()
    try:
        reqs = [orch.submit(p, n) for p, n in jobs]
        for r in reqs:
            assert r.done.wait(300), "request did not finish"
    finally:
        orch.stop()
    return reqs


def test_disaggregated_streams_equal_interleaved_and_jax(pair):
    eng, jeng = pair
    dis = _serve(Orchestrator(eng, steps_per_dispatch=4, mode="disaggregated"))
    inter = _serve(Orchestrator(eng, steps_per_dispatch=4))
    jdis = _serve(JaxOrchestrator(jeng, steps_per_dispatch=4, mode="disaggregated"))
    for (p, n), d, i, j in zip(JOBS, dis, inter, jdis):
        assert d.error is None and i.error is None and j.error is None
        assert d.tokens == i.tokens == j.tokens
        assert len(d.tokens) == n
    assert len({t for r in dis for t in r.tokens}) > 4


def test_stop_joins_both_threads_and_prefills_are_counted(pair):
    eng, _ = pair
    orch = Orchestrator(eng, steps_per_dispatch=2, mode="disaggregated")
    reqs = _serve(orch, JOBS[:4])
    assert not orch._thread.is_alive() and not orch._prefill_thread.is_alive()
    assert orch.stats["prefills_total"] == 4
    assert orch.stats["requests_completed"] == 4 and orch.stats["requests_failed"] == 0
    assert orch.stats["admission_dispatches_total"] == 4  # one insert a prefix
    assert all(r.error is None for r in reqs)


def test_a_failing_prefill_is_retried_then_failed(pair, monkeypatch):
    eng, _ = pair
    flaky, poisoned = JOBS[0][0], JOBS[1][0]
    calls = {"flaky": 0}
    real = eng.prefill

    def prefill(tokens, true_length):
        if len(tokens) == len(poisoned) and (tokens == poisoned).all():
            raise RuntimeError("poisoned prompt")
        if len(tokens) == len(flaky) and (tokens == flaky).all() and calls["flaky"] < 2:
            calls["flaky"] += 1
            raise RuntimeError("passing fault")
        return real(tokens, true_length)

    monkeypatch.setattr(eng, "prefill", prefill)
    orch = Orchestrator(eng, steps_per_dispatch=4, mode="disaggregated")
    orch.max_prefill_attempts = 3
    ok, bad, other = _serve(orch, JOBS[:3])
    monkeypatch.undo()
    assert ok.error is None and ok.attempts == 2
    assert ok.tokens == eng.generate_stream(*JOBS[0])
    assert bad.error is not None and "poisoned" in bad.error and bad.attempts == 3
    assert other.error is None and other.tokens == eng.generate_stream(*JOBS[2])
    # the flaky prompt's 2 failures and its success, the poisoned one's 3, the other's 1
    assert orch.stats["prefills_total"] == 3 + 3 + 1
    assert orch.stats["requests_failed"] == 1


def test_a_sticky_error_in_the_prefill_thread_fails_everything(pair, monkeypatch):
    eng, _ = pair

    def prefill(tokens, true_length):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(eng, "prefill", prefill)
    orch = Orchestrator(eng, steps_per_dispatch=4, mode="disaggregated")
    reqs = _serve(orch, JOBS[:3])
    monkeypatch.undo()
    assert all(r.error is not None for r in reqs)
    assert orch.fatal_error is not None and "illegal memory access" in orch.fatal_error
    assert reqs[0].attempts == 1  # not retried: the context is gone
