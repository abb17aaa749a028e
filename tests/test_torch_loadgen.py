"""The load generator, the offline engine and the microbenchmark (ROADMAP item 5.12).

``infer/loadgen.py`` is the JAX module's protocol in the port: the scenario
and validity cases of the JAX package's ``tests/test_loadgen.py``, the same
Poisson issue schedule for the same settings (both modules driven on one fake
clock), and both scenarios over the port's ``OfflineEngine`` and
``Orchestrator`` at tiny width, VALID with the engine's greedy tokens.
``OfflineEngine.generate_batch`` equals the JAX ``OfflineEngine``'s greedy
tokens on bridged weights; ``run_microbenchmark`` gives the JAX module's JSON
keys, on the CPU only when asked.
"""

import dataclasses
import threading
import time
import types

import numpy as np
import pytest

from maxtext_indextts2_tpu.infer import loadgen as jax_loadgen
from maxtext_indextts2_tpu.infer.offline_engine import OfflineEngine as JaxOfflineEngine
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer import loadgen
from maxtext_indextts2_tpu_torch.infer.loadgen import (
    OFFLINE,
    SERVER,
    OfflineEngineSUT,
    OrchestratorSUT,
    QuerySampleLibrary,
    TestSettings,
    run_test,
)
from maxtext_indextts2_tpu_torch.infer.microbenchmark import run_microbenchmark
from maxtext_indextts2_tpu_torch.infer.offline_engine import OfflineEngine
from maxtext_indextts2_tpu_torch.infer.server import Orchestrator
from torch_port_helpers import TINY_TTS, engine_pair, prompt


class InstantSUT:
    def __init__(self, latency_s=0.0, fail_ids=()):
        self.lat = latency_s
        self.fail_ids = set(fail_ids)
        self.issued = []

    def issue_query(self, ctx, samples):
        self.issued.extend(samples)

        def done():
            if self.lat:
                time.sleep(self.lat)
            for s in samples:
                ctx.query_complete(s.id, None if s.id in self.fail_ids else [1, 2, 3])

        threading.Thread(target=done, daemon=True).start()


def test_offline_scenario_counts_throughput():
    qsl = QuerySampleLibrary([np.array([1, 2])] * 4)
    res = run_test(InstantSUT(), qsl, TestSettings(scenario=OFFLINE, min_query_count=8))
    assert res.valid and res.issued == 8 and res.completed == 8
    assert res.completed_qps > 0
    assert "VALID" in res.summary()


def test_server_scenario_poisson_and_slo_pass():
    qsl = QuerySampleLibrary([np.array([1])])
    res = run_test(
        InstantSUT(latency_s=0.01), qsl,
        TestSettings(scenario=SERVER, target_qps=50.0, min_duration_s=0.3,
                     min_query_count=10, server_target_latency_s=1.0))
    assert res.valid, res.reasons
    assert res.completed == res.issued >= 10
    assert res.percentiles["p99"] < 1.0


def test_server_scenario_slo_violation_is_invalid():
    qsl = QuerySampleLibrary([np.array([1])])
    res = run_test(
        InstantSUT(latency_s=0.2), qsl,
        TestSettings(scenario=SERVER, target_qps=20.0, min_duration_s=0.2,
                     min_query_count=5, server_target_latency_s=0.05))
    assert not res.valid
    assert any("exceeds target" in r for r in res.reasons)
    assert "INVALID" in res.summary()


def test_errored_samples_invalidate():
    qsl = QuerySampleLibrary([np.array([1])] * 2)
    res = run_test(InstantSUT(fail_ids={0}), qsl,
                   TestSettings(scenario=OFFLINE, min_query_count=4))
    assert not res.valid
    assert any("errors" in r for r in res.reasons)


class _Clock:
    """A clock that moves only when the load generator sleeps."""

    def __init__(self):
        self.t = 1000.0

    def perf_counter(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


class _RecordingSUT:
    """Completes each sample at once and records (id, index, issue time)."""

    def __init__(self, clock):
        self.clock = clock
        self.issued = []

    def issue_query(self, ctx, samples):
        for s in samples:
            self.issued.append((s.id, s.index, self.clock.t))
            ctx.query_complete(s.id, [s.index])


@pytest.mark.parametrize("scenario,seed", [(SERVER, 0), (SERVER, 7), (OFFLINE, 0)])
def test_issue_schedule_equals_the_jax_modules(monkeypatch, scenario, seed):
    runs = []
    for module, settings_cls, qsl_cls in ((loadgen, TestSettings, QuerySampleLibrary),
                                          (jax_loadgen, jax_loadgen.TestSettings,
                                           jax_loadgen.QuerySampleLibrary)):
        clock = _Clock()
        monkeypatch.setattr(module, "time", types.SimpleNamespace(
            perf_counter=clock.perf_counter, sleep=clock.sleep))
        sut = _RecordingSUT(clock)
        res = module.run_test(sut, qsl_cls([np.array([i]) for i in range(5)]), settings_cls(
            scenario=scenario, target_qps=20.0, min_duration_s=2.0, min_query_count=12,
            seed=seed))
        runs.append((sut.issued, res.valid, res.issued, res.scheduled_qps))
    assert runs[0] == runs[1]
    issued = runs[0][0]
    assert len(issued) >= (30 if scenario == SERVER else 12)
    if scenario == SERVER:  # Poisson gaps, not a constant rate
        gaps = np.diff([t for _, _, t in issued])
        assert gaps.min() < 0.5 / 20 < 2 / 20 < gaps.max()


@pytest.fixture(scope="module")
def pair():
    return engine_pair(["decode_attention=ragged"], slots=4, seed=1)


POOL = [prompt(40 + i, 4 + (3 * i) % 11) for i in range(7)]


def test_offline_engine_equals_the_jax_offline_engine(pair):
    eng, jeng = pair
    want = JaxOfflineEngine(jeng.cfg, engine=jeng).generate_batch(POOL, 6)
    got = OfflineEngine(eng.cfg, engine=eng).generate_batch(POOL, 6)
    assert got == want
    assert all(len(o) == 6 for o in got) and len({t for o in got for t in o}) > 4


class _KeepResponses:
    """A SUT wrapper that keeps every sample's response."""

    def __init__(self, sut):
        self.sut = sut
        self.responses = {}

    def issue_query(self, ctx, samples):
        outer = self

        class Ctx:
            def query_complete(self, sample_id, response=None):
                outer.responses[sample_id] = response
                ctx.query_complete(sample_id, response)

        self.sut.issue_query(Ctx(), samples)

    def flush_queries(self):
        if hasattr(self.sut, "flush_queries"):
            self.sut.flush_queries()


@pytest.mark.parametrize("scenario", [OFFLINE, SERVER])
def test_loadgen_end_to_end_tiny_engine(pair, scenario):
    """Both scenarios drive the real serving paths (the ``OfflineEngine``,
    the continuous-batching ``Orchestrator``) to a VALID run, and every
    sample's tokens are the greedy stream of its prompt."""
    eng, _ = pair
    qsl = QuerySampleLibrary(POOL)
    offline = OfflineEngine(eng.cfg, engine=eng)
    settings = TestSettings(scenario=scenario, target_qps=20.0, min_query_count=len(POOL),
                            min_duration_s=0.3, server_target_latency_s=60.0)
    orch = None
    if scenario == SERVER:
        orch = Orchestrator(eng, steps_per_dispatch=4)
        orch.start()
        sut = _KeepResponses(OrchestratorSUT(orch, 5).bind(qsl))
    else:
        sut = _KeepResponses(OfflineEngineSUT(offline, 5).bind(qsl))
    try:
        res = run_test(sut, qsl, settings)
    finally:
        if orch is not None:
            orch.stop()
    assert res.valid, res.reasons
    assert res.completed == res.issued >= len(POOL) and res.completed_qps > 0
    want = offline.generate_batch(POOL, 5)
    for sid, toks in sut.responses.items():
        assert toks == want[sid % len(POOL)]


def test_microbenchmark_gives_the_jax_modules_document(pair):
    from maxtext_indextts2_tpu.infer.microbenchmark import run_microbenchmark as jax_run

    eng, jeng = pair
    lengths = "inference_microbenchmark_prefill_lengths=8,16"
    cfg = dataclasses.replace(eng.cfg, inference_microbenchmark_prefill_lengths=(8, 16))
    assert load_config(TINY_TTS + [lengths]).inference_microbenchmark_prefill_lengths == (8, 16)
    got = run_microbenchmark(cfg, engine=eng, iters=1)
    want = jax_run(dataclasses.replace(jeng.cfg, inference_microbenchmark_prefill_lengths=(8, 16)),
                   engine=jeng, iters=1)
    assert set(got) == set(want)
    for key in got:
        assert set(got[key]) == set(want[key]), key
    assert got["decode"]["slots"] == want["decode"]["slots"] == 4
    assert got["chunked_prefill_ms"]["prompt_len"] == want["chunked_prefill_ms"]["prompt_len"]
    assert all(v > 0 for v in got["prefill_ms"].values()) and got["decode"]["step_ms"] > 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _without_gpu(lambda: run_microbenchmark(load_config(TINY_TTS)))


def _without_gpu(fn):
    import torch

    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        return fn()
    finally:
        torch.cuda.is_available = real


def test_cli_entry_points_on_the_cpu(capsys):
    from maxtext_indextts2_tpu_torch.infer import microbenchmark, offline_engine

    tiny = TINY_TTS + ["per_device_batch_size=2"]
    outs = offline_engine.main(tiny + ["max_new_tokens=3", "device=cpu"])
    assert [len(o) for o in outs] == [3, 3]
    doc = microbenchmark.main(tiny + ["inference_microbenchmark_prefill_lengths=8",
                                      "device=cpu"])
    assert set(doc) == {"prefill_ms", "decode", "chunked_prefill_ms"}
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 3 and '"completion"' in printed[0]
