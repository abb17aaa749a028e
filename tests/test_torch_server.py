"""The PyTorch package's ``Orchestrator`` and HTTP server on the CPU: more
requests than slots, each stream equal to the single-stream decode of its
prompt (exact: greedy float32, same engine), the length guards, a failing
device call, a ``POST /generate`` round trip, and a dropped server that frees
its engine at once.
"""

import gc
import json
import threading
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest

from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer import decode as decode_cli
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.infer.server import Orchestrator, make_server, split_device_arg
from torch_port_helpers import TINY_TTS, prompt

ARGS = TINY_TTS + ["decode_attention=ragged", "per_device_batch_size=3"]


@pytest.fixture(scope="module")
def engine():
    eng = Engine(load_config(ARGS), device="cpu")
    eng.load_params()
    return eng


def _wait(reqs, timeout=120):
    for r in reqs:
        assert r.done.wait(timeout), "request did not finish"


@pytest.mark.parametrize("fusion", [8, 1], ids=["fused_admission", "per_request_admission"])
def test_more_requests_than_slots_all_complete(engine, fusion):
    orch = Orchestrator(engine, steps_per_dispatch=4, admission_fusion_max=fusion)
    orch.start()
    try:
        jobs = [(prompt(20 + i, 3 + (5 * i) % 11), 1 + (7 * i) % 13) for i in range(8)]
        reqs = [orch.submit(p, n) for p, n in jobs]
        _wait(reqs)
    finally:
        orch.stop()
    for (p, n), r in zip(jobs, reqs):
        assert r.error is None
        assert r.tokens == engine.generate_stream(p, n), "stream differs from single-stream decode"
    assert orch.stats["requests_completed"] == 8 and orch.stats["requests_failed"] == 0
    assert orch.stats["tokens_generated_total"] == sum(n for _, n in jobs)
    assert orch.stats["prefills_total"] == 8
    if fusion > 1:  # 3 slots: groups of two and one, never one dispatch per request
        assert orch.stats["admission_dispatches_total"] < 8
    assert orch.active_slots() == 0
    text = orch.metrics_text()
    assert "serving_requests_completed 8" in text and "serving_queue_depth 0" in text


def test_eos_ends_a_stream(engine):
    p = prompt(40, 6)
    full = engine.generate_stream(p, 12)
    eos = full[4]
    orch = Orchestrator(engine, eos_id=eos, steps_per_dispatch=4)
    orch.start()
    try:
        r = orch.submit(p, 12)
        _wait([r])
    finally:
        orch.stop()
    assert r.tokens == full[: full.index(eos) + 1]


def test_submit_length_guards(engine):
    cfg = engine.cfg
    orch = Orchestrator(engine, steps_per_dispatch=4)
    orch.start()
    try:
        too_long = orch.submit(np.ones(cfg.max_prefill_predict_length + 1, np.int32), 4)
        empty = orch.submit(np.zeros(0, np.int32), 4)
        no_budget = orch.submit(prompt(41, 4), 0)
        capped = orch.submit(prompt(42, 10), 10_000)
        _wait([too_long, empty, no_budget, capped])
    finally:
        orch.stop()
    for r in (too_long, empty, no_budget):
        assert r.error is not None and r.tokens == []
    # clamped so that the last dispatch cannot step past the cache
    assert capped.error is None
    assert len(capped.tokens) == cfg.max_target_length - 10 - 3
    assert orch.stats["requests_failed"] == 3


def test_device_error_fails_requests_and_stops_the_loop(engine):
    class Boom(RuntimeError):
        pass

    class FailingEngine:
        """Delegates to the real engine; generate_n raises on its 2nd call."""

        def __init__(self, inner):
            self._inner, self.calls = inner, 0

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def generate_n(self, state, n):
            self.calls += 1
            if self.calls >= 2:
                raise Boom("CUDA error: an illegal memory access was encountered")
            return self._inner.generate_n(state, n)

    failing = FailingEngine(engine)
    orch = Orchestrator(failing, steps_per_dispatch=2)
    orch.start()
    reqs = [orch.submit(prompt(50 + i, 4), 30) for i in range(5)]  # 3 in slots, 2 queued
    _wait(reqs, timeout=60)
    assert all(r.error is not None and "illegal memory access" in r.error for r in reqs)
    assert orch._loop_dead.wait(10), "the loop ends; nothing is retried"
    assert failing.calls == 2
    assert "Boom" in orch.fatal_error
    late = orch.submit(prompt(60, 4), 3)
    assert late.done.wait(10) and late.error is not None
    orch.stop()


def test_http_generate_and_metrics_round_trip(engine):
    server, orch, _ = make_server(engine.cfg, port=0, engine=engine, host="127.0.0.1")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        p = prompt(70, 5)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({"prompt": p.tolist(), "max_new_tokens": 6}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
        assert body["tokens"] == engine.generate_stream(p, 6)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
            assert "serving_tokens_generated_total 6" in resp.read().decode()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as resp:
            assert resp.read() == b"ok"
        bad = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=b"{}")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=10)
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        orch.stop()
        thread.join(timeout=10)


def test_unported_serving_mode_raises(engine):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Orchestrator(engine, mode="disaggregated")


def test_decode_cli_on_the_cpu(capsys):
    out = decode_cli.main(ARGS + ["device=cpu", "prompt=3,5,7,11", "max_new_tokens=5"])
    assert len(out) == 5
    assert "completion:" in capsys.readouterr().out
    assert split_device_arg(["a=1", "device=cpu"]) == (["a=1"], "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode_cli.main(ARGS + ["device=cpu", "spec_draft=x.yml"])


def test_a_dropped_server_frees_its_engine_without_a_collector_pass():
    """The handler reaches the orchestrator through its server, not through a
    closure: once stopped and dropped, the server's engine is freed by
    reference counting alone (the garbage collector off throughout)."""
    gc.disable()
    try:
        server, orch, tts_batcher = make_server(load_config(ARGS), port=0, device="cpu",
                                                host="127.0.0.1")
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
            assert "serving_decode_steps_total" in resp.read().decode()
        server.shutdown()
        server.server_close()
        orch.stop()
        thread.join(timeout=10)
        engine = weakref.ref(orch.engine)
        assert engine() is not None
        del server, orch, tts_batcher, thread
        assert engine() is None, "the stopped server's engine is still referenced"
    finally:
        gc.enable()
