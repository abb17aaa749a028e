"""MLPerf-inference-style load generator (dependency-free).

The port's copy of the JAX package's ``infer/loadgen.py``: numpy and
threading over duck-typed systems under test, so the protocol is the
original's, held equal to it by ``tests/test_torch_port_hygiene.py``:

- ``QuerySample`` / ``QuerySampleResponse`` -- the issue/complete handshake,
- ``TestSettings`` with Offline and Server scenarios,
- ``run_test(sut, qsl, settings)`` driving the scenario state machine:
  Offline issues the whole pool as one query and measures completed
  samples/second; Server draws Poisson arrivals at ``target_qps`` from
  ``np.random.default_rng(settings.seed)`` (the same schedule as the JAX
  module's for the same settings) and judges the run VALID/INVALID against
  the target latency percentile,
- an ``mlperf_log_summary``-shaped text report.

The SUT contract matches loadgen's: ``issue_query(samples)`` may return
asynchronously; each sample completes via ``ctx.query_complete(sample_id,
tokens)``. ``flush_queries()`` blocks until everything issued has completed.
``OfflineEngineSUT`` wraps this package's ``infer/offline_engine.OfflineEngine``
and ``OrchestratorSUT`` its ``infer/server.Orchestrator``::

    qsl = QuerySampleLibrary(prompts)  # token arrays
    sut = OrchestratorSUT(orchestrator, max_new_tokens).bind(qsl)  # a started Orchestrator
    result = run_test(sut, qsl, TestSettings(scenario=SERVER, target_qps=4.0))
    print(result.summary())
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

OFFLINE = "offline"
SERVER = "server"


@dataclass(frozen=True)
class QuerySample:
    id: int          # unique per issued sample (response correlation key)
    index: int       # index into the QSL's sample pool


@dataclass
class TestSettings:
    __test__ = False  # loadgen-parity name; not a pytest class

    scenario: str = OFFLINE
    target_qps: float = 1.0
    min_duration_s: float = 10.0
    min_query_count: int = 16
    # Server scenario SLO (loadgen: target_latency + percentile)
    server_target_latency_s: float = 2.0
    server_latency_percentile: float = 0.99
    seed: int = 0


class QuerySampleLibrary:
    """Sample pool. ``samples[i]`` is whatever the SUT's issue_query expects
    to find at ``qsl.samples[qs.index]`` (token arrays here)."""

    def __init__(self, samples: list):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    # loadgen parity hooks (RAM residency management is a no-op on one host)
    def load_samples_to_ram(self, indices):  # noqa: D102 — protocol stub
        del indices

    def unload_samples_from_ram(self, indices):  # noqa: D102
        del indices


@dataclass
class LoadgenResult:
    scenario: str
    valid: bool
    issued: int
    completed: int
    scheduled_qps: float
    completed_qps: float
    latencies_s: list[float] = field(repr=False, default_factory=list)
    percentiles: dict = field(default_factory=dict)
    reasons: list[str] = field(default_factory=list)

    def summary(self) -> str:
        """mlperf_log_summary.txt-shaped report."""
        lines = [
            "=" * 48,
            "MLPerf-style results summary",
            "=" * 48,
            f"Scenario : {self.scenario.capitalize()}",
            f"Result is : {'VALID' if self.valid else 'INVALID'}",
        ]
        for r in self.reasons:
            lines.append(f"  * {r}")
        lines += [
            f"Scheduled samples per second : {self.scheduled_qps:.2f}",
            f"Completed samples per second : {self.completed_qps:.2f}",
            f"Samples issued : {self.issued}",
            f"Samples completed : {self.completed}",
        ]
        for k, v in self.percentiles.items():
            lines.append(f"{k} latency (s) : {v:.4f}")
        return "\n".join(lines)


class _Context:
    """Completion sink handed to the SUT (loadgen's QuerySamplesComplete)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._done = threading.Condition(self._lock)
        self.completions: dict[int, float] = {}  # sample id -> completion ts
        self.responses: dict[int, object] = {}

    def query_complete(self, sample_id: int, response=None):
        now = time.perf_counter()
        with self._lock:
            self.completions[sample_id] = now
            self.responses[sample_id] = response
            self._done.notify_all()

    def wait(self, n: int, timeout: float) -> bool:
        deadline = time.perf_counter() + timeout
        with self._lock:
            while len(self.completions) < n:
                rem = deadline - time.perf_counter()
                if rem <= 0:
                    return False
                self._done.wait(rem)
        return True


def run_test(sut, qsl: QuerySampleLibrary, settings: TestSettings,
             timeout_s: float = 900.0) -> LoadgenResult:
    """Drive one scenario. ``sut`` needs ``issue_query(ctx, samples)`` and
    optionally ``flush_queries()``."""
    ctx = _Context()
    rng = np.random.default_rng(settings.seed)
    issue_times: dict[int, float] = {}

    if settings.scenario == OFFLINE:
        n = max(settings.min_query_count, len(qsl))
        samples = [QuerySample(i, i % len(qsl)) for i in range(n)]
        t0 = time.perf_counter()
        for s in samples:
            issue_times[s.id] = t0
        sut.issue_query(ctx, samples)
        if hasattr(sut, "flush_queries"):
            sut.flush_queries()
        ctx.wait(len(samples), timeout_s)
        wall = max(time.perf_counter() - t0, 1e-9)
        scheduled = len(samples) / wall
    elif settings.scenario == SERVER:
        samples = []
        t0 = time.perf_counter()
        t_next = t0
        sid = 0
        while (t_next - t0 < settings.min_duration_s
               or sid < settings.min_query_count):
            now = time.perf_counter()
            if now < t_next:
                time.sleep(t_next - now)
            s = QuerySample(sid, sid % len(qsl))
            samples.append(s)
            issue_times[s.id] = time.perf_counter()
            sut.issue_query(ctx, [s])
            sid += 1
            t_next += rng.exponential(1.0 / settings.target_qps)
        if hasattr(sut, "flush_queries"):
            sut.flush_queries()
        ctx.wait(len(samples), timeout_s)
        wall = max(time.perf_counter() - t0, 1e-9)
        scheduled = settings.target_qps
    else:
        raise ValueError(f"unknown scenario {settings.scenario!r}")

    lat = [
        ctx.completions[s.id] - issue_times[s.id]
        for s in samples if s.id in ctx.completions
    ]
    completed = len(lat)
    pct = {}
    if lat:
        for p in (50, 90, 99):
            pct[f"p{p}"] = float(np.percentile(lat, p))

    reasons = []
    valid = completed == len(samples)
    if not valid:
        reasons.append(f"only {completed}/{len(samples)} samples completed")
    errored = sum(1 for v in ctx.responses.values() if v is None)
    if errored:
        valid = False
        reasons.append(f"{errored} samples completed with errors")
    if settings.scenario == SERVER and lat:
        bound = settings.server_target_latency_s
        q = float(np.percentile(lat, settings.server_latency_percentile * 100))
        if q > bound:
            valid = False
            reasons.append(
                f"p{settings.server_latency_percentile * 100:.0f} latency "
                f"{q:.3f}s exceeds target {bound:.3f}s")
    return LoadgenResult(
        scenario=settings.scenario,
        valid=valid,
        issued=len(samples),
        completed=completed,
        scheduled_qps=scheduled,
        completed_qps=completed / wall,
        latencies_s=lat,
        percentiles=pct,
        reasons=reasons,
    )


class OfflineEngineSUT:
    """SUT adapter over OfflineEngine (continuous batching over slots) —
    the repo counterpart of reference offline_inference.py's SUT."""

    def __init__(self, offline_engine, max_new_tokens: int):
        self.eng = offline_engine
        self.max_new = max_new_tokens

    def bind(self, qsl: QuerySampleLibrary):
        self._qsl = qsl
        return self

    def issue_query(self, ctx: _Context, samples):
        prompts = [
            np.asarray(self._qsl.samples[s.index], np.int32) for s in samples
        ]
        outs = self.eng.generate_batch(prompts, self.max_new)
        for s, o in zip(samples, outs):
            ctx.query_complete(s.id, o)


class OrchestratorSUT:
    """SUT adapter over the continuous-batching Orchestrator (server
    scenario: per-arrival submits, async completions)."""

    def __init__(self, orchestrator, max_new_tokens: int):
        self.orch = orchestrator
        self.max_new = max_new_tokens
        self._pending: list[threading.Thread] = []

    def bind(self, qsl: QuerySampleLibrary):
        self._qsl = qsl
        return self

    def issue_query(self, ctx: _Context, samples):
        for s in samples:
            req = self.orch.submit(
                np.asarray(self._qsl.samples[s.index], np.int32), self.max_new)

            def waiter(req=req, s=s):
                req.done.wait(timeout=600)
                ctx.query_complete(s.id, None if req.error else req.tokens)

            th = threading.Thread(target=waiter, daemon=True)
            th.start()
            self._pending.append(th)

    def flush_queries(self):
        for th in self._pending:
            th.join(timeout=600)
        self._pending.clear()

