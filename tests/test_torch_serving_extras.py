"""The serving extras of the PyTorch package on the CPU, against the JAX
package where it has the same function: ``Engine.prefill_concat`` and
``Engine.prefill_multisampling`` (the JAX draw's Gumbel noise fed in),
``POST /generate_stream`` (ndjson lines equal to ``/generate``'s tokens, the
error line, a client that goes away), and the Orchestrator's decode
recovery (the JAX package's ``tests/test_serving.py``
``test_orchestrator_decode_failure_resumes_streams``: a failed dispatch,
every stream resumed to the tokens of an uninterrupted decode, through a
chunked prefill past the prefill limit; a stream whose resume fails fails
alone; a sticky CUDA error fails everything at once).

float32 throughout: last logits 1e-4 (the same arithmetic, another order;
the packed prefill's masked rows are summed too), token streams exactly.
"""

import json
import socket
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu_torch.infer.cuda_graphs import CaptureError
from maxtext_indextts2_tpu_torch.infer.server import Orchestrator, make_server
from torch_port_helpers import engine_pair, prompt

TOL_LOGITS = 1e-4


@pytest.fixture(scope="module")
def pair():
    return engine_pair(["decode_attention=ragged"], slots=3)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def test_prefill_concat_matches_jax_and_separate_prefills(pair):
    eng, jeng = pair
    prompts = [prompt(1, 3), prompt(2, 6), prompt(3, 5)]
    got, want = eng.prefill_concat(prompts), jeng.prefill_concat(prompts)
    assert len(got) == 3
    state, jstate = eng.init_decode_state(), jeng.init_decode_state()
    for slot, ((prefix, first), (jprefix, jfirst), p) in enumerate(zip(got, want, prompts)):
        np.testing.assert_allclose(_np(prefix["logits"]), _np(jprefix["logits"]),
                                   atol=TOL_LOGITS)
        assert int(_np(first)[0]) == int(_np(jfirst)[0])
        assert prefix["length"] == len(p) and prefix["cache"][0][0].max_length == len(p)
        solo, _ = eng.prefill(p, len(p))
        np.testing.assert_allclose(_np(prefix["logits"]), _np(solo["logits"]), atol=TOL_LOGITS)
        state = eng.insert(prefix, state, slot)
        jstate = jeng.insert(jprefix, jstate, slot)
    for _ in range(4):
        state, toks = eng.generate(state)
        jstate, jtoks = jeng.generate(jstate)
        np.testing.assert_array_equal(_np(toks), _np(jtoks))
    with pytest.raises(ValueError, match="prompt lengths"):
        eng.prefill_concat([prompt(4, 10), prompt(5, 10)])  # 20 > the prefill limit 16


@pytest.mark.parametrize("strategy", ["weighted", "topk", "nucleus"])
def test_prefill_multisampling_matches_jax_with_its_noise(strategy):
    extra = [f"decode_sampling_strategy={strategy}", "decode_sampling_temperature=1.5",
             "decode_sampling_top_k=8", "decode_sampling_nucleus_p=0.9"]
    eng, jeng = engine_pair(extra, slots=2)
    p = prompt(6, 9)
    # the JAX engine splits its key once in prefill and once for the draw
    key = jax.random.split(jax.random.split(jeng.rng)[0])[1]
    width = 8 if strategy == "topk" else eng.cfg.vocab_size
    noise = np.array(jax.random.gumbel(key, (64, width), np.float32))  # a writable copy
    jprefix, jtoks = jeng.prefill_multisampling(p, len(p), 64)
    prefix, toks = eng.prefill_multisampling(p, len(p), 64, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(_np(prefix["logits"]), _np(jprefix["logits"]), atol=TOL_LOGITS)
    np.testing.assert_array_equal(toks, np.asarray(jtoks))
    assert toks.shape == (64,) and len(np.unique(toks)) > 1
    drawn = eng.prefill_multisampling(p, len(p), 64)[1]  # from the engine's generator
    assert drawn.shape == (64,) and set(drawn) <= set(range(eng.cfg.vocab_size))


# --------------------------------------------------------- /generate_stream
@pytest.fixture()
def server(pair):
    eng, _ = pair
    httpd, orch, _ = make_server(eng.cfg, port=0, engine=eng, host="127.0.0.1")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield httpd.server_address[1], orch
    httpd.shutdown()
    httpd.server_close()
    orch.stop()
    thread.join(timeout=10)


def _post(port, path, body, timeout=60):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.headers.get("Content-Type"), resp.read()


def test_generate_stream_lines_equal_generate(server, pair):
    port, orch = server
    eng, jeng = pair
    results = {}

    def stream(i, p):
        ctype, raw = _post(port, "/generate_stream", {"prompt": p.tolist(), "max_new_tokens": 7})
        results[i] = (ctype, [json.loads(line) for line in raw.decode().splitlines()])

    prompts = [prompt(10 + i, 4 + i) for i in range(5)]  # more requests than the 3 slots
    threads = [threading.Thread(target=stream, args=(i, p)) for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for i, p in enumerate(prompts):
        ctype, lines = results[i]
        assert ctype == "application/x-ndjson"
        tokens = [line["token"] for line in lines]
        assert all(set(line) == {"token"} for line in lines)
        assert tokens == json.loads(_post(port, "/generate", {"prompt": p.tolist(),
                                                              "max_new_tokens": 7})[1])["tokens"]
        assert tokens == eng.generate_stream(p, 7) == jeng.generate_stream(p, 7)


def test_generate_stream_ends_a_failed_request_with_an_error_line(server):
    port, _ = server
    _, raw = _post(port, "/generate_stream", {"prompt": list(range(1, 40)), "max_new_tokens": 4})
    lines = [json.loads(line) for line in raw.decode().splitlines()]
    assert len(lines) == 1 and "serving limits" in lines[0]["error"]
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(port, "/generate_stream", {"max_new_tokens": 4})
    assert err.value.code == 400


def test_a_dropped_stream_client_does_not_stall_the_loop(server):
    port, orch = server
    body = json.dumps({"prompt": prompt(20, 5).tolist(), "max_new_tokens": 40}).encode()
    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
    sock.sendall(b"POST /generate_stream HTTP/1.1\r\nHost: x\r\nContent-Type: application/json"
                 b"\r\nContent-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
    assert b"200" in sock.recv(64)
    sock.close()  # gone before its tokens are
    _, raw = _post(port, "/generate", {"prompt": prompt(21, 5).tolist(), "max_new_tokens": 6})
    assert len(json.loads(raw)["tokens"]) == 6
    assert orch.fatal_error is None and not orch._loop_dead.is_set()


# ------------------------------------------------------------ recovery
class _FailingEngine:
    """Delegates to the real engine; ``generate_n`` raises ``error`` on its
    ``fail_at``-th call; ``prefill`` raises for the prompt ``poison`` once a
    failure happened."""

    def __init__(self, inner, error, fail_at=3, poison=None):
        self._inner, self.error, self.fail_at, self.poison = inner, error, fail_at, poison
        self.calls, self.failed = 0, False

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def generate_n(self, state, n):
        self.calls += 1
        if self.calls == self.fail_at:
            self.failed = True
            raise self.error
        return self._inner.generate_n(state, n)

    def prefill(self, tokens, true_length):
        if self.failed and self.poison is not None and \
                np.array_equal(tokens[:len(self.poison)], self.poison):
            raise RuntimeError("resume refused")
        return self._inner.prefill(tokens, true_length)


def test_decode_failure_resumes_every_stream(pair):
    """Streams resume to the uninterrupted tokens; the 14-token prompt's
    resume is past the prefill limit (16) and goes through prefill_chunked."""
    eng, jeng = pair
    failing = _FailingEngine(eng, RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"))
    orch = Orchestrator(failing, steps_per_dispatch=2)
    orch.start()
    prompts = [np.array([3, 5, 7], np.int32), np.array([11, 13], np.int32), prompt(30, 14)]
    try:
        reqs = [orch.submit(p, 12) for p in prompts]
        for r in reqs:
            assert r.done.wait(timeout=120)
            assert r.error is None, r.error
    finally:
        orch.stop()
    assert failing.failed and orch.stats["decode_recoveries"] == 1
    assert orch.stats["decode_failures"] == 1
    for r, p in zip(reqs, prompts):
        assert r.tokens == eng.generate_stream(p, 12) == jeng.generate_stream(p, 12)


def test_a_stream_whose_resume_fails_fails_alone(pair):
    eng, _ = pair
    poison = np.array([11, 13], np.int32)
    failing = _FailingEngine(eng, RuntimeError("CUDA out of memory"), poison=poison)
    orch = Orchestrator(failing, steps_per_dispatch=2)
    orch.start()
    try:
        good, bad = orch.submit(np.array([3, 5, 7], np.int32), 12), orch.submit(poison, 12)
        assert good.done.wait(120) and bad.done.wait(120)
    finally:
        orch.stop()
    assert "resume refused" in bad.error
    assert good.error is None and good.tokens == eng.generate_stream(np.array([3, 5, 7]), 12)


@pytest.mark.parametrize("error", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    CaptureError("capturing the decode dispatch failed: a host copy")],
    ids=["sticky_cuda_error", "capture_error"])
def test_a_sticky_error_or_a_failed_capture_fails_every_stream_at_once(pair, error):
    """Nothing can be resumed after a sticky error; a failed capture would
    fail again at every dispatch: both fail every request at once."""
    eng, _ = pair
    failing = _FailingEngine(eng, error, fail_at=2)
    orch = Orchestrator(failing, steps_per_dispatch=2)
    orch.start()
    reqs = [orch.submit(prompt(40 + i, 4), 30) for i in range(5)]
    for r in reqs:
        assert r.done.wait(60)
    assert all(str(error)[:20] in r.error for r in reqs)
    assert orch._loop_dead.wait(10) and failing.calls == 2
    assert "decode_recoveries" not in orch.stats
    orch.stop()
