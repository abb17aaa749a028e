"""The PyTorch package's TTS serving: ``TTSBatcher`` (the cases of the JAX
package's serving tests), ``Orchestrator.run_on_loop``, and ``POST /tts``
round trips through ``make_server`` with a tiny pipeline on the CPU.

The port's orchestrator does not retry a failed device call (after a CUDA
error the context is gone), so a stream that fails on its own is one the
orchestrator refuses at submit: a prompt longer than the prefill limit.
"""

import base64
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import torch_audio_helpers as h
import torch_port_helpers as ph
from maxtext_indextts2_tpu_torch.audio import pipeline as pl
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.infer.server import (
    Orchestrator, TTSBatcher, _PartialLMFailure, make_server,
)
from maxtext_indextts2_tpu_torch.ops import s2a_attention as k12

# tiny shapes: one thread is enough, and the cores stay free for the other test workers
torch.set_num_threads(1)

CODEBOOK = h.TINY["cond_codebook_size"]
PIPE_EXTRA = [
    f"audio_codebook_size={CODEBOOK}", f"semantic_codebook_size={CODEBOOK}",
    "max_target_length=256", "max_prefill_predict_length=128",
    f"s2a_num_quantizers={h.TINY['num_quantizers']}", f"s2a_hidden_size={h.TINY['hidden_size']}",
    f"s2a_num_layers={h.TINY['num_layers']}", f"s2a_num_heads={h.TINY['num_heads']}",
    f"s2a_codebook_size={h.TINY['codebook_size']}", f"s2a_cond_codebook_size={CODEBOOK}",
    "s2a_timesteps=[2,1,1]", "tts_batch_max=4", "tts_batch_window_ms=200",
]


@pytest.fixture(scope="module")
def engine():
    eng = Engine(ph.configs(slots=3)[0], device="cpu")
    eng.load_params()
    return eng


def _started(*parts):
    for p in parts:
        p.start()
    return parts


def _wait(reqs, timeout=120):
    for r in reqs:
        assert r.done.wait(timeout), "request did not finish"


def test_tts_batcher_groups_concurrent_requests():
    """Submissions within the window run as ONE synthesize_batch call; each
    result goes back to its own request."""
    calls = []

    class FakePipeline:
        def synthesize_batch(self, bodies, pad_to_batch=None):
            calls.append((len(bodies), pad_to_batch))
            return [(np.full(3, float(len(b["text"]))), {"n": len(bodies)}) for b in bodies]

    (b,) = _started(TTSBatcher(FakePipeline(), max_batch=8, window_ms=200))
    try:
        reqs = [b.submit({"text": "x" * n}) for n in (1, 2, 3)]
        _wait(reqs, 30)
        assert all(r.error is None for r in reqs)
        assert calls == [(3, 8)]  # one batch, padded to the batcher's fixed size
        for n, r in zip((1, 2, 3), reqs):
            wav, info = r.result
            assert wav[0] == float(n) and info["n"] == 3
        assert b.batches == 1 and b.requests == 3
    finally:
        b.stop()


def test_tts_batcher_lm_via_orchestrator(engine):
    """With an orchestrator, the LM stage goes through its shared slots
    (the generate_fn hook) and matches direct single-stream decode."""
    captured = {}

    class FakePipeline:
        def synthesize_batch(self, bodies, generate_fn=None, pad_to_batch=None):
            assert generate_fn is not None
            prompts = [np.asarray(b["prompt"], np.int32) for b in bodies]
            captured["tokens"] = generate_fn(prompts, [5] * len(bodies))
            return [(np.zeros(1), {}) for _ in bodies]

    orch = Orchestrator(engine)
    orch.start()
    (b,) = _started(TTSBatcher(FakePipeline(), max_batch=4, window_ms=100, orchestrator=orch))
    try:
        reqs = [b.submit({"text": "a", "prompt": [3, 5, 7]}),
                b.submit({"text": "b", "prompt": [2, 4, 6]})]
        _wait(reqs)
        assert all(r.error is None for r in reqs), [r.error for r in reqs]
        assert captured["tokens"] == [engine.generate_stream(np.array([3, 5, 7], np.int32), 5),
                                      engine.generate_stream(np.array([2, 4, 6], np.int32), 5)]
    finally:
        b.stop()
        orch.stop()


def test_tts_batcher_partial_lm_failure_isolated(engine):
    """One failing stream does not take its batch down: the batcher fails
    that request and re-runs the survivors on their already generated
    tokens (the _PartialLMFailure path)."""
    calls = []

    class FakePipeline:
        def synthesize_batch(self, bodies, generate_fn=None, pad_to_batch=None):
            prompts = [np.asarray(b["prompt"], np.int32) for b in bodies]
            toks = generate_fn(prompts, [5] * len(bodies))
            calls.append(toks)
            return [(np.zeros(1), {"tokens": t}) for t in toks]

    too_long = list(range(1, engine.cfg.max_prefill_predict_length + 2))
    orch = Orchestrator(engine)
    orch.start()
    (b,) = _started(TTSBatcher(FakePipeline(), max_batch=4, window_ms=100, orchestrator=orch))
    try:
        reqs = [b.submit({"text": "a", "prompt": too_long}),
                b.submit({"text": "b", "prompt": [2, 4, 6]})]
        _wait(reqs)
        assert reqs[0].error is not None and "LM generation failed" in reqs[0].error
        assert reqs[1].error is None, reqs[1].error
        want = engine.generate_stream(np.array([2, 4, 6], np.int32), 5)
        assert calls[-1] == [want] and reqs[1].result[1]["tokens"] == want
        assert not orch._loop_dead.is_set()  # the loop serves on
    finally:
        b.stop()
        orch.stop()


def test_tts_batcher_phased_device_loop(engine):
    """With the stage methods, every device stage runs on the orchestrator's
    decode thread (run_on_loop); a failed stream is dropped while the
    survivors go on to the S2A stage with their frontend outputs."""
    loop_thread_ids = []
    too_long = np.arange(1, engine.cfg.max_prefill_predict_length + 2, dtype=np.int32)

    class PhasedFake:
        def frontend_batch(self, bodies, pad_to_batch=None):
            loop_thread_ids.append(threading.get_ident())
            assert pad_to_batch == 4
            return ([np.zeros(2, np.int32)] * len(bodies),
                    [np.zeros((2, 1), np.int32)] * len(bodies))

        def text_and_prompt_to_lm_prompt(self, text, sem):
            return too_long if text == "bad" else np.asarray([2, 4, 6], np.int32)

        def map_semantic(self, out, force_frames=False):
            return list(out)

        def s2a_vocoder_batch(self, bodies, sems, acs, gens, pad_to_batch=None, **kw):
            loop_thread_ids.append(threading.get_ident())
            return [(np.zeros(1), {"tokens": g}) for g in gens]

    orch = Orchestrator(engine)
    orch.start()
    (b,) = _started(TTSBatcher(PhasedFake(), max_batch=4, window_ms=100, orchestrator=orch))
    try:
        reqs = [b.submit({"text": "bad", "max_new_tokens": 5}),
                b.submit({"text": "ok", "max_new_tokens": 5})]
        _wait(reqs)
        assert reqs[0].error is not None and "LM generation" in reqs[0].error
        assert reqs[1].error is None, reqs[1].error
        want = engine.generate_stream(np.array([2, 4, 6], np.int32), 5)
        assert reqs[1].result[1]["tokens"] == want
        assert loop_thread_ids and set(loop_thread_ids) == {orch._thread.ident}
    finally:
        b.stop()
        orch.stop()


def test_tts_batcher_error_propagates():
    class BrokenPipeline:
        def synthesize_batch(self, bodies, pad_to_batch=None):
            raise RuntimeError("boom")

    (b,) = _started(TTSBatcher(BrokenPipeline(), max_batch=4, window_ms=10))
    try:
        r = b.submit({"text": "x"})
        assert r.done.wait(timeout=30)
        assert r.error is not None and "boom" in r.error and r.result is None
    finally:
        b.stop()


@pytest.mark.parametrize("allow", [False, True], ids=["stripped", "allowed"])
def test_tts_batcher_force_frames_gated_server_side(allow):
    """force_frames turns off the stop at a non-audio token: a load-test
    knob that an untrusted /tts client must not control."""
    seen = []

    class FakePipeline:
        def synthesize_batch(self, bodies, pad_to_batch=None):
            seen.extend(bodies)
            return [(np.zeros(3), {}) for _ in bodies]

    (b,) = _started(TTSBatcher(FakePipeline(), max_batch=2, window_ms=10,
                               allow_force_frames=allow))
    try:
        r = b.submit({"text": "hi", "force_frames": True})
        assert r.done.wait(timeout=30) and r.error is None
        assert ("force_frames" in seen[0]) == allow
    finally:
        b.stop()


def test_run_on_loop_runs_on_the_decode_thread_and_fails_fast_after_exit(engine):
    orch = Orchestrator(engine)
    orch.start()
    try:
        assert orch.run_on_loop(threading.get_ident) == orch._thread.ident
        with pytest.raises(ZeroDivisionError):
            orch.run_on_loop(lambda: 1 / 0)
        # a thunk's failure is its caller's: the loop goes on serving
        r = orch.submit(np.array([3, 5, 7], np.int32), 4)
        assert r.done.wait(60) and r.error is None and len(r.tokens) == 4
    finally:
        orch.stop()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        orch.run_on_loop(lambda: 1, timeout=600)
    assert time.monotonic() - t0 < 10


def test_partial_lm_failure_reports_its_streams():
    e = _PartialLMFailure([[1, 2], None, [3]], ["ValueError('x')"])
    assert "1/3 streams" in str(e) and e.tokens[1] is None


# ------------------------------------------------------------------ POST /tts
@pytest.fixture(scope="module")
def tts_server():
    """make_server with a tiny pipeline: an LM that emits audio tokens only,
    force_frames allowed."""
    cfg, _ = ph.configs(PIPE_EXTRA + ["tts_allow_force_frames=true"], slots=4)
    engine = Engine(cfg, device="cpu")
    engine.set_params({k: torch.from_numpy(v)
                       for k, v in ph.audio_only_lm_weights(cfg, 2).items()})
    pipe = pl.build_tiny_pipeline(cfg, seed=3, device="cpu", engine=engine,
                                  codec_kwargs=h.TINY_CODEC)
    server, orch, batcher = make_server(cfg, port=0, tts_pipeline=pipe, host="127.0.0.1")
    assert orch.engine is engine and batcher is not None and batcher.max_batch == 4
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server.server_address[1], pipe
    server.shutdown()
    server.server_close()
    batcher.stop()
    orch.stop()
    thread.join(timeout=30)


def _post(port, path, body, timeout=300):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _prompt(seed, seconds):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal(int(rate * seconds))).astype(np.float32)
            for rate in (16_000, 24_000)]


def test_tts_round_trip_json_and_b64(tts_server):
    port, pipe = tts_server
    w16, w24 = _prompt(0, 0.7)
    k12.launch_count = 0
    bodies = [
        {"text": "json both ways", "prompt_wav_16k": w16.tolist(),
         "prompt_wav_24k": w24.tolist(), "max_new_tokens": 6},
        {"text": "b64 both ways", "max_new_tokens": 9, "wav_encoding": "b64",
         "prompt_wav_16k_b64": base64.b64encode(w16.astype("<f4").tobytes()).decode(),
         "prompt_wav_24k_b64": base64.b64encode(w24.astype("<f4").tobytes()).decode()},
    ]
    results = [None, None]

    def call(i):
        results[i] = _post(port, "/tts", bodies[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    (code_a, a), (code_b, b) = results
    assert code_a == 200 and code_b == 200, (a, b)
    wav_a = np.asarray(a["wav"], np.float32)
    wav_b = np.frombuffer(base64.b64decode(b["wav_b64"]), "<f4")
    assert b["dtype"] == "float32"
    for wav, info, n in ((wav_a, a["info"], 6), (wav_b, b["info"], 9)):
        assert info["semantic_tokens"] == n and wav.shape == (n * 480,)
        assert np.isfinite(wav).all() and wav.std() > 0
        assert info["batch"] in (1, 2) and info["t_s2a"] > 0
        assert info["t_frontend"] > 0 and info["t_lm"] > 0  # the phased stages' wall times
    # the masked batch path: the fixed-length attention kernel is never taken
    assert k12.launch_count == 0
    # the same request alone gives the same audio (same seed, same prompt)
    alone = pipe.synthesize_batch([{**bodies[0], "prompt_wav_16k": w16,
                                    "prompt_wav_24k": w24}], pad_to_batch=4)
    if a["info"]["batch"] == 1:
        np.testing.assert_array_equal(wav_a, alone[0][0])


def test_tts_bad_requests_and_the_other_routes(tts_server):
    port, _ = tts_server
    code, body = _post(port, "/tts", {"prompt_wav_16k": [0.0]})
    assert code == 400 and "bad request" in body["error"]
    code, body = _post(port, "/tts", {"text": "x", "prompt_wav_16k_b64": "AAA="})  # 2 bytes
    assert code == 400
    code, body = _post(port, "/generate", {"prompt": [3, 5, 7], "max_new_tokens": 3})
    assert code == 200 and len(body["tokens"]) == 3
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
        assert "serving_requests_completed" in resp.read().decode()
