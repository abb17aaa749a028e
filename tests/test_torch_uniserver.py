"""The port's UniServer (``infer/uniserver.py``, ROADMAP item 5.11) on the CPU.

The counterparts of the JAX package's ``tests/test_uniserver.py``: event-loop
correctness (partial reads, mid-request disconnects, oversized bodies,
streaming ndjson over a non-blocking socket, mixed TTS + LM admission through
the fused ``prefill_insert_many`` ladder), the device-side release of finished
slots and the engine's position saturation, the guards; and a greedy
``/generate`` stream equal to the JAX ``Engine.generate_stream`` on the same
(bridged) weights.
"""

import base64
import json
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

import torch

from maxtext_indextts2_tpu_torch.audio.pipeline import build_tiny_pipeline
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.infer.uniserver import UniServer
from torch_port_helpers import numpy_weights

CFG = [
    "vocab_size=9344", "audio_codebook_size=8192",
    "base_emb_dim=64", "base_mlp_dim=128", "base_num_decoder_layers=2",
    "base_num_query_heads=2", "base_num_kv_heads=2", "head_dim=32",
    "max_target_length=512", "max_prefill_predict_length=128",
    "per_device_batch_size=4", "dtype=float32", "decoder_block=tts",  # 4 slots
    "s2a_num_quantizers=4", "s2a_hidden_size=64", "s2a_num_layers=2",
    "s2a_num_heads=4", "s2a_codebook_size=64", "s2a_timesteps=[2,2,2,2]",
    "semantic_codebook_size=8192",
    # serving knobs kept small so warm() compiles a short ladder
    "tts_batch_max=2", "tts_batch_window_ms=30",
    "serving_admission_fusion_max=2", "serving_steps_per_dispatch=2",
    "tts_allow_force_frames=true",
]


@pytest.fixture(scope="module")
def served():
    """One warmed UniServer on an ephemeral port, loop in a thread.

    The event loop runs everything on that single thread (by design);
    running it in a pytest worker thread preserves the architecture —
    there is still exactly one thread touching the device.
    """
    cfg = load_config(CFG)
    engine = Engine(cfg, device="cpu")
    engine.set_params({k: torch.from_numpy(v) for k, v in numpy_weights(cfg, 4).items()})
    pipeline = build_tiny_pipeline(cfg, device="cpu", engine=engine)
    srv = UniServer(cfg, pipeline, port=0, host="127.0.0.1")
    srv.start()
    srv.warm(prompt_s=0.5, gen_tokens=8)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.stop()
    t.join(timeout=30)
    srv.close()


def _url(srv, path):
    return f"http://127.0.0.1:{srv.port}{path}"


def test_finished_slots_released_device_side(served):
    """A finished stream's slot must have its DEVICE-side active flag
    cleared (engine.release_slots batched path). Round-5 regression: slots
    were only freed host-side, so finished slots kept advancing pos; once
    any crossed max_target_length the ragged kernel DMA'd past the cache
    and halted the chip — the 'dies under sustained load' serving failure
    of rounds 3-5 (deterministic at 64 spd-16 dispatches)."""
    body = json.dumps({"prompt": [5, 6, 7], "max_new_tokens": 4}).encode()
    r = urllib.request.urlopen(
        urllib.request.Request(_url(served, "/generate"), body,
                               {"Content-Type": "application/json"}),
        timeout=60,
    )
    assert json.loads(r.read())["tokens"]
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        pend = list(served._to_release)
        active = np.asarray(served.decode_state["active"])
        if not pend and not active.any() and served._active() == 0:
            break
        time.sleep(0.1)
    else:
        raise AssertionError(
            f"slot not released: pending={served._to_release} "
            f"active={np.asarray(served.decode_state['active'])}"
        )


def test_generate_pos_saturates_at_cache_end():
    """Engine guard: an active-but-forgotten slot's pos must saturate at
    max_target_length-1 instead of running past the cache (the device-halt
    OOB that killed serving)."""
    cfg = load_config(CFG)
    engine = Engine(cfg, device="cpu")
    engine.load_params()
    state = engine.init_decode_state()
    prefix, _ = engine.prefill(np.asarray([3, 4, 5], np.int32), 3)
    state = engine.insert(prefix, state, 0)
    # drive far past the cache extent in fused steps
    cap = cfg.max_target_length
    for _ in range((cap // 8) + 4):
        state, _ = engine.generate_n(state, 8)
    pos = np.asarray(state["pos"])
    assert pos[0] == cap - 1, pos
    # and the batched release clears the flag in one dispatch
    state = engine.release_slots(state, [0])
    assert not np.asarray(state["active"]).any()


def _tts_body(max_new=8, text="hello", force_frames=True, seed=0):
    rng = np.random.default_rng(seed)
    w16 = (rng.standard_normal(8000) * 0.1).astype(np.float32)
    w24 = (rng.standard_normal(12000) * 0.1).astype(np.float32)
    return {
        "text": text,
        "prompt_wav_16k_b64": base64.b64encode(w16.tobytes()).decode(),
        "prompt_wav_24k_b64": base64.b64encode(w24.tobytes()).decode(),
        "max_new_tokens": max_new,
        "force_frames": force_frames,
        "wav_encoding": "b64",
    }


def _post(srv, path, obj, timeout=300):
    req = urllib.request.Request(
        _url(srv, path), data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def test_health(served):
    with urllib.request.urlopen(_url(served, "/health"), timeout=30) as r:
        body = json.loads(r.read())
    assert body["ok"] is True
    assert "active" in body


def test_tts_roundtrip(served):
    status, out = _post(served, "/tts", _tts_body(max_new=8))
    assert status == 200
    wav = np.frombuffer(base64.b64decode(out["wav_b64"]), np.float32)
    assert len(wav) > 0 and np.isfinite(wav).all()
    assert out["info"]["semantic_tokens"] >= 1


def test_tts_partial_reads(served):
    """A request trickled in over many small writes must parse exactly as
    one that arrived whole (non-blocking reads re-enter _read_conn)."""
    payload = json.dumps(_tts_body(max_new=6, seed=1)).encode()
    raw = (b"POST /tts HTTP/1.1\r\nHost: x\r\nContent-Type: application/json"
           b"\r\nContent-Length: " + str(len(payload)).encode() +
           b"\r\n\r\n" + payload)
    s = socket.create_connection(("127.0.0.1", served.port), timeout=300)
    try:
        # split mid-headers and mid-body
        for chunk in (raw[:20], raw[20:80], raw[80:200], raw[200:]):
            s.sendall(chunk)
            time.sleep(0.05)
        s.settimeout(300)
        resp = b""
        while True:
            b = s.recv(1 << 16)
            if not b:
                break
            resp += b
    finally:
        s.close()
    head, _, body = resp.partition(b"\r\n\r\n")
    assert b"200" in head.split(b"\r\n", 1)[0]
    out = json.loads(body)
    assert "wav_b64" in out


def test_disconnect_mid_request_does_not_wedge(served):
    """A client that sends half a request and vanishes must not wedge the
    loop; subsequent requests are served."""
    s = socket.create_connection(("127.0.0.1", served.port), timeout=30)
    s.sendall(b"POST /tts HTTP/1.1\r\nContent-Length: 500000\r\n\r\n{")
    time.sleep(0.1)
    s.close()
    status, out = _post(served, "/tts", _tts_body(max_new=6, seed=2))
    assert status == 200 and "wav_b64" in out


def test_oversized_body_rejected(served):
    s = socket.create_connection(("127.0.0.1", served.port), timeout=30)
    try:
        s.sendall(b"POST /tts HTTP/1.1\r\nContent-Length: "
                  + str(512 << 20).encode() + b"\r\n\r\n")
        s.settimeout(30)
        resp = b""
        try:
            while True:
                b = s.recv(4096)
                if not b:
                    break
                resp += b
        except OSError:
            pass
    finally:
        s.close()
    # server must close the connection without buffering 512 MB; the 413
    # flush is best-effort
    assert b"413" in resp or resp == b""
    # and keep serving
    status, out = _post(served, "/tts", _tts_body(max_new=6, seed=3))
    assert status == 200


def test_concurrent_tts_batches(served):
    """Concurrent /tts arrivals share S2A batches and fused admission."""
    before = dict(served.stats)
    results = [None] * 4
    errs = []

    def run(i):
        try:
            results[i] = _post(served, "/tts", _tts_body(max_new=6, seed=10 + i))
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    assert not errs
    for status, out in results:
        assert status == 200 and "wav_b64" in out
    d_req = served.stats["requests_completed"] - before["requests_completed"]
    d_s2a = served.stats["s2a_batches"] - before["s2a_batches"]
    assert d_req >= 4
    # tts_batch_max=2: 4 requests need at least 2 S2A batches but strictly
    # fewer than one per request only if batching happened at least once
    assert d_s2a <= d_req - 1, "no batching happened at all"


def test_generate_budget_termination(served):
    status, out = _post(served, "/generate",
                        {"prompt": [3, 5, 7], "max_new_tokens": 9})
    assert status == 200
    assert len(out["tokens"]) == 9


def test_generate_eos_termination(served):
    """A stream whose decode emits eos_id terminates before its budget."""
    eos = 17
    orig = served.engine.generate_n

    def fake(state, n):
        toks = torch.full((n, served.engine.num_slots), eos, dtype=torch.int32)
        return state, toks

    served.engine.generate_n = fake
    try:
        status, out = _post(served, "/generate",
                            {"prompt": [3, 5], "max_new_tokens": 50,
                             "eos_id": eos})
    finally:
        served.engine.generate_n = orig
    assert status == 200
    toks = out["tokens"]
    assert len(toks) < 50
    assert toks[-1] == eos


def test_generate_stream_ndjson(served):
    req = urllib.request.Request(
        _url(served, "/generate_stream"),
        data=json.dumps({"prompt": [2, 4, 6], "max_new_tokens": 7}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.status == 200
        lines = [json.loads(ln) for ln in r.read().splitlines() if ln.strip()]
    assert len(lines) == 7
    assert all("token" in ln for ln in lines)


def test_generate_mixed_with_tts(served):
    """LM and TTS streams co-admitted through the same fused ladder."""
    out_lm = {}
    out_tts = {}

    def lm():
        out_lm["r"] = _post(served, "/generate",
                            {"prompt": [9, 8, 7], "max_new_tokens": 6})

    def tts():
        out_tts["r"] = _post(served, "/tts", _tts_body(max_new=6, seed=42))

    t1, t2 = threading.Thread(target=lm), threading.Thread(target=tts)
    t1.start(); t2.start()
    t1.join(timeout=600); t2.join(timeout=600)
    assert out_lm["r"][0] == 200 and len(out_lm["r"][1]["tokens"]) == 6
    assert out_tts["r"][0] == 200 and "wav_b64" in out_tts["r"][1]


def test_metrics_endpoint(served):
    with urllib.request.urlopen(_url(served, "/metrics"), timeout=30) as r:
        text = r.read().decode()
    assert "serving_requests_total" in text
    assert "serving_active_slots" in text
    assert "serving_queue_depth" in text


def test_not_found_and_bad_json(served):
    req = urllib.request.Request(_url(served, "/nope"), data=b"{}")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 404
    req = urllib.request.Request(_url(served, "/generate"), data=b"not json")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400


def test_paged_and_disaggregated_guards(served):
    cfg_paged = load_config(CFG + ["paged_attention=true"])
    with pytest.raises(ValueError, match="paged"):
        UniServer(cfg_paged, served.pipeline)
    cfg_dis = load_config(CFG + ["serving_mode=disaggregated"])
    with pytest.raises(ValueError, match="interleaved"):
        UniServer(cfg_dis, served.pipeline)


def test_generate_stream_equals_the_jax_engine(served):
    """A greedy ``/generate`` stream is the JAX ``Engine.generate_stream``
    of the same prompt on the same weights, token for token."""
    from maxtext_indextts2_tpu.config import load_config as jax_load_config
    from maxtext_indextts2_tpu.infer.engine import Engine as JaxEngine
    from torch_port_helpers import jax_tree

    jcfg = jax_load_config([a for a in CFG if not a.startswith("per_device_batch_size")]
                           + ["per_device_batch_size=0.5", "scan_layers=false"])
    jeng = JaxEngine(jcfg, params=jax_tree(numpy_weights(served.cfg, 4)))
    for p, n in (([3, 5, 7, 11, 13], 12), ([400, 9000, 17], 9)):
        status, out = _post(served, "/generate", {"prompt": p, "max_new_tokens": n})
        assert status == 200
        want = jeng.generate_stream(np.asarray(p, np.int32), n)
        assert out["tokens"] == want and len(set(want)) > 2


def test_metrics_carry_the_stage_clock(served):
    """``/metrics`` carries the stage clock (each stage's summed and worst
    seconds), which adds up to the loop's time."""
    with urllib.request.urlopen(_url(served, "/metrics"), timeout=30) as r:
        text = r.read().decode()
    for stage in ("sockets", "admit", "decode", "s2a", "idle"):
        assert f"serving_stage_{stage}_seconds" in text
        assert f"serving_stage_{stage}_max_seconds" in text
    assert sum(served.stage_s.values()) > 0
    assert served._dev_mem() == {}  # the CPU has no caching allocator to read
