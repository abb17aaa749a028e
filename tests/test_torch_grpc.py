"""The PyTorch package's gRPC front end (``infer/grpc_server.py``, ROADMAP
5.10) on the CPU, on ``127.0.0.1``: the cases of the JAX package's
``tests/test_serving.py:513`` (a streamed ``Decode``) and ``:548``
(``Synthesize`` in chunks of waveform).

- ``Decode``: the streamed greedy tokens of several concurrent requests equal,
  token for token, the JAX package's gRPC server's (its engine holding the
  same numpy-seeded weights) and the port's own ``POST /generate``'s; they
  arrive in more than one message; an empty request ends with an error;
- ``Synthesize``: a tiny pipeline's waveform, cut into chunks, put back
  together equals its ``synthesize`` output for the same request, bit for
  bit, with the sample rate and the info JSON on the last chunk;
- ``HealthCheck`` answers;
- the generated message module and the ``.proto`` are byte copies of the JAX
  package's (``tests/test_torch_port_hygiene.py`` holds the files equal).
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import torch_audio_helpers as h
import torch_port_helpers as ph
from maxtext_indextts2_tpu.infer import grpc_server as jax_grpc
from maxtext_indextts2_tpu.infer.server import Orchestrator as JaxOrchestrator
from maxtext_indextts2_tpu_torch.audio import pipeline as pl
from maxtext_indextts2_tpu_torch.infer import grpc_server as gs
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.infer.proto import orchestrator_pb2 as pb
from maxtext_indextts2_tpu_torch.infer.server import Orchestrator, make_server

grpc = pytest.importorskip("grpc")
torch.set_num_threads(1)

PROMPTS = [np.array([3, 5, 7], np.int32), ph.prompt(21, 9), ph.prompt(22, 14)]
NEW_TOKENS = [5, 11, 8]


@pytest.fixture(scope="module")
def engines():
    """(port engine, JAX engine) holding the same weights, 2 slots."""
    return ph.engine_pair(slots=2)


def _serve(orch, **kw):
    orch.start()
    server = gs.create_server(orch, port=0, host="127.0.0.1", **kw)
    server.start()
    return server


def _decode_all(port):
    """Every prompt's Decode stream, all requests at once."""
    chan = grpc.insecure_channel(f"127.0.0.1:{port}")
    stub = gs.OrchestratorStub(chan)
    out = [None] * len(PROMPTS)

    def call(i):
        out[i] = list(stub.Decode(pb.DecodeRequest(token_ids=PROMPTS[i].tolist(),
                                                   max_tokens=NEW_TOKENS[i]), timeout=120))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
    health = stub.HealthCheck(pb.HealthCheckRequest(), timeout=30)
    bad = list(stub.Decode(pb.DecodeRequest(), timeout=30))
    chan.close()
    return out, health, bad


def test_streaming_decode_equals_the_jax_grpc_server_and_generate(engines):
    eng, jeng = engines
    orch = Orchestrator(eng, steps_per_dispatch=2)
    server = _serve(orch)
    try:
        msgs, health, bad = _decode_all(server._mtt_port)
    finally:
        server.stop(grace=0)
        orch.stop()
    assert health.ok and health.queue_depth == 0
    assert bad[-1].done and "empty" in bad[-1].error
    streams = [[t for m in ms for t in m.token_ids] for ms in msgs]
    for ms, stream, n in zip(msgs, streams, NEW_TOKENS):
        assert ms[-1].done and not ms[-1].error and len(stream) == n
    assert len(msgs[1]) >= 2  # streamed: not all in the final message

    jorch = JaxOrchestrator(jeng)
    jorch.start()
    jserver = jax_grpc.create_server(jorch, port=0)
    jserver.start()
    try:
        jmsgs, jhealth, _ = _decode_all(jserver._mtt_port)
    finally:
        jserver.stop(grace=0)
        jorch.stop()
    assert jhealth.ok
    assert streams == [[t for m in ms for t in m.token_ids] for ms in jmsgs]

    httpd, horch, _ = make_server(eng.cfg, port=0, engine=eng, host="127.0.0.1")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        for p, n, stream in zip(PROMPTS, NEW_TOKENS, streams):
            body = json.dumps({"prompt": p.tolist(), "max_new_tokens": n}).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/generate",
                                         data=body, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                assert json.loads(resp.read())["tokens"] == stream
    finally:
        httpd.shutdown()
        httpd.server_close()
        horch.stop()
        thread.join(30)


@pytest.fixture(scope="module")
def pipeline():
    codebook = h.TINY["cond_codebook_size"]
    extra = [f"audio_codebook_size={codebook}", f"semantic_codebook_size={codebook}",
             "max_target_length=256", "max_prefill_predict_length=128",
             f"s2a_num_quantizers={h.TINY['num_quantizers']}",
             f"s2a_hidden_size={h.TINY['hidden_size']}",
             f"s2a_num_layers={h.TINY['num_layers']}", f"s2a_num_heads={h.TINY['num_heads']}",
             f"s2a_codebook_size={h.TINY['codebook_size']}",
             f"s2a_cond_codebook_size={codebook}", "s2a_timesteps=[2,1,1]"]
    cfg, _ = ph.configs(extra, slots=2)
    engine = Engine(cfg, device="cpu")
    engine.set_params({k: torch.from_numpy(v)
                       for k, v in ph.audio_only_lm_weights(cfg, 2).items()})
    return pl.build_tiny_pipeline(cfg, seed=3, device="cpu", engine=engine,
                                  codec_kwargs=h.TINY_CODEC)


def test_synthesize_streams_the_waveform_in_chunks(pipeline, monkeypatch):
    rng = np.random.default_rng(5)
    w16 = (0.1 * rng.standard_normal(11_200)).astype(np.float32)
    w24 = (0.1 * rng.standard_normal(16_800)).astype(np.float32)
    want, info = pipeline.synthesize("hello grpc", w16, w24, max_new_tokens=6)
    chunk = max(1, len(want) // 3 + 1)
    monkeypatch.setattr(gs, "_WAV_CHUNK_SAMPLES", chunk)
    orch = Orchestrator(pipeline.engine)
    server = _serve(orch, tts_pipeline=pipeline)
    try:
        chan = grpc.insecure_channel(f"127.0.0.1:{server._mtt_port}")
        stub = gs.OrchestratorStub(chan)
        msgs = list(stub.Synthesize(pb.SynthesizeRequest(
            text="hello grpc", prompt_wav_16k=w16.tolist(), prompt_wav_24k=w24.tolist(),
            max_new_tokens=6), timeout=300))
        assert stub.HealthCheck(pb.HealthCheckRequest(), timeout=30).ok
        chan.close()
    finally:
        server.stop(grace=0)
        orch.stop()
    assert len(msgs) == 3 and msgs[-1].done and not any(m.done for m in msgs[:-1])
    wav = np.concatenate([np.frombuffer(m.wav_f32le, "<f4") for m in msgs])
    np.testing.assert_array_equal(wav, np.asarray(want, np.float32).ravel())
    got_info = json.loads(msgs[-1].info_json)
    assert msgs[-1].sample_rate == int(info.get("sample_rate", 22050))
    assert got_info["semantic_tokens"] == info["semantic_tokens"] == 6


def test_synthesize_without_a_pipeline_and_on_a_bad_request(engines):
    class BadPipeline:
        def synthesize(self, text, w16, w24, max_new_tokens=256):
            raise ValueError("no such voice")

    eng, _ = engines
    for tts, error in ((None, "no TTS pipeline loaded"), (BadPipeline(), "bad request")):
        orch = Orchestrator(eng)
        server = _serve(orch, tts_pipeline=tts)
        try:
            chan = grpc.insecure_channel(f"127.0.0.1:{server._mtt_port}")
            msgs = list(gs.OrchestratorStub(chan).Synthesize(
                pb.SynthesizeRequest(text="x"), timeout=60))
            chan.close()
        finally:
            server.stop(grace=0)
            orch.stop()
        assert len(msgs) == 1 and msgs[0].done and error in msgs[0].error


def test_service_wiring_matches_the_jax_package():
    assert gs.SERVICE_NAME == jax_grpc.SERVICE_NAME == "mtt.serving.Orchestrator"
    assert gs._WAV_CHUNK_SAMPLES == jax_grpc._WAV_CHUNK_SAMPLES
    # one message schema: bytes written by one package parse in the other
    from maxtext_indextts2_tpu.infer.proto import orchestrator_pb2 as jpb

    msg = pb.DecodeResponse(token_ids=[1, 2, 3], done=True, error="e")
    assert jpb.DecodeResponse.FromString(msg.SerializeToString()) == msg
