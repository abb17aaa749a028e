"""gRPC serving front end for the continuous-batching orchestrator.

Counterpart of the JAX package's ``infer/grpc_server.py``: the same
``Orchestrator`` that backs the HTTP/JSON server (``infer/server.py``) is
exposed over gRPC as the service ``mtt.serving.Orchestrator``, with three
rpcs: a server-streaming ``Decode`` (the first token as soon as its prefill
and insert are done, then one message for every group of tokens ready
together), a server-streaming ``Synthesize`` (a TTS pipeline's waveform in
chunks of at most ``_WAV_CHUNK_SAMPLES`` float32 samples, the info JSON on
the last), and ``HealthCheck``.

The message classes are protoc's output (``infer/proto/``, byte copies of
the JAX package's); the service and the stub are wired by hand with
``grpc.method_handlers_generic_handler``, as generated ``*_pb2_grpc.py``
files would. ``grpc`` and the generated module (``google.protobuf``) are
imported inside the functions that use them.

CLI (GPU unless ``device=cpu``)::

    python -m maxtext_indextts2_tpu_torch.infer.grpc_server <cfg.yml> [key=value ...] [device=cpu]
"""

from __future__ import annotations

import json
import queue
import sys
from concurrent import futures

import numpy as np

from maxtext_indextts2_tpu_torch.config import Config
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.infer.server import Orchestrator, split_device_arg

SERVICE_NAME = "mtt.serving.Orchestrator"

# Keep streamed waveform messages well under gRPC's 4 MiB default cap.
_WAV_CHUNK_SAMPLES = 500_000  # 2 MB of f32


def _pb():
    from maxtext_indextts2_tpu_torch.infer.proto import orchestrator_pb2

    return orchestrator_pb2


class OrchestratorService:
    """Servicer backing the three rpcs; holds the shared orchestrator."""

    def __init__(self, orch: Orchestrator, tts_pipeline=None):
        self.orch = orch
        self.tts_pipeline = tts_pipeline

    # -------------------------------------------------------------- Decode
    def Decode(self, request, context):
        pb = _pb()
        if not request.token_ids:
            yield pb.DecodeResponse(done=True, error="empty token_ids")
            return
        req = self.orch.submit(
            np.asarray(request.token_ids, np.int32),
            int(request.max_tokens) if request.max_tokens else 32,
            stream=True,
        )
        finished = False
        while not finished:
            tok = req.stream_q.get()
            chunk: list[int] = []
            if tok is None:
                finished = True
            else:
                chunk.append(tok)
                # every token already emitted goes into this message: a
                # dispatch decodes several steps at once
                while True:
                    try:
                        nxt = req.stream_q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:
                        finished = True
                        break
                    chunk.append(nxt)
            if chunk or finished:
                yield pb.DecodeResponse(token_ids=chunk, done=finished, error=req.error or "")

    # ---------------------------------------------------------- Synthesize
    def Synthesize(self, request, context):
        pb = _pb()
        if self.tts_pipeline is None:
            yield pb.SynthesizeResponse(done=True, error="no TTS pipeline loaded")
            return
        try:
            wav, info = self.tts_pipeline.synthesize(
                request.text,
                np.asarray(request.prompt_wav_16k, np.float32),
                np.asarray(request.prompt_wav_24k, np.float32),
                max_new_tokens=int(request.max_new_tokens) if request.max_new_tokens else 256,
            )
        except (KeyError, ValueError) as e:
            yield pb.SynthesizeResponse(done=True, error=f"bad request: {e}")
            return
        wav = np.asarray(wav, np.float32).ravel()
        sr = int(info.get("sample_rate", 22050)) if isinstance(info, dict) else 22050
        for start in range(0, max(len(wav), 1), _WAV_CHUNK_SAMPLES):
            piece = wav[start:start + _WAV_CHUNK_SAMPLES]
            last = start + _WAV_CHUNK_SAMPLES >= len(wav)
            yield pb.SynthesizeResponse(
                wav_f32le=piece.astype("<f4").tobytes(),
                sample_rate=sr,
                done=last,
                info_json=json.dumps(info) if last else "",
            )

    # --------------------------------------------------------- HealthCheck
    def HealthCheck(self, request, context):
        return _pb().HealthCheckResponse(
            ok=True,
            active_slots=self.orch.active_slots(),
            queue_depth=self.orch.queue.qsize(),
        )


def _handlers(svc: OrchestratorService):
    import grpc

    pb = _pb()
    return grpc.method_handlers_generic_handler(
        SERVICE_NAME,
        {
            "Decode": grpc.unary_stream_rpc_method_handler(
                svc.Decode,
                request_deserializer=pb.DecodeRequest.FromString,
                response_serializer=pb.DecodeResponse.SerializeToString,
            ),
            "Synthesize": grpc.unary_stream_rpc_method_handler(
                svc.Synthesize,
                request_deserializer=pb.SynthesizeRequest.FromString,
                response_serializer=pb.SynthesizeResponse.SerializeToString,
            ),
            "HealthCheck": grpc.unary_unary_rpc_method_handler(
                svc.HealthCheck,
                request_deserializer=pb.HealthCheckRequest.FromString,
                response_serializer=pb.HealthCheckResponse.SerializeToString,
            ),
        },
    )


class OrchestratorStub:
    """Client stub (what a generated ``*_pb2_grpc`` stub would be)."""

    def __init__(self, channel):
        pb = _pb()
        self.Decode = channel.unary_stream(
            f"/{SERVICE_NAME}/Decode",
            request_serializer=pb.DecodeRequest.SerializeToString,
            response_deserializer=pb.DecodeResponse.FromString,
        )
        self.Synthesize = channel.unary_stream(
            f"/{SERVICE_NAME}/Synthesize",
            request_serializer=pb.SynthesizeRequest.SerializeToString,
            response_deserializer=pb.SynthesizeResponse.FromString,
        )
        self.HealthCheck = channel.unary_unary(
            f"/{SERVICE_NAME}/HealthCheck",
            request_serializer=pb.HealthCheckRequest.SerializeToString,
            response_deserializer=pb.HealthCheckResponse.FromString,
        )


def create_server(orch: Orchestrator, tts_pipeline=None, port: int = 9000,
                  max_workers: int = 64, host: str = "[::]"):
    """Build (but do not start) a ``grpc.Server`` bound to ``host:port``.

    The orchestrator must already be started by the caller; one orchestrator
    can serve the HTTP and the gRPC front ends. ``port=0`` asks the system
    for a free port (``server._mtt_port`` holds the one bound)."""
    import grpc

    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=[("grpc.max_send_message_length", 64 * 1024 * 1024)],
    )
    server.add_generic_rpc_handlers((_handlers(OrchestratorService(orch, tts_pipeline)),))
    server._mtt_port = server.add_insecure_port(f"{host}:{port}")
    return server


def serve_grpc(cfg: Config, port: int | None = None, engine: Engine | None = None,
               tts_pipeline=None, device=None):
    """Blocking gRPC server entry point."""
    orch = Orchestrator(
        engine or (tts_pipeline.engine if tts_pipeline else Engine(cfg, device=device)),
        steps_per_dispatch=cfg.serving_steps_per_dispatch,
        mode=cfg.serving_mode,
        admission_fusion_max=cfg.serving_admission_fusion_max,
    )
    orch.start()
    server = create_server(orch, tts_pipeline, port=port or cfg.inference_server_port)
    server.start()
    try:
        server.wait_for_termination()
    finally:
        server.stop(grace=1)
        orch.stop()


def main(argv=None):
    from maxtext_indextts2_tpu_torch.config import load_config

    argv, device = split_device_arg(list(sys.argv[1:] if argv is None else argv))
    cfg = load_config(argv)
    print(f"gRPC serving on :{cfg.inference_server_port}")
    serve_grpc(cfg, device=device)


if __name__ == "__main__":
    main()
