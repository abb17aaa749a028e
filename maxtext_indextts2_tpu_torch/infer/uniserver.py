"""Single-threaded event-loop TTS server: sockets and device on ONE thread.

Counterpart of the JAX package's ``infer/uniserver.py``: a selectors-based
non-blocking HTTP front end multiplexed with the continuous-batching decode
loop, fused admission and the batched TTS stages, all on the caller's
thread, over this package's ``Engine`` and ``TTSPipeline``
(``prefill_insert_many``, ``generate_n``, ``release_slots``,
``refresh_decode``; ``frontend_batch``, ``text_and_prompt_to_lm_prompt``,
``map_semantic``, ``s2a_vocoder_batch``). The only blocking calls are device
calls, and one thread launches every kernel and replays every captured decode
graph (``infer/cuda_graphs.py``): ``warm()`` captures the decode dispatch
and runs every fused-admission size and TTS batch size before READY, so no
capture or kernel build lands on a live request. The threaded server
(``infer/server.py``) serves the same endpoints with helper threads.

Endpoints (HTTP/1.1, Connection: close):
  GET  /health                 -> {"ok": true, "active": N}
  GET  /metrics                -> prometheus text exposition (counters, and
       the stage clock: ``serving_stage_<stage>_seconds`` summed and
       ``serving_stage_<stage>_max_seconds`` the worst pass, for the stages
       sockets, admit, decode, s2a and idle)
  POST /tts {text, prompt_wav_16k_b64, prompt_wav_24k_b64,
             max_new_tokens?, force_frames?, wav_encoding: "b64"}
       -> {"wav_b64": ..., "info": {...}}
  POST /generate {prompt: [ids], max_new_tokens?, eos_id?}
       -> {"tokens": [...]}
  POST /generate_stream        -> ndjson {"token": t} per line; an error
       line ends a failed stream. LM streams share decode slots and the fused
       admission ladder with TTS streams.

Paged and disaggregated configs are refused, as in the JAX package: their
admission is the threaded server's.

Run (the GPU unless ``device=cpu``; a seeded tiny pipeline sized by the
config's ``s2a_*`` keys, as the JAX module builds)::

    python -m maxtext_indextts2_tpu_torch.infer.uniserver <config.yml> [key=value ...] \
        [port=N] [device=cpu] [supervise=1]
"""

from __future__ import annotations

import base64
import json
import selectors
import socket
import time

import numpy as np

import torch

from maxtext_indextts2_tpu_torch.config import Config


def _pow2ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class _Conn:
    """One client connection's read/write state (non-blocking)."""

    __slots__ = ("sock", "rbuf", "wbuf", "need", "headers_done", "hold")

    def __init__(self, sock):
        self.sock = sock
        self.rbuf = b""
        self.wbuf = b""
        self.need = None  # total bytes (headers + body) once known
        self.headers_done = False
        self.hold = False  # streaming response: keep open on empty wbuf


class _Stream:
    """One in-flight request (TTS synthesis or token-LM generation)."""

    __slots__ = ("conn", "body", "sem", "ac", "lm_prompt", "max_new",
                 "force_frames", "tokens", "slot", "t_arrive", "kind",
                 "stream", "eos_id")

    def __init__(self, conn, body, t_arrive, kind="tts", stream=False):
        self.conn = conn
        self.body = body
        self.sem = None
        self.ac = None
        self.lm_prompt = None
        self.max_new = 0
        self.force_frames = False
        self.tokens: list[int] = []
        self.slot = -1
        self.t_arrive = t_arrive
        self.kind = kind        # "tts" | "lm"
        self.stream = stream    # ndjson per-token streaming (/generate_stream)
        self.eos_id = None


class UniServer:
    """Single-threaded serving executor. Call serve_forever() from the
    thread that owns the device (usually the main thread)."""

    def __init__(self, cfg: Config, pipeline, port: int | None = None, host: str = "0.0.0.0"):
        # UniServer admits unconditionally via fused prefill_insert_many
        # with plain slot bookkeeping -- no page reservation. Paged and
        # disaggregated configs belong to the threaded server's
        # sequential-admission path (infer/server.py).
        if cfg.paged_attention:
            raise ValueError("UniServer does not support paged_attention; "
                             "use infer.server (sequential admission)")
        if cfg.serving_mode != "interleaved":
            raise ValueError(f"UniServer supports interleaved serving only, "
                             f"got serving_mode={cfg.serving_mode!r}")
        self.cfg = cfg
        self.pipeline = pipeline
        self.engine = pipeline.engine
        self.port = port if port is not None else cfg.inference_server_port
        self.host = host
        self.spd = max(1, cfg.serving_steps_per_dispatch)
        self.batch_max = max(1, cfg.tts_batch_max)
        self.window_s = cfg.tts_batch_window_ms / 1e3
        self.fuse_max = max(1, cfg.serving_admission_fusion_max)
        # b64 float32 prompt audio for minutes of speech fits well below
        self.max_body = 64 << 20
        self.eos_id = None  # audio streams terminate via map_semantic
        self.stats = {"requests_total": 0, "requests_completed": 0,
                      "decode_dispatches": 0, "s2a_batches": 0,
                      "errors": 0}
        # cumulative wall-seconds per loop stage (the event loop is serial,
        # so these sum to ~uptime and read as a utilization profile)
        self.stage_s = {"sockets": 0.0, "admit": 0.0, "decode": 0.0,
                        "s2a": 0.0, "idle": 0.0}
        # worst single pass per stage: a multi-second max is a stall (a
        # kernel build or capture on a live request), and the listen backlog
        # overflows into connect timeouts only while the loop stops accepting
        self.stage_max = {k: 0.0 for k in self.stage_s}
        self._sel = selectors.DefaultSelector()
        self._pending: list[_Stream] = []   # parsed, awaiting frontend+admit
        self._pending_t0 = None
        self._lm_done: list[_Stream] = []   # LM finished, awaiting S2A batch
        self._lm_done_t0 = None
        self._slots: list[_Stream | None] = [None] * self.engine.num_slots
        self._remaining = np.zeros(self.engine.num_slots, np.int64)
        self._to_release: list[int] = []  # finished slots awaiting batched
        # device-side release (engine.release_slots): a finished slot left
        # active burns ragged-attention work and, before the engine's pos
        # saturation guard, advanced past the cache end and halted the chip
        self._stop = False
        self.decode_state = None
        self._lsock = None

    # ------------------------------------------------------------ lifecycle
    def start(self):
        if self.engine.params is None:
            self.engine.load_params()
        self.decode_state = self.engine.init_decode_state()
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((self.host, self.port))
        self.port = self._lsock.getsockname()[1]  # resolve port=0 (tests)
        self._lsock.listen(512)
        self._lsock.setblocking(False)
        self._sel.register(self._lsock, selectors.EVENT_READ, None)

    def stop(self):
        self._stop = True

    def close(self):
        for key in list(self._sel.get_map().values()):
            try:
                key.fileobj.close()
            except OSError:
                pass
        self._sel.close()

    def serve_forever(self, deadline_s: float | None = None):
        """The event loop: socket IO and device work interleaved on THIS
        thread. deadline_s bounds the run (benches/tests)."""
        t_end = time.monotonic() + deadline_s if deadline_s else None
        st = self.stage_s
        while not self._stop:
            t0 = time.monotonic()
            if t_end is not None and t0 >= t_end:
                break
            busy = self._poll_sockets()
            t1 = time.monotonic()
            busy |= self._admit_ready()
            t2 = time.monotonic()
            busy |= self._decode_round()
            t3 = time.monotonic()
            busy |= self._s2a_round()
            t4 = time.monotonic()
            self._flush_writes()
            st["sockets"] += t1 - t0
            st["admit"] += t2 - t1
            st["decode"] += t3 - t2
            st["s2a"] += t4 - t3
            mx = self.stage_max
            mx["sockets"] = max(mx["sockets"], t1 - t0)
            mx["admit"] = max(mx["admit"], t2 - t1)
            mx["decode"] = max(mx["decode"], t3 - t2)
            mx["s2a"] = max(mx["s2a"], t4 - t3)
            if not busy:
                # idle: block in the selector (not a sleep) so arrivals wake
                # the loop immediately
                self._poll_sockets(timeout=0.02)
                st["idle"] += time.monotonic() - t4

    # -------------------------------------------------------------- sockets
    def _poll_sockets(self, timeout: float = 0.0) -> bool:
        busy = False
        for key, mask in self._sel.select(timeout):
            if key.data is None:
                # drain the accept queue: the listener shows up once per
                # select, and one accept per serve-loop cycle would cap new
                # connections at one a cycle while the backlog overflows
                while True:
                    try:
                        sock, _ = self._lsock.accept()
                    except OSError:
                        break
                    sock.setblocking(False)
                    self._sel.register(sock, selectors.EVENT_READ,
                                       _Conn(sock))
                    busy = True
                continue
            conn: _Conn = key.data
            if mask & selectors.EVENT_READ:
                busy |= self._read_conn(conn)
            if mask & selectors.EVENT_WRITE:
                busy |= self._write_conn(conn)
        return busy

    def _read_conn(self, conn: _Conn) -> bool:
        # drain: one 64 KB recv per serve-loop cycle meant a ~230 KB /tts
        # body (b64 prompt audio) took 4+ cycles (>1 s under load) just to
        # upload
        chunks = []
        while True:
            try:
                data = conn.sock.recv(1 << 18)
            except BlockingIOError:
                break
            except OSError:
                self._drop(conn)
                return True
            if not data:
                if not chunks:
                    self._drop(conn)
                    return True
                break
            chunks.append(data)
            if len(data) < (1 << 18):
                break
        if not chunks:
            return False
        conn.rbuf += b"".join(chunks)
        if conn.need is None and b"\r\n\r\n" not in conn.rbuf \
                and len(conn.rbuf) > (64 << 10):
            self._drop(conn)  # runaway headers
            return True
        if conn.need is None and b"\r\n\r\n" in conn.rbuf:
            head, _, _ = conn.rbuf.partition(b"\r\n\r\n")
            clen = 0
            for line in head.split(b"\r\n")[1:]:
                k, _, v = line.partition(b":")
                if k.strip().lower() == b"content-length":
                    clen = int(v.strip() or 0)
            if clen > self.max_body:
                # reject before buffering: best-effort flush, then close
                self._respond(conn, 413, {"error": "body too large"})
                self._write_conn(conn)
                self._drop(conn)
                return True
            conn.need = len(head) + 4 + clen
        if conn.need is not None and len(conn.rbuf) >= conn.need:
            self._handle_request(conn)
            return True
        return False

    def _handle_request(self, conn: _Conn):
        raw, conn.rbuf = conn.rbuf[:conn.need], conn.rbuf[conn.need:]
        conn.need = None
        head, _, body_bytes = raw.partition(b"\r\n\r\n")
        request_line = head.split(b"\r\n", 1)[0].decode("latin-1")
        parts = request_line.split()
        method, path = (parts + ["", ""])[:2]
        if method == "GET" and path == "/health":
            self._respond(conn, 200, {"ok": True, "active": self._active()})
            return
        if method == "GET" and path == "/metrics":
            self._respond_raw(conn, 200, self.metrics_text().encode(),
                              ctype="text/plain; version=0.0.4")
            return
        if method != "POST" or path not in ("/tts", "/generate",
                                            "/generate_stream"):
            self._respond(conn, 404, {"error": "not found"})
            return
        try:
            body = json.loads(body_bytes)
            overshoot = self.spd - 1
            budget = (self.cfg.max_target_length - overshoot)
            if path == "/tts":
                st = _Stream(conn, body, time.perf_counter())
                st.max_new = min(int(body.get("max_new_tokens", 256)), budget)
                st.force_frames = bool(body.get("force_frames")) and \
                    self.cfg.tts_allow_force_frames
            else:
                st = _Stream(conn, body, time.perf_counter(), kind="lm",
                             stream=(path == "/generate_stream"))
                st.lm_prompt = np.asarray(body["prompt"], np.int32)
                if st.lm_prompt.ndim != 1 or st.lm_prompt.size == 0:
                    raise ValueError("prompt must be a non-empty 1-d id list")
                st.max_new = min(int(body.get("max_new_tokens", 32)), budget)
                if body.get("eos_id") is not None:
                    st.eos_id = int(body["eos_id"])
            self.stats["requests_total"] += 1
            self._pending.append(st)
            if self._pending_t0 is None:
                self._pending_t0 = time.monotonic()
        except Exception as e:  # noqa: BLE001 - bad request
            self._respond(conn, 400, {"error": repr(e)[:300]})

    def metrics_text(self) -> str:
        """Prometheus text exposition format (stdlib-only), mirroring
        Orchestrator.metrics_text (reference: maxengine_server prometheus)."""
        lines = []
        for k, v in self.stats.items():
            lines.append(f"# TYPE serving_{k} counter")
            lines.append(f"serving_{k} {v}")
        lines.append("# TYPE serving_active_slots gauge")
        lines.append(f"serving_active_slots {self._active()}")
        lines.append("# TYPE serving_queue_depth gauge")
        lines.append(f"serving_queue_depth {len(self._pending)}")
        for k, v in self.stage_s.items():
            lines.append(f"# TYPE serving_stage_{k}_seconds counter")
            lines.append(f"serving_stage_{k}_seconds {v:.3f}")
        for k, v in self.stage_max.items():
            lines.append(f"# TYPE serving_stage_{k}_max_seconds gauge")
            lines.append(f"serving_stage_{k}_max_seconds {v:.3f}")
        return "\n".join(lines) + "\n"

    def _respond(self, conn: _Conn, status: int, obj: dict):
        self._respond_raw(conn, status, json.dumps(obj).encode())

    def _respond_raw(self, conn: _Conn, status: int, payload: bytes,
                     ctype: str = "application/json"):
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  413: "Payload Too Large",
                  500: "Internal Server Error"}.get(status, "OK")
        conn.hold = False
        conn.wbuf += (
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {ctype}\r\nContent-Length: "
            f"{len(payload)}\r\nConnection: close\r\n\r\n"
        ).encode() + payload
        self._want_write(conn)

    def _begin_stream(self, conn: _Conn):
        """Streaming ndjson response: headers out immediately, no
        Content-Length - Connection: close delimits the body."""
        conn.hold = True
        conn.wbuf += (b"HTTP/1.1 200 OK\r\nContent-Type: "
                      b"application/x-ndjson\r\nConnection: close\r\n\r\n")
        self._want_write(conn)

    def _stream_line(self, conn: _Conn, obj: dict):
        conn.wbuf += json.dumps(obj).encode() + b"\n"
        self._want_write(conn)

    def _end_stream(self, conn: _Conn):
        conn.hold = False
        if not conn.wbuf:
            self._drop(conn)
        # else: _write_conn drops once wbuf drains (hold cleared)

    def _want_write(self, conn: _Conn):
        try:
            self._sel.modify(conn.sock, selectors.EVENT_READ |
                             selectors.EVENT_WRITE, conn)
        except (KeyError, ValueError, OSError):
            pass

    def _write_conn(self, conn: _Conn) -> bool:
        if not conn.wbuf:
            return False
        try:
            n = conn.sock.send(conn.wbuf)
        except BlockingIOError:
            return False
        except OSError:
            self._drop(conn)
            return True
        conn.wbuf = conn.wbuf[n:]
        if not conn.wbuf and not conn.hold:
            self._drop(conn)  # Connection: close
        return True

    def _flush_writes(self):
        for key in list(self._sel.get_map().values()):
            if isinstance(key.data, _Conn) and key.data.wbuf:
                self._write_conn(key.data)

    def _drop(self, conn: _Conn):
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    # -------------------------------------------------------------- serving
    def _dev_mem(self) -> dict:
        """The caching allocator's bytes in use and their peak (the JAX
        module's device memory stats)."""
        try:
            if self.engine.device.type != "cuda":
                return {}
            s = torch.cuda.memory_stats(self.engine.device)
            return {"bytes_in_use": s.get("allocated_bytes.all.current", 0),
                    "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0)}
        except Exception:  # noqa: BLE001 - diagnostics are best-effort
            return {}

    def _active(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def warm(self, prompt_s: float = 1.0, gen_tokens: int = 250):
        """Run every steady-state device path once before serving: the pow2
        BATCH ladder for frontend and S2A/vocoder, the fused-admission ladder
        (k prompts at once), and the decode dispatch of ``serving_steps_per_
        dispatch`` steps, which is CAPTURED here (its first dispatch runs
        eagerly and captures; every later one replays). Kernel builds,
        cuBLAS handles and the capture never land on a live request. The
        warm streams are released, not replaced by a new decode state: the
        captured graph reads this state's tensors."""
        w16 = np.zeros(int(16_000 * prompt_s), np.float32)
        w24 = np.zeros(int(24_000 * prompt_s), np.float32)
        body = {"text": "warmup sentence for the serving executor",
                "prompt_wav_16k": w16, "prompt_wav_24k": w24}
        # pow2 batch ladder (underfilled batches pad to the next pow2, not
        # to batch_max -- see _admit_ready/_s2a_round)
        b = 1
        sems = acs = None
        while b <= self.batch_max:
            sems, acs = self.pipeline.frontend_batch(
                [dict(body) for _ in range(b)], pad_to_batch=b)
            self.pipeline.s2a_vocoder_batch(
                [body], sems[:1], acs[:1], [[1] * gen_tokens],
                pad_to_batch=b)
            b *= 2
        lm_prompt = self.pipeline.text_and_prompt_to_lm_prompt(
            body["text"], sems[0])
        bucket = self.cfg.max_prefill_predict_length
        state = self.decode_state
        k = 1
        while k <= self.fuse_max and k <= self.engine.num_slots and \
                k * len(lm_prompt) <= bucket:
            lb = min(max(_pow2ceil(k * len(lm_prompt)), 256), bucket)
            state, _ = self.engine.prefill_insert_many(
                state, [lm_prompt] * k, list(range(k)), bucket=lb)
            k *= 2
        state, _ = self.engine.generate_n(state, self.spd)  # eager, then captured
        state, _ = self.engine.generate_n(state, self.spd)  # a replay
        # warm streams must not leak into serving: every slot released (an
        # insert resets a slot's cache rows, segment ids and position)
        self.decode_state = self.engine.release_slots(state, range(self.engine.num_slots))

    def _admit_ready(self) -> bool:
        """Window-gated: frontend the pending batch, build LM prompts, admit
        via fused prefill_insert_many groups."""
        if not self._pending:
            return False
        waited = time.monotonic() - (self._pending_t0 or 0)
        free = self._free_slots()
        if len(self._pending) < self.batch_max and waited < self.window_s:
            return False
        if not free:
            return False
        batch = self._pending[: min(self.batch_max, len(free))]
        del self._pending[: len(batch)]
        self._pending_t0 = time.monotonic() if self._pending else None
        tts_batch = [st for st in batch if st.kind == "tts"]
        if tts_batch:
            # pow2 batch bucket: a trickle-rate group of 3 pads to 4, not
            # to batch_max: padded rows are real compute. warm() runs the
            # ladder.
            fb = min(_pow2ceil(len(tts_batch)), self.batch_max)
            try:
                bodies = []
                for st in tts_batch:
                    b = dict(st.body)
                    if "prompt_wav_16k_b64" in b:
                        b["prompt_wav_16k"] = np.frombuffer(
                            base64.b64decode(b["prompt_wav_16k_b64"]),
                            np.float32)
                    if "prompt_wav_24k_b64" in b:
                        b["prompt_wav_24k"] = np.frombuffer(
                            base64.b64decode(b["prompt_wav_24k_b64"]),
                            np.float32)
                    bodies.append(b)
                sems, acs = self.pipeline.frontend_batch(
                    bodies, pad_to_batch=fb)
                for st, sem, ac in zip(tts_batch, sems, acs):
                    st.sem, st.ac = sem, ac
                    st.lm_prompt = self.pipeline.text_and_prompt_to_lm_prompt(
                        st.body.get("text", ""), sem)
            except Exception as e:  # noqa: BLE001 - fail the TTS cohort;
                # co-arrived /generate requests proceed
                for st in tts_batch:
                    self._fail(st, e)
                batch = [st for st in batch if st.kind != "tts"]
        for st in batch:
            st.max_new = min(
                st.max_new,
                self.cfg.max_target_length - len(st.lm_prompt) -
                (self.spd - 1),
            )
        # fused admission in power-of-two groups (one executable per size)
        bucket = self.cfg.max_prefill_predict_length
        todo = [st for st in batch if len(st.lm_prompt) <= bucket]
        for st in batch:
            if len(st.lm_prompt) > bucket:
                self._fail(st, ValueError("prompt exceeds prefill bucket"))
        while todo:
            free = self._free_slots()
            k, plen = 0, 0
            limit = min(len(free), self.fuse_max, len(todo))
            while k < limit and plen + len(todo[k].lm_prompt) <= bucket:
                plen += len(todo[k].lm_prompt)
                k += 1
            k = 1 << (max(k, 1).bit_length() - 1)  # largest pow2 <= k
            # pow2 LENGTH bound for the packed prefill, as in the JAX
            # module (the engine pads nothing: the bound only caps the pack)
            plen_k = sum(len(st.lm_prompt) for st in todo[:k])
            lbucket = min(max(_pow2ceil(plen_k), 256), bucket)
            group, todo = todo[:k], todo[k:]
            slots = free[:k]
            # a reused slot must not sit in the pending-release list: the
            # insert below re-activates it, and a later batched release
            # would kill the LIVE stream
            self._to_release = [s for s in self._to_release
                                if s not in slots]
            try:
                self.decode_state, firsts = self.engine.prefill_insert_many(
                    self.decode_state, [st.lm_prompt for st in group], slots,
                    bucket=lbucket)
                firsts = firsts.cpu().numpy()
            except Exception as e:  # noqa: BLE001
                for st in group + todo:
                    self._fail(st, e)
                return True
            for st, slot, tok in zip(group, slots, firsts):
                st.slot = slot
                st.tokens = [int(tok)]
                self._slots[slot] = st
                self._remaining[slot] = st.max_new - 1
                if st.stream:
                    # headers + first token leave as soon as admission
                    # lands: clients measure true TTFB
                    self._begin_stream(st.conn)
                    self._stream_line(st.conn, {"token": int(tok)})
                if self._remaining[slot] <= 0 or (
                        st.eos_id is not None and int(tok) == st.eos_id):
                    self._finish_lm(slot)
        return True

    def _decode_round(self) -> bool:
        if self._to_release:
            # one dispatch clears every slot that finished since the last
            # round (release before generate: stale-active slots would bill
            # their full context into this round's ragged attention)
            try:
                self.decode_state = self.engine.release_slots(
                    self.decode_state, self._to_release)
                self._to_release.clear()
            except Exception:  # noqa: BLE001 - fall through; the decode
                # dispatch below hits the same fault and runs recovery
                pass
        if self._active() == 0:
            return False
        try:
            self.decode_state, toks = self.engine.generate_n(
                self.decode_state, self.spd)
            toks = toks.cpu().numpy()  # [spd, slots]
        except Exception as e:  # noqa: BLE001 - fail in-flight streams, then
            # rebuild with a backoff ladder. After a sticky CUDA error
            # (server.context_survived) nothing can run in this process: the
            # loop exits at once so that a supervisor (supervise=1) starts a
            # clean process. Sleeping blocks the event loop, which is fine:
            # the device is the thing that is down.
            import sys as _sys

            from maxtext_indextts2_tpu_torch.infer.server import context_survived

            print(f"[uniserver] decode dispatch failed: {e!r}"[:500],
                  file=_sys.stderr, flush=True)
            print(f"[uniserver] device memory at failure: {self._dev_mem()}",
                  file=_sys.stderr, flush=True)
            self.stats["errors"] += 1
            for i, st in enumerate(self._slots):
                if st is not None:
                    self._slots[i] = None
                    self._fail(st, e)
            self._flush_writes()
            ladder = (0.0, 2.0, 8.0, 30.0) if context_survived(e, self.engine.device) else ()
            for backoff_s in ladder:
                if backoff_s:
                    time.sleep(backoff_s)
                try:
                    self.engine.refresh_decode()
                    self.decode_state = self.engine.init_decode_state()
                    self._to_release.clear()  # fresh state: all inactive
                    self.stats["decode_recoveries"] = (
                        self.stats.get("decode_recoveries", 0) + 1)
                    print(f"[uniserver] decode recovered after "
                          f"{backoff_s}s backoff", file=_sys.stderr,
                          flush=True)
                    break
                except Exception as e2:  # noqa: BLE001 - try next backoff
                    print(f"[uniserver] recovery attempt (backoff "
                          f"{backoff_s}s) failed: {e2!r}"[:300],
                          file=_sys.stderr, flush=True)
            else:
                # the device is lost for THIS process: exit cleanly so a
                # supervisor (supervise=1) can relaunch a clean process
                print("[uniserver] backend unrecoverable; exiting for "
                      "supervisor restart", file=_sys.stderr, flush=True)
                self._stop = True
            return True
        self.stats["decode_dispatches"] += 1
        for step in toks:
            for i, st in enumerate(self._slots):
                if st is None:
                    continue
                tok = int(step[i])
                st.tokens.append(tok)
                self._remaining[i] -= 1
                if st.stream:
                    self._stream_line(st.conn, {"token": tok})
                if self._remaining[i] <= 0 or (
                        st.eos_id is not None and tok == st.eos_id):
                    self._finish_lm(i)
        return True

    def _finish_lm(self, slot: int):
        st = self._slots[slot]
        self._slots[slot] = None
        self._to_release.append(slot)
        if st is None:
            return
        if st.kind == "lm":
            self.stats["requests_completed"] += 1
            if st.stream:
                self._end_stream(st.conn)
            else:
                self._respond(st.conn, 200, {"tokens": st.tokens})
            return
        self._lm_done.append(st)
        if self._lm_done_t0 is None:
            self._lm_done_t0 = time.monotonic()

    def _s2a_round(self) -> bool:
        if not self._lm_done:
            return False
        waited = time.monotonic() - (self._lm_done_t0 or 0)
        if len(self._lm_done) < self.batch_max and waited < self.window_s \
                and (self._active() or self._pending):
            return False
        batch = self._lm_done[: self.batch_max]
        del self._lm_done[: len(batch)]
        self._lm_done_t0 = time.monotonic() if self._lm_done else None
        try:
            gens = [self.pipeline.map_semantic(st.tokens,
                                               force_frames=st.force_frames)
                    for st in batch]
            outs = self.pipeline.s2a_vocoder_batch(
                [st.body for st in batch],
                [st.sem for st in batch], [st.ac for st in batch],
                gens,
                pad_to_batch=min(_pow2ceil(len(batch)), self.batch_max))
        except Exception as e:  # noqa: BLE001
            for st in batch:
                self._fail(st, e)
            return True
        self.stats["s2a_batches"] += 1
        for st, (wav, info) in zip(batch, outs):
            info = {k: v for k, v in info.items() if not k.startswith("t_")}
            info["e2e_s"] = round(time.perf_counter() - st.t_arrive, 3)
            self.stats["requests_completed"] += 1
            self._respond(st.conn, 200, {
                "wav_b64": base64.b64encode(
                    np.asarray(wav, np.float32).tobytes()).decode(),
                "info": info,
            })
        return True

    def _fail(self, st: _Stream, e: Exception):
        self.stats["errors"] += 1
        if st.stream and st.conn.hold:
            # streaming headers already out: an explicit error line ends
            # the stream (clients tell failure from a short completion)
            self._stream_line(st.conn, {"error": repr(e)[:500]})
            self._end_stream(st.conn)
        else:
            self._respond(st.conn, 500, {"error": repr(e)[:500]})


def supervise(argv):
    """Relaunch the serving child whenever it exits: a sticky CUDA error is
    terminal for the process's context, so always-up serving is a
    supervised process, not a process that never dies. The child exits
    cleanly once its backoff ladder is exhausted; the supervisor starts a
    clean process. It touches no device itself."""
    import subprocess
    import sys

    child_args = [a for a in argv if not a.startswith("supervise=")]
    n = 0
    while True:
        n += 1
        t0 = time.monotonic()
        print(f"[uniserver-supervisor] start #{n}", file=sys.stderr,
              flush=True)
        code = subprocess.call(
            [sys.executable, "-m", "maxtext_indextts2_tpu_torch.infer.uniserver",
             *child_args])
        up_s = time.monotonic() - t0
        print(f"[uniserver-supervisor] child exited code={code} after "
              f"{up_s:.0f}s; restarting", file=sys.stderr, flush=True)
        if up_s < 30:
            # crash loop (config error, port conflict): don't spin
            print("[uniserver-supervisor] child died in <30s; stopping",
                  file=sys.stderr, flush=True)
            return code


def main(argv=None):
    import sys

    from maxtext_indextts2_tpu_torch.audio.pipeline import build_tiny_pipeline
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.infer.server import split_device_arg

    args = list(argv if argv is not None else sys.argv[1:])
    if any(a == "supervise=1" for a in args):
        raise SystemExit(supervise([a for a in args if a != "supervise=1"]))
    args, device = split_device_arg(args)
    port = None
    rest = []
    for a in args:
        if a.startswith("port="):
            port = int(a.split("=", 1)[1])
        else:
            rest.append(a)
    cfg = load_config(rest)
    engine = Engine(cfg, device=device)
    pipeline = build_tiny_pipeline(cfg, device=engine.device, engine=engine)
    srv = UniServer(cfg, pipeline, port=port)
    srv.start()
    t0 = time.perf_counter()
    srv.warm()
    print(f"[uniserver] warm {time.perf_counter() - t0:.1f}s",
          file=sys.stderr, flush=True)
    print(f"[uniserver] READY port={srv.port}", file=sys.stderr, flush=True)
    try:
        srv.serve_forever()
    finally:
        print(f"[uniserver] EXIT stop={srv._stop} stats={srv.stats}",
              file=sys.stderr, flush=True)
        srv.close()


if __name__ == "__main__":
    main()
