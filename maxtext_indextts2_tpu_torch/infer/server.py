"""Continuous-batching inference server.

Counterpart of the JAX package's ``infer/server.py`` for the token LM: an
in-process orchestrator (request queue -> fused admission -> shared decode
loop over slots) behind a dependency-free HTTP/JSON server (stdlib):
``POST /generate {"prompt": [ids...], "max_new_tokens": N} -> {"tokens":
[...]}`` and ``GET /metrics`` (Prometheus text).

One thread, the decode loop, owns the device. A device call that raises is
NOT retried: after a CUDA error the context is unusable, so the loop fails
every in-flight and queued request with that error and ends; later
submissions fail at once.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from maxtext_indextts2_tpu_torch.config import Config
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.models.layers import _unsupported


@dataclass
class _Request:
    prompt: np.ndarray
    max_new_tokens: int
    done: threading.Event = field(default_factory=threading.Event)
    tokens: list[int] = field(default_factory=list)
    error: str | None = None


class Orchestrator:
    """Slot scheduler: request queue -> prefill+insert -> shared generate loop."""

    def __init__(self, engine: Engine, eos_id: int | None = None,
                 steps_per_dispatch: int = 4, mode: str = "interleaved",
                 admission_fusion_max: int = 8):
        if mode != "interleaved":
            _unsupported(f"serving_mode={mode!r}", "5, decode extras")
        self.engine = engine
        self.eos_id = eos_id
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        self.mode = mode
        # fused admission group cap (engine.prefill_insert_many); <=1 keeps
        # the per-request prefill+insert path
        self.admission_fusion_max = admission_fusion_max
        self.queue: queue.Queue[_Request] = queue.Queue()
        self.slots: list[_Request | None] = [None] * engine.num_slots
        self.remaining = np.zeros(engine.num_slots, np.int32)
        self._carry: list[_Request] = []  # popped but not yet admitted, in arrival order
        self._loop_dead = threading.Event()  # set when _loop has exited
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.decode_state = None
        self.fatal_error: str | None = None
        self.stats = {
            "requests_total": 0,
            "requests_completed": 0,
            "requests_failed": 0,
            "tokens_generated_total": 0,
            "prefills_total": 0,
            "admission_dispatches_total": 0,
            "decode_steps_total": 0,
        }

    def start(self):
        if self.engine.params is None:
            self.engine.load_params()
        self.decode_state = self.engine.init_decode_state()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=30)

    def submit(self, prompt: np.ndarray, max_new_tokens: int) -> _Request:
        req = _Request(np.asarray(prompt, np.int32).reshape(-1), int(max_new_tokens))
        self.stats["requests_total"] += 1
        # length guards: decoding past max_target_length does not error, the
        # KV write clamps onto the last cache row and corrupts that stream;
        # and a prompt longer than the prefill limit cannot prefill at all
        cfg = self.engine.cfg
        overshoot = max(0, self.steps_per_dispatch - 1)
        budget = cfg.max_target_length - len(req.prompt) - overshoot
        if (len(req.prompt) < 1 or len(req.prompt) > cfg.max_prefill_predict_length
                or budget < 1):
            self._fail(req, ValueError(
                f"prompt length {len(req.prompt)} outside serving limits "
                f"(prefill limit {cfg.max_prefill_predict_length}, "
                f"context {cfg.max_target_length}, dispatch depth "
                f"{self.steps_per_dispatch})"))
            return req
        if req.max_new_tokens < 1:
            self._fail(req, ValueError(f"max_new_tokens {req.max_new_tokens} < 1"))
            return req
        req.max_new_tokens = min(req.max_new_tokens, budget)
        self.queue.put(req)
        if self._loop_dead.is_set():
            # the loop may have exited between its last drain and this put
            self._fail_all(RuntimeError(self.fatal_error or "serving loop is not running"))
        return req

    # ------------------------------------------------------------- internals
    def _emit(self, req: _Request, tok: int):
        req.tokens.append(tok)
        self.stats["tokens_generated_total"] += 1

    def _fail(self, req: _Request, e: Exception):
        if req.done.is_set():
            return
        req.error = repr(e)
        self.stats["requests_failed"] += 1
        req.done.set()

    def _fail_all(self, e: Exception):
        """Fail every in-flight, carried and queued request."""
        for i, req in enumerate(self.slots):
            if req is not None:
                self._fail(req, e)
                self.slots[i] = None
        for req in self._carry:
            self._fail(req, e)
        self._carry = []
        while True:
            try:
                self._fail(self.queue.get_nowait(), e)
            except queue.Empty:
                return

    def _loop(self):
        try:
            self._loop_body()
        except Exception as e:  # noqa: BLE001 - surfaced to every waiting request
            # a failed device call leaves a CUDA context nothing can be
            # retried on: fail everything and end the loop
            self.fatal_error = repr(e)
            self._stop.set()
            self._loop_dead.set()
            self._fail_all(e)
        finally:
            self._loop_dead.set()

    def _loop_body(self):
        while not self._stop.is_set():
            if self.admission_fusion_max > 1:
                admitted = self._admit_interleaved()
            else:
                admitted = self._admit_sequential()
            if not any(r is not None for r in self.slots):
                if not admitted:
                    time.sleep(0.001)
                continue
            self._decode_round()

    def _next_request(self) -> _Request | None:
        if self._carry:
            return self._carry.pop(0)
        try:
            return self.queue.get_nowait()
        except queue.Empty:
            return None

    def _admit_bookkeeping(self, slot: int, req: _Request, first_tok: int):
        self._emit(req, first_tok)
        self.slots[slot] = req
        self.remaining[slot] = req.max_new_tokens - 1
        if self.remaining[slot] <= 0 or first_tok == self.eos_id:
            self._finish(slot)

    def _admit_interleaved(self) -> bool:
        """FUSED admission: pack every waiting request (up to the free slots,
        the fusion cap and the prefill limit) and admit each group with one
        ``engine.prefill_insert_many``. Group sizes are powers of two, as in
        the JAX server (there to bound the set of compiled programs; kept so
        both servers admit the same groups)."""
        cfg = self.engine.cfg
        admitted = False
        while True:
            free = [i for i, r in enumerate(self.slots) if r is None]
            if not free:
                return admitted
            group: list[_Request] = []
            plen = 0
            max_k = min(len(free), max(1, self.admission_fusion_max))
            while len(group) < max_k:
                req = self._next_request()
                if req is None:
                    break
                if group and plen + len(req.prompt) > cfg.max_prefill_predict_length:
                    self._carry.insert(0, req)  # leads the next group
                    break
                group.append(req)
                plen += len(req.prompt)
            if not group:
                return admitted
            k = 1
            while k * 2 <= len(group):
                k *= 2
            self._carry[:0] = group[k:]  # keeps the overflow's arrival order
            group = group[:k]
            slots = free[:k]
            self.stats["prefills_total"] += len(group)
            self.stats["admission_dispatches_total"] += 1
            try:
                self.decode_state, firsts = self.engine.prefill_insert_many(
                    self.decode_state, [r.prompt for r in group], slots)
                firsts = firsts.cpu().numpy()
            except Exception:
                self._carry[:0] = group  # so that _fail_all reaches them
                raise
            for slot, req, tok in zip(slots, group, firsts):
                self._admit_bookkeeping(slot, req, int(tok))
            admitted = True

    def _admit_sequential(self) -> bool:
        """Per-request admission: one prefill and one insert for each."""
        admitted = False
        while True:
            free = [i for i, r in enumerate(self.slots) if r is None]
            if not free:
                return admitted
            req = self._next_request()
            if req is None:
                return admitted
            admitted |= self._admit_via_prefill(free[0], req)

    def _admit_via_prefill(self, slot: int, req: _Request) -> bool:
        self.stats["prefills_total"] += 1
        self.stats["admission_dispatches_total"] += 1
        try:
            prefix, first = self.engine.prefill(req.prompt, len(req.prompt))
            self.decode_state = self.engine.insert(prefix, self.decode_state, slot)
            first_tok = int(first.cpu()[0])
        except Exception:
            self._carry.insert(0, req)
            raise
        self._admit_bookkeeping(slot, req, first_tok)
        return True

    def _decode_round(self):
        """``steps_per_dispatch`` decode steps, ONE device-to-host copy of
        their tokens, then host-side emission. The depth is constant: a
        stream that finishes mid-round is clamped at its remaining count
        here, and the device decodes at most n-1 unused tokens for it."""
        n = self.steps_per_dispatch
        self.decode_state, toks_n = self.engine.generate_n(self.decode_state, n)
        toks_n = toks_n.cpu().numpy()  # [n, slots]
        self.stats["decode_steps_total"] += n
        for step_toks in toks_n:
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                tok = int(step_toks[i])
                self._emit(req, tok)
                self.remaining[i] -= 1
                if self.remaining[i] <= 0 or (self.eos_id is not None and tok == self.eos_id):
                    self._finish(i)

    def _finish(self, slot: int):
        req = self.slots[slot]
        self.slots[slot] = None
        # mark the slot inactive on the device too: its pos stops advancing
        self.decode_state = self.engine.release_slot(self.decode_state, slot)
        if req is not None:
            self.stats["requests_completed"] += 1
            req.done.set()

    def active_slots(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def metrics_text(self) -> str:
        """Prometheus text exposition format (stdlib-only)."""
        lines = []
        for k, v in self.stats.items():
            lines.append(f"# TYPE serving_{k} counter")
            lines.append(f"serving_{k} {v}")
        lines.append("# TYPE serving_active_slots gauge")
        lines.append(f"serving_active_slots {self.active_slots()}")
        lines.append("# TYPE serving_queue_depth gauge")
        lines.append(f"serving_queue_depth {self.queue.qsize() + len(self._carry)}")
        return "\n".join(lines) + "\n"


def make_server(cfg: Config, port: int | None = None, engine: Engine | None = None,
                device=None, host: str = "0.0.0.0"):
    """Build the HTTP server without blocking. Returns (httpd, orch):
    callers run ``httpd.serve_forever()`` themselves (``serve``) or in a
    thread. ``port=0`` asks the system for a free port
    (``httpd.server_address[1]``). Endpoints: POST /generate, GET /metrics,
    GET anything else -> "ok" (health check)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    orch = Orchestrator(
        engine or Engine(cfg, device=device),
        steps_per_dispatch=cfg.serving_steps_per_dispatch,
        mode=cfg.serving_mode,
        admission_fusion_max=cfg.serving_admission_fusion_max,
    )
    orch.start()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: bytes, ctype: str = "application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_POST(self):
            if self.path != "/generate":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(length) or "{}")
                prompt = np.asarray(body["prompt"], np.int32)
                max_new = int(body.get("max_new_tokens", 32))
            except (json.JSONDecodeError, KeyError, ValueError, TypeError) as e:
                self._send(400, json.dumps({"error": f"bad request: {e}"}).encode())
                return
            req = orch.submit(prompt, max_new)
            if not req.done.wait(timeout=600):
                req.error = "timed out"
            ok = req.error is None
            self._send(200 if ok else 500, json.dumps(
                {"tokens": req.tokens} if ok else {"error": req.error}).encode())

        def do_GET(self):
            if self.path == "/metrics":
                self._send(200, orch.metrics_text().encode(), "text/plain; version=0.0.4")
                return
            self._send(200, b"ok", "text/plain")

        def log_message(self, *a):
            pass

    server = ThreadingHTTPServer(
        (host, cfg.inference_server_port if port is None else port), Handler)
    return server, orch


def serve(cfg: Config, port: int | None = None, engine: Engine | None = None, device=None):
    """Blocking HTTP server."""
    server, orch = make_server(cfg, port, engine, device)
    try:
        server.serve_forever()
    finally:
        orch.stop()
        server.server_close()


def split_device_arg(argv: list[str]):
    """Take ``device=<name>`` out of a key=value argument list. Returns
    (remaining argv, device or None). None means the GPU."""
    device = None
    rest = []
    for a in argv:
        if a.startswith("device="):
            device = a.partition("=")[2]
        else:
            rest.append(a)
    return rest, device


def main(argv=None):
    import sys

    from maxtext_indextts2_tpu_torch.config import load_config

    argv, device = split_device_arg(list(sys.argv[1:] if argv is None else argv))
    cfg = load_config(argv)
    print(f"serving on :{cfg.inference_server_port}")
    serve(cfg, device=device)


if __name__ == "__main__":
    main()
