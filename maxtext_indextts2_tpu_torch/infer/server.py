"""Continuous-batching inference server.

Counterpart of the JAX package's ``infer/server.py``: an in-process
orchestrator (request queue -> fused admission -> shared decode loop over
slots) behind a dependency-free HTTP/JSON server (stdlib):
``POST /generate {"prompt": [ids...], "max_new_tokens": N} -> {"tokens":
[...]}``, ``GET /metrics`` (Prometheus text) and, with a TTS pipeline,
``POST /tts {"text": ..., "prompt_wav_16k": [...], "prompt_wav_24k": [...]}
-> {"wav": [...], "info": {...}}`` (``*_b64`` prompts and
``"wav_encoding": "b64"`` carry little-endian float32 as base64).

One thread, the decode loop, owns the device: the TTS batcher hands its
device stages to it (``Orchestrator.run_on_loop``) between decode rounds. A
device call of the decode loop that raises is NOT retried: after a CUDA
error the context is unusable, so the loop fails every in-flight and queued
request with that error and ends; later submissions fail at once.

With a paged engine (``paged_attention``) admission is controlled by pages:
the device's page allocator has no error path (an exhausted pool hands out
the null page), so each request reserves, host-side, the pages it can reach
at worst (prompt + budget + the dispatch's overshoot) and waits at the head
of the line until the pool has them; admission is then one request at a
time (prefill + insert), as in the JAX server.
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from maxtext_indextts2_tpu_torch.config import Config
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.unported import _unsupported


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
        self._paged = bool(engine.cfg.paged_attention)
        if self._paged:
            self._tpp = int(engine.cfg.pagedattn_tokens_per_page)
            self._pages_total = int(engine.cfg.pagedattn_num_pages) - 1  # the null page
            self._pages_reserved = np.zeros(engine.num_slots, np.int64)
        self._carry: list[_Request] = []  # popped but not yet admitted, in arrival order
        self._loop_dead = threading.Event()  # set when _loop has exited
        # closures other threads need run ON the device thread (run_on_loop)
        self._thunks: queue.Queue = queue.Queue()
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

    def run_on_loop(self, fn, timeout: float = 600.0):
        """Run ``fn()`` on the decode loop between decode rounds and return
        its result (or raise its exception). The TTS batcher runs its device
        stages this way, so all device work stays on one thread. Fails at once
        when the loop has exited."""
        if self._loop_dead.is_set():
            raise RuntimeError(self.fatal_error or "device loop is not running")
        box = {"done": threading.Event(), "fn": fn}
        self._thunks.put(box)
        if self._loop_dead.is_set():
            # the loop may have exited between its final drain and this put
            self._fail_pending_thunks(RuntimeError("device loop exited"))
        if not box["done"].wait(timeout):
            raise TimeoutError("device-loop thunk timed out")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _drain_thunks(self, limit: int = 1):
        """Run up to ``limit`` queued thunks on this (the device) thread."""
        for _ in range(limit):
            try:
                box = self._thunks.get_nowait()
            except queue.Empty:
                return
            try:
                box["result"] = box["fn"]()
            except Exception as e:  # noqa: BLE001 - re-raised in the caller's thread
                box["error"] = e
            box["done"].set()

    def _fail_pending_thunks(self, err: Exception):
        """Complete every queued thunk with ``err``: the loop is exiting and
        will never run them."""
        while True:
            try:
                box = self._thunks.get_nowait()
            except queue.Empty:
                return
            if not box["done"].is_set():
                box["error"] = err
                box["done"].set()

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
        if self._paged and self._pages_needed(req) > self._pages_total:
            # it would wait at the head of the line for ever
            self._fail(req, ValueError(
                f"request needs {self._pages_needed(req)} pages, the pool has "
                f"{self._pages_total}"))
            return req
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
            self._fail_pending_thunks(RuntimeError(self.fatal_error or "device loop exited"))

    def _pages_needed(self, req: _Request) -> int:
        # the device advances a slot up to steps_per_dispatch - 1 steps past
        # prompt + budget before the host finishes it: reserve that too, or a
        # full pool could hand the allocator's null page to a live slot
        overshoot = max(0, self.steps_per_dispatch - 1)
        return -(-(len(req.prompt) + req.max_new_tokens + overshoot) // self._tpp)

    def _can_admit(self, req: _Request) -> bool:
        if not self._paged:
            return True
        return int(self._pages_reserved.sum()) + self._pages_needed(req) <= self._pages_total

    def _loop_body(self):
        while not self._stop.is_set():
            if self.admission_fusion_max > 1 and not self._paged:
                admitted = self._admit_interleaved()
            else:
                admitted = self._admit_sequential()
            self._drain_thunks()
            if not any(r is not None for r in self.slots):
                if not admitted:
                    time.sleep(0.001)
                continue
            self._decode_round()

    def _next_request(self) -> _Request | None:
        """The next request in arrival order, if the pool can take it (paged:
        the head of the line waits for pages; it is never failed for want of
        them)."""
        if not self._carry:
            try:
                self._carry.append(self.queue.get_nowait())
            except queue.Empty:
                return None
        return self._carry.pop(0) if self._can_admit(self._carry[0]) else None

    def _admit_bookkeeping(self, slot: int, req: _Request, first_tok: int):
        self._emit(req, first_tok)
        self.slots[slot] = req
        self.remaining[slot] = req.max_new_tokens - 1
        if self._paged:
            self._pages_reserved[slot] = self._pages_needed(req)
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
        """Per-request admission: one prefill and one insert for each (paged:
        while the pool has the pages each reserves)."""
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
        # (paged: its pages go back to the pool)
        self.decode_state = self.engine.release_slot(self.decode_state, slot)
        if self._paged:
            self._pages_reserved[slot] = 0
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


@dataclass
class _TTSRequest:
    body: dict
    done: threading.Event = field(default_factory=threading.Event)
    result: tuple | None = None
    error: str | None = None


class _PartialLMFailure(RuntimeError):
    """Some (not necessarily all) streams of a batched LM generation failed.
    ``tokens`` is aligned with the submitted batch: a token list per stream
    that succeeded, None per failed one; ``errors`` holds the failures."""

    def __init__(self, tokens, errors):
        super().__init__(f"LM generation failed for {sum(t is None for t in tokens)}/"
                         f"{len(tokens)} streams: {errors[0] if errors else ''}")
        self.tokens = tokens
        self.errors = errors


class TTSBatcher:
    """Collects /tts requests into one masked S2A pass.

    Requests arriving within ``window_ms`` of each other (up to
    ``max_batch``) are served together. With an orchestrator and a pipeline
    that has the stage methods (``frontend_batch``, ``s2a_vocoder_batch``),
    every device stage runs on the orchestrator's thread (``run_on_loop``) and
    the LM stage goes through its shared slots; otherwise the batch is one
    ``pipeline.synthesize_batch`` call."""

    def __init__(self, pipeline, max_batch: int = 8, window_ms: int = 50,
                 orchestrator: Orchestrator | None = None, allow_force_frames: bool = False):
        self.pipeline = pipeline
        self.max_batch = max(1, max_batch)
        self.window_s = window_ms / 1e3
        self.orch = orchestrator
        # force_frames disables the stop at a non-audio token: a load-testing
        # knob, not something an untrusted /tts client may set; stripped at
        # submit unless the server was built with tts_allow_force_frames
        self.allow_force_frames = allow_force_frames
        self.queue: queue.Queue[_TTSRequest] = queue.Queue()
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.batches = 0
        self.requests = 0

    def _generate_via_orch(self, lm_prompts, max_tokens):
        """The LM stage through the orchestrator's shared slots. A failed
        stream raises _PartialLMFailure, so that the batcher fails THAT
        request and still synthesizes the rest."""
        reqs = [self.orch.submit(np.asarray(p, np.int32), int(m))
                for p, m in zip(lm_prompts, max_tokens)]
        oks, errs = [], []
        for r in reqs:
            if not r.done.wait(timeout=600):
                r.error = "LM generation timed out"
            oks.append(r.error is None)
            if r.error is not None:
                errs.append(str(r.error))
        if not all(oks):
            raise _PartialLMFailure(
                tokens=[r.tokens if ok else None for r, ok in zip(reqs, oks)], errors=errs)
        return [r.tokens for r in reqs]

    def start(self):
        self.thread.start()

    def stop(self):
        self._stop.set()
        self.thread.join(timeout=30)

    def submit(self, body: dict) -> _TTSRequest:
        if not self.allow_force_frames:
            body.pop("force_frames", None)
        req = _TTSRequest(body=body)
        self.queue.put(req)
        return req

    def _collect(self) -> list[_TTSRequest]:
        try:
            first = self.queue.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            wait = deadline - time.monotonic()
            if wait <= 0:
                break
            try:
                batch.append(self.queue.get(timeout=wait))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            phased = self.orch is not None and hasattr(self.pipeline, "frontend_batch")
            all_reqs = list(batch)  # done-signalling covers the failed ones too
            try:
                if phased:
                    results, batch = self._run_phased(batch)
                else:
                    kw = {"generate_fn": self._generate_via_orch} if self.orch else {}
                    # one batch shape whatever the window collected
                    kw["pad_to_batch"] = self.max_batch
                    results = self.pipeline.synthesize_batch([r.body for r in batch], **kw)
                for req, res in zip(batch, results):
                    req.result = res
            except _PartialLMFailure as e:
                # non-phased path only: fail the broken streams, re-run the
                # survivors with their ALREADY-GENERATED tokens
                survivors, cached = [], []
                for req, toks in zip(batch, e.tokens):
                    if toks is None:
                        req.error = f"{type(e).__name__}: {e}"
                    else:
                        survivors.append(req)
                        cached.append(toks)
                if survivors:
                    try:
                        results = self.pipeline.synthesize_batch(
                            [r.body for r in survivors], generate_fn=lambda p, m: cached,
                            pad_to_batch=self.max_batch)
                        for req, res in zip(survivors, results):
                            req.result = res
                    except Exception as e2:  # noqa: BLE001 - surfaced to every caller
                        for req in survivors:
                            req.error = f"{type(e2).__name__}: {e2}"
            except Exception as e:  # noqa: BLE001 - surfaced to every caller
                for req in batch:
                    if req.error is None and req.result is None:
                        req.error = f"{type(e).__name__}: {e}"
            self.batches += 1
            self.requests += len(all_reqs)
            for req in all_reqs:
                req.done.set()

    def _run_phased(self, batch):
        """One batch with every device stage on the orchestrator's thread:
        frontend -> LM (shared slots) -> S2A + vocoder. A stream whose LM
        generation failed is failed alone; the survivors go on to the S2A
        pass with their frontend outputs. The results' ``t_frontend`` and
        ``t_lm`` are the stages' wall times (the JAX server reports 0 there).
        Returns (results, survivors)."""
        pipeline, orch = self.pipeline, self.orch
        bodies = [r.body for r in batch]
        t0 = time.perf_counter()
        sems, acs = orch.run_on_loop(
            lambda: pipeline.frontend_batch(bodies, pad_to_batch=self.max_batch))
        t1 = time.perf_counter()
        lm_prompts = [pipeline.text_and_prompt_to_lm_prompt(b["text"], s)
                      for b, s in zip(bodies, sems)]
        mnts = [int(b.get("max_new_tokens", 256)) for b in bodies]
        try:
            outs = self._generate_via_orch(lm_prompts, mnts)
        except _PartialLMFailure as e:
            keep = []
            for i, (req, toks) in enumerate(zip(batch, e.tokens)):
                if toks is None:
                    req.error = f"{type(e).__name__}: {e}"
                else:
                    keep.append(i)
            if not keep:
                return [], []
            batch = [batch[i] for i in keep]
            bodies = [bodies[i] for i in keep]
            sems = [sems[i] for i in keep]
            acs = [acs[i] for i in keep]
            outs = [e.tokens[i] for i in keep]
        gens = [pipeline.map_semantic(o, force_frames=bool(b.get("force_frames")))
                for o, b in zip(outs, bodies)]
        timings = {"t_frontend": t1 - t0, "t_lm": time.perf_counter() - t1, "t_start": t0}
        results = orch.run_on_loop(lambda: pipeline.s2a_vocoder_batch(
            bodies, sems, acs, gens, pad_to_batch=self.max_batch, timings=timings))
        return results, batch


def _tts_payload(body: dict, result) -> bytes:
    wav, info = result
    if body.get("wav_encoding") == "b64":
        # base64 of little-endian float32: ~7x smaller than a JSON list
        wav32 = np.asarray(wav, "<f4")
        return json.dumps({"wav_b64": base64.b64encode(wav32.tobytes()).decode(),
                           "dtype": "float32", "info": info}).encode()
    return json.dumps({"wav": np.asarray(wav).tolist(), "info": info}).encode()


class _Handler(BaseHTTPRequestHandler):
    """The endpoints. A handler reaches the orchestrator and the TTS batcher
    through its server (``self.server.orch``, ``self.server.tts_batcher``),
    never through a closure: a class defined inside ``make_server`` would sit
    in a reference cycle and keep a dropped server's engine, and its GPU
    memory, alive until a collector pass."""

    def _send(self, code: int, payload: bytes, ctype: str = "application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_POST(self):
        if self.path == "/tts" and self.server.tts_batcher is not None:
            self._do_tts()
            return
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
        req = self.server.orch.submit(prompt, max_new)
        if not req.done.wait(timeout=600):
            req.error = "timed out"
        ok = req.error is None
        self._send(200 if ok else 500, json.dumps(
            {"tokens": req.tokens} if ok else {"error": req.error}).encode())

    def _do_tts(self):
        length = int(self.headers.get("Content-Length", 0))
        try:
            body = json.loads(self.rfile.read(length) or "{}")
            body["text"]  # validated before it is queued
            for k in ("prompt_wav_16k", "prompt_wav_24k"):
                if k + "_b64" in body:  # binary prompt upload (float32 LE)
                    body[k] = np.frombuffer(base64.b64decode(body.pop(k + "_b64")), "<f4")
        except (json.JSONDecodeError, KeyError, ValueError, TypeError) as e:
            self._send(400, json.dumps({"error": f"bad request: {e}"}).encode())
            return
        req = self.server.tts_batcher.submit(body)
        finished = req.done.wait(timeout=870)
        if req.error is not None or not finished or req.result is None:
            err = req.error or ("timed out" if not finished else "no result")
            self._send(500, json.dumps({"error": err}).encode())
            return
        self._send(200, _tts_payload(body, req.result))

    def do_GET(self):
        if self.path == "/metrics":
            self._send(200, self.server.orch.metrics_text().encode(),
                       "text/plain; version=0.0.4")
            return
        self._send(200, b"ok", "text/plain")

    def log_message(self, *a):
        pass


def make_server(cfg: Config, port: int | None = None, engine: Engine | None = None,
                device=None, host: str = "0.0.0.0", tts_pipeline=None):
    """Build the HTTP server without blocking. Returns (httpd, orch,
    tts_batcher): callers run ``httpd.serve_forever()`` themselves (``serve``)
    or in a thread. ``port=0`` asks the system for a free port
    (``httpd.server_address[1]``). Endpoints: POST /generate, GET /metrics,
    GET anything else -> "ok" (health check), and POST /tts when a TTS
    pipeline is given (its engine serves the LM unless ``engine`` is). Once
    stopped (``orch.stop()``, the batcher's ``stop()``, ``server_close()``),
    dropping the three frees the engine at once, without a collector pass."""
    if engine is None:
        engine = tts_pipeline.engine if tts_pipeline is not None else Engine(cfg, device=device)
    orch = Orchestrator(
        engine,
        steps_per_dispatch=cfg.serving_steps_per_dispatch,
        mode=cfg.serving_mode,
        admission_fusion_max=cfg.serving_admission_fusion_max,
    )
    orch.start()
    tts_batcher = None
    if tts_pipeline is not None:
        tts_batcher = TTSBatcher(tts_pipeline, cfg.tts_batch_max, cfg.tts_batch_window_ms,
                                 orchestrator=orch,
                                 allow_force_frames=cfg.tts_allow_force_frames)
        tts_batcher.start()
    server = ThreadingHTTPServer(
        (host, cfg.inference_server_port if port is None else port), _Handler)
    server.orch, server.tts_batcher = orch, tts_batcher
    return server, orch, tts_batcher


def serve(cfg: Config, port: int | None = None, engine: Engine | None = None, device=None,
          tts_pipeline=None):
    """Blocking HTTP server."""
    server, orch, tts_batcher = make_server(cfg, port, engine, device,
                                            tts_pipeline=tts_pipeline)
    try:
        server.serve_forever()
    finally:
        orch.stop()
        if tts_batcher is not None:
            tts_batcher.stop()
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
