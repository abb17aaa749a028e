"""Input pipeline in a sidecar process ("colocated" data loading).

Counterpart of the JAX package's ``train/data/colocated.py`` (the reference's
``colocated_python_data_input``): the configured input pipeline runs in a
spawned CPU process that prefetches numpy batches into a bounded queue, so
tokenization, packing and disk reads never hold up the training loop. The
sidecar is spawned, never forked (a forked child would share the parent's
CUDA state), and touches no device. Every batch is tagged with the inner
iterator's state after it, so ``get_state`` / ``set_state`` round-trip
through a training checkpoint as the in-process pipelines' do; an iterator
without state is fast-forwarded by the number of batches consumed.

``train/train.create_data_iterator`` wraps it in ``DeviceBatches`` when
``colocated_python_data_input=true``.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import pickle
import queue as queue_lib

import numpy as np

logger = logging.getLogger(__name__)

_END = "__end__"  # inner iterator exhausted
_ERR = "__err__"  # inner iterator raised


class _SyntheticBatches:
    """The synthetic batch, as numpy, forever (``SyntheticDataIterator``'s)."""

    def __init__(self, cfg):
        from maxtext_indextts2_tpu_torch.train.data.synthetic import make_batch

        self.batch = make_batch(cfg, 0)

    def __iter__(self):
        return self

    def __next__(self):
        return self.batch


def host_iterator(cfg):
    """The numpy batch iterator of ``cfg.dataset_type`` (what the sidecar runs)."""
    if cfg.dataset_type == "synthetic":
        return _SyntheticBatches(cfg)
    from maxtext_indextts2_tpu_torch.train.train import make_host_iterator

    return make_host_iterator(cfg)


def _worker_main(cfg_bytes: bytes, init_state: bytes | None, batch_q, stop_evt):
    """Sidecar entry: build the real iterator and stream (batch, state) pairs."""
    try:
        cfg = pickle.loads(cfg_bytes)
        it = host_iterator(cfg)
        skip = 0
        if init_state:
            st = pickle.loads(init_state)
            if st.get("inner") is not None and hasattr(it, "set_state"):
                it.set_state(st["inner"])
            else:
                skip = st.get("consumed", 0)  # deterministic fast-forward
        for _ in range(skip):
            next(it)
        while not stop_evt.is_set():
            try:
                batch = next(it)
            except StopIteration:
                batch_q.put(_END)
                return
            batch = {k: np.asarray(v) for k, v in batch.items()}
            state = it.get_state() if hasattr(it, "get_state") else None
            while not stop_evt.is_set():
                try:
                    batch_q.put((batch, state), timeout=0.2)
                    break
                except queue_lib.Full:
                    continue
    except Exception as e:  # noqa: BLE001 - relayed to the trainer, which raises it
        batch_q.put((_ERR, repr(e)))


class ColocatedDataIterator:
    """Runs the configured input pipeline in a sidecar process. The sidecar
    starts on the first ``__next__``, so that ``set_state`` (a checkpoint
    restore) can still reposition the stream."""

    def __init__(self, cfg, prefetch: int = 4, timeout_s: float = 300.0):
        import dataclasses

        self.cfg = dataclasses.replace(cfg, colocated_python_data_input=False)
        self.prefetch = prefetch
        self.timeout_s = timeout_s
        self._ctx = mp.get_context("spawn")
        self._proc = None
        self._queue = None
        self._stop = None
        self._pending_state: bytes | None = None
        self._consumed = 0
        self._last_inner_state = None

    def _start(self):
        self._queue = self._ctx.Queue(maxsize=self.prefetch)
        self._stop = self._ctx.Event()
        self._proc = self._ctx.Process(
            target=_worker_main,
            args=(pickle.dumps(self.cfg), self._pending_state, self._queue, self._stop),
            daemon=True)
        self._proc.start()
        logger.info("colocated data sidecar started (pid %d)", self._proc.pid)

    def close(self):
        if self._proc is None:
            return
        self._stop.set()
        try:  # drain, so that the sidecar's put() returns
            while True:
                self._queue.get_nowait()
        except queue_lib.Empty:
            pass
        self._proc.join(timeout=5.0)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=5.0)
        self._proc = None

    def __del__(self):
        self.close()

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._proc is None:
            self._start()
        try:
            item = self._queue.get(timeout=self.timeout_s)
        except queue_lib.Empty as e:
            raise RuntimeError(
                f"colocated data sidecar produced nothing for {self.timeout_s}s "
                f"(alive={self._proc.is_alive()}): check the dataset config") from e
        if isinstance(item, str) and item == _END:
            raise StopIteration
        if isinstance(item, tuple) and isinstance(item[0], str) and item[0] == _ERR:
            raise RuntimeError(f"colocated data sidecar failed: {item[1]}")
        batch, inner_state = item
        self._consumed += 1
        self._last_inner_state = inner_state
        return batch

    def get_state(self) -> bytes:
        return pickle.dumps({"consumed": self._consumed, "inner": self._last_inner_state})

    def set_state(self, state: bytes):
        self.close()
        self._pending_state = state
        st = pickle.loads(state) if state else {}
        self._consumed = st.get("consumed", 0)
        self._last_inner_state = st.get("inner")
