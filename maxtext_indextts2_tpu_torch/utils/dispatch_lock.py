"""Process-wide device-dispatch serialization.

The port's copy of the JAX package's ``utils/dispatch_lock.py`` (the lock
itself is held equal to the original by ``tests/test_torch_port_hygiene.py``).
On one GPU it serializes the host side of device work between threads: the
disaggregated serving mode's prefill thread enqueues its prefill while the
decode loop holds no lock, and never while the decode loop enqueues or
CAPTURES a decode dispatch (``infer/cuda_graphs.py``): a capture must see no
launch, allocation or launch count of another thread. The device work itself
still overlaps, each thread on its own CUDA stream.

``device_dispatch()`` is a reentrant, FIFO-fair lock: fairness matters
because the decode loop re-acquires in a tight loop and a plain
threading.Lock would starve the other thread behind it indefinitely.
"""

from __future__ import annotations

import collections
import contextlib
import threading

__all__ = ["device_dispatch"]


class _FairRLock:
    """Reentrant lock granting waiters in FIFO order."""

    def __init__(self):
        self._cv = threading.Condition()
        self._owner: int | None = None
        self._count = 0
        self._waiters: collections.deque[int] = collections.deque()

    def acquire(self):
        me = threading.get_ident()
        with self._cv:
            if self._owner == me:
                self._count += 1
                return
            self._waiters.append(me)
            try:
                while self._owner is not None or self._waiters[0] != me:
                    self._cv.wait()
            except BaseException:
                # Interrupted mid-wait (e.g. KeyboardInterrupt at shutdown):
                # leaving our ident queued would wedge every later acquire on
                # `_waiters[0] != me` forever. Remove it and wake the others.
                self._waiters.remove(me)
                self._cv.notify_all()
                raise
            self._waiters.popleft()
            self._owner = me
            self._count = 1

    def release(self):
        with self._cv:
            if self._owner != threading.get_ident():
                raise RuntimeError("release of un-owned dispatch lock")
            self._count -= 1
            if self._count == 0:
                self._owner = None
                self._cv.notify_all()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


_LOCK = _FairRLock()


@contextlib.contextmanager
def device_dispatch():
    """Hold while dispatching (and fetching) device work from a thread that
    may race another device-using thread in this process."""
    with _LOCK:
        yield
