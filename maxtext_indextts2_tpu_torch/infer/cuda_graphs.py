"""Captured decode dispatches: CUDA graphs over a decode state's own tensors.

The JAX engine runs a decode dispatch as ONE compiled program: ``generate``,
``generate_n`` (a ``lax.scan`` of n steps) and a speculative round are each a
``jax.jit`` with the decode state donated. The counterpart here is a CUDA
graph: on a CUDA device a dispatch is one graph replay instead of the ~1,500
launches an eager ``tts-1b`` step makes from the host.

A graph is captured for one decode state and one static shape (the key: the
step count, the bucket width of ``decode_attention=bucketed``, ...). It reads
and writes the state's tensors at the addresses they had at capture, so every
engine call mutates the state in place and keeps each tensor's storage; a
state whose tensors are not the captured ones (a new state, a tensor that was
replaced) is captured anew. The first dispatch of a key runs eagerly -- it
builds the kernels' library, fills the wrappers' launch-configuration caches
and lets cuBLAS make its handles, none of which may happen inside a capture --
and is then captured; every later dispatch replays. All graphs of one cache
share one memory pool: they replay one at a time on one stream, and each
replay's outputs are copied out before the next. A capture that fails raises
``CaptureError``: nothing falls back to eager, and the server does not treat
it as a passing fault.

Random draws are not captured: the caller draws a dispatch's uniform noise
eagerly from its generator and passes it in, the graph reads it from a static
input. So each replay samples fresh noise, and the eager route, fed the same
draws, gives the same tokens.

The kernel wrappers count launches in Python, which a replay does not run: a
capture's counts (``ops/launch_counts``) are taken out again, and each replay
adds them once.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch

from maxtext_indextts2_tpu_torch.ops import launch_counts


class CaptureError(RuntimeError):
    """A dispatch could not be captured: a defect of the step's code (a host
    copy, a synchronising call), which every later capture repeats."""


@dataclasses.dataclass
class _Entry:
    graph: torch.cuda.CUDAGraph
    inputs: list  # static input tensors (None where the dispatch has none)
    outputs: object  # a tensor or a tuple of tensors, written by each replay
    launches: dict  # kernel launches one replay makes (ops/launch_counts keys)
    state: list  # weak references to the state tensors the graph reads and writes

    def holds(self, tensors) -> bool:
        return len(tensors) == len(self.state) and all(
            ref() is t for ref, t in zip(self.state, tensors))


def _copy_out(outputs):
    if isinstance(outputs, tuple):
        return tuple(t.clone() for t in outputs)
    return outputs.clone()


class GraphCache:
    """The captured dispatches of one engine."""

    def __init__(self):
        self._pool = None  # one memory pool for every graph of this cache
        self._entries: dict = {}
        self.captures = 0
        self.replays = 0

    def clear(self):
        """Drop every graph (the counterpart of dropping compiled programs)."""
        self._entries.clear()
        self._pool = None

    def run(self, key, tensors: list[torch.Tensor], fn, inputs: list):
        """``fn(*inputs)`` as a replay of the graph of ``key`` over the state
        ``tensors`` (every tensor ``fn`` reads or writes that outlives it).
        ``inputs``: this dispatch's tensors (or None), copied into the graph's
        static inputs. Returns ``fn``'s outputs (copies)."""
        full_key = (key, id(tensors[0]))
        entry = self._entries.get(full_key)
        if entry is not None and entry.holds(tensors):
            for static, x in zip(entry.inputs, inputs):
                if x is not None:
                    static.copy_(x)
            entry.graph.replay()
            launch_counts.add(entry.launches)
            self.replays += 1
            return _copy_out(entry.outputs)
        out = fn(*inputs)  # the first dispatch of this key and state, eagerly
        self._capture(full_key, tensors, fn, inputs)
        return out

    def _capture(self, full_key, tensors, fn, inputs):
        # graphs of states that are gone can never replay again
        for k in [k for k, e in self._entries.items() if e.state[0]() is None]:
            del self._entries[k]
        static = [None if x is None else x.clone() for x in inputs]
        if not self._entries:
            # a pool whose graphs are gone cannot take another capture (PyTorch
            # asserts; cuBLAS's workspace, allocated in the first capture, keeps
            # it from being freed): a new pool
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = launch_counts.snapshot()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                outputs = fn(*static)
        except Exception as e:
            raise CaptureError(f"capturing the decode dispatch {full_key[0]} as a CUDA graph "
                               f"failed: {e}") from e
        finally:
            after = launch_counts.snapshot()
            launch_counts.restore(before)  # a capture launches nothing
        self._entries[full_key] = _Entry(graph, static, outputs,
                                         launch_counts.diff(after, before),
                                         [weakref.ref(t) for t in tensors])
        self.captures += 1


def state_tensors(decode_state: dict) -> list[torch.Tensor]:
    """Every tensor of a decode state (``infer/engine.py``), in a fixed order:
    what a captured step reads and writes."""
    out = [decode_state["tokens"], decode_state["pos"], decode_state["active"]]
    for unit in decode_state["cache"]:
        for c in unit:
            out.extend(c.leaves().values())
    if "page_state" in decode_state:
        out.extend(decode_state["page_state"])
    return out
