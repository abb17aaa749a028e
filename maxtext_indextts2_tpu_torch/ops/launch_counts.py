"""Every kernel wrapper's launch count, read and written in one place.

Each wrapper adds one to its count where it launches its kernel. A replayed
CUDA graph launches kernels without calling a wrapper, so whoever replays a
graph (``infer/cuda_graphs.py``) takes the counts a capture added
(:func:`snapshot` before and after, :func:`restore` to undo them: a capture
launches nothing) and :func:`add` s them once for every replay.
"""

from __future__ import annotations

from maxtext_indextts2_tpu_torch.ops import (
    ada_rmsnorm,
    flash_attention,
    grouped_matmul,
    inplace_update,
    int8w_matmul,
    quant_kernels,
    ragged_decode_attention,
    s2a_attention,
)

# (module, integer attribute)
_SCALARS = (
    (ragged_decode_attention, "launch_count"),
    (ragged_decode_attention, "paged_launch_count"),
    (inplace_update, "launch_count"),
    (ada_rmsnorm, "launch_count"),
    (s2a_attention, "launch_count"),
    (int8w_matmul, "launch_count"),
)
# (module, attribute holding a dict of integers)
_DICTS = (
    (flash_attention, "launch_counts"),
    (grouped_matmul, "launch_counts"),
    (quant_kernels, "launch_counts"),
    (inplace_update, "span_launch_counts"),
)


_MODULES = {m.__name__: m for m, _ in _SCALARS + _DICTS}


def snapshot() -> dict:
    """Every count, keyed by (module name, attribute[, dict key])."""
    out = {(m.__name__, a): getattr(m, a) for m, a in _SCALARS}
    for m, a in _DICTS:
        out.update({(m.__name__, a, k): v for k, v in getattr(m, a).items()})
    return out


def _set(key, value) -> None:
    module = _MODULES[key[0]]
    if len(key) == 3:
        getattr(module, key[1])[key[2]] = value
    else:
        setattr(module, key[1], value)


def restore(snap: dict) -> None:
    """Every count back to ``snap``; a dict key that ``snap`` lacks goes away."""
    for m, a in _DICTS:
        counts = getattr(m, a)
        for k in [k for k in counts if (m.__name__, a, k) not in snap]:
            del counts[k]
    for key, value in snap.items():
        _set(key, value)


def diff(after: dict, before: dict) -> dict:
    """The counts that grew from ``before`` to ``after``, by how much."""
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def add(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the counts (a new dict key starts at 0)."""
    for key, n in delta.items():
        module = _MODULES[key[0]]
        if len(key) == 3:
            counts = getattr(module, key[1])
            counts[key[2]] = counts.get(key[2], 0) + n * times
        else:
            setattr(module, key[1], getattr(module, key[1]) + n * times)
