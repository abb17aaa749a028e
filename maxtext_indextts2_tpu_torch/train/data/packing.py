"""Host-side sequence packing into fixed-length LM rows.

This package's own copy of the JAX package's ``train/data/packing.py``
(numpy only; ``tests/test_torch_data.py`` holds the two equal). First-fit
packing of variable-length token lists into [max_len] rows with segment ids
(1-based per packed example, 0 = padding) and per-example restarted
positions; targets are next-token shifted within each segment.
"""

from __future__ import annotations

from collections.abc import Iterator, Sequence

import numpy as np


def pack_examples(
    examples: Sequence[Sequence[int]],
    max_len: int,
    pad_id: int = 0,
) -> list[dict[str, np.ndarray]]:
    """Greedy first-fit packing. Returns full LM rows (inputs/targets/etc)."""
    rows: list[list[list[int]]] = []
    for ex in examples:
        ex = list(ex)[: max_len + 1]  # keep one extra token for the shift
        placed = False
        for row in rows:
            if sum(len(s) - 1 for s in row) + len(ex) - 1 <= max_len:
                row.append(ex)
                placed = True
                break
        if not placed:
            rows.append([ex])
    return [finalize_row(row, max_len, pad_id) for row in rows]


def finalize_row(
    segments: list[list[int]], max_len: int, pad_id: int = 0
) -> dict[str, np.ndarray]:
    inputs = np.full(max_len, pad_id, np.int32)
    targets = np.full(max_len, pad_id, np.int32)
    segmentation = np.zeros(max_len, np.int32)
    positions = np.zeros(max_len, np.int32)
    off = 0
    for seg_id, seg in enumerate(segments, start=1):
        toks = np.asarray(seg, np.int32)
        n = min(len(toks) - 1, max_len - off)
        if n <= 0:
            break
        inputs[off : off + n] = toks[:n]
        targets[off : off + n] = toks[1 : n + 1]
        segmentation[off : off + n] = seg_id
        positions[off : off + n] = np.arange(n)
        off += n
    return {
        "inputs": inputs,
        "targets": targets,
        "inputs_segmentation": segmentation,
        "targets_segmentation": segmentation.copy(),
        "inputs_position": positions,
    }


class PackedBatcher:
    """Streams token-lists -> packed batches of shape [batch, max_len]."""

    def __init__(self, source: Iterator[list[int]], batch_size: int, max_len: int,
                 pack: bool = True):
        self.source = source
        self.batch_size = batch_size
        self.max_len = max_len
        self.pack = pack
        self._pending: list[dict[str, np.ndarray]] = []

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        while len(self._pending) < self.batch_size:
            chunk = []
            try:
                for _ in range(self.batch_size * 2):
                    chunk.append(next(self.source))
            except StopIteration:
                if not chunk and not self._pending:
                    raise
            if not chunk:
                break
            if self.pack:
                self._pending.extend(pack_examples(chunk, self.max_len))
            else:
                self._pending.extend(
                    finalize_row([ex], self.max_len) for ex in chunk
                )
        take, self._pending = self._pending[: self.batch_size], self._pending[self.batch_size:]
        while len(take) < self.batch_size:  # pad the final partial batch
            take.append(finalize_row([[0, 0]], self.max_len))
        return {k: np.stack([row[k] for row in take]) for k in take[0]}
