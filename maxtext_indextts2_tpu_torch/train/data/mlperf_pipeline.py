"""MLPerf GPT-3 style C4 pipeline (``dataset_type=c4_mlperf``).

This package's own copy of the JAX package's
``train/data/mlperf_pipeline.py`` (numpy only; ``tests/test_torch_data.py``
holds the batches of the two equal; ``datasets`` is imported only to stream a
named HF dataset). Reference: MaxText/input_pipeline/_tfds_data_processing_c4_mlperf.py
(reduce_concat_tokens:90, split_tokens:118, format_fn:235,
preprocess_train_dataset:247). The distinctive semantics, reproduced here
host-side in NumPy (no tf.data dependency):

1. Documents are tokenized then **concatenated across document boundaries**
   and re-split into exactly ``max_target_length``-token segments, so no
   space is wasted on padding (reference reduce_concat_tokens +
   split_tokens_to_targets_length).
2. Segments are greedily packed (mostly 1 segment/row since they are full).
3. MLPerf row format (reference format_fn:235): ``inputs`` is the raw
   segment, ``targets`` is the segment shifted LEFT by one with EOS
   appended, and segmentation is zeroed wherever targets hit EOS/pad so
   those positions carry no loss.
"""

from __future__ import annotations

from collections.abc import Iterable, Iterator

import numpy as np

from maxtext_indextts2_tpu_torch.config import Config


def concat_and_split(
    doc_tokens: Iterable[list[int]],
    segment_length: int,
    docs_per_concat: int = 128,
) -> Iterator[list[int]]:
    """Concatenate document token lists, re-split into full segments.

    Matches reference reduce_concat_tokens (batch docs, flatten, strip pad
    zeros) followed by split_tokens (pad the tail segment only). The final
    partial segment of each concat group is emitted as-is (reference keeps
    it: "Only the final segment may be shorter").
    """
    group: list[int] = []
    n_docs = 0
    for toks in doc_tokens:
        group.extend(t for t in toks if t != 0)
        n_docs += 1
        if n_docs >= docs_per_concat:
            while len(group) >= segment_length:
                yield group[:segment_length]
                group = group[segment_length:]
            n_docs = 0
    while len(group) >= segment_length:
        yield group[:segment_length]
        group = group[segment_length:]
    if group:
        yield group


def format_mlperf_row(
    segment: list[int], max_len: int, eos_id: int = 1, pad_id: int = 0
) -> dict[str, np.ndarray]:
    """One packed row in mlperf format (reference format_fn:235)."""
    toks = np.asarray(segment[:max_len], np.int32)
    n = len(toks)
    inputs = np.full(max_len, pad_id, np.int32)
    inputs[:n] = toks
    # shift left, pad with eos (reference _shift_left_and_pad:47)
    targets = np.full(max_len, eos_id, np.int32)
    targets[: n - 1] = toks[1:]
    targets[n:] = pad_id
    seg = np.zeros(max_len, np.int32)
    seg[:n] = 1
    # zero loss/attention where targets are eos or pad (format_fn:240-243)
    seg = np.where((targets != eos_id) & (targets != pad_id), seg, 0).astype(np.int32)
    pos = np.zeros(max_len, np.int32)
    pos[:n] = np.arange(n)
    return {
        "inputs": inputs,
        "targets": targets,
        "inputs_segmentation": seg,
        "targets_segmentation": seg.copy(),
        "inputs_position": pos,
    }


class MlperfBatcher:
    """Streams segments -> [batch, max_len] mlperf-format batches."""

    def __init__(self, segments: Iterator[list[int]], batch_size: int,
                 max_len: int, eos_id: int = 1, pad_id: int = 0):
        self.segments = segments
        self.batch_size = batch_size
        self.max_len = max_len
        self.eos_id = eos_id
        self.pad_id = pad_id
        self._done = False

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        rows = []
        for _ in range(self.batch_size):
            try:
                rows.append(
                    format_mlperf_row(next(self.segments), self.max_len,
                                      self.eos_id, self.pad_id)
                )
            except StopIteration:
                break
        if not rows:
            raise StopIteration
        while len(rows) < self.batch_size:  # pad final batch (reference
            rows.append(format_mlperf_row([self.pad_id], self.max_len,
                                          self.eos_id, self.pad_id))
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def _document_tokens(cfg: Config, process_index: int, process_count: int):
    """Token lists per document from dataset_path (.jsonl/.txt local file or
    HF streaming dataset name)."""
    from maxtext_indextts2_tpu_torch.train.data.tokenizer import build_tokenizer

    tok = build_tokenizer(cfg)
    path = cfg.dataset_path
    if path.endswith((".jsonl", ".json")):
        import json

        def gen():
            with open(path) as f:
                for i, line in enumerate(f):
                    if i % process_count != process_index or not line.strip():
                        continue
                    ex = json.loads(line)
                    text = ex.get("text") or ex.get("content") or ""
                    if text:
                        yield tok.encode(text)

        return gen()
    if path.endswith(".txt"):
        def gen():
            with open(path) as f:
                for i, line in enumerate(f):
                    if i % process_count != process_index or not line.strip():
                        continue
                    yield tok.encode(line.strip())

        return gen()

    from datasets import load_dataset  # HF streaming (e.g. allenai/c4)

    ds = load_dataset(path, split=cfg.dataset_split or "train", streaming=True)
    if process_count > 1:
        ds = ds.shard(num_shards=process_count, index=process_index)

    def gen():
        for ex in ds:
            text = ex.get("text") or ex.get("content") or ""
            if text:
                yield tok.encode(text)

    return gen()


def make_c4_mlperf_iterator(cfg: Config, process_index: int = 0,
                            process_count: int = 1) -> MlperfBatcher:
    """Reference make_c4_mlperf_train_iterator:319, tf.data-free."""
    docs = _document_tokens(cfg, process_index, process_count)
    segments = concat_and_split(docs, cfg.max_target_length)
    batch = cfg.global_batch_size_to_load // process_count
    return MlperfBatcher(segments, batch, cfg.max_target_length,
                         eos_id=cfg.eos_id, pad_id=0)
