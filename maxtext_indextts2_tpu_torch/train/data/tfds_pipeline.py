"""TFDS text-dataset pipeline (``dataset_type=tfds``; this package's own copy
of the JAX package's ``train/data/tfds_pipeline.py``; reference:
input_pipeline/_tfds_data_processing.py:80): per-process shard -> shuffle ->
tokenize -> pack -> batches.

``tensorflow_datasets`` is imported only when records are read from a
dataset (a missing package raises an ImportError that names it), and the
preprocessing is pure Python over ``tfds.data_source`` (ArrayRecord random
access, no tf.data graph); ``examples=`` takes injected records instead. ``dataset_path`` names the
dataset, optionally ``name@data_dir`` to point at a prepared directory.
"""

from __future__ import annotations

from typing import Iterable, Iterator

from maxtext_indextts2_tpu_torch.config import Config
from maxtext_indextts2_tpu_torch.train.data.packing import PackedBatcher
from maxtext_indextts2_tpu_torch.train.data.tokenizer import build_tokenizer


def _tfds_examples(cfg: Config, process_index: int, process_count: int) -> Iterator[dict]:
    try:
        import tensorflow_datasets as tfds
    except ImportError as e:
        raise ImportError(
            "dataset_type=tfds needs the tensorflow_datasets package, which "
            "is not installed here. Use dataset_type=grain/hf/"
            "c4_mlperf for the same data semantics without tf, or install "
            "tensorflow_datasets."
        ) from e

    name, _, data_dir = cfg.dataset_path.partition("@")
    source = tfds.data_source(name, data_dir=data_dir or None)["train"]
    n = len(source)
    # contiguous per-process shard, like the reference's shard_options
    lo = n * process_index // process_count
    hi = n * (process_index + 1) // process_count
    order = list(range(lo, hi))
    if cfg.enable_data_shuffling:
        import random

        random.Random(cfg.data_shuffle_seed).shuffle(order)
    for i in order:
        yield source[i]


def make_tfds_iterator(
    cfg: Config,
    process_index: int = 0,
    process_count: int = 1,
    examples: Iterable[dict] | None = None,
):
    """``examples`` injects a record stream for tests (dicts with a
    text/content field, as tfds text datasets yield)."""
    if examples is None:
        examples = _tfds_examples(cfg, process_index, process_count)
    tokenizer = build_tokenizer(cfg)

    def gen():
        for ex in examples:
            text = ex.get("text") or ex.get("content") or b""
            if isinstance(text, bytes):
                text = text.decode("utf-8", errors="replace")
            if text:
                yield tokenizer.encode(text)

    batch = cfg.global_batch_size_to_load // process_count
    return PackedBatcher(gen(), batch, cfg.max_target_length, pack=cfg.packing)
