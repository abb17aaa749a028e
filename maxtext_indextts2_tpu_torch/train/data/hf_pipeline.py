"""HuggingFace dataset pipelines (this package's own copy of the JAX
package's ``train/data/hf_pipeline.py``, ``datasets`` imported only to load a
split; reference:
input_pipeline/_hf_data_processing.py:35 preprocessing_pipeline, :145
vision_sft_preprocessing_pipeline).

- ``make_hf_iterator``: streaming pretraining pipeline — configurable text
  columns (cfg.train_data_columns), tokenize -> pack -> batches.
- ``make_hf_eval_iterator``: same pipeline over cfg.eval_split with
  cfg.eval_data_columns.
- ``make_hf_vision_sft_iterator``: streamed multimodal SFT rows
  (``train/sft.vision_sft_example_to_row``) with their pixels.
"""

from __future__ import annotations

from maxtext_indextts2_tpu_torch.config import Config
from maxtext_indextts2_tpu_torch.train.data.packing import PackedBatcher
from maxtext_indextts2_tpu_torch.train.data.tokenizer import build_tokenizer


def _load_split(cfg: Config, split: str, dataset=None):
    if dataset is not None:  # injected in-memory dataset (tests, offline)
        return dataset
    from datasets import load_dataset

    return load_dataset(cfg.dataset_path, split=split, streaming=True)


def _text_iterator(cfg: Config, ds, columns, process_index, process_count):
    tokenizer = build_tokenizer(cfg)
    if cfg.enable_data_shuffling and hasattr(ds, "shuffle"):
        try:
            ds = ds.shuffle(seed=cfg.data_shuffle_seed, buffer_size=10_000)
        except TypeError:  # non-streaming datasets take no buffer_size
            ds = ds.shuffle(seed=cfg.data_shuffle_seed)
    if process_count > 1:
        ds = ds.shard(num_shards=process_count, index=process_index)

    def gen():
        for ex in ds:
            for col in columns:
                text = ex.get(col)
                if text:
                    yield tokenizer.encode(text)
                    break

    batch = cfg.global_batch_size_to_load // process_count
    return PackedBatcher(gen(), batch, cfg.max_target_length, pack=cfg.packing)


def make_hf_iterator(cfg: Config, process_index: int = 0, process_count: int = 1,
                     dataset=None):
    ds = _load_split(cfg, cfg.dataset_split, dataset)
    return _text_iterator(
        cfg, ds, tuple(cfg.train_data_columns) or ("text", "content"),
        process_index, process_count,
    )


def make_hf_eval_iterator(cfg: Config, process_index: int = 0,
                          process_count: int = 1, dataset=None):
    """Eval-split iterator (reference preprocessing_pipeline is built once
    per split; eval uses config.hf_eval_split)."""
    assert cfg.eval_split or dataset is not None, "set cfg.eval_split"
    ds = _load_split(cfg, cfg.eval_split, dataset)
    return _text_iterator(
        cfg, ds, tuple(cfg.eval_data_columns) or ("text", "content"),
        process_index, process_count,
    )


def make_hf_vision_sft_iterator(cfg: Config, process_index: int = 0, process_count: int = 1,
                                dataset=None, tokens_per_image: int = 16,
                                image_size: int = 224):
    """Streamed multimodal SFT batches. Rows need an image column (``image``,
    or the first of ``images``) and prompt / completion text columns
    (``cfg.train_data_columns`` when it names two, else ``("prompt",
    "completion")``); rows without an image are skipped. Yields numpy
    ``{"inputs", "targets", "targets_segmentation", ..., "image_mask",
    "pixels" [B, tiles, S, S, 3]}``: run the pixels through
    ``models/vision.VisionEncoder`` and feed the result as
    ``vision_embeddings`` to ``Transformer.forward``."""
    import numpy as np

    from maxtext_indextts2_tpu_torch.train.sft import vision_sft_example_to_row

    cols = tuple(cfg.train_data_columns)
    # the pretraining default ("text", "content") is a probe order, not an
    # SFT (prompt, completion) pair: fall through to the SFT default
    text_cols = cols if len(cols) == 2 and cols != ("text", "content") else ("prompt",
                                                                             "completion")
    tokenizer = build_tokenizer(cfg)
    ds = _load_split(cfg, cfg.dataset_split, dataset)
    if process_count > 1:
        ds = ds.shard(num_shards=process_count, index=process_index)
    batch = cfg.global_batch_size_to_load // process_count

    def gen():
        rows, pixel_stack = [], []
        for ex in ds:
            image = ex.get("image")
            if image is None:
                imgs = ex.get("images")
                image = imgs[0] if imgs else None
            if image is None:
                continue
            image = np.asarray(image)
            if image.ndim == 4:  # a list-of-images column decoded as [N, H, W, C]
                image = image[0]
            row, pixels = vision_sft_example_to_row(
                cfg, image, tokenizer.encode(ex.get(text_cols[0]) or ""),
                tokenizer.encode(ex.get(text_cols[1]) or ""), tokens_per_image, image_size)
            rows.append(row)
            pixel_stack.append(pixels)
            if len(rows) == batch:
                out = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
                out["pixels"] = np.stack(pixel_stack)
                yield out
                rows, pixel_stack = [], []

    return gen()
