"""Supervised fine-tuning: the loss masked to the completion tokens.

Counterpart of the JAX package's ``train/sft.py``, on numpy rows and the
trainer of ``train/train.py``: the only difference from pretraining is the
data, rows whose ``targets_segmentation`` is zero over the prompt's
positions, so the cross-entropy ignores them.

Run: ``python -m maxtext_indextts2_tpu_torch.train.sft <config.yml> key=value ...``
(``dataset_path`` names a HuggingFace dataset of prompt / completion or chat
rows; without it, synthetic prompt / completion pairs). The trainer runs on
the GPU; ``device=cpu`` asks for the CPU.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np

from maxtext_indextts2_tpu_torch.config import Config, load_config
from maxtext_indextts2_tpu_torch.train.data.packing import finalize_row
from maxtext_indextts2_tpu_torch.train.data.tokenizer import build_tokenizer


def mask_prompt_targets(row: dict, prompt_len: int) -> dict:
    """Zero the loss weights over the prompt region of an (unpacked) row."""
    tseg = row["targets_segmentation"].copy()
    tseg[: max(prompt_len - 1, 0)] = 0  # target at i predicts token i+1
    return {**row, "targets_segmentation": tseg}


def sft_example_to_row(prompt_ids: list[int], completion_ids: list[int], max_len: int) -> dict:
    row = finalize_row([list(prompt_ids) + list(completion_ids)], max_len)
    return mask_prompt_targets(row, len(prompt_ids))


class SFTDataIterator:
    """Yields numpy batches of prompt-masked rows."""

    def __init__(self, cfg: Config, source: Iterator[tuple[list[int], list[int]]] | None = None):
        self.cfg = cfg
        self.batch = cfg.global_batch_size_to_load
        self.max_len = cfg.max_target_length
        self.source = source or self._synthetic()

    def _synthetic(self):
        rng = np.random.default_rng(self.cfg.data_shuffle_seed)
        v = self.cfg.vocab_size
        while True:
            p = rng.integers(3, min(v, 64), size=int(rng.integers(4, 16))).tolist()
            c = rng.integers(3, min(v, 64), size=int(rng.integers(4, 32))).tolist()
            yield p, c

    def __iter__(self):
        return self

    def __next__(self):
        rows = [sft_example_to_row(*next(self.source), self.max_len) for _ in range(self.batch)]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def hf_sft_source(cfg: Config):
    """A ``{'prompt', 'completion'}`` or chat-format HF dataset -> (ids, ids)."""
    from datasets import load_dataset

    tok = build_tokenizer(cfg)
    ds = load_dataset(cfg.dataset_path, split="train", streaming=True)
    for ex in ds:
        if "messages" in ex:  # chat format: all but the last message are the prompt
            msgs = ex["messages"]
            prompt = "\n".join(m["content"] for m in msgs[:-1])
            completion = msgs[-1]["content"]
        else:
            prompt = ex.get("prompt", "")
            completion = ex.get("completion") or ex.get("response", "")
        yield tok.encode(prompt), tok.encode(completion)


def train_sft(cfg: Config, device=None, quiet: bool = False):
    """``train/train.train_loop`` on :class:`SFTDataIterator`'s batches: the
    HF dataset of ``dataset_path``, else synthetic pairs."""
    from maxtext_indextts2_tpu_torch.train import train as train_lib

    source = hf_sft_source(cfg) if cfg.dataset_path else None
    it = SFTDataIterator(cfg, source)
    orig = train_lib.create_data_iterator
    train_lib.create_data_iterator = lambda c, dev: train_lib.DeviceBatches(it, dev)
    try:
        return train_lib.train_loop(cfg, device, quiet=quiet)
    finally:
        train_lib.create_data_iterator = orig


def main(argv=None):
    import sys

    from maxtext_indextts2_tpu_torch.infer.server import split_device_arg

    argv, device = split_device_arg(list(sys.argv[1:] if argv is None else argv))
    metrics = train_sft(load_config(argv), device)
    print({k: v for k, v in metrics.items() if k != "history"})
    return metrics


if __name__ == "__main__":
    main()


def vision_sft_example_to_row(cfg: Config, image, prompt_ids: list[int], answer_ids: list[int],
                              tokens_per_image: int, image_size: int = 224):
    """A vision-SFT row: the prompt carries one image placeholder expanded to
    ``tokens_per_image`` slots of ``cfg.image_token_id``; the loss is masked
    to the answer. Returns (row dict, pixels [tiles, S, S, 3]).

    Training composition: encode ``pixels`` with ``models/vision.VisionEncoder``
    (and the family's projector), then pass the result as
    ``vision_embeddings`` to ``Transformer.forward``, the fusion path of the
    multimodal tests."""
    from maxtext_indextts2_tpu_torch.utils.multimodal import (
        ImagePreprocessConfig,
        insert_image_tokens,
        preprocess_image,
    )

    s = cfg.max_target_length
    placeholder = -7  # internal marker, expanded below
    seq = list(prompt_ids) + [placeholder] + list(answer_ids)
    tokens, img_mask = insert_image_tokens(np.asarray(seq, np.int32), placeholder,
                                           tokens_per_image, cfg.image_token_id, s)
    # the answer starts after the prompt and the image tokens
    ans_start = min(len(prompt_ids) + tokens_per_image, s)
    ans_end = min(ans_start + len(answer_ids), s)
    targets = np.roll(tokens, -1)
    targets[-1] = 0
    weights = np.zeros((s,), np.float32)
    weights[max(ans_start - 1, 0): max(ans_end - 1, 0)] = 1.0  # predict the answer tokens
    row = {
        "inputs": tokens,
        "inputs_position": np.arange(s, dtype=np.int32),
        "inputs_segmentation": (tokens != 0).astype(np.int32),
        "targets": targets,
        "targets_segmentation": (weights > 0).astype(np.int32),
        "image_mask": img_mask,
    }
    pixels = preprocess_image(image, ImagePreprocessConfig(image_size=image_size))
    return row, pixels
