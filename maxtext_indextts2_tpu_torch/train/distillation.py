"""Distillation data: teacher completions -> an SFT dataset.

Counterpart of the JAX package's ``train/distillation.py``: the offline
engine completes a prompt set and the pairs are written as JSONL
(``prompt``, ``prompt_ids``, ``completion_ids``, ``completion``), which
``train/sft.py`` reads (``dataset_path=<file>.jsonl``).

Run: ``python -m maxtext_indextts2_tpu_torch.train.distillation <config.yml>
distillation_out=/tmp/distill.jsonl key=value ...`` (``device=cpu`` for the CPU).
"""

from __future__ import annotations

import json

import numpy as np

from maxtext_indextts2_tpu_torch.config import Config, load_config
from maxtext_indextts2_tpu_torch.infer.offline_engine import OfflineEngine
from maxtext_indextts2_tpu_torch.train.data.tokenizer import build_tokenizer


def generate_distillation_data(cfg: Config, prompts, out_path: str, max_new_tokens: int = 64,
                               engine=None, device=None) -> int:
    """Complete ``prompts`` (strings or token-id arrays) and write one JSONL
    line a prompt; returns the number written."""
    tok = build_tokenizer(cfg)
    if prompts and isinstance(prompts[0], str):
        prompt_ids = [np.asarray(tok.encode(p), np.int32) for p in prompts]
        texts = list(prompts)
    else:
        prompt_ids = [np.asarray(p, np.int32) for p in prompts]
        texts = [tok.decode(list(p)) for p in prompt_ids]
    completions = OfflineEngine(cfg, engine=engine, device=device).generate_batch(
        prompt_ids, max_new_tokens)
    n = 0
    with open(out_path, "w") as f:
        for text, pids, comp in zip(texts, prompt_ids, completions):
            f.write(json.dumps({"prompt": text, "prompt_ids": pids.tolist(),
                                "completion_ids": comp, "completion": tok.decode(comp)}) + "\n")
            n += 1
    return n


def main(argv=None):
    import sys

    from maxtext_indextts2_tpu_torch.infer.server import split_device_arg

    argv, device = split_device_arg(list(sys.argv[1:] if argv is None else argv))
    out = "/tmp/distillation.jsonl"
    keep = []
    for a in argv:
        if a.startswith("distillation_out="):
            out = a.split("=", 1)[1]
        else:
            keep.append(a)
    cfg = load_config(keep)
    prompts = ["hello world", "the quick brown fox", "once upon a time"]
    n = generate_distillation_data(cfg, prompts, out, device=device)
    print(f"wrote {n} distillation examples to {out}")


if __name__ == "__main__":
    main()
