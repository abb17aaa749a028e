"""Batch-decode CLI.

Run: ``python -m maxtext_indextts2_tpu_torch.infer.decode <cfg.yml> key=value ...``
Decodes ``prompt`` (comma-separated token ids) for ``max_new_tokens`` tokens
and prints the result; the weights come from ``load_parameters_path`` (a
checkpoint of ``train/checkpointing.py``), or are seeded random weights when
it is empty. Runs on the GPU; ``device=cpu`` asks for the CPU explicitly.
"""

from __future__ import annotations

import sys

import numpy as np

from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.infer.server import split_device_arg


def main(argv=None, prompt_ids=None, max_new_tokens: int = 16, device=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    argv, cli_device = split_device_arg(argv)
    device = cli_device or device
    extra = [a for a in argv if a.startswith(("prompt=", "max_new_tokens="))]
    argv = [a for a in argv if a not in extra]
    for a in extra:
        k, _, v = a.partition("=")
        if k == "prompt":
            prompt_ids = np.array([int(t) for t in v.split(",")], np.int32)
        else:
            max_new_tokens = int(v)
    if any(a.startswith("spec_draft=") for a in argv):
        raise NotImplementedError(
            "speculative decoding is not ported to the PyTorch/CUDA package yet "
            "(ROADMAP.md, port queue: 5, decode extras)")
    cfg = load_config(argv)
    if prompt_ids is None:
        prompt_ids = np.arange(1, 9, dtype=np.int32)

    engine = Engine(cfg, device=device)
    engine.load_params(cfg.load_parameters_path or None)
    out = engine.generate_stream(prompt_ids, max_new_tokens)
    print("prompt:", prompt_ids.tolist())
    print("completion:", out)
    if cfg.autoregressive_decode_assert:
        expected = [int(t) for t in cfg.autoregressive_decode_assert.split(",")]
        if out[: len(expected)] != expected:
            raise AssertionError(f"decode assert failed: {out[:len(expected)]} != {expected}")
        print("decode assert passed")
    return out


if __name__ == "__main__":
    main()
