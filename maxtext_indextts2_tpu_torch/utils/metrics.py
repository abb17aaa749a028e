"""Metric logging: stdout and JSONL.

Counterpart of the JAX package's ``utils/metrics.py`` ``MetricLogger``: one
line per step on stdout, one JSON object per step in ``metrics_file`` when
set, with the step time, tokens/s, TFLOP/s and MFU against the H100's dense
bf16 peak (``utils/flops.py``) beside the step's metrics. TensorBoard is not
ported (``enable_tensorboard`` raises); there is no upload.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

from maxtext_indextts2_tpu_torch.config import Config
from maxtext_indextts2_tpu_torch.unported import _unsupported
from maxtext_indextts2_tpu_torch.utils import flops as flops_lib

_SHOWN = ("loss", "grad_norm", "step_time_s", "tflops_per_s", "tokens_per_s", "mfu")


class MetricLogger:
    def __init__(self, cfg: Config, quiet: bool = False):
        if cfg.enable_tensorboard:
            _unsupported("TensorBoard metric logging", "4b, rest of training: item 4b.7")
        self.cfg = cfg
        self.quiet = quiet
        self._jsonl = None
        if cfg.metrics_file:
            os.makedirs(os.path.dirname(cfg.metrics_file) or ".", exist_ok=True)
            self._jsonl = open(cfg.metrics_file, "a")

    def write_step(self, step: int, metrics: dict[str, Any], step_time: float,
                   tflops_per_step: float = 0.0, tokens_per_step: int = 0) -> dict:
        scalars = {k: float(v) for k, v in metrics.items()}
        scalars["step_time_s"] = step_time
        if tflops_per_step and step_time > 0:
            scalars["tflops_per_s"] = tflops_per_step / step_time
            scalars["mfu"] = flops_lib.mfu(tflops_per_step, step_time)
        if tokens_per_step and step_time > 0:
            scalars["tokens_per_s"] = tokens_per_step / step_time
        if not self.quiet:
            line = ", ".join(f"{k}: {v:.4g}" for k, v in scalars.items() if k in _SHOWN)
            print(f"step {step}: {line}", flush=True)
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, "ts": time.time(), **scalars}) + "\n")
            self._jsonl.flush()
        return scalars

    def close(self):
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
