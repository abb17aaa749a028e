"""Metric logging: stdout, JSONL and TensorBoard.

Counterpart of the JAX package's ``utils/metrics.py`` ``MetricLogger``: one
line per step on stdout, one JSON object per step in ``metrics_file`` when
set (the JAX package's keys: the step's metrics, ``step_time_s``,
``per_device_tflops_per_s``, ``mfu``, ``tokens_per_s``), mirrored to
``metrics_upload_dir`` every 100 steps and at ``close`` (a plain copy, or
``gsutil cp`` for ``gs://``; best effort: metric delivery never takes a
training job down), and with ``enable_tensorboard`` one scalar per key and
step under ``<base_output_directory>/<run_name>/tb``
(``torch.utils.tensorboard``; where its package cannot be imported nothing
is written, as in the JAX package). The MFU is against the H100's dense
bf16 peak (``utils/flops.py``).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import time
from typing import Any

from maxtext_indextts2_tpu_torch.config import Config
from maxtext_indextts2_tpu_torch.utils import flops as flops_lib

_SHOWN = ("loss", "grad_norm", "step_time_s", "per_device_tflops_per_s", "tokens_per_s", "mfu")
UPLOAD_PERIOD = 100


class MetricLogger:
    def __init__(self, cfg: Config, quiet: bool = False):
        self.cfg = cfg
        self.quiet = quiet
        self._jsonl = None
        if cfg.metrics_file:
            os.makedirs(os.path.dirname(cfg.metrics_file) or ".", exist_ok=True)
            self._jsonl = open(cfg.metrics_file, "a")
        self._tb = None
        if cfg.enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(
                    os.path.join(cfg.base_output_directory, cfg.run_name, "tb"))
            except ImportError:
                pass

    def write_step(self, step: int, metrics: dict[str, Any], step_time: float,
                   tflops_per_step: float = 0.0, tokens_per_step: int = 0) -> dict:
        scalars = {k: float(v) for k, v in metrics.items()}
        scalars["step_time_s"] = step_time
        if tflops_per_step and step_time > 0:
            scalars["per_device_tflops_per_s"] = tflops_per_step / step_time
            scalars["mfu"] = flops_lib.mfu(tflops_per_step, step_time)
        if tokens_per_step and step_time > 0:
            scalars["tokens_per_s"] = tokens_per_step / step_time
        if not self.quiet:
            line = ", ".join(f"{k}: {v:.4g}" for k, v in scalars.items() if k in _SHOWN)
            print(f"step {step}: {line}", flush=True)
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, "ts": time.time(), **scalars}) + "\n")
            self._jsonl.flush()
            if step % UPLOAD_PERIOD == 0:
                self._maybe_upload()
        if self._tb:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        return scalars

    def _maybe_upload(self) -> None:
        """Mirror the JSONL to ``metrics_upload_dir`` (``gsutil cp`` for
        ``gs://``, a plain copy otherwise). Best effort: a failed copy is
        dropped."""
        dest, src = self.cfg.metrics_upload_dir, self.cfg.metrics_file
        if not dest or not src:
            return
        try:
            if dest.startswith("gs://"):
                subprocess.run(["gsutil", "-q", "cp", src, dest.rstrip("/") + "/"],
                               check=False, timeout=60)
            else:
                os.makedirs(dest, exist_ok=True)
                shutil.copy2(src, dest)
        except Exception:  # noqa: BLE001
            pass

    def close(self):
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
            self._maybe_upload()
        if self._tb:
            self._tb.close()
            self._tb = None
