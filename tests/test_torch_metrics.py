"""The PyTorch package's ``MetricLogger`` against the JAX package's: the same
``write_step`` calls go through both, and what they write must agree.

- JSONL: the same keys, and equal values for every key but the wall-clock
  ``ts`` and the chip-dependent ``mfu`` (each package divides by its own
  card's peak). The JAX logger gets ``num_devices=1``, the port's one device.
- ``metrics_upload_dir``: both mirror the JSONL there at step 0 (every 100
  steps) and at ``close``; a ``gs://`` destination goes to the same
  ``gsutil`` command, best effort (a missing ``gsutil`` raises nothing).
- TensorBoard: both write event files under ``<base_output_directory>/
  <run_name>/tb``; read back with ``event_accumulator``, tags, steps and
  values are equal but for ``mfu``. The JAX package writes TF2 tensor
  summaries, the port scalar summaries: both are read as floats.

Values are compared exactly: both loggers turn the same Python floats into
JSON and float32 event values.
"""

import dataclasses
import json
import os
import subprocess

import numpy as np
import pytest

from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.utils import metrics as jmetrics
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.utils import metrics

CHIP_DEPENDENT = {"mfu"}
STEPS = [  # (step, metrics, step_time, tflops_per_step, tokens_per_step)
    (0, {"loss": 6.25, "grad_norm": 1.5}, 0.5, 12.0, 8192),
    (1, {"loss": 5.5, "grad_norm": 1.25}, 0.25, 12.0, 8192),
    (1, {"eval_loss": 5.75, "eval_weight": 100.0}, 0.0, 0.0, 0),
    (2, {"loss": 5.0, "grad_norm": 1.0, "param_norm": 40.0}, 0.125, 0.0, 0),
]


def _loggers(tmp_path, **overrides):
    args = [f"base_output_directory={tmp_path}", "run_name=r"]
    cfgs = {}
    for name, load in (("jax", jax_load_config), ("torch", load_config)):
        cfg = load(args)
        cfgs[name] = dataclasses.replace(cfg, metrics_file=str(tmp_path / name / "m.jsonl"),
                                         **{k: (v(name) if callable(v) else v)
                                            for k, v in overrides.items()})
    jlog = jmetrics.MetricLogger(dataclasses.replace(cfgs["jax"], num_devices=1))
    tlog = metrics.MetricLogger(cfgs["torch"], quiet=True)
    for step, m, dt, tflops, tokens in STEPS:
        jlog.write_step(step, dict(m), step_time=dt, tflops_per_step=tflops,
                        tokens_per_step=tokens)
        tlog.write_step(step, dict(m), step_time=dt, tflops_per_step=tflops,
                        tokens_per_step=tokens)
    return jlog, tlog


def _rows(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def test_jsonl_keys_and_values_equal_the_jax_loggers(tmp_path):
    jlog, tlog = _loggers(tmp_path)
    jlog.close()
    tlog.close()
    want, got = _rows(tmp_path / "jax" / "m.jsonl"), _rows(tmp_path / "torch" / "m.jsonl")
    assert len(got) == len(want) == len(STEPS)
    for g, w in zip(got, want):
        assert set(g) == set(w), (sorted(g), sorted(w))
        assert "per_device_tflops_per_s" in g or "tokens_per_s" not in g
        for key in set(w) - CHIP_DEPENDENT - {"ts"}:
            assert g[key] == w[key], key


def test_jsonl_is_mirrored_to_the_upload_dir_at_step_0_and_close(tmp_path):
    jlog, tlog = _loggers(tmp_path, metrics_upload_dir=lambda name: str(tmp_path / f"up_{name}"))
    for name in ("jax", "torch"):  # step 0's copy: the first line only
        assert len(_rows(tmp_path / f"up_{name}" / "m.jsonl")) == 1
    jlog.close()
    tlog.close()
    for name in ("jax", "torch"):
        assert (tmp_path / f"up_{name}" / "m.jsonl").read_bytes() == \
            (tmp_path / name / "m.jsonl").read_bytes()
    tlog.close()  # closing twice is harmless


def test_gs_upload_calls_gsutil_as_the_jax_logger_and_never_raises(tmp_path, monkeypatch):
    calls = []

    def run(cmd, **kw):
        calls.append((cmd, kw))
        raise FileNotFoundError("gsutil")  # no gsutil here: best effort

    monkeypatch.setattr(subprocess, "run", run)
    jlog, tlog = _loggers(tmp_path, metrics_upload_dir="gs://bucket/run/")
    jlog.close()
    tlog.close()
    by_file = {}
    for cmd, kw in calls:
        by_file.setdefault(os.path.basename(os.path.dirname(cmd[3])), []).append((cmd, kw))
    assert len(by_file["jax"]) == len(by_file["torch"]) == 2  # step 0 and close
    for (jcmd, jkw), (tcmd, tkw) in zip(by_file["jax"], by_file["torch"]):
        assert jcmd[:3] == tcmd[:3] == ["gsutil", "-q", "cp"]
        assert jcmd[4] == tcmd[4] == "gs://bucket/run/"
        assert jkw == tkw == {"check": False, "timeout": 60}


def _scalars(directory) -> dict[str, list[tuple[int, float]]]:
    from tensorboard.backend.event_processing import event_accumulator
    from tensorboard.util import tensor_util

    acc = event_accumulator.EventAccumulator(str(directory), size_guidance={
        event_accumulator.SCALARS: 0, event_accumulator.TENSORS: 0})
    acc.Reload()
    tags = acc.Tags()
    out = {tag: [(e.step, float(e.value)) for e in acc.Scalars(tag)] for tag in tags["scalars"]}
    for tag in tags["tensors"]:
        out[tag] = [(e.step, float(np.float32(tensor_util.make_ndarray(e.tensor_proto))))
                    for e in acc.Tensors(tag)]
    return out


def test_tensorboard_event_files_hold_the_jax_loggers_scalars(tmp_path):
    jlog, tlog = _loggers(tmp_path, enable_tensorboard=True,
                          base_output_directory=lambda name: str(tmp_path / f"tb_{name}"))
    jlog.close()
    tlog.close()
    want = _scalars(tmp_path / "tb_jax" / "r" / "tb")
    got = _scalars(tmp_path / "tb_torch" / "r" / "tb")
    assert set(got) == set(want) and "loss" in got and "mfu" in got
    for tag in set(want) - CHIP_DEPENDENT:
        assert got[tag] == want[tag], tag


def test_tensorboard_without_its_package_writes_nothing(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    cfg = dataclasses.replace(load_config([f"base_output_directory={tmp_path}"]),
                              enable_tensorboard=True)
    log = metrics.MetricLogger(cfg, quiet=True)
    log.write_step(0, {"loss": 1.0}, step_time=0.5)
    log.close()
    assert not (tmp_path / cfg.run_name / "tb").exists()


@pytest.mark.parametrize("tflops,step_time", [(12.0, 0.5), (0.0, 0.5), (12.0, 0.0)])
def test_per_device_rate_and_mfu_use_the_one_card(tflops, step_time):
    log = metrics.MetricLogger(load_config([]), quiet=True)
    out = log.write_step(0, {"loss": 1.0}, step_time=step_time, tflops_per_step=tflops)
    if tflops and step_time:
        assert out["per_device_tflops_per_s"] == tflops / step_time
        assert out["mfu"] == metrics.flops_lib.mfu(tflops, step_time)
    else:
        assert "per_device_tflops_per_s" not in out and "mfu" not in out
