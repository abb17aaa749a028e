"""Training checkpoints and params-only checkpoints, as ``torch.save`` files.

Counterpart of the JAX package's ``train/checkpointing.py`` (Orbax there). The
format is this package's own, one directory a checkpoint::

    a training step, <checkpoint_dir>/<step>, holds
        params.pt      {name: tensor}, the model's state dict
        opt_state.pt   {"count": int, "mu": {...}, "nu": {...}}
        meta.json      {"step": <steps taken>, "kind": "train_state"}
    a params-only checkpoint, <path>, holds params.pt and meta.json ("kind": "params")

Every file is read with ``torch.load(weights_only=True)``. A directory appears
under its final name only when all its files are written (it is written under
a temporary name and renamed), so a crash never leaves a step that looks
whole. Parameter names are unrolled (``decoder.layers_{i}``) or scan-stacked
(``decoder.layers`` with a leading layer axis); :func:`params_checkpoint_is_scanned`
tells which and :func:`unroll_scanned_params` unrolls.

IN-PLACE state: the training step updates parameters and Adam moments in
place, so a save copies every tensor off the live ones before it returns (to
pinned host memory, on the device's stream, so that the copies run before the
next step's updates); with ``async_checkpointing`` only the disk write runs in
a background thread, after a CUDA event says the copies are done.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
from collections.abc import Mapping

import torch

from maxtext_indextts2_tpu_torch.utils.param_bridge import LAYER_REGIONS, is_unrolled_key

logger = logging.getLogger(__name__)

PARAMS_FILE, OPT_FILE, META_FILE = "params.pt", "opt_state.pt", "meta.json"


class _Snapshot:
    """Host copies of a state's tensors: ``take`` enqueues them on the
    device's current stream and returns the copies with a CUDA event recorded
    after them (None when no tensor is on the GPU). Pinned buffers are kept
    and reused across saves of the same shapes."""

    def __init__(self):
        self._pinned: dict[tuple, torch.Tensor] = {}

    def take(self, tree):
        event = None

        def copy(key, t):
            nonlocal event
            t = t.detach()
            if t.device.type != "cuda":
                return t.clone()
            buf = self._pinned.get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                self._pinned[key] = buf
            buf.copy_(t, non_blocking=True)
            if event is None:
                event = torch.cuda.Event()
            return buf

        def walk(node, path):
            if isinstance(node, torch.Tensor):
                return copy(path, node)
            if isinstance(node, Mapping):
                return {k: walk(v, path + (k,)) for k, v in node.items()}
            return node

        out = walk(tree, ())
        if event is not None:
            event.record(torch.cuda.current_stream())
        return out, event


def _write_dir(final: str, files: dict[str, object], meta: dict) -> None:
    """Write ``files`` (name -> object for ``torch.save``) and ``meta.json``
    into ``final``, atomically."""
    parent = os.path.dirname(final)
    os.makedirs(parent, exist_ok=True)
    tmp = f"{final}.tmp-{os.getpid()}-{threading.get_ident()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    for name, obj in files.items():
        torch.save(obj, os.path.join(tmp, name))
    with open(os.path.join(tmp, META_FILE), "w") as fh:
        json.dump(meta, fh)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)


def _load(path: str, map_location="cpu"):
    return torch.load(path, map_location=map_location, weights_only=True, mmap=True)


class CheckpointManager:
    """``save(step, state)`` / ``maybe_restore(state)`` over one directory,
    keeping the newest ``max_to_keep`` steps (``cfg.checkpoint_max_to_keep``)."""

    def __init__(self, cfg, directory: str | None = None, max_to_keep: int | None = None):
        self.cfg = cfg
        self.directory = os.path.abspath(directory or cfg.checkpoint_dir)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = cfg.checkpoint_max_to_keep if max_to_keep is None else max_to_keep
        self.async_checkpointing = cfg.async_checkpointing
        self._snapshot = _Snapshot()
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def _steps(self) -> list[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isdir(os.path.join(self.directory, d)))

    def save(self, step: int, state, force: bool = False) -> bool:
        """Snapshot ``state`` (a ``train.TrainState``: ``params``,
        ``opt_state``, ``step``) and write it as step ``step``. The snapshot is
        complete, on the device's stream, before the next in-place update;
        with ``async_checkpointing`` the write runs in the background (one at
        a time: a save first waits for the previous one). ``force`` is kept
        for the JAX package's signature: every call saves."""
        self.wait()
        snap, event = self._snapshot.take({"params": state.params,
                                           "opt_state": state.opt_state})
        files = {PARAMS_FILE: snap["params"]}
        if snap["opt_state"] is not None:
            files[OPT_FILE] = snap["opt_state"]
        meta = {"step": int(state.step), "kind": "train_state"}
        final = os.path.join(self.directory, str(int(step)))

        def write():
            try:
                if event is not None:
                    event.synchronize()
                _write_dir(final, files, meta)
                if self.max_to_keep > 0:
                    for old in self._steps()[:-self.max_to_keep]:
                        shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
                logger.info("saved checkpoint at step %d -> %s", step, self.directory)
            except Exception as e:  # noqa: BLE001 - re-raised by wait() on the caller's thread
                self._error = e

        if self.async_checkpointing:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
            self._raise()
        return True

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def step_path(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def maybe_restore(self, state):
        """Restore the newest step into ``state`` IN PLACE (parameters,
        optimizer moments and count, step); returns ``state``, or None when
        there is no checkpoint."""
        self.wait()
        step = self.latest_step()
        if step is None:
            return None
        _restore_into(state, self.step_path(step))
        logger.info("restored checkpoint step %d from %s", step, self.directory)
        return state

    def _raise(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint write into {self.directory} failed") from err

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise()

    def close(self):
        self.wait()


def _copy_into(dst: dict, src: dict, what: str):
    missing, extra = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
    if missing or extra:
        raise KeyError(f"{what}: missing {missing}, unexpected {extra}")
    for name, t in dst.items():
        s = src[name]
        if tuple(s.shape) != tuple(t.shape) or s.dtype != t.dtype:
            raise ValueError(f"{what} {name}: checkpoint {tuple(s.shape)} {s.dtype}, "
                             f"state {tuple(t.shape)} {t.dtype}")
        t.copy_(s)


@torch.no_grad()
def _restore_into(state, path: str) -> None:
    """Copy the training checkpoint at ``path`` into ``state`` in place."""
    with open(os.path.join(path, META_FILE)) as fh:
        meta = json.load(fh)
    _copy_into(state.params, _load(os.path.join(path, PARAMS_FILE)), "params")
    opt = state.opt_state
    if opt is not None:
        saved = _load(os.path.join(path, OPT_FILE))
        for key in ("mu", "nu"):
            if key in opt:
                _copy_into(opt[key], saved[key], f"opt_state.{key}")
        opt["count"] = int(saved["count"])
    state.step = int(meta["step"])


class EmergencyCheckpointManager:
    """Two tiers (the JAX package's emergency manager, on plain files):

    - LOCAL (fast disk, ``local_checkpoint_directory``): saved every
      ``local_period`` steps, keeps 2;
    - PERSISTENT (``checkpoint_dir``): saved once ``persistent_period`` steps
      have passed since its last save (not on a modulo of the step number:
      save() is only called on local-period steps).

    Restore takes the tier that holds the newest step (local wins ties)."""

    def __init__(self, cfg):
        local_dir = cfg.local_checkpoint_directory or os.path.join(
            cfg.checkpoint_dir, "..", "local_emergency")
        self.local_period = max(1, cfg.local_checkpoint_period or cfg.checkpoint_period // 10)
        self.persistent_period = max(1, cfg.checkpoint_period)
        self.local = CheckpointManager(cfg, directory=local_dir, max_to_keep=2)
        self.local_dir = self.local.directory
        self.persistent = CheckpointManager(cfg)
        self._last_persistent = self.persistent.latest_step()

    def save(self, step: int, state, force: bool = False) -> bool:
        saved_local = self.local.save(step, state, force=True)
        saved_persistent = False
        last = self._last_persistent
        if force or last is None or step - last >= self.persistent_period:
            saved_persistent = self.persistent.save(step, state, force=True)
            if saved_persistent:
                self._last_persistent = step
        return saved_local or saved_persistent

    def latest_step(self) -> int | None:
        steps = [s for s in (self.local.latest_step(), self.persistent.latest_step())
                 if s is not None]
        return max(steps) if steps else None

    def maybe_restore(self, state):
        self.wait()
        local_step, persistent_step = self.local.latest_step(), self.persistent.latest_step()
        if local_step is None and persistent_step is None:
            return None
        if persistent_step is None or (local_step is not None and local_step >= persistent_step):
            return self.local.maybe_restore(state)
        return self.persistent.maybe_restore(state)

    def wait(self):
        self.local.wait()
        self.persistent.wait()

    def close(self):
        self.local.close()
        self.persistent.close()


def save_params_only(path: str, params) -> None:
    """Write a params-only checkpoint (the inference artifact): ``params`` is
    a state dict ``{name: tensor}`` (any device; written from host copies)."""
    host = {k: v.detach().cpu() for k, v in params.items()}
    _write_dir(os.path.abspath(path), {PARAMS_FILE: host}, {"kind": "params"})


def _params_file(path: str) -> str:
    """``params.pt`` of a params-only checkpoint or of a training step, or of
    the newest step under a checkpoint directory."""
    path = os.path.abspath(path)
    if os.path.isfile(os.path.join(path, PARAMS_FILE)):
        return os.path.join(path, PARAMS_FILE)
    steps = sorted(int(d) for d in os.listdir(path) if d.isdigit()) if os.path.isdir(path) else []
    if steps and os.path.isfile(os.path.join(path, str(steps[-1]), PARAMS_FILE)):
        return os.path.join(path, str(steps[-1]), PARAMS_FILE)
    raise FileNotFoundError(f"no {PARAMS_FILE} under {path}")


def load_params_only(path: str, abstract_params=None) -> dict[str, torch.Tensor]:
    """The state dict of a params-only checkpoint or of a training
    checkpoint's params (memory-mapped CPU tensors). ``abstract_params``
    (a state dict), when given, must match names and shapes."""
    params = _load(_params_file(path))
    if abstract_params is not None:
        missing = sorted(set(abstract_params) - set(params))
        extra = sorted(set(params) - set(abstract_params))
        if missing or extra:
            raise KeyError(f"checkpoint {path}: missing {missing}, unexpected {extra}")
        for name, want in abstract_params.items():
            if tuple(params[name].shape) != tuple(want.shape):
                raise ValueError(f"checkpoint {path} {name}: shape {tuple(params[name].shape)}"
                                 f" != {tuple(want.shape)}")
    return params


def _decoder_keys(names) -> set[str]:
    return {n.split(".")[1] for n in names if n.startswith("decoder.") and n.count(".") >= 2}


def names_are_scanned(names) -> bool | None:
    """True: scan-stacked decoder layers (``decoder.layers.*``, a leading
    layer axis); False: unrolled (``decoder.layers_{i}.*``); None: no
    decoder layers among ``names``."""
    keys = _decoder_keys(names)
    if any(k in LAYER_REGIONS for k in keys):
        return True
    if any(is_unrolled_key(k) for k in keys):
        return False
    return None


def params_checkpoint_is_scanned(path: str) -> bool | None:
    """:func:`names_are_scanned` of the checkpoint at ``path``; None also
    when there is no readable checkpoint there (the caller decides)."""
    try:
        names = _load(_params_file(path)).keys()
    except (OSError, RuntimeError):
        return None
    return names_are_scanned(names)


def unroll_scanned_params(params: dict) -> dict:
    """Scan-stacked ``decoder.<region>.<rest>`` ``[L, ...]`` ->
    ``decoder.<region>_{i}.<rest>``; other names pass through."""
    out = {}
    for name, t in params.items():
        parts = name.split(".")
        if len(parts) > 2 and parts[0] == "decoder" and parts[1] in LAYER_REGIONS:
            rest = ".".join(parts[2:])
            for i in range(t.shape[0]):
                out[f"decoder.{parts[1]}_{i}.{rest}"] = t[i]
        else:
            out[name] = t
    return out


def stack_unrolled_params(params: dict) -> dict:
    """The inverse of :func:`unroll_scanned_params`: ``decoder.<region>_{i}.<rest>``
    -> ``decoder.<region>.<rest>`` stacked on a new leading layer axis."""
    out: dict = {}
    groups: dict = {}
    for name, t in params.items():
        parts = name.split(".")
        if len(parts) > 2 and parts[0] == "decoder" and is_unrolled_key(parts[1]):
            region, _, i = parts[1].rpartition("_")
            groups.setdefault(f"decoder.{region}.{'.'.join(parts[2:])}", {})[int(i)] = t
        else:
            out[name] = t
    for name, layers in groups.items():
        out[name] = torch.stack([layers[i] for i in range(len(layers))])
    return out
