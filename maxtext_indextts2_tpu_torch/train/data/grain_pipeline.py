"""Grain-based deterministic data pipeline.

This package's own copy of the JAX package's ``train/data/grain_pipeline.py``
(``tests/test_torch_data.py`` holds the batches of the two equal). ``grain``,
``pyarrow``, ``array_record`` and ``tensorflow`` are imported inside the
functions that need them; a missing one raises an ``ImportError`` that names
it. Reference: MaxText/input_pipeline/_grain_data_processing.py:93. Reads the
reference's on-disk dataset formats with real grain sources:

- **ArrayRecord** shards (``.array_record``) via grain.ArrayRecordDataSource;
  records are serialized tf.train.Example protos (the reference's format,
  parsed with ParseFeatures — _input_pipeline_utils.py:349) or raw
  JSON/UTF-8 lines,
- **Parquet** files via pyarrow (random-access rows, deterministic),
- **JSONL** shards ({"text": ...} per line) via a byte-offset source.

All formats flow through the same grain IndexSampler -> tokenize -> pack
pipeline with get_state/set_state plumbed through, so the train checkpoint
resumes the data stream exactly regardless of format.
"""

from __future__ import annotations

import json
import os

from maxtext_indextts2_tpu_torch.config import Config
from maxtext_indextts2_tpu_torch.train.data.packing import PackedBatcher
from maxtext_indextts2_tpu_torch.train.data.tokenizer import build_tokenizer


def _require(module: str, package: str, what: str):
    """``module`` imported, or an ImportError that names ``package``."""
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{what} needs the {package} package, which is not installed "
                          f"here") from e


class GrainTextSource:
    """Random-access source over JSONL files ({"text": ...} per line)."""

    def __init__(self, paths: list[str]):
        self.records: list[tuple[str, int, int]] = []  # (path, offset, length)
        for path in paths:
            with open(path, "rb") as f:
                off = 0
                for line in f:
                    self.records.append((path, off, len(line)))
                    off += len(line)

    def __len__(self):
        return len(self.records)

    def __repr__(self):
        # grain validates checkpoints against repr(data_source): it must be
        # stable across processes (the default includes id()), keyed on the
        # actual dataset identity.
        paths = sorted({p for p, _, _ in self.records})
        return f"GrainTextSource(paths={paths!r}, n={len(self.records)})"

    def __getitem__(self, idx: int) -> str:
        path, off, ln = self.records[idx]
        with open(path, "rb") as f:
            f.seek(off)
            raw = f.read(ln)
        obj = json.loads(raw)
        return obj.get("text") or obj.get("content") or ""


class ParquetTextSource:
    """Random-access source over parquet files (reference grain_file_type=
    parquet). pyarrow memory-maps the column; rows are fetched lazily."""

    def __init__(self, paths: list[str], column: str = "text"):
        pq = _require("pyarrow.parquet", "pyarrow", "grain_file_type=parquet")

        self.column = column
        self.tables = [pq.read_table(p, memory_map=True) for p in paths]
        self.offsets = []
        total = 0
        for t in self.tables:
            self.offsets.append(total)
            total += t.num_rows
        self.total = total
        self.paths = list(paths)

    def __repr__(self):
        return f"ParquetTextSource(paths={self.paths!r}, column={self.column!r}, n={self.total})"

    def __len__(self):
        return self.total

    def __getitem__(self, idx: int) -> str:
        import bisect

        t_i = bisect.bisect_right(self.offsets, idx) - 1
        row = idx - self.offsets[t_i]
        table = self.tables[t_i]
        if self.column in table.column_names:
            return table.column(self.column)[row].as_py() or ""
        # fall back to the first string column
        for name in table.column_names:
            val = table.column(name)[row].as_py()
            if isinstance(val, str):
                return val
        return ""


def _decode_array_record(raw: bytes, column: str = "text") -> str:
    """ArrayRecord payload -> text. The reference writes serialized
    tf.train.Example protos (ParseFeatures, _input_pipeline_utils.py:349);
    plain JSON/UTF-8 payloads are also accepted."""
    try:
        obj = json.loads(raw)
        if isinstance(obj, dict):
            return obj.get(column) or obj.get("text") or obj.get("content") or ""
        if isinstance(obj, str):
            return obj
    except (json.JSONDecodeError, UnicodeDecodeError):
        pass
    try:
        from tensorflow.core.example import example_pb2

        ex = example_pb2.Example.FromString(raw)
        feats = ex.features.feature
        if feats:
            for key in (column, "text", "content"):
                if key in feats:
                    f = feats[key]
                    if f.bytes_list.value:
                        return f.bytes_list.value[0].decode("utf-8", "replace")
                    if f.int64_list.value:
                        # pre-tokenized ids: surface as a list for the
                        # tokenizer bypass below
                        return list(f.int64_list.value)
            return ""
    except ImportError:
        pass
    except Exception:  # noqa: BLE001 — protobuf DecodeError (raw UTF-8
        # payload that happens not to be JSON) must fall through to the
        # plain-text path, same as when tensorflow isn't installed
        pass
    return raw.decode("utf-8", "replace")


class ArrayRecordTextSource:
    """Random-access source over ArrayRecord shards via grain's reader."""

    def __init__(self, paths: list[str], column: str = "text"):
        grain = _require("grain.python", "grain", "dataset_type=grain")
        _require("array_record.python.array_record_data_source", "array_record",
                 "grain_file_type=arrayrecord")
        self.source = grain.ArrayRecordDataSource(paths)
        self.column = column
        self.paths = list(paths)

    def __repr__(self):
        # stable across processes — grain checkpoints validate repr(source)
        return f"ArrayRecordTextSource(paths={self.paths!r}, column={self.column!r})"

    def __len__(self):
        return len(self.source)

    def __getitem__(self, idx: int):
        return _decode_array_record(self.source[idx], self.column)


_FORMATS = {
    "arrayrecord": (".array_record", ".arrayrecord"),
    "parquet": (".parquet",),
    "jsonl": (".jsonl", ".json"),
}


def _resolve_files(cfg: Config) -> tuple[str, list[str]]:
    """(file_type, paths) from cfg.dataset_path + optional cfg.grain_file_type."""
    if os.path.isdir(cfg.dataset_path):
        all_files = sorted(
            os.path.join(cfg.dataset_path, p) for p in os.listdir(cfg.dataset_path)
        )
    else:
        all_files = [cfg.dataset_path]
    wanted = cfg.grain_file_type
    if wanted and wanted != "auto":
        exts = _FORMATS[wanted]
        paths = [p for p in all_files if p.endswith(exts)]
        if not paths:
            raise FileNotFoundError(
                f"no {wanted} files ({exts}) under {cfg.dataset_path}"
            )
        return wanted, paths
    for fmt, exts in _FORMATS.items():
        paths = [p for p in all_files if p.endswith(exts)]
        if paths:
            return fmt, paths
    raise FileNotFoundError(
        f"no arrayrecord/parquet/jsonl files under {cfg.dataset_path}"
    )


def make_grain_iterator(cfg: Config, process_index: int = 0, process_count: int = 1):
    grain = _require("grain.python", "grain", "dataset_type=grain")

    fmt, paths = _resolve_files(cfg)
    column = (cfg.train_data_columns or ("text",))[0]
    if fmt == "arrayrecord":
        source = ArrayRecordTextSource(paths, column)
    elif fmt == "parquet":
        source = ParquetTextSource(paths, column)
    else:
        source = GrainTextSource(paths)
    tokenizer = build_tokenizer(cfg)

    sampler = grain.IndexSampler(
        num_records=len(source),
        shard_options=grain.ShardOptions(
            shard_index=process_index, shard_count=process_count, drop_remainder=True
        ),
        shuffle=cfg.enable_data_shuffling,
        num_epochs=cfg.num_epochs,
        seed=cfg.data_shuffle_seed,
    )

    class _Tokenize(grain.MapTransform):
        def map(self, text):
            if isinstance(text, list):  # pre-tokenized int64 feature
                return [int(t) for t in text]
            return tokenizer.encode(text)

    loader = grain.DataLoader(
        data_source=source,
        sampler=sampler,
        operations=[_Tokenize()],
        worker_count=0,
    )
    it = iter(loader)
    batch = cfg.global_batch_size_to_load // process_count
    return GrainPackedIterator(it, batch, cfg.max_target_length, cfg.packing)


class GrainPackedIterator(PackedBatcher):
    """PackedBatcher + grain iterator state checkpointing."""

    def __init__(self, grain_iter, batch, max_len, pack):
        self._grain_iter = grain_iter
        super().__init__(grain_iter, batch, max_len, pack)

    def get_state(self) -> bytes:
        import pickle

        if not hasattr(self._grain_iter, "get_state"):
            return b""
        # The packer holds already-built rows in _pending; the grain iterator
        # has advanced PAST the examples inside them, so resuming from the
        # grain state alone would silently drop those rows. Snapshot both.
        return pickle.dumps(
            {"grain": self._grain_iter.get_state(), "pending": self._pending}
        )

    def set_state(self, state: bytes):
        import pickle

        if state and hasattr(self._grain_iter, "set_state"):
            st = pickle.loads(state)
            self._grain_iter.set_state(st["grain"])
            self._pending = st["pending"]
