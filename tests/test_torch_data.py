"""The PyTorch package's training data iterators against the JAX package's.

Both packages get the same config (the port's per-device batch eight times
the JAX one: the JAX test harness has eight CPU devices, the port one) and
the same records, written here or injected; several batches of each
iterator must be EQUAL key by key (integers). The cases follow the JAX
package's ``tests/test_data.py``: packing invariants, ``PackedBatcher``, the
TTS sequence round trip, ``emilia_audio`` (synthetic), grain over JSONL /
ArrayRecord / Parquet, ``c4_mlperf``, ``tfds`` and ``hf`` with injected
records, ArrayRecord's raw UTF-8 decode; then grain's resumable state, the
trainer's device adapter and ``train_loop`` / ``run_eval`` on
``emilia_audio``.
"""

import json
import os

import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.train.data import audio_iterator as jaudio
from maxtext_indextts2_tpu.train.data import grain_pipeline as jgrain
from maxtext_indextts2_tpu.train.data import hf_pipeline as jhf
from maxtext_indextts2_tpu.train.data import mlperf_pipeline as jmlperf
from maxtext_indextts2_tpu.train.data import packing as jpacking
from maxtext_indextts2_tpu.train.data import tfds_pipeline as jtfds
from maxtext_indextts2_tpu.train.train import create_data_iterator as jax_create_data_iterator
from maxtext_indextts2_tpu.vocab.mapping import build_mapping as jax_build_mapping
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.train import train as ttrain
from maxtext_indextts2_tpu_torch.train.data import audio_iterator, grain_pipeline, hf_pipeline
from maxtext_indextts2_tpu_torch.train.data import mlperf_pipeline, packing, tfds_pipeline
from maxtext_indextts2_tpu_torch.vocab.mapping import build_mapping

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "maxtext_indextts2_tpu_torch", "configs", "tiny.yml")
KEYS = {"inputs", "targets", "inputs_segmentation", "targets_segmentation", "inputs_position"}
JAX_DEVICES = 8


def configs(args, jax_rows: float):
    """(port config, JAX config) that load the same global batch: the JAX
    package loads ``ceil(jax_rows)`` rows on each of its 8 devices (and trains
    on ``jax_rows * 8``; a fractional remainder is dropped)."""
    import math

    cfg = load_config(args + [f"per_device_batch_size={math.ceil(jax_rows) * JAX_DEVICES}"])
    jcfg = jax_load_config(args + [f"per_device_batch_size={jax_rows:g}"])
    assert cfg.global_batch_size_to_load == jcfg.global_batch_size_to_load
    return cfg, jcfg


def assert_batches_equal(ours, theirs, n=3, keys=KEYS):
    for i in range(n):
        a, b = next(ours), next(theirs)
        assert set(a) == set(b) == set(keys), (set(a), set(b))
        for k in a:
            av = a[k].cpu().numpy() if torch.is_tensor(a[k]) else a[k]
            assert av.dtype == np.int32 and np.asarray(b[k]).dtype == np.int32, k
            np.testing.assert_array_equal(av, np.asarray(b[k]), err_msg=f"batch {i} {k}")


# ------------------------------------------------------------------ packing


def test_pack_examples_invariants_and_equality():
    exs = [[1, 2, 3, 4], [5, 6, 7], [8, 9, 10, 11, 12, 13], [14, 15], list(range(20, 35))]
    rows = packing.pack_examples(exs, max_len=8)
    want = jpacking.pack_examples(exs, max_len=8)
    assert len(rows) == len(want)
    for r, w in zip(rows, want):
        assert set(r) == set(w) == KEYS
        for k in r:
            np.testing.assert_array_equal(r[k], w[k])
    total = sum(min(len(e), 9) - 1 for e in exs)
    assert sum(int((r["inputs_segmentation"] > 0).sum()) for r in rows) == total
    for r in rows:
        seg, pos = r["inputs_segmentation"], r["inputs_position"]
        for s in np.unique(seg[seg > 0]):
            np.testing.assert_array_equal(pos[seg == s], np.arange(int((seg == s).sum())))
            np.testing.assert_array_equal(r["inputs"][seg == s][1:], r["targets"][seg == s][:-1])


@pytest.mark.parametrize("pack", [True, False])
def test_packed_batcher_equal_with_its_padded_last_batch(pack):
    src = [[1, 2, 3]] * 7 + [[4, 5, 6, 7, 8]] * 4
    ours = packing.PackedBatcher(iter(src), batch_size=3, max_len=6, pack=pack)
    theirs = jpacking.PackedBatcher(iter(src), batch_size=3, max_len=6, pack=pack)
    n = 0
    while True:
        try:
            b = next(theirs)
        except StopIteration:
            with pytest.raises(StopIteration):
                next(ours)
            break
        a = next(ours)
        n += 1
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert n >= 2
    # the final partial batch is padded with finalize_row([[0, 0]]) rows
    tail = packing.PackedBatcher(iter([[1, 2, 3]]), batch_size=2, max_len=4)
    last = next(tail)
    np.testing.assert_array_equal(last["inputs_segmentation"][1], [1, 0, 0, 0])
    np.testing.assert_array_equal(last["inputs"][1], [0, 0, 0, 0])


def test_tts_sequence_roundtrip_and_equality():
    mapping = build_mapping(1000, codebook_size=64, soft_token_index=500)
    jmapping = jax_build_mapping(1000, codebook_size=64, soft_token_index=500)
    text, audio = [3, 10, 499, 501], [0, 5, 63]
    seq = audio_iterator.build_tts_sequence(text, audio, mapping)
    assert seq == jaudio.build_tts_sequence(text, audio, jmapping)
    assert audio_iterator.split_tts_sequence(seq[:-1], mapping) == (text, audio)
    assert jaudio.split_tts_sequence(seq[:-1], jmapping) == (text, audio)


# ------------------------------------------------------------- emilia_audio

EMILIA = ["dataset_type=emilia_audio", "vocab_size=9344", "audio_codebook_size=8192",
          "max_target_length=256"]


@pytest.mark.parametrize("pack", ["true", "false"])
def test_emilia_audio_synthetic_batches_equal(pack):
    cfg, jcfg = configs(EMILIA + [f"packing={pack}"], 0.5)
    ours = audio_iterator.make_emilia_audio_train_iterator(cfg)
    assert_batches_equal(ours, jaudio.make_emilia_audio_train_iterator(jcfg), n=4)
    batch = next(audio_iterator.make_emilia_audio_eval_iterator(cfg))
    assert batch["inputs"].shape == (cfg.global_batch_size_to_load, 256)
    assert 0 <= batch["inputs"].min() and batch["inputs"].max() < cfg.vocab_size
    if pack == "true":  # real tokens fill most of a packed row
        assert (batch["inputs_segmentation"] > 0).mean() > 0.5


def test_emilia_audio_two_processes_split_the_stream_as_jax_does():
    cfg, jcfg = configs(EMILIA, 0.5)
    for index in range(2):
        assert_batches_equal(
            audio_iterator.make_emilia_audio_train_iterator(cfg, process_index=index,
                                                            process_count=2),
            jaudio.make_emilia_audio_train_iterator(jcfg, process_index=index, process_count=2),
            n=2)


def test_emilia_hf_stream_imports_datasets_only_when_it_starts(monkeypatch):
    import sys

    cfg, _ = configs(EMILIA + ["dataset_path=some/emilia"], 0.5)
    it = audio_iterator.make_emilia_audio_train_iterator(cfg)  # nothing read yet
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="datasets"):
        next(it)


# -------------------------------------------------------------------- grain


def _jsonl(path, n=64):
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({"text": f"example number {i} " * 3}) + "\n")
    return path


def _arrayrecord(tmp_path, n=32):
    from array_record.python.array_record_module import ArrayRecordWriter
    from tensorflow.core.example import example_pb2, feature_pb2

    w = ArrayRecordWriter(str(tmp_path / "shard-00000.array_record"), "group_size:1")
    for i in range(n):
        ex = example_pb2.Example(features=feature_pb2.Features(feature={
            "text": feature_pb2.Feature(bytes_list=feature_pb2.BytesList(
                value=[f"array record example {i} ".encode() * 2]))}))
        w.write(ex.SerializeToString())
    w.close()
    return tmp_path


def _parquet(tmp_path, n=48):
    import pyarrow as pa
    import pyarrow.parquet as pq

    pq.write_table(pa.table({"text": [f"parquet row {i} with words " * 2 for i in range(n)]}),
                   str(tmp_path / "part-0.parquet"))
    return tmp_path


@pytest.mark.parametrize("fmt", ["jsonl", "arrayrecord", "parquet"])
@pytest.mark.parametrize("shuffle", ["false", "true"])
def test_grain_batches_equal(tmp_path, fmt, shuffle):
    path = {"jsonl": lambda: _jsonl(tmp_path / "data.jsonl"),
            "arrayrecord": lambda: _arrayrecord(tmp_path),
            "parquet": lambda: _parquet(tmp_path)}[fmt]()
    args = ["dataset_type=grain", f"dataset_path={path}", "max_target_length=64",
            "num_epochs=4", f"enable_data_shuffling={shuffle}"]
    if fmt == "arrayrecord":
        args.append("grain_file_type=arrayrecord")
    cfg, jcfg = configs(args, 0.25)
    assert_batches_equal(grain_pipeline.make_grain_iterator(cfg),
                         jgrain.make_grain_iterator(jcfg), n=4)


def test_grain_state_resumes_to_the_same_next_batch(tmp_path):
    """``set_state`` restores grain's position AND the packed rows still
    pending, so the resumed stream's next batches are the uninterrupted ones."""
    path = _jsonl(tmp_path / "data.jsonl", 96)
    cfg, _ = configs(["dataset_type=grain", f"dataset_path={path}", "max_target_length=64",
                      "num_epochs=4", "enable_data_shuffling=true"], 0.25)
    it = grain_pipeline.make_grain_iterator(cfg)
    next(it)
    state = it.get_state()
    assert isinstance(state, bytes) and it._pending  # rows built but not yet yielded
    want = [next(it) for _ in range(3)]
    resumed = grain_pipeline.make_grain_iterator(cfg)
    resumed.set_state(state)
    for w in want:
        got = next(resumed)
        for k in w:
            np.testing.assert_array_equal(got[k], w[k], err_msg=k)
    # through the trainer's device adapter too
    dev = ttrain.DeviceBatches(grain_pipeline.make_grain_iterator(cfg), "cpu")
    dev.set_state(state)
    np.testing.assert_array_equal(next(dev)["inputs"].numpy(), want[0]["inputs"])
    assert isinstance(dev.get_state(), bytes)


def test_grain_without_files_names_what_it_looked_for(tmp_path):
    cfg, _ = configs(["dataset_type=grain", f"dataset_path={tmp_path}"], 0.25)
    with pytest.raises(FileNotFoundError, match="arrayrecord/parquet/jsonl"):
        grain_pipeline.make_grain_iterator(cfg)
    cfg, _ = configs(["dataset_type=grain", f"dataset_path={tmp_path}",
                      "grain_file_type=parquet"], 0.25)
    with pytest.raises(FileNotFoundError, match="no parquet files"):
        grain_pipeline.make_grain_iterator(cfg)


def test_grain_names_a_missing_package(tmp_path, monkeypatch):
    import sys

    cfg, _ = configs(["dataset_type=grain", f"dataset_path={_jsonl(tmp_path / 'd.jsonl')}"],
                     0.25)
    monkeypatch.setitem(sys.modules, "grain.python", None)
    with pytest.raises(ImportError, match="needs the grain package"):
        grain_pipeline.make_grain_iterator(cfg)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ImportError, match="needs the pyarrow package"):
        grain_pipeline.ParquetTextSource([str(tmp_path / "x.parquet")])


def test_array_record_decode_raw_utf8_equal():
    for raw in (b"hello raw utf-8 record", b'{"text": "json wins"}', b'"a json string"',
                b'{"content": "from content"}', b"\xff\xfe not utf-8"):
        assert grain_pipeline._decode_array_record(raw) == jgrain._decode_array_record(raw)
    assert grain_pipeline._decode_array_record(b"hello raw utf-8 record") == \
        "hello raw utf-8 record"


# ---------------------------------------------------------------- c4_mlperf


def test_c4_mlperf_pieces_equal():
    docs = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10], [0, 11, 0, 12]]
    for seg_len, per in ((4, 2), (3, 128), (5, 1)):
        got = list(mlperf_pipeline.concat_and_split(iter(docs), seg_len, per))
        assert got == list(jmlperf.concat_and_split(iter(docs), seg_len, per))
    for seg in ([5, 6, 7], [5], list(range(2, 12))):
        a, b = mlperf_pipeline.format_mlperf_row(seg, 5), jmlperf.format_mlperf_row(seg, 5)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    row = mlperf_pipeline.format_mlperf_row([5, 6, 7], max_len=5, eos_id=1, pad_id=0)
    assert row["targets"].tolist() == [6, 7, 1, 0, 0]
    assert row["inputs_segmentation"].tolist() == [1, 1, 0, 0, 0]


@pytest.mark.parametrize("suffix", ["jsonl", "txt"])
def test_c4_mlperf_batches_equal_through_create_data_iterator(tmp_path, suffix):
    path = tmp_path / f"c4.{suffix}"
    with open(path, "w") as f:
        for i in range(40):
            text = f"mlperf doc {i} " * 4
            f.write((json.dumps({"text": text}) if suffix == "jsonl" else text) + "\n")
    cfg, jcfg = configs(["dataset_type=c4_mlperf", f"dataset_path={path}",
                         "max_target_length=64"], 0.25)
    ours = ttrain.create_data_iterator(cfg, "cpu")
    assert isinstance(ours, ttrain.DeviceBatches)
    assert_batches_equal(ours, jax_create_data_iterator(jcfg), n=3)
    # zero waste: every row of the first batch is a full segment
    b = next(mlperf_pipeline.make_c4_mlperf_iterator(cfg))
    assert (b["inputs"][:, :-1] > 0).all() and np.all(b["inputs_position"][:, 0] == 0)


def test_c4_mlperf_runs_out_with_a_padded_last_batch(tmp_path):
    path = tmp_path / "short.txt"
    path.write_text("one short document\n")
    cfg, jcfg = configs(["dataset_type=c4_mlperf", f"dataset_path={path}",
                         "max_target_length=64"], 0.25)
    a, b = next(mlperf_pipeline.make_c4_mlperf_iterator(cfg)), \
        next(jmlperf.make_c4_mlperf_iterator(jcfg))
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
    it = mlperf_pipeline.make_c4_mlperf_iterator(cfg)
    next(it)
    with pytest.raises(StopIteration):
        next(it)


# -------------------------------------------------------------- tfds and hf


def test_tfds_injected_records_equal():
    cfg, jcfg = configs(["dataset_type=tfds", "dataset_path=c4/en:3.0.1",
                         "max_target_length=32"], 0.25)
    records = [{"text": b"tfds yields bytes %d " % i * 2} for i in range(16)] + \
        [{"content": f"a content record {i}"} for i in range(8)]
    assert_batches_equal(tfds_pipeline.make_tfds_iterator(cfg, examples=records),
                         jtfds.make_tfds_iterator(jcfg, examples=records), n=3)


def test_tfds_without_the_package_names_it():
    try:
        import tensorflow_datasets  # noqa: F401
    except ImportError:
        cfg, _ = configs(["dataset_type=tfds", "dataset_path=c4/en:3.0.1"], 0.25)
        with pytest.raises(ImportError, match="dataset_type=tfds needs the tensorflow_datasets"):
            next(iter(tfds_pipeline.make_tfds_iterator(cfg)))
        with pytest.raises(ImportError, match="tensorflow_datasets"):
            next(ttrain.create_data_iterator(cfg, "cpu"))
    else:
        pytest.skip("tensorflow_datasets is installed: there is no missing package to name")


def test_hf_injected_train_and_eval_equal():
    from datasets import Dataset

    ds = Dataset.from_dict({"content": [f"def f{i}(): return {i}  # pad " * 3
                                        for i in range(24)]})
    cfg, jcfg = configs(["dataset_type=hf", "max_target_length=64"], 0.25)
    assert_batches_equal(hf_pipeline.make_hf_iterator(cfg, dataset=ds),
                         jhf.make_hf_iterator(jcfg, dataset=ds), n=3)
    ev = Dataset.from_dict({"document": [f"eval document {i} body text " * 2
                                         for i in range(16)]})
    cfg, jcfg = configs(["dataset_type=hf", "eval_split=validation",
                         "eval_data_columns=['document']", "max_target_length=64"], 0.25)
    assert_batches_equal(hf_pipeline.make_hf_eval_iterator(cfg, dataset=ev),
                         jhf.make_hf_eval_iterator(jcfg, dataset=ev), n=2)


def test_hf_shuffled_stream_equal():
    from datasets import Dataset

    ds = Dataset.from_dict({"text": [f"row {i} of a shuffled set " * 2 for i in range(40)]})
    cfg, jcfg = configs(["dataset_type=hf", "max_target_length=64",
                         "enable_data_shuffling=true", "data_shuffle_seed=5"], 0.25)
    assert_batches_equal(hf_pipeline.make_hf_iterator(cfg, dataset=ds),
                         jhf.make_hf_iterator(jcfg, dataset=ds), n=3)


def test_hf_vision_sft_names_its_queue_item():
    """The vision SFT iterator, which refused naming ROADMAP item 6 until its
    vision part was ported, now gives the JAX package's batches (the case of
    its ``tests/test_data.py``): rows equal, pixels within 1e-5."""
    from datasets import Dataset

    rng = np.random.default_rng(0)
    ds = Dataset.from_dict({
        "image": [rng.integers(0, 255, (32, 32, 3), np.uint8) for _ in range(16)],
        "prompt": [f"describe image {i}" for i in range(16)],
        "completion": [f"it shows pattern {i}" for i in range(16)],
    })
    cfg, jcfg = configs(["dataset_type=hf", "max_target_length=128", "image_token_id=9000",
                         "vocab_size=9344"], 0.25)
    ours = hf_pipeline.make_hf_vision_sft_iterator(cfg, dataset=ds, tokens_per_image=4,
                                                   image_size=32)
    theirs = jhf.make_hf_vision_sft_iterator(jcfg, dataset=ds, tokens_per_image=4,
                                             image_size=32)
    bsz = cfg.global_batch_size_to_load
    for _ in range(2):
        a, b = next(ours), next(theirs)
        assert set(a) == set(b) and a["inputs"].shape == (bsz, 128)
        for k in a:
            if k == "pixels":
                np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=0, atol=1e-5)
            else:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
        assert (a["inputs"] == 9000).sum() == bsz * 4


# ------------------------------------------------------------ the trainer


def test_create_data_iterator_moves_int32_batches_to_the_device():
    cfg, jcfg = configs(EMILIA, 0.5)
    it = ttrain.create_data_iterator(cfg, "cpu")
    batch = next(it)
    assert set(batch) == KEYS
    assert all(v.dtype == torch.int32 and v.device.type == "cpu" and v.is_contiguous()
               for v in batch.values())
    synthetic = next(ttrain.create_data_iterator(load_config(["dataset_type=synthetic"]), "cpu"))
    assert {v.dtype for v in synthetic.values()} == {torch.int32}
    with pytest.raises(ValueError, match="unknown dataset_type"):
        ttrain.create_data_iterator(load_config(["dataset_type=nope"]), "cpu")


def test_train_loop_on_emilia_audio_and_its_eval_iterator():
    args = [TINY, "dataset_type=emilia_audio", "vocab_size=9344", "audio_codebook_size=8192",
            "max_target_length=128", "steps=2", "decoder_block=tts", "eval_interval=2",
            "eval_steps=2", "per_device_batch_size=2"]
    out = ttrain.train_loop(load_config(args), device="cpu", quiet=True)  # eval after step 2
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 2 and np.isfinite(losses).all()
    # run_eval reads the emilia eval stream: its loss is that of those batches
    cfg = load_config(args)
    state = ttrain.setup_train_state(cfg, "cpu")
    want = ttrain.run_eval(cfg, state, num_batches=1)
    batch = next(ttrain.DeviceBatches(audio_iterator.make_emilia_audio_eval_iterator(cfg),
                                      "cpu"))
    m = ttrain.eval_step(cfg, state, ttrain._take(batch, cfg.global_batch_size_to_eval_on))
    assert want["eval_loss"] == pytest.approx(float(m["eval_loss"]), rel=1e-6)
