"""Training checkpoints and params-only checkpoints of the PyTorch package
(``train/checkpointing.py``), the checkpointed train loop and
``Engine.load_params``, on the CPU at a tiny size.

The format is the port's own (``torch.save`` state dicts, not Orbax), so the
JAX package is the reference for behaviour: which steps each emergency tier
saves and keeps, and that a resumed run continues the uninterrupted one.
Everything restored must be BITWISE equal to what was saved, and a run
resumed after 2 of 4 steps must give the uninterrupted run's losses and
weights bitwise: the same float32 arithmetic on the same tensors (the
synthetic iterator yields the same batch every step, and, as in the JAX
package, the iterator's position is not restored).
"""

import json
import os
import threading
import types

import jax.numpy as jnp
import pytest
import torch

import torch_port_helpers as ph
from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.train import checkpointing as jax_checkpointing
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.train import checkpointing
from maxtext_indextts2_tpu_torch.train import train as ttrain

TRAIN = ["decoder_block=tts", "base_emb_dim=64", "base_mlp_dim=128",
         "base_num_decoder_layers=2", "base_num_query_heads=4", "base_num_kv_heads=2",
         "head_dim=16", "vocab_size=256", "max_target_length=16", "per_device_batch_size=2",
         "dataset_type=synthetic", "dtype=float32", "learning_rate=1e-3",
         "warmup_steps_fraction=0.0"]


def _cfg(tmp_path, *extra):
    return load_config(TRAIN + [f"checkpoint_dir={tmp_path}/ckpt", "enable_checkpointing=true",
                                *extra])


def _equal(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _snapshot(state):
    return ({k: v.detach().clone() for k, v in state.params.items()},
            {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v
             for k, v in state.opt_state.items()}, state.step)


def _two_steps(cfg):
    state = ttrain.setup_train_state(cfg, "cpu")
    batches = ttrain.create_data_iterator(cfg, state.device)
    for _ in range(2):
        ttrain.train_step(cfg, state, next(batches))
    return state, batches


@pytest.mark.parametrize("async_save", ["true", "false"])
def test_round_trip_restores_params_moments_count_and_step(tmp_path, async_save):
    cfg = _cfg(tmp_path, f"async_checkpointing={async_save}")
    state, _ = _two_steps(cfg)
    params, opt, step = _snapshot(state)
    mgr = checkpointing.CheckpointManager(cfg)
    assert mgr.maybe_restore(state) is None and mgr.latest_step() is None  # empty directory
    mgr.save(1, state)
    mgr.wait()
    assert mgr.latest_step() == 1
    with open(os.path.join(cfg.checkpoint_dir, "1", "meta.json")) as fh:
        assert json.load(fh)["step"] == 2

    fresh = ttrain.setup_train_state(load_config(TRAIN + ["init_weights_seed=7"]), "cpu")
    objects = {k: id(v) for k, v in fresh.params.items()}
    assert mgr.maybe_restore(fresh) is fresh
    mgr.close()
    _equal(fresh.params, params)
    _equal(fresh.opt_state["mu"], opt["mu"])
    _equal(fresh.opt_state["nu"], opt["nu"])
    assert fresh.opt_state["count"] == opt["count"] == 2 and fresh.step == step == 2
    # in place: the model's own parameters hold the restored values
    assert {k: id(v) for k, v in fresh.params.items()} == objects
    assert all(p.requires_grad for p in fresh.params.values())


def test_max_to_keep_keeps_the_newest_steps(tmp_path):
    cfg = _cfg(tmp_path, "checkpoint_max_to_keep=2", "async_checkpointing=true")
    state, batches = _two_steps(cfg)
    mgr = checkpointing.CheckpointManager(cfg)
    for step in range(5):
        mgr.save(step, state)
    mgr.close()
    assert sorted(os.listdir(cfg.checkpoint_dir)) == ["3", "4"]


def test_an_async_save_is_not_changed_by_the_next_in_place_step(tmp_path, monkeypatch):
    """The write runs in the background and is held back here until the
    next step has updated the parameters and moments in place: the files
    still hold the values of the step that was saved."""
    cfg = _cfg(tmp_path, "async_checkpointing=true")
    state, batches = _two_steps(cfg)
    saved_params, saved_opt, _ = _snapshot(state)
    mgr = checkpointing.CheckpointManager(cfg)
    gate, real_save = threading.Event(), torch.save

    def held_save(obj, path):
        assert gate.wait(60)
        real_save(obj, path)

    monkeypatch.setattr(checkpointing.torch, "save", held_save)
    mgr.save(1, state)
    ttrain.train_step(cfg, state, next(batches))  # step 3, in place, before the write
    gate.set()
    mgr.wait()
    monkeypatch.undo()
    assert not torch.equal(state.params["decoder_norm.scale"], saved_params["decoder_norm.scale"])
    on_disk = checkpointing.load_params_only(mgr.step_path(1))
    _equal(dict(on_disk), saved_params)
    opt = torch.load(os.path.join(mgr.step_path(1), "opt_state.pt"), weights_only=True)
    _equal(opt["mu"], saved_opt["mu"])
    _equal(opt["nu"], saved_opt["nu"])
    assert opt["count"] == 2


def test_a_write_that_fails_raises_at_wait(tmp_path, monkeypatch):
    cfg = _cfg(tmp_path, "async_checkpointing=true")
    state = ttrain.setup_train_state(cfg, "cpu")
    mgr = checkpointing.CheckpointManager(cfg)

    def broken(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(checkpointing.torch, "save", broken)
    mgr.save(0, state)
    with pytest.raises(RuntimeError, match="checkpoint write") as err:
        mgr.wait()
    assert "disk full" in str(err.value.__cause__)
    assert mgr.latest_step() is None  # no half-written step looks whole


@pytest.mark.parametrize("emergency", [False, True], ids=["persistent", "emergency"])
def test_a_run_resumed_after_2_of_4_steps_equals_the_uninterrupted_run(tmp_path, emergency):
    extra = ["checkpoint_period=2", "async_checkpointing=true", "steps=4"]
    if emergency:
        extra += ["enable_emergency_checkpoint=true", "local_checkpoint_period=1"]

    def run(name, steps):
        cfg = load_config(TRAIN + [f"checkpoint_dir={tmp_path}/{name}/ckpt",
                                   f"local_checkpoint_directory={tmp_path}/{name}/local",
                                   "enable_checkpointing=true", *extra, f"steps={steps}"])
        return cfg, ttrain.train_loop(cfg, device="cpu", quiet=True)

    cfg, whole = run("whole", 4)
    _, first = run("resumed", 2)
    _, rest = run("resumed", 4)
    assert len(first["history"]) == len(rest["history"]) == 2  # steps 0-1, then 2-3
    assert [h["loss"] for h in first["history"] + rest["history"]] == \
        [h["loss"] for h in whole["history"]]
    # the final checkpoints (saved at the last step) hold the same weights
    _equal(dict(checkpointing.load_params_only(f"{tmp_path}/whole/ckpt")),
           dict(checkpointing.load_params_only(f"{tmp_path}/resumed/ckpt")))


def test_emergency_tiers_save_and_keep_the_steps_the_jax_package_does(tmp_path):
    """Periods that do not divide each other (local 2, persistent 25): the
    persistent tier fires once 25 steps have passed since its last save, as
    in the JAX package (whose manager runs here on the same step sequence)."""
    keys = ["async_checkpointing=false", "enable_emergency_checkpoint=true",
            "checkpoint_period=25", "local_checkpoint_period=2"]

    def persistent_saves(mgr, state_at):
        steps = []
        for step in range(120):  # the train loop calls save on local-period steps only
            if (step + 1) % mgr.local_period == 0:
                before = mgr.persistent.latest_step()
                mgr.save(step, state_at(step))
                if mgr.persistent.latest_step() != before:
                    steps.append(step)
        mgr.wait()
        return steps

    cfg = load_config(TRAIN + keys + [f"checkpoint_dir={tmp_path}/t/ckpt",
                                      f"local_checkpoint_directory={tmp_path}/t/local"])
    ours = checkpointing.EmergencyCheckpointManager(cfg)
    got = persistent_saves(ours, lambda s: types.SimpleNamespace(
        params={"w": torch.full((4,), float(s))}, opt_state=None, step=s + 1))
    jcfg = jax_load_config(keys + [f"checkpoint_dir={tmp_path}/j/ckpt",
                                   f"local_checkpoint_directory={tmp_path}/j/local"])
    theirs = jax_checkpointing.EmergencyCheckpointManager(jcfg)
    want = persistent_saves(theirs, lambda s: {"w": jnp.full((4,), float(s))})
    assert got == want == [1, 27, 53, 79, 105]
    assert ours.local._steps() == list(theirs.local.all_steps()) == [117, 119]
    assert ours.latest_step() == theirs.latest_step() == 119
    theirs.close()
    # restore takes the newest tier: the local one here
    restored = ours.maybe_restore(types.SimpleNamespace(params={"w": torch.zeros(4)},
                                                        opt_state=None, step=0))
    assert restored.step == 120 and torch.equal(restored.params["w"], torch.full((4,), 119.0))
    ours.close()


def test_params_only_checkpoint_and_layout_detection(tmp_path):
    cfg = load_config(TRAIN)
    state = ttrain.setup_train_state(cfg, "cpu")
    checkpointing.save_params_only(str(tmp_path / "p"), state.params)
    assert checkpointing.params_checkpoint_is_scanned(str(tmp_path / "p")) is False
    _equal(dict(checkpointing.load_params_only(str(tmp_path / "p"))),
           {k: v.detach() for k, v in state.params.items()})
    stacked = _stack(state.params)
    checkpointing.save_params_only(str(tmp_path / "s"), stacked)
    assert checkpointing.params_checkpoint_is_scanned(str(tmp_path / "s")) is True
    _equal(checkpointing.unroll_scanned_params(
        dict(checkpointing.load_params_only(str(tmp_path / "s")))),
        {k: v.detach() for k, v in state.params.items()})
    checkpointing.save_params_only(str(tmp_path / "n"), {"token_embedder.embedding":
                                                        torch.zeros(2, 2)})
    assert checkpointing.params_checkpoint_is_scanned(str(tmp_path / "n")) is None
    assert checkpointing.params_checkpoint_is_scanned(str(tmp_path / "missing")) is None
    with pytest.raises(KeyError, match="missing"):
        checkpointing.load_params_only(str(tmp_path / "n"), abstract_params=state.params)
    # both layer layouts, and the JAX package's MoE region split
    for names, want in (([f"decoder/layers/x"], True), (["decoder/layers_0/x"], False),
                        (["decoder/moe_layers/x"], True), (["token_embedder/embedding"], None)):
        assert checkpointing.names_are_scanned([n.replace("/", ".") for n in names]) is want


def _stack(params):
    """The scan-stacked layout: ``decoder.layers.<rest>`` with a leading axis."""
    out, layers = {}, {}
    for k, v in params.items():
        parts = k.split(".")
        if parts[0] == "decoder" and parts[1].startswith("layers_"):
            layers.setdefault(".".join(parts[2:]), {})[int(parts[1][7:])] = v.detach()
        else:
            out[k] = v.detach()
    for rest, per_layer in layers.items():
        out[f"decoder.layers.{rest}"] = torch.stack([per_layer[i] for i in sorted(per_layer)])
    return out


# ------------------------------------------------------------------ Engine.load_params
SERVE = ph.TINY_TTS + ["per_device_batch_size=2"]


@pytest.fixture(scope="module")
def reference_stream():
    cfg = load_config(SERVE)
    weights = {k: torch.from_numpy(v) for k, v in ph.numpy_weights(cfg, seed=3).items()}
    eng = Engine(cfg, device="cpu")
    eng.set_params(weights, cast_dtype=torch.bfloat16)
    prompt = ph.prompt(4, 9)
    return weights, prompt, eng.generate_stream(prompt, 10)


@pytest.mark.parametrize("layout", ["params_only", "scanned", "train_state"])
def test_load_params_serves_the_stream_of_set_params(tmp_path, reference_stream, layout):
    weights, prompt, want = reference_stream
    if layout == "train_state":
        cfg = load_config(SERVE + [f"checkpoint_dir={tmp_path}/ckpt"])
        state = ttrain.setup_train_state(cfg, "cpu", params=weights)
        mgr = checkpointing.CheckpointManager(cfg)
        mgr.save(0, state)
        mgr.close()
        path = mgr.step_path(0)
    else:
        path = str(tmp_path / "p")
        checkpointing.save_params_only(path, _stack(weights) if layout == "scanned" else weights)
    for p in (path, None):  # a path argument, or the config's load_parameters_path
        cfg = load_config(SERVE + ([] if p else [f"load_parameters_path={path}"]))
        eng = Engine(cfg, device="cpu")
        params = eng.load_params(p, cast_dtype=torch.bfloat16)
        assert params["decoder_norm.scale"].dtype == torch.float32  # scales stay float32
        assert params["decoder.layers_0.mlp_0.wi_0.kernel"].dtype == torch.bfloat16
        assert eng.generate_stream(prompt, 10) == want


def test_load_params_from_a_training_directory_takes_the_newest_step(tmp_path,
                                                                      reference_stream):
    weights, prompt, want = reference_stream
    cfg = load_config(SERVE + [f"checkpoint_dir={tmp_path}/ckpt"])
    state = ttrain.setup_train_state(cfg, "cpu", params=weights)
    mgr = checkpointing.CheckpointManager(cfg)
    mgr.save(0, ttrain.setup_train_state(cfg, "cpu"))  # another model: the older step
    mgr.save(5, state)
    mgr.close()
    eng = Engine(load_config(SERVE), device="cpu")
    eng.load_params(cfg.checkpoint_dir, cast_dtype=torch.bfloat16)
    assert eng.generate_stream(prompt, 10) == want


def test_load_params_refuses_a_checkpoint_of_another_model(tmp_path):
    cfg = load_config(SERVE)
    checkpointing.save_params_only(str(tmp_path / "p"), {"token_embedder.embedding":
                                                        torch.zeros(3, 3)})
    with pytest.raises(KeyError, match="state dict mismatch"):
        Engine(cfg, device="cpu").load_params(str(tmp_path / "p"))
    with pytest.raises(FileNotFoundError):
        Engine(cfg, device="cpu").load_params(str(tmp_path / "nothing"))
