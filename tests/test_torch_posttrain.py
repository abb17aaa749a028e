"""The port's post-training modules against the JAX package's.

DPO and GRPO: the loss and its parts on one batch, and one update, with the
same numpy weights and batch in both packages (a tiny float32 audio LM,
``attention=dot_product``); the GRPO batch and its advantages equal the JAX
``build_grpo_batch``'s, and the behaviour log-probabilities are an input of
both (perturbed, so that the clipped ratio matters). Tolerances: losses and
their parts 2e-5 absolute; parameters after one Adam update of 1e-3 within
5e-5 (all but one in a thousand within 2e-6), as ``tests/test_torch_train.py``.
Distillation: the JSONL the port writes from greedy completions equals the
JAX package's line for line, and ``train/sft.py`` trains on it. Elastic: a
run with a failure injected at step 3 and snapshots every 2 steps ends where
the uninterrupted run ends, bitwise; on two gloo ranks a failure after which
one rank survives resizes the world to one rank, whose global batch follows
``per_device_batch_size``, and continues from the snapshot's step to the
numbers of a one-process run of the same schedule (loss 1e-5 relative).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_helpers import run_ranks
from torch_port_helpers import TINY_TTS, configs, engine_pair, jax_tree, numpy_weights, prompt

from maxtext_indextts2_tpu.models import Transformer as JaxTransformer
from maxtext_indextts2_tpu.train import distillation as jdistill
from maxtext_indextts2_tpu.train import dpo as jdpo
from maxtext_indextts2_tpu.train import grpo as jgrpo
from maxtext_indextts2_tpu.train import optimizers as joptim
from maxtext_indextts2_tpu.train import train as jtrain
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.models import Transformer
from maxtext_indextts2_tpu_torch.train import distillation, dpo, elastic, grpo, sft
from maxtext_indextts2_tpu_torch.train import train as ttrain
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_from_jax

ARGS = ["learning_rate=1e-3", "warmup_steps_fraction=0", "attention=dot_product",
        "max_target_length=32", "steps=4"]
ROWS = 4


def _adam_close(got, want, what):
    diff = np.abs(got - want)
    assert diff.max() <= 5e-5, (what, diff.max())
    assert (diff > 2e-6).mean() <= 1e-3, (what, int((diff > 2e-6).sum()))


def _jax_state(jcfg, weights):
    model = JaxTransformer(cfg=jcfg)
    tx = joptim.get_optimizer(jcfg, joptim.create_learning_rate_schedule(jcfg))
    return model, jtrain.TrainState.create(apply_fn=model.apply, params=jax_tree(weights), tx=tx)


def _torch_state(cfg, weights):
    return ttrain.setup_train_state(cfg, "cpu", {k: torch.from_numpy(v) for k, v in weights.items()})


def _ref_model(cfg, weights):
    ref = Transformer(cfg, device="cpu")
    ref.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    return ref.requires_grad_(False)


def _check_params(tstate, jstate):
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for n, w in want.items():
        _adam_close(tstate.params[n].detach().numpy(), w.numpy(), n)


def test_dpo_loss_and_step_match_jax():
    cfg, jcfg = configs(ARGS, slots=ROWS)
    policy, reference = numpy_weights(cfg, seed=3), numpy_weights(cfg, seed=4)
    batch = next(dpo.DPODataIterator(cfg))
    jbatch = {k: v[:ROWS] for k, v in next(jdpo.DPODataIterator(jcfg)).items()}
    for k in batch:  # the JAX package loads a row a device: the port's rows are its first
        np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)
    model, jstate = _jax_state(jcfg, policy)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jaux = jdpo.dpo_loss_fn(model, jcfg, jstate.params, jax_tree(reference), jb, 0.1)
    tstate = _torch_state(cfg, policy)
    ref = _ref_model(cfg, reference)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss, taux = dpo.dpo_loss_fn(tstate.model, cfg, ref, tb, 0.1)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), atol=2e-5, rtol=0)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(taux[k]), float(v), atol=2e-5, rtol=0, err_msg=k)
    jstate, jm = jdpo.dpo_train_step(model, jcfg, jstate, jax_tree(reference), jb,
                                     jax.random.PRNGKey(0), 0.1)
    tm = dpo.dpo_train_step(cfg, tstate, ref, tb, 0.1)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=2e-5, rtol=0)
    _check_params(tstate, jstate)


def _grpo_batch(cfg, jcfg, weights):
    rng = np.random.default_rng(5)
    prompts = [prompt(i, n) for i, n in enumerate((5, 9))]
    completions = [[rng.integers(1, 512, size=int(rng.integers(3, 12))).tolist()
                    for _ in range(3)] for _ in prompts]
    rewards = rng.normal(size=(2, 3)).astype(np.float32)
    batch = grpo.build_grpo_batch(prompts, completions, rewards, cfg.max_target_length)
    want = jgrpo.build_grpo_batch(prompts, completions, rewards, jcfg.max_target_length)
    assert set(batch) == set(want)
    for k in batch:
        np.testing.assert_allclose(batch[k], np.asarray(want[k]), rtol=0, atol=1e-6, err_msg=k)
    model = JaxTransformer(cfg=jcfg)
    logits = model.apply({"params": jax_tree(weights)}, jnp.asarray(batch["inputs"]),
                         jnp.asarray(batch["inputs_position"]),
                         jnp.asarray(batch["inputs_segmentation"]))
    logps = np.asarray(jgrpo.log_probs_from_logits(logits, jnp.asarray(batch["targets"])))
    batch["old_logps"] = (logps + 0.3 * rng.normal(size=logps.shape)).astype(np.float32)
    return batch


def test_grpo_loss_and_step_match_jax():
    cfg, jcfg = configs(ARGS, slots=6)
    policy, reference = numpy_weights(cfg, seed=3), numpy_weights(cfg, seed=4)
    batch = _grpo_batch(cfg, jcfg, policy)
    model, jstate = _jax_state(jcfg, policy)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jaux = jgrpo.grpo_loss_fn(model, jcfg, jstate.params, jax_tree(reference), jb)
    tstate = _torch_state(cfg, policy)
    ref = _ref_model(cfg, reference)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss, taux = grpo.grpo_loss_fn(tstate.model, cfg, ref, tb)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), atol=2e-5, rtol=0)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(taux[k]), float(v), atol=2e-5, rtol=0, err_msg=k)
    jstate, jm = jgrpo.grpo_train_step(model, jcfg, jstate, jax_tree(reference), jb,
                                       jax.random.PRNGKey(0))
    tm = grpo.grpo_train_step(cfg, tstate, ref, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=2e-5, rtol=0)
    _check_params(tstate, jstate)


def test_grpo_loop_samples_through_the_engine_and_updates():
    cfg = load_config(TINY_TTS + ARGS + ["per_device_batch_size=4"])
    prompts = [prompt(0, 5), prompt(1, 7)]
    seen = []

    def reward(c):
        seen.append(list(c))
        return float(len(set(c)))

    state, metrics = grpo.grpo_train_loop(cfg, reward, num_iterations=2, group_size=2,
                                          prompts=prompts, max_new_tokens=6, device="cpu")
    assert state.step == 2 and np.isfinite(metrics["loss"]) and np.isfinite(metrics["kl"])
    assert len(seen) == 2 * 2 * 2 and all(len(c) == 6 for c in seen)


def test_distillation_jsonl_equals_jax_and_sft_trains_on_it(tmp_path):
    # a byte-range vocabulary: the byte tokenizer decodes every id
    eng, jeng = engine_pair(["tokenizer_type=none", "vocab_size=256"])
    prompts = [prompt(i, n, vocab=256) for i, n in enumerate((4, 9, 6, 12, 5))]
    got, want = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    assert distillation.generate_distillation_data(eng.cfg, prompts, str(got), 8,
                                                   engine=eng) == 5
    jdistill.generate_distillation_data(jeng.cfg, prompts, str(want), 8, engine=jeng)
    lines = [json.loads(x) for x in got.read_text().splitlines()]
    assert lines == [json.loads(x) for x in want.read_text().splitlines()]
    assert all(len(x["completion_ids"]) == 8 for x in lines)
    cfg = load_config(TINY_TTS + ARGS + ["per_device_batch_size=2", "steps=1",
                                         "vocab_size=256", f"dataset_path={got}"])
    out = sft.train_sft(cfg, device="cpu", quiet=True)
    assert np.isfinite(out["loss"])


def test_elastic_recovery_ends_where_the_uninterrupted_run_ends():
    cfg = load_config(TINY_TTS + ARGS + ["per_device_batch_size=2", "steps=6",
                                         "dataset_type=synthetic"])
    fired = []

    def inject(step):
        if step == 3 and not fired:
            fired.append(step)
            raise RuntimeError("injected")

    got = elastic.elastic_train_loop(cfg, snapshot_period=2, failure_injector=inject,
                                     device="cpu")
    want = elastic.elastic_train_loop(cfg, snapshot_period=2, device="cpu")
    assert (got["recoveries"], got["final_step"], want["recoveries"]) == (1, 6, 0)
    for k in ("loss", "grad_norm", "param_norm"):
        assert got[k] == want[k], k


def test_elastic_resize_two_ranks_to_one_continues_from_the_snapshot(tmp_path):
    args = TINY_TTS + ARGS + ["per_device_batch_size=2", "steps=5", "dataset_type=synthetic",
                              "ici_fsdp_parallelism=2"]
    ranks = run_ranks(tmp_path, 2, "elastic", args, 3, [0])
    assert ranks[1] == {"left_at": 3, "recoveries": 1}
    out = ranks[0]
    assert (out["recoveries"], out["final_step"], out["final_num_devices"],
            out["final_global_batch"]) == (1, 5, 1, 2)
    # one process: steps 0-1 on the two ranks' global batch of 4 rows (the
    # snapshot of step 2), then steps 2-4 on one rank's 2 rows
    big = load_config(TINY_TTS + ARGS + ["per_device_batch_size=4", "steps=5"])
    small = dataclasses.replace(big, per_device_batch_size=2, global_batch_size_to_train_on=2,
                                global_batch_size_to_load=2, micro_batch_size_to_train_on=2)
    from maxtext_indextts2_tpu_torch.train.data import synthetic

    state = ttrain.setup_train_state(big, "cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in synthetic.make_batch(big, 0, 4).items()}
    for _ in range(2):
        ttrain.train_step(big, state, batch)
    for _ in range(3):
        m = ttrain.train_step(small, state, {k: v[:2] for k, v in batch.items()})
    np.testing.assert_allclose(out["loss"], float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(out["param_norm"], float(m["param_norm"]), rtol=1e-5)
