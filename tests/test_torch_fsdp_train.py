"""The port's sharded training step on two gloo ranks against the JAX
package's ``train_step`` on the same global batch.

One spawn of two ranks runs each case for three steps: FSDP
(``ici_fsdp_parallelism=2``), Zero-1 (``zero1_fsdp_ag_once`` with two
microbatches) and the same accumulation without it, data parallelism, and
context parallelism (the ring, on the load-balanced sequence, with packed
rows). The JAX step runs unsharded on the global batch (its sharded program
computes the same function). A tiny audio LM in float32 with the numpy
weights of ``torch_port_helpers``; tolerances as ``tests/test_torch_train.py``
(the frameworks and the ranks sum in other orders): loss 2e-5, norms 1e-5
relative, parameters within 5e-5 (all but one in a thousand within 2e-6)
after three Adam steps, moments 1e-5 relative plus 1e-4 of the leaf's
largest.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_helpers import run_ranks
from torch_port_helpers import TINY_TTS, configs, jax_tree, numpy_weights

from maxtext_indextts2_tpu.models import Transformer as JaxTransformer
from maxtext_indextts2_tpu.train import optimizers as joptim
from maxtext_indextts2_tpu.train import train as jtrain
from maxtext_indextts2_tpu_torch.train.data import synthetic
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_from_jax

TRAIN = ["max_target_length=32", "learning_rate=1e-3", "warmup_steps_fraction=0.2", "steps=5",
         "dataset_type=synthetic", "remat_policy=full", "attention=flash"]
STEPS = 3
ROWS = 8
CASES = {  # name: (port mesh and accumulation, per-device rows, the JAX accumulation)
    "fsdp": (["ici_fsdp_parallelism=2"], 4, 1),
    "zero1": (["ici_fsdp_parallelism=2", "zero1_fsdp_ag_once=true",
               "gradient_accumulation_steps=2"], 2, 2),
    "fsdp_accumulation": (["ici_fsdp_parallelism=2", "gradient_accumulation_steps=2"], 2, 2),
    "data": (["ici_data_parallelism=2", "ici_fsdp_parallelism=1"], 4, 1),
    "context_ring": (["ici_context_parallelism=2", "ici_fsdp_parallelism=1",
                      "context_parallel_algorithm=ring", "per_device_batch_size=4"], 4, 1),
}


def _batch(cfg):
    batch = {k: np.array(v) for k, v in synthetic.make_batch(cfg, 0, ROWS).items()}
    for r in range(0, ROWS, 2):  # packed rows: a second document and a padded tail
        batch["inputs_segmentation"][r, 20:] = 2
        batch["inputs_position"][r, 20:] -= 20
        batch["inputs_segmentation"][r, 28:] = 0
    batch["targets_segmentation"] = batch["inputs_segmentation"].copy()
    return batch


def _setup():
    cfg, _ = configs(TRAIN, slots=ROWS)
    return numpy_weights(cfg, seed=7), _batch(cfg)


def _jax_run(accumulation, weights, batch):
    _, jcfg = configs(TRAIN + [f"gradient_accumulation_steps={accumulation}"],
                      slots=ROWS // accumulation)
    jcfg = dataclasses.replace(jcfg, flash_block_sizes=(16, 16))
    model = JaxTransformer(cfg=jcfg)
    tx = joptim.get_optimizer(jcfg, joptim.create_learning_rate_schedule(jcfg))
    state = jtrain.TrainState.create(apply_fn=model.apply, params=jax_tree(weights), tx=tx)
    step = jax.jit(functools.partial(jtrain.train_step, model, jcfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    history = []
    for _ in range(STEPS):
        state, m = step(state, jbatch, jax.random.PRNGKey(0))
        history.append({k: float(v) for k, v in m.items()})
    return state, history


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    weights, batch = _setup()
    cases = [(TINY_TTS + TRAIN + mesh + [f"per_device_batch_size={rows}"], weights, batch)
             for mesh, rows, _ in CASES.values()]
    ranks = run_ranks(tmp_path_factory.mktemp("fsdp"), 2, "train", cases, STEPS)
    return {name: [r[i] for r in ranks] for i, name in enumerate(CASES)}


def _assert_adam_close(got, want, what):
    diff = np.abs(got - want)
    assert diff.max() <= 5e-5, (what, diff.max())
    assert (diff > 2e-6).mean() <= 1e-3, (what, int((diff > 2e-6).sum()))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_steps_match_jax(name, port_runs):
    weights, batch = _setup()
    jstate, jhist = _jax_run(CASES[name][2], weights, batch)
    ranks = port_runs[name]
    for rank in ranks:
        for step, (got, want) in enumerate(zip(rank["history"], jhist)):
            np.testing.assert_allclose(got["loss"], want["loss"], atol=2e-5, rtol=0,
                                       err_msg=f"loss, step {step}")
            for key in ("grad_norm", "param_norm"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                           err_msg=f"{key} {step}")
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    got = ranks[0]["params"]
    assert set(got) == set(want)
    for n, w in want.items():
        _assert_adam_close(got[n].numpy(), w.numpy(), n)
        assert torch.equal(ranks[1]["params"][n], got[n]), n  # one state, gathered on both
    adam = jstate.opt_state[0]
    assert ranks[0]["count"] == int(adam.count) == STEPS
    for key in ("mu", "nu"):
        jm = params_from_jax(jax.tree.map(np.asarray, getattr(adam, key)))
        for n, w in jm.items():
            w = w.numpy()
            np.testing.assert_allclose(ranks[0][key][n].numpy(), w, rtol=1e-5,
                                       atol=1e-4 * np.abs(w).max(), err_msg=f"{key} {n}")


def test_fsdp_halves_the_state_and_zero1_gathers_once_a_step(port_runs):
    total = sum(v.nbytes for v in _setup()[0].values())
    for name in ("fsdp", "zero1", "fsdp_accumulation"):
        for rank in port_runs[name]:
            # every weight of the model width splits in two (norm scales stay whole)
            assert rank["unsharded_share"] < 0.01, (name, rank["unsharded_share"])
            assert 0.5 * total <= rank["piece_bytes"] < 0.51 * total, (name, rank["piece_bytes"])
    # data parallelism splits no weight (and has no sharding axis to check);
    # "embed" splits over the context axis too
    assert port_runs["data"][0]["unsharded_share"] == 0.0
    assert port_runs["data"][0]["piece_bytes"] == total
    assert port_runs["context_ring"][0]["unsharded_share"] < 0.01
    assert port_runs["context_ring"][0]["piece_bytes"] < 0.51 * total
    # a gather and a reduction a microbatch, or one of each a step with Zero-1
    assert port_runs["fsdp"][0]["counts"] == {"gathers": STEPS, "reductions": STEPS}
    assert port_runs["fsdp_accumulation"][0]["counts"] == {"gathers": 2 * STEPS,
                                                           "reductions": 2 * STEPS}
    assert port_runs["zero1"][0]["counts"] == {"gathers": STEPS, "reductions": STEPS}
