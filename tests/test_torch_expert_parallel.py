"""Expert parallelism (``expert``, ``models/moe.py`` under
``parallel/tensor.expert_split``) on gloo ranks against the JAX package on
one CPU device, from the same numpy weights (float32): the JAX package's MoE
training config (``tests/test_moe.py``'s mixtral-style decoder, as
``tests/test_torch_moe_train.py``), over ``expert`` 2 on two ranks and over
``expert`` 4 x ``tensor`` 2 on eight.

Each rank holds its experts (and, under ``tensor``, each expert's ``mlp``
columns); the sparse route runs on the CPU too (the plain grouped
products): the rows go to their experts' ranks by the variable-split
all-to-all and come home for the float32 combine. Held to:

- a serving forward (every rank the whole batch, each dispatching its chunk
  of the rows): the logits within 2e-5 of the largest, equal on every rank;
- three train steps on the global batch (each rank its rows; the
  load-balance loss of the global batch): loss 2e-5, gradient and parameter
  norms 1e-5 relative, and the parameters after three Adam steps as
  ``tests/test_torch_moe_train.py`` holds the one-rank MoE steps (1e-4; all
  but one in a thousand within 2e-6: Adam moves a parameter whose gradient
  is near zero by up to the learning rate).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_helpers import run_ranks
from torch_port_helpers import JAX_DEVICES, jax_tree, numpy_weights

from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.models import Transformer as JaxTransformer
from maxtext_indextts2_tpu.train import optimizers as joptim
from maxtext_indextts2_tpu.train import train as jtrain
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.train.data import synthetic
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_from_jax

MOE = ["decoder_block=mixtral", "base_num_decoder_layers=2", "base_emb_dim=64",
       "base_mlp_dim=128", "moe_mlp_dim=128", "num_experts=4", "num_experts_per_tok=2",
       "vocab_size=256", "base_num_query_heads=2", "base_num_kv_heads=2", "head_dim=32",
       "max_target_length=32", "dtype=float32", "scan_layers=false", "learning_rate=1e-3",
       "warmup_steps_fraction=0.0", "steps=5", "dataset_type=synthetic",
       "attention=dot_product"]
ROWS = 8
STEPS = 3
CASES = {  # name: (ranks, the port's mesh)
    "expert2": (2, ["ici_expert_parallelism=2"]),
    "expert4_tensor2": (8, ["ici_expert_parallelism=4", "ici_tensor_parallelism=2"]),
}


def _setup():
    cfg = load_config(MOE + [f"per_device_batch_size={ROWS}"])
    jcfg = jax_load_config(MOE + [f"per_device_batch_size={ROWS / JAX_DEVICES}"])
    batch = {k: np.array(v) for k, v in synthetic.make_batch(cfg, 0, ROWS).items()}
    return numpy_weights(cfg, seed=11), batch, dataclasses.replace(jcfg, scan_layers=False)


def _jax_run(jcfg, weights, batch):
    model = JaxTransformer(cfg=jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    logits = np.asarray(model.apply({"params": jax_tree(weights)}, jbatch["inputs"],
                                    jbatch["inputs_position"],
                                    jnp.ones_like(jbatch["inputs"])))
    tx = joptim.get_optimizer(jcfg, joptim.create_learning_rate_schedule(jcfg))
    state = jtrain.TrainState.create(apply_fn=model.apply, params=jax_tree(weights), tx=tx)
    step = jax.jit(functools.partial(jtrain.train_step, model, jcfg))
    history = []
    for _ in range(STEPS):
        state, m = step(state, jbatch, jax.random.PRNGKey(0))
        history.append({k: float(v) for k, v in m.items()})
    return logits, history, params_from_jax(jax.tree.map(np.asarray, state.params))


@pytest.mark.parametrize("name", list(CASES))
def test_expert_parallel_forward_and_steps_match_jax(name, tmp_path):
    world, mesh = CASES[name]
    weights, batch, jcfg = _setup()
    args = MOE + mesh + [f"per_device_batch_size={ROWS // world}"]
    ranks = [r[0] for r in run_ranks(tmp_path, world, "moe", [(args, weights, batch, STEPS)])]
    jlogits, jhist, jparams = _jax_run(jcfg, weights, batch)
    for rank in ranks:
        np.testing.assert_allclose(rank["logits"], jlogits, rtol=0,
                                   atol=2e-5 * np.abs(jlogits).max())
        np.testing.assert_array_equal(rank["logits"], ranks[0]["logits"])
        # each layer's rows went out to their experts and came home
        assert rank["calls"]["all_to_all_v"] == 2 * 2
        assert rank["calls"]["expert_counts"] == 2
        for step, (got, want) in enumerate(zip(rank["history"], jhist)):
            np.testing.assert_allclose(got["loss"], want["loss"], atol=2e-5, rtol=0,
                                       err_msg=f"loss, step {step}")
            for key in ("grad_norm", "param_norm"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                           err_msg=f"{key} {step}")
    got = ranks[0]["params"]
    assert set(got) == set(jparams)
    for n, w in jparams.items():
        diff = np.abs(got[n].numpy() - w.numpy())
        assert diff.max() <= 1e-4, (n, diff.max())
        assert (diff > 2e-6).mean() <= 1e-3, (n, int((diff > 2e-6).sum()))
        for other in ranks[1:]:
            assert torch.equal(other["params"][n], got[n]), n
