"""Multi-token prediction in the PyTorch package against the JAX package, on
the CPU: the configuration of the JAX package's ``tests/test_train.py``
MTP test (``mtp_num_layers=2``) from the same weights and batch, its
``mtp_loss``, the loss and every gradient, also on packed rows (two
documents and a padding tail in a row) and with explicit ``target_weights``;
a training step's parameters; the model ``deepseek-v3`` builds and serves
without the MTP layers.

Weights and batches are made with numpy from a seed. Tolerances: float32,
2e-5 relative to the largest |value| (other summation orders), as the other
training tests; Adam-updated parameters as ``tests/test_torch_moe_train.py``
states.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.models import Transformer as JaxTransformer
from maxtext_indextts2_tpu.train import optimizers as joptim
from maxtext_indextts2_tpu.train import train as jtrain
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.models import MODE_PREFILL, Transformer
from maxtext_indextts2_tpu_torch.models.attention import MODE_TRAIN
from maxtext_indextts2_tpu_torch.train import train as ttrain
from maxtext_indextts2_tpu_torch.train.data import synthetic
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_to_jax
from torch_port_helpers import JAX_DEVICES, jax_tree, numpy_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "maxtext_indextts2_tpu_torch", "configs", "tiny.yml")
TINY_JAX = os.path.join(REPO, "maxtext_indextts2_tpu", "configs", "tiny.yml")
TOL = 2e-5
ROWS = 8
# tests/test_train.py's SMALL, float32, unrolled, with two MTP depths
SMALL = ["max_target_length=64", "base_emb_dim=128", "base_mlp_dim=256",
         "base_num_decoder_layers=2", "base_num_query_heads=4", "base_num_kv_heads=4",
         "head_dim=32", "steps=6", "warmup_steps_fraction=0.0", "learning_rate=1e-3",
         "mtp_num_layers=2", "dtype=float32", "scan_layers=false"]


def _configs(extra=()):
    args = SMALL + list(extra)
    cfg = load_config([TINY] + args + [f"per_device_batch_size={ROWS}"])
    jcfg = jax_load_config([TINY_JAX] + args + [f"per_device_batch_size={ROWS / JAX_DEVICES}"])
    return cfg, dataclasses.replace(jcfg, scan_layers=False)


def _batch(cfg, packed):
    batch = {k: np.array(v) for k, v in synthetic.make_batch(cfg, 0, ROWS).items()}
    if packed:  # a second document in some rows and a padding tail
        for r in range(0, ROWS, 2):
            batch["inputs_segmentation"][r, 30:] = 2
            batch["inputs_position"][r, 30:] -= 30
            batch["inputs_segmentation"][r, 50:] = 0
        batch["targets_segmentation"] = batch["inputs_segmentation"].copy()
    return batch


def _leaves(tree):
    return {"/".join(p.key for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("packed", [False, True], ids=["synthetic", "packed_segments"])
def test_mtp_loss_loss_and_gradients_match_jax(packed):
    cfg, jcfg = _configs()
    weights = numpy_weights(cfg, seed=21)
    assert any(k.startswith("mtp_2.layer.") for k in weights)
    batch = _batch(cfg, packed)
    model = JaxTransformer(cfg=jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jtrain.loss_fn(model, jcfg, p, jbatch, jax.random.PRNGKey(0)),
        has_aux=True)(jax_tree(weights))

    state = ttrain.setup_train_state(
        cfg, device="cpu", params={k: torch.from_numpy(v) for k, v in weights.items()})
    loss, aux = ttrain.loss_fn(state.model, cfg, {k: torch.from_numpy(v)
                                                  for k, v in batch.items()})
    grads = dict(zip(state.params, ttrain._grads(loss, list(state.params.values()))))
    np.testing.assert_allclose(float(aux["mtp_loss"].detach()), float(jaux["mtp_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0, atol=TOL)
    got = _leaves(params_to_jax({k: v.detach() for k, v in grads.items()}))
    want = _leaves(jgrads)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=TOL * max(float(np.abs(w).max()), 1e-6), err_msg=name)
    # the MTP depths are trained: every mtp_k weight receives a gradient
    assert all(float(grads[k].abs().max()) > 0 for k in grads if k.startswith("mtp_"))


def test_mtp_loss_with_target_weights_matches_jax():
    cfg, jcfg = _configs()
    weights = numpy_weights(cfg, seed=22)
    batch = _batch(cfg, packed=True)
    tw = np.random.default_rng(5).uniform(0.0, 2.0, size=batch["targets"].shape
                                          ).astype(np.float32)
    model = JaxTransformer(cfg=jcfg)
    _, inter = model.apply(
        {"params": jax_tree(weights)}, jnp.asarray(batch["inputs"]),
        jnp.asarray(batch["inputs_position"]), jnp.asarray(batch["inputs_segmentation"]),
        targets=jnp.asarray(batch["targets"]), target_weights=jnp.asarray(tw),
        mutable=["intermediates"])
    want = float(np.asarray(inter["intermediates"]["mtp_loss"][0]))
    tmodel = Transformer(cfg, device="cpu")
    tmodel.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    aux = {}
    with torch.no_grad():
        tmodel(torch.from_numpy(batch["inputs"]), torch.from_numpy(batch["inputs_position"]),
               torch.from_numpy(batch["inputs_segmentation"]), mode=MODE_TRAIN,
               targets=torch.from_numpy(batch["targets"]),
               target_weights=torch.from_numpy(tw), aux=aux)
    np.testing.assert_allclose(float(aux["mtp_loss"]), want, rtol=1e-5)


def test_mtp_train_steps_match_jax():
    cfg, jcfg = _configs()
    weights = numpy_weights(cfg, seed=23)
    batch = _batch(cfg, packed=False)
    model = JaxTransformer(cfg=jcfg)
    tx = joptim.get_optimizer(jcfg, joptim.create_learning_rate_schedule(jcfg))
    jstate = jtrain.TrainState.create(apply_fn=model.apply, params=jax_tree(weights), tx=tx)
    step = jax.jit(functools.partial(jtrain.train_step, model, jcfg))
    tstate = ttrain.setup_train_state(
        cfg, device="cpu", params={k: torch.from_numpy(v) for k, v in weights.items()})
    for i in range(2):
        jstate, jm = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.PRNGKey(0))
        tm = ttrain.train_step(cfg, tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert np.isfinite(float(tm["mtp_loss"]))
        np.testing.assert_allclose(float(tm["mtp_loss"]), float(jm["mtp_loss"]), rtol=1e-5,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=0, atol=TOL)
    got = _leaves(params_to_jax({k: v.detach() for k, v in tstate.params.items()}))
    for name, want in _leaves(jstate.params).items():
        diff = np.abs(got[name] - want)  # see tests/test_torch_moe_train.py
        assert diff.max() <= 1e-4, (name, diff.max())
        assert (diff > 2e-6).mean() <= 1e-3, (name, int((diff > 2e-6).sum()))


def test_serving_forward_skips_the_mtp_layers():
    """Prefill (and a training forward without targets) computes no MTP loss
    and gives the logits of the trunk alone, as in the JAX package."""
    cfg, _ = _configs()
    weights = numpy_weights(cfg, seed=24)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    called = []
    for k in (1, 2):
        getattr(model, f"mtp_{k}").register_forward_hook(lambda *a: called.append(1))
    toks = torch.from_numpy(np.random.default_rng(0).integers(1, 1000, (1, 12)).astype(np.int32))
    pos = torch.arange(12, dtype=torch.int32)[None]
    aux = {}
    with torch.no_grad():
        model(toks, pos, torch.ones_like(toks), mode=MODE_PREFILL,
              cache=model.init_cache(1, 12), aux=aux)
        model(toks, pos, torch.ones_like(toks), mode=MODE_TRAIN, aux=aux)
    assert not called and "mtp_loss" not in aux


def test_deepseek_v3_builds_with_its_mtp_layer():
    cfg = load_config(["model_name=deepseek-v3", "max_target_length=16",
                       "max_prefill_predict_length=8"])
    assert cfg.mtp_num_layers == 1
    model = Transformer(cfg, device="meta")
    names = [n for n, _ in model.named_parameters() if n.startswith("mtp_1.")]
    assert "mtp_1.projection.kernel" in names and "mtp_1.hidden_norm.scale" in names
    assert not any(".moe_" in n for n in names)  # the MTP layer is dense
