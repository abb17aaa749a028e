"""MLP dropout in LM training: the PyTorch package against the JAX package,
with the JAX package's own masks.

The JAX package drops out each MLP's activation product after the
``mlp_pre_wo`` anchor with ``flax.linen.Dropout`` (``bernoulli(1 - rate)``,
kept entries divided by ``1 - rate``). The test captures its masks by
wrapping ``flax.linen.Dropout.__call__`` (``monkeypatch``, inside the test):
the wrapper draws the key as flax does, sows ``bernoulli(key, 1 - rate,
shape)`` into ``intermediates`` and hands flax the same key, so the masks are
the ones the JAX loss uses. The port takes them as ``models.layers.MlpDropout``.

Tolerances (float32 on both sides; the frameworks sum products in other
orders): the MLP block's output 1e-6 absolute on O(1) values; a 2-layer LM's
loss 2e-5 absolute (values ~6) and every gradient 1e-4 of its largest entry,
with remat off, ``full`` and ``save_attn_and_mlp``; two training steps as
``tests/test_torch_train.py`` holds its steps. Remat against no remat in the
port: equal within 1e-6 of each gradient's largest entry (only the
recomputation's order of the same sums differs).
"""

import dataclasses
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen.module import merge_param
from torch_port_helpers import configs, jax_tree, numpy_weights

from maxtext_indextts2_tpu.models import Transformer as JaxTransformer
from maxtext_indextts2_tpu.models.layers import MlpBlock as JaxMlpBlock
from maxtext_indextts2_tpu.train import optimizers as joptim
from maxtext_indextts2_tpu.train import train as jtrain
from maxtext_indextts2_tpu_torch.models.layers import MlpBlock, MlpDropout, dropout
from maxtext_indextts2_tpu_torch.train import train as ttrain
from maxtext_indextts2_tpu_torch.train.data import synthetic
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_to_jax, tree_to_state_dict

RATE = 0.25
ROWS = 8  # the JAX test harness has eight CPU devices
TRAIN = ["max_target_length=32", "learning_rate=1e-3", "warmup_steps_fraction=0.2", "steps=5",
         "dataset_type=synthetic", "enable_dropout=true", f"dropout_rate={RATE}"]


@pytest.fixture
def capture_masks(monkeypatch):
    """Wrap ``flax.linen.Dropout.__call__`` so that every dropout sows its
    keep mask into ``intermediates`` (``keep_mask``)."""
    original = nn.Dropout.__call__

    def call(self, inputs, deterministic=None, rng=None):
        det = merge_param("deterministic", self.deterministic, deterministic)
        if self.rate > 0.0 and not det and rng is None:
            rng = self.make_rng(self.rng_collection)
        if rng is not None:
            self.sow("intermediates", "keep_mask",
                     jax.random.bernoulli(rng, 1.0 - self.rate, inputs.shape))
        return original(self, inputs, deterministic, rng)

    monkeypatch.setattr(nn.Dropout, "__call__", call)


def _jax_masks(jcfg, params, batch, rng) -> list[np.ndarray]:
    """The keep masks ``train.loss_fn`` of the JAX package draws from ``rng``
    (its forward with the same rngs), in layer order."""
    model = JaxTransformer(cfg=dataclasses.replace(jcfg, remat_policy="none"))
    _, mutables = model.apply(
        {"params": params}, batch["inputs"], batch["inputs_position"],
        batch["inputs_segmentation"], deterministic=False,
        rngs={"dropout": rng, "params": jax.random.fold_in(rng, 1)}, mutable=["intermediates"])
    dec = mutables["intermediates"]["decoder"]
    return [np.asarray(dec[f"layers_{i}"]["mlp_0"]["Dropout_0"]["keep_mask"][0])
            for i in range(jcfg.num_decoder_layers)]


def _setup(extra=()):
    cfg, jcfg = configs(TRAIN + list(extra), slots=ROWS)
    weights = numpy_weights(cfg, seed=5)
    batch = {k: np.array(v) for k, v in synthetic.make_batch(cfg, 0, ROWS).items()}
    return cfg, jcfg, weights, batch


def _grads_by_name(state, loss):
    grads = torch.autograd.grad(loss, list(state.params.values()))
    return dict(zip(state.params, grads))


def _assert_grads_close(got: dict, want_tree, tol):
    got = params_to_jax({k: v.detach() for k, v in got.items()})
    for path, want in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, want_tree)):
        node = got
        for p in path:
            node = node[p.key]
        err = np.abs(node - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= tol, (jax.tree_util.keystr(path), err)


@pytest.mark.usefixtures("capture_masks")
def test_masked_mlp_block_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 16)).astype(np.float32)
    jblock = JaxMlpBlock(intermediate_dim=32, dtype=jnp.float32, intermediate_dropout_rate=RATE)
    params = nn.meta.unbox(jblock.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    key = jax.random.PRNGKey(1)
    want, mut = jblock.apply(params, jnp.asarray(x), deterministic=False, rngs={"dropout": key},
                             mutable=["intermediates"])
    mask = np.asarray(mut["intermediates"]["Dropout_0"]["keep_mask"][0])
    assert 0.6 < mask.mean() < 0.9
    block = MlpBlock(16, 32, dtype=torch.float32, dropout_rate=RATE, device="cpu")
    block.load_state_dict(tree_to_state_dict(jax.tree.map(np.asarray, params)))
    got = block(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)
    # no mask: deterministic, as the JAX block with deterministic=True
    np.testing.assert_allclose(block(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jblock.apply(params, jnp.asarray(x))), atol=1e-6)


def test_dropout_scales_by_the_keep_probability_in_the_inputs_dtype():
    """flax divides by ``1 - rate`` cast to the input's dtype (bf16(0.9) =
    0.8984375); rate 1 gives zeros."""
    x = torch.tensor([1.0, 2.0, -3.0, 4.0], dtype=torch.bfloat16)
    keep = torch.tensor([True, False, True, True])
    want = np.asarray(jnp.where(jnp.asarray(keep.numpy()),
                                jnp.asarray([1.0, 2.0, -3.0, 4.0], jnp.bfloat16) / 0.9, 0))
    got = dropout(x, keep, 0.1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    assert torch.equal(dropout(x, keep, 1.0), torch.zeros_like(x))


@pytest.mark.usefixtures("capture_masks")
@pytest.mark.parametrize("remat", ["none", "full", "save_attn_and_mlp"])
def test_lm_loss_and_gradients_with_jax_masks_match_jax(remat):
    cfg, jcfg, weights, batch = _setup([f"remat_policy={remat}"])
    params = jax_tree(weights)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(11)
    masks = _jax_masks(jcfg, params, jbatch, rng)
    jmodel = JaxTransformer(cfg=jcfg)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtrain.loss_fn(jmodel, jcfg, p, jbatch, rng), has_aux=True)(params)
    state = ttrain.setup_train_state(cfg, device="cpu",
                                     params={k: torch.from_numpy(v) for k, v in weights.items()})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    drop = MlpDropout(RATE, masks=[torch.from_numpy(m) for m in masks])
    loss, _ = ttrain.loss_fn(state.model, cfg, tbatch, dropout=drop)
    np.testing.assert_allclose(float(loss), float(jloss), atol=2e-5, rtol=0)
    _assert_grads_close(_grads_by_name(state, loss), jgrads, 1e-4)
    # without dropout the loss moves: the masks did something
    plain, _ = ttrain.loss_fn(state.model, cfg, tbatch)
    assert abs(float(plain) - float(loss)) > 1e-3


@pytest.mark.parametrize("remat", ["full", "save_attn_out", "save_attn_and_mlp", "minimal"])
def test_remat_recomputes_with_the_same_masks(remat):
    """Masks drawn from a generator as the decoder reaches each layer: every
    remat policy gives no remat's gradients (a mask drawn again on
    recomputation would not)."""
    cfg, _, weights, batch = _setup(["remat_policy=none"])
    cfg_remat = dataclasses.replace(cfg, remat_policy=remat)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for c in (cfg, cfg_remat):
        state = ttrain.setup_train_state(c, device="cpu", params={
            k: torch.from_numpy(v) for k, v in weights.items()})
        drop = MlpDropout(RATE, generator=torch.Generator().manual_seed(3))
        loss, _ = ttrain.loss_fn(state.model, c, tbatch, dropout=drop)
        out[c.remat_policy] = (float(loss), _grads_by_name(state, loss))
    (l0, g0), (l1, g1) = out["none"], out[remat]
    assert l0 == l1
    for name, g in g0.items():
        err = float((g1[name] - g).abs().max() / g.abs().max().clamp(min=1e-30))
        assert err <= 1e-6, (name, err)


@pytest.mark.usefixtures("capture_masks")
def test_train_steps_with_dropout_match_jax():
    """Two ``train_step``s of each package, the JAX step's masks handed to
    the port's step; losses, norms and the parameters after them."""
    cfg, jcfg, weights, batch = _setup(["remat_policy=full"])
    jmodel = JaxTransformer(cfg=jcfg)
    tx = joptim.get_optimizer(jcfg, joptim.create_learning_rate_schedule(jcfg))
    jstate = jtrain.TrainState.create(apply_fn=jmodel.apply, params=jax_tree(weights), tx=tx)
    jstep = jax.jit(functools.partial(jtrain.train_step, jmodel, jcfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = ttrain.setup_train_state(cfg, device="cpu",
                                     params={k: torch.from_numpy(v) for k, v in weights.items()})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for step in range(2):
        rng = jax.random.PRNGKey(20 + step)
        masks = _jax_masks(jcfg, jstate.params, jbatch, rng)
        jstate, jm = jstep(jstate, jbatch, rng)
        tm = ttrain.train_step(cfg, state, tbatch, dropout=MlpDropout(
            RATE, masks=[torch.from_numpy(m) for m in masks]))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=2e-5, rtol=0)
        for key in ("grad_norm", "param_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5)
    got = params_to_jax({k: v.detach() for k, v in state.params.items()})
    for path, want in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                                       jstate.params)):
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, want, atol=5e-5, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_default_step_dropout_is_seeded_by_seed_and_step():
    cfg, _, _, _ = _setup()
    a, b = ttrain.step_dropout(cfg, 3, "cpu"), ttrain.step_dropout(cfg, 3, "cpu")
    c = ttrain.step_dropout(cfg, 4, "cpu")
    ma, mb, mc = (d.keep_mask(0, (4, 8, 32), "cpu") for d in (a, b, c))
    assert torch.equal(ma, mb) and not torch.equal(ma, mc)
    assert 0.6 < float(ma.float().mean()) < 0.9
    assert ttrain.step_dropout(dataclasses.replace(cfg, enable_dropout=False), 3, "cpu") is None
    assert ttrain.step_dropout(dataclasses.replace(cfg, dropout_rate=0.0), 3, "cpu") is None


def test_train_loop_trains_with_dropout_and_eval_stays_deterministic():
    cfg, _, _, batch = _setup(["remat_policy=save_attn_and_mlp", "steps=2"])
    out = ttrain.train_loop(cfg, device="cpu", quiet=True)
    assert len(out["history"]) == 2 and np.isfinite(out["loss"])
    state = ttrain.setup_train_state(cfg, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    e1, e2 = (float(ttrain.eval_step(cfg, state, tbatch)["eval_loss"]) for _ in range(2))
    assert e1 == e2
