"""MoE training in the PyTorch package against the JAX package, on the CPU.

* The grouped product's autograd Function (``ops/grouped_matmul.GroupedMatmul``,
  plain backward: a float32 product a group) against ``jax.vjp`` of
  ``jax.lax.ragged_dot(..., preferred_element_type=float32).astype(dtype)``,
  in float32 and bfloat16, with empty groups and with one group holding every
  row: the result, dx and dw, and their dtypes.
* One training step of the JAX package's MoE training configs
  (``tests/test_moe.py``: the mixtral-style decoder, and deepseek's dense then
  MoE layers) from the same weights and batch: the loss, ``moe_lb_loss``,
  every gradient and, after a few steps, every parameter.
* The port's sparse route (sort, grouped products through the Function,
  ordered sum back) against its dense einsum route: a layer's output and
  gradients, and a whole training step.

Weights, inputs and cotangents are made with numpy from a seed and handed to
both packages. Tolerances: float32, 2e-5 relative to the largest |value|
(other summation orders); bfloat16, one bfloat16 step of the largest |value|
(2**-7: both round a float32 sum, summed in another order, once).
"""

import dataclasses
import functools

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
from maxtext_indextts2_tpu_torch.models.moe import RoutedMoE
from maxtext_indextts2_tpu_torch.ops import grouped_matmul as gm
from maxtext_indextts2_tpu_torch.train import train as ttrain
from maxtext_indextts2_tpu_torch.train.data import synthetic
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_to_jax
from torch_port_helpers import JAX_DEVICES, jax_tree, numpy_weights

TOL_F32 = 2e-5
TOL_BF16 = 2.0 ** -7
ROWS = 8  # batch rows: the JAX harness's eight CPU devices each take one

# the JAX package's MoE training configs (tests/test_moe.py:127 and :150),
# unrolled, float32
MOE_BASE = ["base_emb_dim=64", "base_mlp_dim=128", "moe_mlp_dim=128", "num_experts=4",
            "num_experts_per_tok=2", "vocab_size=256", "base_num_query_heads=2",
            "base_num_kv_heads=2", "head_dim=32", "max_target_length=32", "dtype=float32",
            "scan_layers=false", "learning_rate=1e-3", "warmup_steps_fraction=0.0",
            "steps=5", "dataset_type=synthetic"]
CONFIGS = {
    "mixtral": ["decoder_block=mixtral", "base_num_decoder_layers=2"],
    "deepseek_dense_then_moe": ["decoder_block=deepseek", "base_num_decoder_layers=4",
                                "first_num_dense_layers=2"],
}


def _configs(extra):
    args = MOE_BASE + list(extra)
    cfg = load_config(args + [f"per_device_batch_size={ROWS}"])
    jcfg = jax_load_config(args + [f"per_device_batch_size={ROWS / JAX_DEVICES}"])
    return cfg, dataclasses.replace(jcfg, scan_layers=False)


def _offsets(sizes):
    return torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32)


GROUPINGS = {"ragged": [5, 0, 9, 3, 0, 7], "empty_groups": [0, 0, 24, 0, 0, 0],
             "one_group_holds_all": [0, 0, 0, 0, 0, 24]}


@pytest.mark.parametrize("grouping", list(GROUPINGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_backward_matches_jax_vjp_of_ragged_dot(dtype, grouping):
    sizes = np.asarray(GROUPINGS[grouping], np.int32)
    rng = np.random.default_rng(3)
    r, k, n, g = int(sizes.sum()), 48, 40, len(sizes)
    x = rng.normal(size=(r, k)).astype(np.float32)
    w = (rng.normal(size=(g, k, n)) / np.sqrt(k)).astype(np.float32)
    c = rng.normal(size=(r, n)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def f(a, b):
        return jax.lax.ragged_dot(a, b, jnp.asarray(sizes), preferred_element_type=jnp.float32
                                  ).astype(jdt)

    jy, vjp = jax.vjp(f, jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    jdx, jdw = vjp(jnp.asarray(c, jdt))

    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    tw = torch.from_numpy(w).to(tdt).requires_grad_(True)
    before = dict(gm.launch_counts)
    ty = gm.grouped_matmul(tx, tw, _offsets(sizes))
    assert type(ty.grad_fn).__name__ == "GroupedMatmulBackward"
    ty.backward(torch.from_numpy(c).to(tdt))
    assert gm.launch_counts == before  # the CPU takes the plain versions: no launch
    tol = TOL_F32 if dtype == "float32" else TOL_BF16
    for name, got, want in (("y", ty, jy), ("dx", tx.grad, jdx), ("dw", tw.grad, jdw)):
        assert str(got.dtype).replace("torch.", "") == str(want.dtype) == dtype, name
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().detach().numpy(), want, rtol=0,
                                   atol=tol * max(1.0, float(np.abs(want).max())), err_msg=name)
    if grouping != "ragged":  # an empty group's weight gradient is zero
        assert (tw.grad[torch.from_numpy(sizes == 0)] == 0).all()


def test_plain_backward_versions_equal_loops_of_products():
    rng = np.random.default_rng(5)
    sizes = [3, 0, 4]
    off = _offsets(sizes)
    x = torch.from_numpy(rng.normal(size=(7, 16)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(7, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 16, 8)).astype(np.float32))
    dx = gm.grouped_matmul_dgrad(dy, w, off)
    dw = gm.grouped_matmul_wgrad(x, dy, off)
    torch.testing.assert_close(dx[:3], dy[:3] @ w[0].t())
    torch.testing.assert_close(dx[3:], dy[3:] @ w[2].t())
    torch.testing.assert_close(dw[0], x[:3].t() @ dy[:3])
    assert (dw[1] == 0).all()
    torch.testing.assert_close(dw[2], x[3:].t() @ dy[3:])
    with pytest.raises(ValueError, match="one CUDA device|cuda"):
        gm.grouped_matmul_dgrad(dy, w, off, impl="cuda")


def _batch(cfg):
    return {k: np.array(v) for k, v in synthetic.make_batch(cfg, 0, ROWS).items()}


def _jax_grads(jcfg, weights, batch):
    model = JaxTransformer(cfg=jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, aux), grads = jax.value_and_grad(
        lambda p: jtrain.loss_fn(model, jcfg, p, jbatch, jax.random.PRNGKey(0)),
        has_aux=True)(jax_tree(weights))
    return float(loss), {k: float(v) for k, v in aux.items()}, grads


def _torch_grads(cfg, weights, batch):
    state = ttrain.setup_train_state(
        cfg, device="cpu", params={k: torch.from_numpy(v) for k, v in weights.items()})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, aux = ttrain.loss_fn(state.model, cfg, tbatch)
    grads = ttrain._grads(loss, list(state.params.values()))
    return float(loss.detach()), {k: float(v.detach()) for k, v in aux.items()}, \
        dict(zip(state.params, grads))


def _leaves(tree):
    return {"/".join(p.key for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_grads_close(got: dict, want_tree, tol=TOL_F32):
    got = _leaves(params_to_jax({k: v.detach() for k, v in got.items()}))
    want = _leaves(want_tree)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=tol * max(float(np.abs(w).max()), 1e-6), err_msg=name)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_moe_loss_and_gradients_match_jax(config):
    cfg, jcfg = _configs(CONFIGS[config])
    weights = numpy_weights(cfg, seed=11)
    batch = _batch(cfg)
    jloss, jaux, jgrads = _jax_grads(jcfg, weights, batch)
    tloss, taux, tgrads = _torch_grads(cfg, weights, batch)
    assert "moe_lb_loss" in taux and "moe_lb_loss" in jaux
    np.testing.assert_allclose(taux["moe_lb_loss"], jaux["moe_lb_loss"], rtol=1e-5)
    np.testing.assert_allclose(tloss, jloss, rtol=0, atol=2e-5)
    np.testing.assert_allclose(taux["ce_loss"], jaux["ce_loss"], rtol=0, atol=2e-5)
    _assert_grads_close(tgrads, jgrads)
    # the router's selection bias takes no gradient (none here: softmax routing)
    assert not any(k.endswith("gate_bias") for k in tgrads) or all(
        (v == 0).all() for k, v in tgrads.items() if k.endswith("gate_bias"))


def _steps_match_jax(extra, seed, steps=3):
    cfg, jcfg = _configs(extra)
    weights = numpy_weights(cfg, seed=seed)
    batch = _batch(cfg)
    model = JaxTransformer(cfg=jcfg)
    tx = joptim.get_optimizer(jcfg, joptim.create_learning_rate_schedule(jcfg))
    jstate = jtrain.TrainState.create(apply_fn=model.apply, params=jax_tree(weights), tx=tx)
    step = jax.jit(functools.partial(jtrain.train_step, model, jcfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tstate = ttrain.setup_train_state(
        cfg, device="cpu", params={k: torch.from_numpy(v) for k, v in weights.items()})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(steps):
        jstate, jm = step(jstate, jbatch, jax.random.PRNGKey(0))
        tm = ttrain.train_step(cfg, tstate, tbatch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=0, atol=2e-5,
                                   err_msg=f"loss, step {i}")
        if "moe_lb_loss" in jm:
            np.testing.assert_allclose(float(tm["moe_lb_loss"]), float(jm["moe_lb_loss"]),
                                       rtol=1e-5, err_msg=f"moe_lb_loss, step {i}")
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    got = _leaves(params_to_jax({k: v.detach() for k, v in tstate.params.items()}))
    for name, want in _leaves(jstate.params).items():
        # a few Adam updates of 1e-3 each: Adam divides a gradient by its own
        # root mean square, so a gradient near zero, whose last bits differ,
        # moves its parameter by up to the learning rate in either direction;
        # such entries must stay rare (one in a thousand) and small
        diff = np.abs(got[name] - want)
        assert diff.max() <= 1e-4, (name, diff.max())
        assert (diff > 2e-6).mean() <= 1e-3, (name, int((diff > 2e-6).sum()))


def _sparse_on_the_cpu(monkeypatch):
    """Route every MoE layer through the sparse route (the grouped products'
    plain versions, their gradients through the autograd Function)."""
    dense = RoutedMoE.dense_experts
    monkeypatch.setattr(RoutedMoE, "dense_experts",
                        lambda self, *a: RoutedMoE.sparse_experts(self, *a, impl="plain"))
    return dense


@pytest.mark.parametrize("extra", [
    [], ["moe_weight_on_input=true"], ["shared_experts=1", "routed_score_func=sigmoid",
                                       "routed_bias=true", "normalize_topk_weights=true",
                                       "num_experts=8", "n_routing_groups=4",
                                       "topk_routing_group=2"],
], ids=["softmax", "weight_on_input", "sigmoid_grouped_shared"])
def test_sparse_route_output_and_gradients_equal_the_dense_route(extra):
    cfg = load_config(MOE_BASE + ["decoder_block=mixtral"] + extra)
    torch.manual_seed(0)
    moe = RoutedMoE(cfg, device="cpu")
    gen = torch.Generator().manual_seed(4)
    moe.reset_parameters(gen)
    if moe.gate_bias is not None:
        moe.gate_bias.copy_(0.1 * torch.randn(moe.gate_bias.shape, generator=gen))
    for p in moe.parameters():
        p.requires_grad_(True)
    with torch.no_grad():
        moe.gate.kernel.normal_(generator=gen)
    x = torch.randn((2, 16, 64), generator=gen)
    c = torch.randn((2, 16, 64), generator=gen)
    results = []
    for route in ("sparse", "dense"):
        xi = x.clone().requires_grad_(True)
        top_idx, top_w, _ = moe.route(xi)
        fn = moe.sparse_experts if route == "sparse" else moe.dense_experts
        kwargs = {"impl": "plain"} if route == "sparse" else {}
        out = fn(xi, top_idx, top_w, moe.wi_0, moe.wi_1, moe.wo, **kwargs)
        params = [moe.wi_0, moe.wi_1, moe.wo, moe.gate.kernel]
        grads = torch.autograd.grad((out * c).sum(), [xi] + params)
        results.append([out] + list(grads))
    for name, a, b in zip(("out", "dx", "wi_0", "wi_1", "wo", "gate"), *results):
        torch.testing.assert_close(a, b, rtol=0, atol=TOL_F32 * max(1.0, float(b.abs().max())),
                                   msg=name)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_sparse_route_train_step_equals_the_dense_route(config, monkeypatch):
    cfg, _ = _configs(CONFIGS[config])
    weights = numpy_weights(cfg, seed=13)
    batch = _batch(cfg)
    dense = _torch_grads(cfg, weights, batch)
    _sparse_on_the_cpu(monkeypatch)
    sparse = _torch_grads(cfg, weights, batch)
    np.testing.assert_allclose(sparse[0], dense[0], rtol=0, atol=2e-5)
    np.testing.assert_allclose(sparse[1]["moe_lb_loss"], dense[1]["moe_lb_loss"], rtol=1e-6)
    for name, g in dense[2].items():
        torch.testing.assert_close(sparse[2][name], g, rtol=0,
                                   atol=TOL_F32 * max(float(g.abs().max()), 1e-6), msg=name)


@pytest.mark.parametrize("policy", ["full", "minimal", "save_attn_out", "save_attn_and_mlp"])
def test_every_remat_policy_gives_the_moe_gradients_of_none(policy):
    cfg, _ = _configs(CONFIGS["deepseek_dense_then_moe"])
    weights = numpy_weights(cfg, seed=14)
    batch = _batch(cfg)
    want = _torch_grads(dataclasses.replace(cfg, remat_policy="none"), weights, batch)
    got = _torch_grads(dataclasses.replace(cfg, remat_policy=policy), weights, batch)
    assert got[1]["moe_lb_loss"] == want[1]["moe_lb_loss"]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    for name, g in want[2].items():
        torch.testing.assert_close(got[2][name], g, rtol=0, atol=1e-6, msg=name)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_moe_train_steps_match_jax(config):
    _steps_match_jax(CONFIGS[config], seed=12)


def test_gradient_accumulation_with_moe_matches_jax():
    """Two microbatches a step: each routes its own tokens, and the step's
    loss and gradients are the microbatches' means, as in the JAX package."""
    _steps_match_jax(CONFIGS["mixtral"] + ["gradient_accumulation_steps=2"], seed=15)


def test_pinned_routing_takes_the_first_pass_selection_and_its_own_weights():
    """``tools/moe_route_noise.pinned_routing``: the first call of each layer
    records its top-k; a later call on other inputs takes that selection,
    gathers its combine weights from its own scores (as ``route(top_idx=)``),
    counts the tokens its own scores would have sent elsewhere, and the
    module's own ``route`` is back after the block."""
    from maxtext_indextts2_tpu_torch.tools.moe_route_noise import pinned_routing, rel_gaps

    cfg = load_config(MOE_BASE + ["decoder_block=mixtral", "normalize_topk_weights=true"])
    moe = RoutedMoE(cfg, device="cpu")
    gen = torch.Generator().manual_seed(6)
    moe.reset_parameters(gen)
    with torch.no_grad():
        moe.gate.kernel.normal_(generator=gen)
    holder = torch.nn.ModuleDict({"moe_0": moe})
    x0 = torch.randn((2, 16, 64), generator=gen)
    x1 = torch.randn((2, 16, 64), generator=gen)
    own1 = moe.route(x1)
    selection, flips = {}, []
    with pinned_routing([holder], selection, flips):
        first = moe.route(x0)
        later = moe.route(x1)
    assert "route" not in moe.__dict__
    torch.testing.assert_close(first[0], moe.route(x0)[0], rtol=0, atol=0)
    torch.testing.assert_close(later[0], first[0], rtol=0, atol=0)
    want_w = torch.gather(own1[2], -1, first[0])
    want_w = (want_w / want_w.sum(-1, keepdim=True)).to(later[1].dtype)
    torch.testing.assert_close(later[1], want_w, rtol=0, atol=TOL_F32)
    torch.testing.assert_close(later[2], own1[2], rtol=0, atol=0)
    moved = int((torch.sort(own1[0], -1).values
                 != torch.sort(first[0], -1).values).any(-1).sum())
    assert flips == [0, moved] and moved > 0
    assert rel_gaps([torch.tensor([1.0, -3.0])], [torch.tensor([1.0, -4.0])]) == [0.25]
