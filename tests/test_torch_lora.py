"""LoRA adapters against the JAX package: the adapted forward, LoRA-only
training, ``Engine.load_lora_adapter``, and the weight bridge with int8,
scale and adapter leaves.

Tolerances: float32 logits within 1e-4 (two layers of float32 products
summed in another order, as ``test_torch_lm_forward.py``). LoRA-only
training, two adamw steps: losses within 2e-5 (values ~6), adapter values
within 5e-5 after the update (Adam's normalised step turns a float32
difference in a near-zero gradient into a share of the step; see
``test_torch_train.py``) and all but 1 in 1000 within 2e-6; every base
weight bitwise unchanged. A merged adapter equals the JAX engine's merge
bitwise (one float32 product of [in, r] x [r, out], r = 4: exact sums of
four terms in either order, then one addition).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import JaxEngine, configs, jax_tree, numpy_weights, prompt

from maxtext_indextts2_tpu.models import Transformer as JaxTransformer
from maxtext_indextts2_tpu.train import optimizers as joptim
from maxtext_indextts2_tpu.train import train as jtrain
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.models import Transformer
from maxtext_indextts2_tpu_torch.train import optimizers as toptim
from maxtext_indextts2_tpu_torch.train import train as ttrain
from maxtext_indextts2_tpu_torch.train.data import synthetic
from maxtext_indextts2_tpu_torch.utils.param_bridge import (
    params_from_jax,
    params_to_jax,
    tree_to_state_dict,
)

LORA = ["lora_rank=4"]


def _inputs(cfg, seed=0, batch=2, seq=24):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)
    positions = np.tile(np.arange(seq, dtype=np.int32), (batch, 1))
    return tokens, positions, np.ones((batch, seq), np.int32)


def test_adapters_sit_on_query_and_value_only():
    model = Transformer(configs(LORA)[0], device="cpu")
    names = [n for n, _ in model.named_parameters() if "lora_" in n]
    assert names and all(".query." in n or ".value." in n for n in names)
    a = dict(model.named_parameters())["decoder.layers_0.self_attention_0.query.lora_a"]
    assert tuple(a.shape) == (128, 4)  # [flat_in, r]
    # the base weights from a seed are the ones a model without adapters gets
    base = Transformer(configs()[0], device="cpu").init_params(3).state_dict()
    adapted = model.init_params(3).state_dict()
    for name, t in base.items():
        assert torch.equal(adapted[name], t), name
    assert not adapted["decoder.layers_0.self_attention_0.value.lora_a"].eq(0).all()
    assert adapted["decoder.layers_0.self_attention_0.value.lora_b"].eq(0).all()


@pytest.mark.parametrize("scan_layers", [False, True], ids=["unrolled", "scan_stacked"])
def test_lora_forward_matches_jax_through_the_bridge(scan_layers):
    """Nonzero adapters (lora_b too), carried to the JAX tree by the bridge
    in both layer layouts."""
    cfg, jcfg = configs(LORA)
    weights = numpy_weights(cfg, seed=1)
    assert np.abs(weights["decoder.layers_1.self_attention_0.value.lora_b"]).max() > 0
    tokens, positions, segs = _inputs(cfg)
    want = JaxTransformer(cfg=dataclasses.replace(jcfg, scan_layers=scan_layers)).apply(
        {"params": jax_tree(weights, scan_layers=scan_layers)}, jnp.asarray(tokens),
        jnp.asarray(positions), jnp.asarray(segs))
    model = Transformer(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), torch.from_numpy(positions),
                    torch.from_numpy(segs)).numpy()
        base = dict(weights)
        for k in [k for k in base if k.endswith("lora_b")]:
            base[k] = np.zeros_like(base[k])
        model.load_state_dict({k: torch.from_numpy(v) for k, v in base.items()})
        plain = model(torch.from_numpy(tokens), torch.from_numpy(positions),
                      torch.from_numpy(segs)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    assert np.abs(got - plain).max() > 1e-2, "the adapters changed nothing"


@pytest.mark.parametrize("scan_layers", [False, True], ids=["unrolled", "scan_stacked"])
def test_bridge_round_trip_with_int8_scale_and_lora_leaves(scan_layers):
    """An int8w_serve state dict (int8 kernels, float32 scales) and a LoRA
    one cross to the JAX tree and back bitwise, dtypes kept."""
    serve = Engine(configs(["quantization=int8w_serve"])[0], device="cpu")
    serve.load_params()
    lora = {k: torch.from_numpy(v) for k, v in numpy_weights(configs(LORA)[0], seed=2).items()}
    for state in (serve.params, lora):
        tree = params_to_jax(state, scan_layers=scan_layers)
        back = params_from_jax(tree)
        assert sorted(back) == sorted(state)
        for name, t in state.items():
            assert back[name].dtype == t.dtype and torch.equal(back[name], t), name
    tree = params_to_jax(serve.params)
    q = tree["decoder"]["layers_0"]["self_attention_0"]["query"]
    assert q["kernel"].dtype == np.int8 and q["kernel_scale"].dtype == np.float32
    assert q["kernel_scale"].shape == (1, 4, 32)  # (1,) * len(in) + features


TRAIN = ["max_target_length=32", "learning_rate=1e-3", "warmup_steps_fraction=0.2",
         "steps=5", "dataset_type=synthetic", "remat_policy=full"]
ROWS, STEPS = 8, 2


def test_lora_only_training_matches_jax():
    cfg, jcfg = configs(TRAIN + LORA, slots=ROWS)
    weights = numpy_weights(cfg, seed=7)
    batch = {k: np.array(v) for k, v in synthetic.make_batch(cfg, 0, ROWS).items()}

    model = JaxTransformer(cfg=jcfg)
    tx = joptim.get_optimizer(jcfg, joptim.create_learning_rate_schedule(jcfg))
    jstate = jtrain.TrainState.create(apply_fn=model.apply, params=jax_tree(weights), tx=tx)
    step = jax.jit(functools.partial(jtrain.train_step, model, jcfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss = []
    for _ in range(STEPS + 1):  # step 0 has learning rate 0 (warmup)
        jstate, m = step(jstate, jbatch, jax.random.PRNGKey(0))
        jloss.append(float(m["loss"]))

    state = ttrain.setup_train_state(
        cfg, device="cpu", params={k: torch.from_numpy(v) for k, v in weights.items()})
    assert sorted(state.opt_state["mu"]) == sorted(n for n in state.params if "lora_" in n)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss = [float(ttrain.train_step(cfg, state, tbatch)["loss"]) for _ in range(STEPS + 1)]
    np.testing.assert_allclose(tloss, jloss, atol=2e-5, rtol=0)
    assert tloss[2] < tloss[1]

    got = {k: v.detach().numpy() for k, v in state.params.items()}
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for name, w in weights.items():
        if "lora_" not in name:  # hard-frozen: bitwise the weights it started from
            np.testing.assert_array_equal(got[name], w, err_msg=name)
            continue
        diff = np.abs(got[name] - want[name].numpy())
        assert np.abs(got[name] - w).max() > 1e-4, f"{name} did not train"
        assert diff.max() <= 5e-5, (name, diff.max())
        assert (diff > 2e-6).mean() <= 1e-3, (name, int((diff > 2e-6).sum()))


def test_lora_only_keeps_no_moments_for_frozen_weights():
    cfg = configs(LORA)[0]
    tx = toptim.get_optimizer(cfg, toptim.create_learning_rate_schedule(cfg))
    params = {"a.kernel": torch.ones(3), "a.lora_a": torch.ones(2), "a.lora_b": torch.zeros(2)}
    state = tx.init(params)
    assert sorted(state["mu"]) == ["a.lora_a", "a.lora_b"]
    updates, _ = tx.update({k: torch.ones_like(v) for k, v in params.items()}, state, params)
    assert sorted(updates) == ["a.lora_a", "a.lora_b"]
    full = toptim.get_optimizer(dataclasses.replace(cfg, lora_only_training=False),
                                toptim.create_learning_rate_schedule(cfg))
    assert sorted(full.init(params)["mu"]) == sorted(params)


def test_load_lora_adapter_equals_jax_bitwise():
    cfg, jcfg = configs()
    weights = numpy_weights(cfg, seed=4)
    rng = np.random.default_rng(5)
    adapter = {}
    for module, shape in (("decoder.layers_0.self_attention_0.query", (128, 128)),
                          ("decoder.layers_1.self_attention_0.value", (128, 64))):
        adapter[f"{module}.lora_a"] = rng.normal(size=(shape[0], 4)).astype(np.float32) / 4
        adapter[f"{module}.lora_b"] = rng.normal(size=(4, shape[1])).astype(np.float32) / 8
    jeng = JaxEngine(dataclasses.replace(jcfg, scan_layers=False), params=jax_tree(weights))
    want = params_from_jax(jax.tree.map(np.asarray, jeng.load_lora_adapter(
        jax.tree.map(jnp.asarray, params_to_jax({k: torch.from_numpy(v)
                                                 for k, v in adapter.items()})))))
    eng = Engine(cfg, device="cpu")
    eng.set_params({k: torch.from_numpy(v) for k, v in weights.items()})
    got = eng.load_lora_adapter({k: torch.from_numpy(v) for k, v in adapter.items()})
    changed = [n for n in got if not np.array_equal(got[n].numpy(), weights[n])]
    assert sorted(changed) == ["decoder.layers_0.self_attention_0.query.kernel",
                               "decoder.layers_1.self_attention_0.value.kernel"]
    for name in got:
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(), err_msg=name)
    # a JAX adapter tree, flattened by the bridge, merges the same
    eng2 = Engine(cfg, device="cpu")
    eng2.set_params({k: torch.from_numpy(v) for k, v in weights.items()})
    nested = params_to_jax({k: torch.from_numpy(v) for k, v in adapter.items()})
    for name, t in eng2.load_lora_adapter(tree_to_state_dict(nested)).items():
        assert torch.equal(t, got[name]), name


def test_merged_adapter_serves_as_the_unmerged_one():
    """A ``lora_rank`` engine serving an adapter unmerged, and the base engine
    with it merged: the same greedy streams (float32 model)."""
    cfg, _ = configs(LORA)
    weights = numpy_weights(cfg, seed=6)
    unmerged = Engine(cfg, device="cpu")
    unmerged.set_params({k: torch.from_numpy(v) for k, v in weights.items()})
    merged = Engine(configs()[0], device="cpu")
    merged.set_params({k: torch.from_numpy(v) for k, v in weights.items() if "lora_" not in k})
    # the JAX forward scales the adapter's product by alpha / r; the merge folds it in
    merged.load_lora_adapter({k: torch.from_numpy(v) for k, v in weights.items()
                              if "lora_" in k}, alpha=16.0)
    base = Engine(configs()[0], device="cpu")
    base.set_params({k: torch.from_numpy(v) for k, v in weights.items() if "lora_" not in k})
    streams = [unmerged.generate_stream(prompt(s, 6), 8) for s in (1, 2, 3)]
    assert [merged.generate_stream(prompt(s, 6), 8) for s in (1, 2, 3)] == streams
    assert [base.generate_stream(prompt(s, 6), 8) for s in (1, 2, 3)] != streams
