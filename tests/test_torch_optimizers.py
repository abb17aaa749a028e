"""The PyTorch package's optimizers and schedule against the JAX package's
(optax). Same numpy parameters and gradients; three updates; the optimizer
state crosses by ``utils/param_bridge`` and is compared too.

Tolerances. The schedule: float32 arithmetic on both sides, the cosine of
numpy against XLA's: 1e-6 relative. float32 leaves: the same operations in
the same order; pow and cos may differ in the last bit: 1e-6 relative, 1e-7
absolute. bfloat16 leaves: both sides round every operation to bfloat16 (the
port multiplies by bfloat16 constants as JAX's weak typing does); where the
float32 results of pow and sqrt straddle a rounding boundary a value moves by
one bfloat16 step: 2**-7 relative (one step of a value in [1, 2) is 2**-7).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.train import optimizers as joptim
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.train import optimizers as toptim
from maxtext_indextts2_tpu_torch.utils.param_bridge import opt_state_from_jax, opt_state_to_jax

torch.set_num_threads(1)

SHAPES = {"decoder.layers_0.mlp_0.wo.kernel": (4, 8), "decoder_norm.scale": (8,),
          "token_embedder.embedding": (3, 5, 2)}


def _configs(extra):
    args = ["learning_rate=1e-2", "steps=10", "adam_b1=0.9", "adam_b2=0.95",
            "adam_weight_decay=0.1", "adam_eps=1e-8"] + list(extra)
    return load_config(args), jax_load_config(args)


@pytest.mark.parametrize("extra", [
    [], ["warmup_steps_fraction=0.0"], ["warmup_steps_fraction=0.5", "steps=7"],
    ["learning_rate_schedule_steps=20", "cosine_learning_rate_final_fraction=0.0"],
], ids=["default", "no_warmup", "half_warmup", "longer_schedule"])
def test_schedule_matches_optax(extra):
    cfg, jcfg = _configs(extra)
    ours, theirs = toptim.create_learning_rate_schedule(cfg), \
        joptim.create_learning_rate_schedule(jcfg)
    got = np.array([ours(i) for i in range(cfg.learning_rate_schedule_steps + 3)])
    want = np.array([float(theirs(jnp.int32(i)))
                     for i in range(cfg.learning_rate_schedule_steps + 3)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0.0  # with warmup the first step does not move the weights


def _nested(flat):
    tree = {}
    for name, v in flat.items():
        node = tree
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt", ["adamw", "adam_pax", "sgd"])
def test_three_updates_match_optax(opt, dtype):
    cfg, jcfg = _configs([f"opt_type={opt}", "warmup_steps_fraction=0.2", "adam_eps_root=1e-6"])
    rng = np.random.default_rng(0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    start = {n: (1.0 + 0.5 * rng.normal(size=s)).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: rng.normal(size=s).astype(np.float32) for n, s in SHAPES.items()}
             for _ in range(3)]

    jtx = joptim.get_optimizer(jcfg, joptim.create_learning_rate_schedule(jcfg))
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), _nested(start))
    jstate = jtx.init(jparams)

    ttx = toptim.get_optimizer(cfg, toptim.create_learning_rate_schedule(cfg))
    tparams = {n: torch.tensor(a).to(tdt) for n, a in start.items()}
    tstate = ttx.init(tparams)

    rel = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
    for g in grads:
        jg = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), _nested(g))
        upd, jstate = jtx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tupd, tstate = ttx.update({n: torch.tensor(a).to(tdt) for n, a in g.items()}, tstate,
                                  tparams)
        toptim.apply_updates(tparams, tupd)
        for n, want in _flat(jparams).items():
            assert tparams[n].dtype == tdt, n
            want = np.asarray(want.astype(jnp.float32))
            np.testing.assert_allclose(tparams[n].float().numpy(), want, rtol=rel, atol=1e-7,
                                       err_msg=n)

    # the optimizer state crosses the bridge both ways and agrees
    ours = opt_state_to_jax(tstate)
    theirs = opt_state_from_jax(jax.tree.map(np.asarray, jstate))
    assert int(ours["count"]) == theirs["count"] == 3
    for moment in ("mu", "nu"):
        assert (moment in ours) == (opt != "sgd")
        if moment not in ours:
            continue
        for n, want in theirs[moment].items():
            assert want.dtype == tdt, n
            np.testing.assert_allclose(_flat(ours[moment])[n], want.float().numpy(), rtol=rel,
                                       atol=1e-7, err_msg=f"{moment} {n}")


def test_bfloat16_moments_cross_the_bridge_bit_for_bit():
    mu = {"a": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3).astype(ml_dtypes.bfloat16)}}
    state = opt_state_from_jax(optax.ScaleByAdamState(count=np.int32(5), mu=mu, nu=mu))
    assert state["count"] == 5 and state["mu"]["a.kernel"].dtype == torch.bfloat16
    np.testing.assert_array_equal(state["nu"]["a.kernel"].float().numpy(),
                                  mu["a"]["kernel"].astype(np.float32))


def test_unknown_optimizer_and_lora_training_raise():
    cfg, _ = _configs(["opt_type=lion"])
    with pytest.raises(ValueError, match="unknown opt_type"):
        toptim.get_optimizer(cfg, toptim.create_learning_rate_schedule(cfg))
    cfg, _ = _configs(["lora_rank=4"])
    with pytest.raises(NotImplementedError, match="port queue: 5"):
        toptim.get_optimizer(cfg, toptim.create_learning_rate_schedule(cfg))
