"""Train-mode logits of the PyTorch package's ``Transformer`` against the
JAX package's, on a tiny audio-LM configuration (``decoder_block=tts``),
with the same weights on both sides, carried across by the parameter bridge
in both layer layouts.

Tolerances: float32 logits atol 1e-4 (two layers of float32 products summed
in another order). bfloat16 activations: atol 0.15 on logits of magnitude
~3, about four bfloat16 steps at that size (2**-6 each): every layer rounds
its products, norms and residual to bfloat16 and the two frameworks round at
different places.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.models import Transformer as JaxTransformer
from maxtext_indextts2_tpu_torch.models import Transformer
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_from_jax, params_to_jax
from torch_port_helpers import configs, jax_tree, numpy_weights


def _inputs(cfg, seed=0, batch=2, seq=24):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)
    positions = np.tile(np.arange(seq, dtype=np.int32), (batch, 1))
    segs = np.ones((batch, seq), np.int32)
    # second row: two packed documents and a padded tail
    positions[1, 10:20] = np.arange(10)
    segs[1, 10:20] = 2
    segs[1, 20:] = 0
    return tokens, positions, segs


def _torch_logits(cfg, state_dict, tokens, positions, segs):
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(state_dict)
    with torch.no_grad():
        return model(torch.from_numpy(tokens), torch.from_numpy(positions),
                     torch.from_numpy(segs)).numpy()


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 0.15)])
@pytest.mark.parametrize("extra", [(), ("logits_via_embedding=true",)], ids=["dense", "tied"])
def test_train_logits_match_jax(extra, dtype, atol):
    cfg, jcfg = configs([f"dtype={dtype}", *extra])
    weights = numpy_weights(cfg, seed=1)
    tokens, positions, segs = _inputs(cfg)
    want = JaxTransformer(cfg=jcfg).apply(
        {"params": jax_tree(weights)}, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(segs))
    got = _torch_logits(cfg, {k: torch.from_numpy(v) for k, v in weights.items()},
                        tokens, positions, segs)
    assert got.dtype == np.float32 and got.shape == want.shape
    valid = segs > 0  # padded positions attend to nothing on either side
    np.testing.assert_allclose(got[valid], np.asarray(want)[valid], atol=atol)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan_stacked"])
def test_bridge_carries_a_jax_initialised_tree(scan):
    """Weights drawn by the JAX package's own init, in either layer layout,
    give the same logits through ``params_from_jax``."""
    cfg, jcfg = configs([f"scan_layers={'true' if scan else 'false'}"])
    tokens, positions, segs = _inputs(cfg, seed=2)
    jmodel = JaxTransformer(cfg=jcfg)
    jt, jp, js = jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(segs)
    variables = flax.linen.meta.unbox(jax.jit(jmodel.init)(jax.random.PRNGKey(3), jt, jp, js))
    want = np.asarray(jmodel.apply(variables, jt, jp, js))
    tree = jax.tree.map(np.asarray, variables["params"])
    assert ("layers" in tree["decoder"]) == scan
    state = params_from_jax(tree, cfg)
    got = _torch_logits(cfg, state, tokens, positions, segs)
    valid = segs > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan_stacked"])
def test_bridge_round_trip(scan):
    cfg, _ = configs()
    weights = numpy_weights(cfg, seed=4)
    tree = params_to_jax(weights, scan_layers=scan)
    if scan:
        assert tree["decoder"]["layers"]["self_attention_0"]["query"]["kernel"].shape == (
            2, 128, 4, 32)
    back = params_from_jax({"params": tree}, cfg)
    assert set(back) == set(weights)
    for name, w in weights.items():
        np.testing.assert_array_equal(back[name].numpy(), w, err_msg=name)


def test_bridge_rejects_wrong_depth_and_foreign_leaves():
    cfg, _ = configs()
    weights = numpy_weights(cfg, seed=5)
    tree = params_to_jax(weights)
    del tree["decoder"]["layers_1"]
    with pytest.raises(ValueError, match="decoder units"):
        params_from_jax(tree, cfg)
    with pytest.raises(TypeError, match="numpy"):
        params_from_jax({"token_embedder": {"embedding": [1.0, 2.0]}})


def test_prefill_then_decode_logits_match_train_logits():
    """The port's own consistency: teacher-forced train logits equal the
    prefill logits and the step-by-step cached decode logits (float32)."""
    from maxtext_indextts2_tpu_torch.models import MODE_AUTOREGRESSIVE, MODE_PREFILL

    cfg, _ = configs(["decode_attention=ragged"])
    model = Transformer(cfg, device="cpu").init_params(7)
    rng = np.random.default_rng(8)
    n, extra = 9, 4
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, n + extra)).astype(np.int32))
    positions = torch.arange(n + extra, dtype=torch.int32)[None]
    with torch.no_grad():
        full = model(tokens, positions, torch.ones_like(tokens))
        cache = model.init_cache(1, cfg.max_target_length, "cpu")
        pre = model(tokens[:, :n], positions[:, :n], torch.ones_like(tokens[:, :n]),
                    mode=MODE_PREFILL, cache=cache)
        np.testing.assert_allclose(pre.numpy(), full[:, :n].numpy(), atol=1e-4)
        for i in range(n, n + extra):
            step = model(tokens[:, i:i + 1], positions[:, i:i + 1],
                         torch.ones_like(tokens[:, i:i + 1]), mode=MODE_AUTOREGRESSIVE,
                         cache=cache)
            np.testing.assert_allclose(step[:, 0].numpy(), full[:, i].numpy(), atol=1e-4)
