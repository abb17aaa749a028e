"""A tiny model of the flagship's structure in both packages: ``tts-flagship``.

The flagship (``configs/models/tts-flagship.yml``) is a ``tts`` decoder with
head dim 256, 16 query / 8 kv heads (group 2), a 264,192-row vocabulary tied
to the embedding with the 1/sqrt(E) normaliser, and the vocabulary-fused
chunked cross-entropy (``fused_vocab_ce_chunk: 512``). The tiny model keeps
all of that but the widths: E 128, 2 layers, 4 query / 2 kv heads of 256,
vocab 512, S 32, 8 rows (the JAX harness's eight CPU devices), a chunk of
48 rows (256 rows: not a multiple), float32, ``attention=flash`` (the JAX
kernels in interpret mode, the port's plain versions). Both packages get the
same numpy weights and batch.

Held: the JAX ``train.loss_fn`` loss and every parameter's gradient
(gradients reach the tied embedding through the lookup and the unembedding)
against the port's, for the chunked, streaming and int8 routes of the fused
CE; one ``train_step``'s metrics and parameters; the port's fused route
against its own materialised CE; the port's ``tts-flagship.yml`` loading to
the JAX package's ``Config``; the pipeline's default audio-token mapping at
vocab 264,192 against the JAX package's.

Tolerances (float32 on both sides, other summation orders): loss 2e-5
absolute; a gradient within 1e-4 of its leaf's largest entry plus 1e-5
relative. The int8 route rounds its logits to bfloat16 (``logits_dtype``),
and XLA's default ``xla_allow_excess_precision`` drops that rounding inside
the JAX function, so its loss is held to 2e-4 and its gradients to 2**-6 of
each leaf's largest entry (with ``--xla_allow_excess_precision=false``:
5e-7 and 7e-5). The train step as ``tests/test_torch_train.py`` holds it.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import configs, jax_tree, numpy_weights

from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.models import Transformer as JaxTransformer
from maxtext_indextts2_tpu.train import optimizers as joptim
from maxtext_indextts2_tpu.train import train as jtrain
from maxtext_indextts2_tpu.train.data.audio_iterator import _default_mapping
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.train import train as ttrain
from maxtext_indextts2_tpu_torch.train.data import synthetic
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_to_jax
from maxtext_indextts2_tpu_torch.vocab.mapping import default_mapping

torch.set_num_threads(1)

ROWS = 8
FLAGSHIP_TINY = [
    "base_emb_dim=128", "base_mlp_dim=256", "base_num_decoder_layers=2",
    "base_num_query_heads=4", "base_num_kv_heads=2", "head_dim=256", "vocab_size=512",
    "logits_via_embedding=true", "normalize_embedding_logits=true",
    "fused_vocab_ce_chunk=48", "max_target_length=32", "attention=flash",
    "remat_policy=full", "learning_rate=1e-3", "warmup_steps_fraction=0.0", "steps=3",
    "dataset_type=synthetic",
]
ROUTES = {"chunked": [], "streaming": ["fused_vocab_ce_chunk=0", "fused_vocab_ce_tile=256"],
          "int8": ["fused_ce_int8=true"]}


def _pair(extra=()):
    cfg, jcfg = configs(FLAGSHIP_TINY + list(extra), slots=ROWS)
    return cfg, dataclasses.replace(jcfg, flash_block_sizes=(16, 16))


def _batch(cfg):
    batch = {k: np.array(v) for k, v in synthetic.make_batch(cfg, 0, ROWS).items()}
    batch["targets_segmentation"][1::2, 24:] = 0  # some rows end in padding
    return batch


def _jax_loss_and_grads(jcfg, weights, batch):
    model = JaxTransformer(cfg=jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(params):
        return jtrain.loss_fn(model, jcfg, params, jbatch, jax.random.PRNGKey(0))[0]

    value, grads = jax.value_and_grad(loss)(jax_tree(weights))
    return float(value), jax.tree.map(np.asarray, grads)


def _torch_loss_and_grads(cfg, weights, batch, is_train=True):
    state = ttrain.setup_train_state(
        cfg, device="cpu", params={k: torch.from_numpy(v) for k, v in weights.items()})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = ttrain.loss_fn(state.model, cfg, tbatch, is_train=is_train)
    grads = torch.autograd.grad(loss, list(state.params.values()))
    return float(loss.detach()), params_to_jax(dict(zip(state.params, grads)))


def _leaves(tree):
    return {"/".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_grads_close(got, want, rel=1e-4):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=rel * np.abs(w).max(),
                                   err_msg=name)


def test_flagship_yml_loads_to_the_jax_config():
    got = dataclasses.asdict(load_config(["model_name=tts-flagship"]))
    want = dataclasses.asdict(jax_load_config(["model_name=tts-flagship"]))
    for key in ("decoder_block", "emb_dim", "num_query_heads", "num_kv_heads", "mlp_dim",
                "num_decoder_layers", "head_dim", "vocab_size", "logits_via_embedding",
                "normalize_embedding_logits", "fused_vocab_ce_chunk", "audio_codebook_size",
                "max_target_length", "s2a_num_quantizers", "s2a_hidden_size",
                "s2a_num_layers", "s2a_num_heads", "dtype", "weight_dtype"):
        assert got[key] == want[key], key
    assert (got["emb_dim"], got["num_decoder_layers"], got["head_dim"], got["vocab_size"]) == (
        3840, 48, 256, 264192)


@pytest.mark.parametrize("route", list(ROUTES))
def test_flagship_loss_fn_matches_jax(route):
    cfg, jcfg = _pair(ROUTES[route])
    assert cfg.head_dim == 256 and cfg.num_query_heads // cfg.num_kv_heads == 2
    weights = numpy_weights(cfg, seed=11)
    assert "logits_dense.kernel" not in weights  # tied
    batch = _batch(cfg)
    jloss, jgrads = _jax_loss_and_grads(jcfg, weights, batch)
    tloss, tgrads = _torch_loss_and_grads(cfg, weights, batch)
    loss_tol, grad_rel = (2e-4, 2.0 ** -6) if route == "int8" else (2e-5, 1e-4)
    np.testing.assert_allclose(tloss, jloss, atol=loss_tol, rtol=0)
    _assert_grads_close(tgrads, jgrads, grad_rel)


def test_flagship_fused_ce_equals_the_materialised_one():
    """The port's fused route against its own unfused CE (the eval route) on
    the same model and batch: the same function."""
    cfg, _ = _pair()
    weights = numpy_weights(cfg, seed=12)
    batch = _batch(cfg)
    fused, gf = _torch_loss_and_grads(cfg, weights, batch)
    plain, gp = _torch_loss_and_grads(
        dataclasses.replace(cfg, fused_vocab_ce_chunk=0), weights, batch)
    np.testing.assert_allclose(fused, plain, atol=2e-6, rtol=0)
    _assert_grads_close(gf, gp)


def test_flagship_eval_keeps_the_materialised_cross_entropy(monkeypatch):
    cfg, _ = _pair()
    from maxtext_indextts2_tpu_torch.ops import losses

    def refuse(*a, **k):
        raise AssertionError("eval took the fused route")

    monkeypatch.setattr(losses, "chunked_unembed_cross_entropy", refuse)
    state = ttrain.setup_train_state(cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    m = ttrain.eval_step(cfg, state, batch)
    assert np.isfinite(float(m["eval_loss"]))
    with pytest.raises(AssertionError, match="fused route"):
        ttrain.loss_fn(state.model, cfg, batch)


def test_flagship_train_step_matches_jax():
    cfg, jcfg = _pair()
    weights = numpy_weights(cfg, seed=13)
    batch = _batch(cfg)
    model = JaxTransformer(cfg=jcfg)
    tx = joptim.get_optimizer(jcfg, joptim.create_learning_rate_schedule(jcfg))
    jstate = jtrain.TrainState.create(apply_fn=model.apply, params=jax_tree(weights), tx=tx)
    step = jax.jit(functools.partial(jtrain.train_step, model, jcfg))
    jstate, jm = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(0))
    state = ttrain.setup_train_state(
        cfg, device="cpu", params={k: torch.from_numpy(v) for k, v in weights.items()})
    tm = ttrain.train_step(cfg, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=2e-5, rtol=0)
    for key in ("grad_norm", "param_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    got = _leaves(params_to_jax({k: v.detach() for k, v in state.params.items()}))
    for name, want in _leaves(jstate.params).items():
        # one Adam update of up to 1e-3 (see tests/test_torch_train.py)
        assert np.abs(got[name] - want).max() <= 5e-5, name


def test_pipeline_mapping_at_the_flagship_vocab_equals_the_jax_package():
    cfg = load_config(["model_name=tts-flagship"])
    jcfg = jax_load_config(["model_name=tts-flagship"])
    ours, theirs = default_mapping(cfg), _default_mapping(jcfg)
    assert cfg.vocab_size == 264192
    np.testing.assert_array_equal(ours.embedding_to_audio_array(cfg.vocab_size),
                                  theirs.embedding_to_audio_array(jcfg.vocab_size))
    for attr in ("codebook_size", "audio_start_id", "audio_end_id"):
        if hasattr(theirs, attr):
            assert getattr(ours, attr) == getattr(theirs, attr), attr
