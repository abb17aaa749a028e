"""The port's pipeline (``models/pipeline.py``) on gloo ranks against the JAX
package's ``Pipeline`` on its 8-device CPU mesh (stage x fsdp).

The JAX test of the pipeline (``tests/test_pipeline.py``) builds a scanned
model and remaps its weights into the pipeline's stage-major unit axis; here
both packages get those weights (the port's by ``utils/param_bridge``, which
carries the pipeline tree to the unpipelined layer names), run the same
tokens, and the logits and the gradients of mean(logits**2) must agree
within 1e-5 (float32) at (S, R, M) = (4, 1, 4) and (2, 2, 4) (circular
storage), and with ``pipeline_delay_activation_forwarding`` at (4, 1, 8).
Each stage rank holds its own units only (layer r*S + s on stage s).
"""

import os

import flax
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_helpers import run_ranks

from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.models import Transformer as JaxTransformer
from maxtext_indextts2_tpu.parallel import create_device_mesh as jax_mesh
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_from_jax

BASE = ["base_emb_dim=64", "base_mlp_dim=128", "base_num_query_heads=2", "base_num_kv_heads=2",
        "head_dim=32", "vocab_size=256", "max_target_length=32", "per_device_batch_size=1",
        "dtype=float32", "attention=dot_product"]
TOL = 1e-5
B, L = 8, 32
SETTINGS = {  # name: (S, R, M, delayed forwarding)
    "s4_r1_m4": (4, 1, 4, False),
    "s4_r1_m8_delayed": (4, 1, 8, True),
    "s2_r2_m4_circular": (2, 2, 4, False),
}


def _args(s, r, m, delay):
    return BASE + [f"base_num_decoder_layers={s * r}", f"ici_stage_parallelism={s}",
                   f"num_pipeline_microbatches={m}", f"num_pipeline_repeats={r}",
                   f"pipeline_delay_activation_forwarding={str(delay).lower()}"]


def _remap(p_scan, p_pipe_shape, stages, repeats):
    """The JAX pipeline test's remap: scan layer r*S+s -> pipeline unit s*R+r."""
    fs_scan = flax.traverse_util.flatten_dict(nn.meta.unbox(p_scan)["params"])
    fs_pipe = flax.traverse_util.flatten_dict(nn.meta.unbox(p_pipe_shape)["params"])
    perm = np.zeros(stages * repeats, np.int32)
    for r in range(repeats):
        for s in range(stages):
            perm[s * repeats + r] = r * stages + s
    out = {}
    for k in fs_pipe:
        if k[:3] == ("decoder", "layers", "layers"):
            out[k] = fs_scan[("decoder", "layers") + k[3:]][perm]
        else:
            out[k] = fs_scan[k]
    return {"params": flax.traverse_util.unflatten_dict(out)}


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_run(name):
    s, r, m, delay = SETTINGS[name]
    cfg_scan = jax_load_config(BASE + [f"base_num_decoder_layers={s * r}", "scan_layers=true"])
    cfg_pipe = jax_load_config(_args(s, r, m, delay) + [f"ici_fsdp_parallelism={8 // s}"])
    mesh = jax_mesh(cfg_pipe)
    m_scan, m_pipe = JaxTransformer(cfg=cfg_scan), JaxTransformer(cfg=cfg_pipe, mesh=mesh)
    key = jax.random.PRNGKey(0)
    tokens = jax.random.randint(key, (B, L), 0, cfg_scan.vocab_size)
    positions = jnp.broadcast_to(jnp.arange(L), (B, L))
    segs = jnp.ones((B, L), jnp.int32)
    p_scan = m_scan.init(key, tokens, positions, segs)
    p_pipe = _remap(p_scan, jax.eval_shape(m_pipe.init, key, tokens, positions, segs), s, r)

    def loss(p):
        return jnp.mean(jnp.square(m_pipe.apply(p, tokens, positions, segs)))

    with mesh:
        logits = m_pipe.apply(p_pipe, tokens, positions, segs)
        grads = jax.grad(loss)(p_pipe)
    return _numpy(nn.meta.unbox(p_scan)), _numpy(p_pipe), np.asarray(tokens), \
        np.asarray(logits), _numpy(grads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_runs = {name: _jax_run(name) for name in SETTINGS}

    def case(name):
        s, r, m, delay = SETTINGS[name]
        p_scan, _, tokens, _, _ = jax_runs[name]
        weights = {k: v.numpy() for k, v in params_from_jax(p_scan).items()}
        return (_args(s, r, m, delay) + ["per_device_batch_size=2"], weights, tokens)

    four = run_ranks(tmp_path_factory.mktemp("pipe4"), 4, "pipeline",
                     [case("s4_r1_m4"), case("s4_r1_m8_delayed")])
    two = run_ranks(tmp_path_factory.mktemp("pipe2"), 2, "pipeline", [case("s2_r2_m4_circular")])
    port = {"s4_r1_m4": [r[0] for r in four], "s4_r1_m8_delayed": [r[1] for r in four],
            "s2_r2_m4_circular": [r[0] for r in two]}
    return jax_runs, port


def _port_cfg(monkeypatch, name):
    monkeypatch.setenv("WORLD_SIZE", str(SETTINGS[name][0]))
    return load_config(_args(*SETTINGS[name]))


@pytest.mark.parametrize("name", list(SETTINGS))
def test_pipeline_output_and_gradients_match_jax(name, runs, monkeypatch):
    jax_runs, port = runs
    _, _, _, logits, grads = jax_runs[name]
    ranks = port[name]
    for rank in ranks:  # every stage rank ends with the last stage's output
        np.testing.assert_allclose(rank["logits"].numpy(), logits, atol=TOL, rtol=0)
    want = params_from_jax(grads, _port_cfg(monkeypatch, name))
    got = ranks[0]["grads"]
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), atol=TOL, rtol=0, err_msg=n)
    s, r = SETTINGS[name][:2]
    for stage, rank in enumerate(ranks):  # stage s holds layers r*S + s
        assert rank["units"] == [f"layers_{i * s + stage}" for i in range(r)]


def test_bridge_carries_the_pipeline_tree(runs, monkeypatch):
    jax_runs, _ = runs
    p_scan, p_pipe, *_ = jax_runs["s2_r2_m4_circular"]
    got = params_from_jax(p_pipe, _port_cfg(monkeypatch, "s2_r2_m4_circular"))
    want = params_from_jax(p_scan)
    assert set(got) == set(want)
    for n in want:
        assert torch.equal(got[n], want[n]), n
    with pytest.raises(ValueError, match="stages"):
        params_from_jax(p_pipe)
