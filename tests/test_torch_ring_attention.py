"""Context-parallel flash attention of the port on four gloo ranks against
the JAX package's ``flash_attention_sharded`` on its 8-device CPU mesh
(context 4 x fsdp 2; Pallas in interpret mode).

One spawn of four ranks runs every case (the all-gather, ring and Ulysses
algorithms; load-balanced order; packed documents with padding; a sliding
window; GQA with 2 kv heads where the algorithm takes it: Ulysses needs kv
heads divisible by cp). The ranks' outputs and q / k / v gradients, put back
together along the sequence, must equal the JAX package's within 2e-5
(float32; the frameworks sum in other orders). The upstream gradient is a
fixed random tensor, the same on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_helpers import run_ranks

from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.ops import flash_attention as jfa
from maxtext_indextts2_tpu.parallel import create_device_mesh as jax_mesh
from maxtext_indextts2_tpu_torch.ops.flash_attention import load_balanced_reorder

CP = 4
TOL = 2e-5
CASES = [  # (name, algorithm, kv heads, packed, sliding window)
    ("allgather_gqa_packed", "allgather", 2, True, 0),
    ("allgather_sliding", "allgather", 4, False, 40),
    ("ring_gqa_packed", "ring", 2, True, 0),
    ("ring_gqa_sliding", "ring", 2, False, 40),
    ("ring_packed_sliding", "ring", 4, True, 24),
    ("ulysses_packed", "ulysses", 4, True, 0),
    ("ulysses_sliding", "ulysses", 4, False, 40),
]


def _inputs(nkv, packed, b=2, s=128, n=4, d=32, seed=0):
    rng = np.random.default_rng(seed)
    x = {"q": rng.normal(size=(b, s, n, d)), "k": rng.normal(size=(b, s, nkv, d)),
         "v": rng.normal(size=(b, s, nkv, d)), "do": rng.normal(size=(b, s, n, d))}
    x = {k: v.astype(np.float32) for k, v in x.items()}
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    seg = np.ones((b, s), np.int32)
    if packed:  # two documents and a padded tail
        seg[:, s // 2:] = 2
        seg[:, s - 16:] = 0
        pos[:, s // 2:] -= s // 2
    x.update(pos=pos, seg=seg)
    # the load-balanced order of the batch, as the train loops reorder it
    return {k: load_balanced_reorder(torch.from_numpy(v), CP).numpy() for k, v in x.items()}


def _jax(algorithm, x, window):
    cfg = jax_load_config(["ici_context_parallelism=4", "ici_fsdp_parallelism=2"])
    mesh = jax_mesh(cfg)

    def run(q, k, v):
        with mesh:
            return jfa.flash_attention_sharded(
                q, k, v, jnp.asarray(x["seg"]), mesh=mesh, positions=jnp.asarray(x["pos"]),
                sliding_window=window, block_q=16, block_kv=16, algorithm=algorithm)

    qkv = [jnp.asarray(x[n]) for n in ("q", "k", "v")]
    o, vjp = jax.vjp(jax.jit(run), *qkv)
    return [np.asarray(t) for t in (o, *vjp(jnp.asarray(x["do"])))]


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    cases = [(alg, _inputs(nkv, packed), {"sliding_window": w})
             for _, alg, nkv, packed, w in CASES]
    ranks = run_ranks(tmp_path_factory.mktemp("ring"), CP, "attention",
                      ["ici_context_parallelism=4"], cases)
    return {name: [r[i] for r in ranks] for i, (name, *_) in enumerate(CASES)}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_context_parallel_attention_matches_jax(case, port_results):
    name, algorithm, nkv, packed, window = case
    x = _inputs(nkv, packed)
    want = _jax(algorithm, x, window)
    ranks = port_results[name]
    for key, w in zip(("o", "dq", "dk", "dv"), want):
        got = torch.cat([r[key] for r in ranks], dim=1).numpy()
        np.testing.assert_allclose(got, w, atol=TOL, rtol=0, err_msg=f"{name} {key}")
    calls = ranks[0]["calls"]
    if algorithm == "ring":  # cp - 1 hops of K/V forward; backward K/V and dK/dV hops
        assert calls == {"exchange": (CP - 1) + (CP - 1) + CP}, calls
    elif algorithm == "allgather":  # K, V, positions, segment ids; dK, dV back
        assert calls == {"all_gather": 4, "reduce_scatter": 2}, calls
    else:  # q, k, v there and o back, twice over for the gradients
        assert calls == {"all_to_all": 8, "all_gather": 2}, calls


def test_ulysses_refuses_heads_that_do_not_split():
    from maxtext_indextts2_tpu_torch.ops.flash_attention import flash_attention_sharded

    class Mesh:  # four context ranks: the check comes before any collective
        shape = {"context": 4}

        def group(self, axes):
            return None

    q = torch.zeros((1, 8, 4, 32))
    kv = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="divisible by context parallelism"):
        flash_attention_sharded(q, kv, kv, None, mesh=Mesh(), algorithm="ulysses")
