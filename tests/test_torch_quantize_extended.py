"""The extended quantizers of the PyTorch package (``audio/quantize_extended.py``:
k-means, the EMA Euclidean codebook, the simple codebook, ``VectorQuantize``,
lookup-free quantization) against the JAX package's, on the CPU.

The draws are inputs: the rows that seed k-means and replace expired codes
are the JAX package's own (``jax.random.permutation(key, N)[:K]``, or
``randint`` when N < K, from the keys its modules split), handed to the port
as index tensors; the initial EMA codebook (the JAX package's
``normal(PRNGKey(0), (K, D))``) crosses with the bridge.

Tolerances (float32 on both sides; the two frameworks sum products in other
orders): indices and bin counts equal; sampled rows exactly equal; k-means
means, EMA state and outputs 1e-5 relative to the leaf's largest entry;
losses 1e-5 relative; gradients through the straight-through estimator 1e-4 of
each one's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.audio import quantize_extended as jqe
from maxtext_indextts2_tpu_torch.audio import quantize_extended as tqe
from maxtext_indextts2_tpu_torch.utils.param_bridge import variables_from_jax, variables_to_jax

torch.set_num_threads(1)
RTOL = 1e-5
GRAD_TOL = 1e-4


def _close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _jax_sample_idx(key, n, num):
    """The rows ``jqe.sample_vectors(key, samples, num)`` takes."""
    if n >= num:
        return np.asarray(jax.random.permutation(key, n)[:num])
    return np.asarray(jax.random.randint(key, (num,), 0, n))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_sq_dist_neg_matches_jax():
    rng = np.random.default_rng(0)
    flat, embed = rng.normal(size=(40, 8)).astype(np.float32), rng.normal(size=(16, 8)).astype(
        np.float32)
    _close(tqe._sq_dist_neg(_t(flat), _t(embed)), jqe._sq_dist_neg(flat, embed))


@pytest.mark.parametrize("n,num", [(50, 16), (10, 16)], ids=["permutation", "with_replacement"])
def test_sample_vectors_takes_the_given_rows(n, num):
    samples = np.random.default_rng(1).normal(size=(n, 4)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    idx = _jax_sample_idx(key, n, num)
    want = np.asarray(jqe.sample_vectors(key, jnp.asarray(samples), num))
    np.testing.assert_array_equal(tqe.sample_vectors(_t(samples), _t(idx)).numpy(), want)
    # drawn from a generator: the same kind of draw, in range, distinct when n >= num
    drawn = tqe.draw_sample_indices(n, num, torch.Generator().manual_seed(0))
    assert drawn.shape == (num,) and int(drawn.max()) < n
    if n >= num:
        assert len(set(drawn.tolist())) == num


@pytest.mark.parametrize("n,cosine", [(120, False), (120, True), (12, False)],
                         ids=["euclidean", "cosine", "fewer_rows_than_clusters"])
def test_kmeans_matches_jax(n, cosine):
    samples = np.random.default_rng(2).normal(size=(n, 6)).astype(np.float32)
    if cosine:
        samples /= np.linalg.norm(samples, axis=-1, keepdims=True)
    key = jax.random.PRNGKey(7)
    want_means, want_bins = jqe.kmeans(key, jnp.asarray(samples), 16, 5, use_cosine_sim=cosine)
    means, bins = tqe.kmeans(_t(samples), _t(_jax_sample_idx(key, n, 16)), 5,
                             use_cosine_sim=cosine)
    _close(means, want_means, what="means")
    np.testing.assert_array_equal(bins.numpy(), np.asarray(want_bins))
    if n < 16:  # empty clusters kept their (sampled) mean
        assert int((bins == 0).sum()) > 0


def _vq_pair(codebook_type, kmeans_init=False, input_dim=12, dim=4, size=16, **kw):
    jvq = jqe.VectorQuantize(input_dim=input_dim, codebook_size=size, codebook_dim=dim,
                             codebook_type=codebook_type, kmeans_init=kmeans_init, **kw)
    x = np.random.default_rng(4).normal(size=(3, 10, input_dim)).astype(np.float32)
    variables = jax.tree.map(np.asarray, jvq.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    tvq = tqe.VectorQuantize(input_dim, size, dim, codebook_type=codebook_type,
                             kmeans_init=kmeans_init, device="cpu", **kw)
    tvq.load_state_dict(variables_from_jax(variables), strict=True)
    return jvq, tvq, variables


def _jax_step(jvq, variables, x, key):
    """One JAX training call; returns (result, new variables, the draws the
    port takes: the k-means seed rows and the expiry rows)."""
    res, mut = jvq.apply(variables, jnp.asarray(x), train=True, rng=key, mutable=["codebook"])
    r_init, r_expire = jax.random.split(key)
    n = x.shape[0] * x.shape[1]
    size = variables["codebook"]["codebook"]["embed"].shape[0]
    draws = dict(init_idx=_t(_jax_sample_idx(r_init, n, size)),
                 expire_idx=_t(_jax_sample_idx(r_expire, n, size)))
    return res, {**variables, **jax.tree.map(np.asarray, dict(mut))}, draws


def _assert_state(tvq, variables, what):
    state = variables["codebook"]["codebook"]
    buffers = dict(tvq.codebook.named_buffers())
    assert bool(buffers["initted"]) == bool(state["initted"]), what
    assert int(buffers["step"]) == int(state["step"]), what
    for name in ("cluster_size", "embed", "embed_avg"):
        _close(buffers[name], state[name], what=f"{what}: {name}")


@pytest.mark.parametrize("kmeans_init", [True, False], ids=["kmeans_init", "random_init"])
def test_euclidean_codebook_state_follows_jax_through_init_ema_and_expiry(kmeans_init):
    """Three training calls (k-means init on the first when asked, the EMA
    update, dead-code expiry at threshold 2), then an eval call: every state
    leaf, the indices, outputs and losses."""
    jvq, tvq, variables = _vq_pair("euclidean", kmeans_init=kmeans_init,
                                   threshold_ema_dead_code=2.0)
    rng = np.random.default_rng(5)
    expired = 0
    for call in range(3):
        x = rng.normal(size=(3, 10, 12)).astype(np.float32)
        want, variables, draws = _jax_step(jvq, variables, x, jax.random.PRNGKey(10 + call))
        got = tvq(_t(x), train=True, **draws)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
        _close(got.quantized.detach(), want.quantized, what=f"call {call} output")
        _close(got.commit_loss.detach(), want.commit_loss, what="commit")
        _close(got.codebook_loss.detach(), want.codebook_loss, what="codebook loss")
        _assert_state(tvq, variables, f"call {call}")
        expired += int((variables["codebook"]["codebook"]["cluster_size"] < 2.0).sum())
    assert expired > 0  # the expiry branch ran
    x = rng.normal(size=(3, 10, 12)).astype(np.float32)
    want = jvq.apply(variables, jnp.asarray(x))
    got = tvq(_t(x))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    _assert_state(tvq, variables, "eval call")  # an eval call changes nothing


def test_euclidean_codebook_default_draws_are_seeded_by_the_step():
    """Without draws the port seeds a CPU generator with the codebook's step:
    two codebooks with one state take the same steps; the step counts."""
    _, a, _ = _vq_pair("euclidean", kmeans_init=True)
    _, b, _ = _vq_pair("euclidean", kmeans_init=True)
    x = _t(np.random.default_rng(6).normal(size=(3, 10, 12)).astype(np.float32))
    for _ in range(2):
        ra, rb = a(x, train=True), b(x, train=True)
        assert torch.equal(ra.indices, rb.indices)
    for name, buf in a.codebook.named_buffers():
        assert torch.equal(buf, dict(b.codebook.named_buffers())[name]), name
    assert int(a.codebook.step) == 2 and bool(a.codebook.initted)


@pytest.mark.parametrize("l2", [False, True], ids=["euclidean_search", "l2_search"])
def test_simple_codebook_vector_quantize_and_gradients_match_jax(l2):
    jvq, tvq, variables = _vq_pair("simple", use_l2_normalize=l2)
    x = np.random.default_rng(7).normal(size=(3, 10, 12)).astype(np.float32)

    def jloss(params, xx):
        r = jvq.apply({"params": params}, xx)
        return jnp.sum(r.quantized * jnp.cos(xx)) + r.commit_loss + r.codebook_loss, r

    (_, want), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    got = tvq(tx)
    loss = torch.sum(got.quantized * torch.cos(tx)) + got.commit_loss + got.codebook_loss
    grads = torch.autograd.grad(loss, [tx, *tvq.parameters()])
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    _close(got.quantized.detach(), want.quantized, what="output")
    _close(got.codebook_loss.detach(), want.codebook_loss, what="codebook loss")
    want_grads = variables_from_jax({"params": jax.tree.map(np.asarray, jg)})
    _close(grads[0], jgx, GRAD_TOL, "grad x")
    for (name, _), g in zip(tvq.named_parameters(), grads[1:]):
        _close(g, want_grads[name], GRAD_TOL, f"grad {name}")
    ids = _t(np.random.default_rng(8).integers(0, 16, size=(2, 5)))
    _close(tvq.vq2emb(ids).detach(), jvq.apply(variables, jnp.asarray(ids.numpy()),
                                              method=jvq.vq2emb), what="vq2emb")


@pytest.mark.parametrize("input_dim", [12, 4], ids=["projected", "unprojected"])
def test_lookup_free_quantize_codes_and_vq2emb_match_jax(input_dim):
    jq = jqe.LookupFreeQuantize(input_dim=input_dim, codebook_size=16, codebook_dim=4)
    x = np.random.default_rng(9).normal(size=(2, 7, input_dim)).astype(np.float32) * 3
    params = jax.tree.map(np.asarray, jq.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    tq = tqe.LookupFreeQuantize(input_dim, 16, 4, device="cpu")
    tq.load_state_dict(variables_from_jax(params), strict=True)
    want = jq.apply(params, jnp.asarray(x))
    got = tq(_t(x))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    _close(got.quantized.detach(), want.quantized, what="output")
    assert float(got.commit_loss) == 0.0 and float(got.codebook_loss) == 0.0
    ids = np.arange(16).reshape(2, 8)
    for out_proj in (True, False):
        _close(tq.vq2emb(_t(ids), out_proj).detach(),
               jq.apply(params, jnp.asarray(ids), out_proj, method=jq.vq2emb), what="vq2emb")
    with pytest.raises(ValueError):
        tqe.LookupFreeQuantize(4, 15, 4)


@pytest.mark.parametrize("codebook_type", ["euclidean", "simple"])
def test_vector_quantize_variables_cross_both_ways_bitwise(codebook_type):
    """params and the "codebook" collection in, state dict out and back:
    every leaf bitwise, dtypes kept (``initted`` bool, ``step`` int32)."""
    jvq, tvq, variables = _vq_pair(codebook_type, kmeans_init=True)
    if codebook_type == "euclidean":  # a trained state, not the init's
        x = np.random.default_rng(11).normal(size=(3, 10, 12)).astype(np.float32)
        _, variables, draws = _jax_step(jvq, variables, x, jax.random.PRNGKey(12))
        tvq.load_state_dict(variables_from_jax(variables), strict=True)
    back = variables_to_jax(tvq)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(variables),
                                 jax.tree.leaves(back)):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=str(path))
