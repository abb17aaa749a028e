"""The PyTorch package's multi-head latent attention (``models/mla.py``)
against the JAX package's ``MLAttention`` on the CPU: a prefill (padded, the
true length from the segment ids), decode steps on the latent cache, and the
speculative verify span (written at each slot's index, which stays), with
``q_lora_rank`` 0 and above and the yarn scale.

One numpy-seeded set of weights goes into both modules. Outputs are float32
within 2e-5 (the same arithmetic in another order, as ``tests/test_engine.py``
holds its logits); the cache rows within 1e-6 and the write indices exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.models.mla import MLAttention as JaxMLAttention
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.models.attention import (
    MODE_AUTOREGRESSIVE,
    MODE_PREFILL,
    MODE_TRAIN,
    MODE_VERIFY,
)
from maxtext_indextts2_tpu_torch.models.mla import LatentCache, MLAttention
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_to_jax

torch.set_num_threads(1)

TOL = 2e-5
TOL_CACHE = 1e-6
BASE = ["decoder_block=deepseek", "base_emb_dim=64", "base_num_query_heads=4",
        "base_num_kv_heads=4", "kv_lora_rank=32", "qk_nope_head_dim=16", "qk_rope_head_dim=8",
        "v_head_dim=16", "max_target_length=24", "dtype=float32"]
VARIANTS = {
    "q_direct": [],
    "q_lora": ["q_lora_rank=24"],
    "q_lora_yarn": ["q_lora_rank=24", "rope_type=yarn", "rope_factor=4"],
}


def _pair(extra, seed=0):
    cfg, jcfg = load_config(BASE + extra), jax_load_config(BASE + extra)
    port = MLAttention(cfg, device="cpu")
    rng = np.random.default_rng(seed)
    weights = {}
    for name, p in port.state_dict().items():
        shape = tuple(p.shape)
        w = (1.0 + 0.1 * rng.normal(size=shape) if name.endswith("scale")
             else rng.normal(size=shape) / np.sqrt(np.prod(shape[:1 if len(shape) < 3 else 1])))
        if name == "out.kernel":
            w = rng.normal(size=shape) / np.sqrt(shape[0] * shape[1])
        weights[name] = w.astype(np.float32)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()}, strict=False)
    params = jax.tree.map(jnp.asarray, params_to_jax(weights))
    return cfg, port, JaxMLAttention(cfg=jcfg), params


def _run_jax(jmla, params, cache, x, pos, seg, mode):
    variables = {"params": params} if cache is None else {"params": params, "cache": cache}
    out, new = jmla.apply(variables, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(seg),
                          mode=mode, mutable=["cache"])
    return np.asarray(out), new["cache"]


def _check_cache(cache: LatentCache, jcache):
    np.testing.assert_allclose(cache.cached_ckv.numpy(), np.asarray(jcache["cached_ckv"]),
                               atol=TOL_CACHE)
    np.testing.assert_allclose(cache.cached_kpe.numpy(), np.asarray(jcache["cached_kpe"]),
                               atol=TOL_CACHE)
    np.testing.assert_array_equal(cache.cache_index.numpy(), np.asarray(jcache["cache_index"]))


def _prefilled(cfg, port, jmla, params, rng, lengths, width=10):
    """A padded prefill of ``len(lengths)`` rows (row b real for lengths[b])."""
    b = len(lengths)
    x = rng.normal(size=(b, width, cfg.emb_dim)).astype(np.float32)
    pos = np.tile(np.arange(width, dtype=np.int32), (b, 1))
    seg = (pos < np.asarray(lengths)[:, None]).astype(np.int32)
    cache = port.init_cache(b)
    with torch.no_grad():
        out = port(torch.from_numpy(x), None, torch.from_numpy(pos), torch.from_numpy(seg),
                   mode=MODE_PREFILL, cache=cache).numpy()
    jout, jcache = _run_jax(jmla, params, None, x, pos, seg, "prefill")
    real = seg.astype(bool)
    np.testing.assert_allclose(out[real], jout[real], atol=TOL)
    _check_cache(cache, jcache)
    return cache, jcache


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_then_decode_steps(variant):
    cfg, port, jmla, params = _pair(VARIANTS[variant])
    rng = np.random.default_rng(1)
    cache, jcache = _prefilled(cfg, port, jmla, params, rng, [7, 4])
    idx = np.array([7, 4], np.int32)
    for _ in range(5):
        x = rng.normal(size=(2, 1, cfg.emb_dim)).astype(np.float32)
        pos = idx[:, None]
        seg = np.ones_like(pos)
        with torch.no_grad():
            out = port(torch.from_numpy(x), None, torch.from_numpy(pos), torch.from_numpy(seg),
                       mode=MODE_AUTOREGRESSIVE, cache=cache).numpy()
        jout, jcache = _run_jax(jmla, params, jcache, x, pos, seg, "autoregressive")
        np.testing.assert_allclose(out, jout, atol=TOL)
        _check_cache(cache, jcache)
        idx = idx + 1


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_verify_span_writes_without_advancing(variant):
    cfg, port, jmla, params = _pair(VARIANTS[variant], seed=2)
    rng = np.random.default_rng(3)
    cache, jcache = _prefilled(cfg, port, jmla, params, rng, [9, 5])
    span = 4
    x = rng.normal(size=(2, span, cfg.emb_dim)).astype(np.float32)
    pos = np.array([[9], [5]], np.int32) + np.arange(span, dtype=np.int32)[None, :]
    seg = np.ones_like(pos)
    with torch.no_grad():
        out = port(torch.from_numpy(x), None, torch.from_numpy(pos), torch.from_numpy(seg),
                   mode=MODE_VERIFY, cache=cache).numpy()
    jout, jcache = _run_jax(jmla, params, jcache, x, pos, seg, "verify")
    np.testing.assert_allclose(out, jout, atol=TOL)
    _check_cache(cache, jcache)
    np.testing.assert_array_equal(cache.cache_index.numpy(), [9, 5])


def test_training_forward():
    cfg, port, jmla, params = _pair(VARIANTS["q_lora"], seed=4)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 12, cfg.emb_dim)).astype(np.float32)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    seg = np.ones_like(pos)
    seg[1, 7:] = 2  # two documents packed in row 1
    with torch.no_grad():
        out = port(torch.from_numpy(x), None, torch.from_numpy(pos), torch.from_numpy(seg),
                   mode=MODE_TRAIN).numpy()
    want = jmla.apply({"params": params}, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(seg))
    np.testing.assert_allclose(out, np.asarray(want), atol=TOL)


def test_latent_cache_protocol():
    """copy_rows / load_rows / insert_rows / clone move the latent rows and
    the index as ``KVCache`` moves its rows."""
    cache = LatentCache(2, 8, 4, 2, torch.float32)
    cache.cached_ckv.copy_(torch.arange(64, dtype=torch.float32).reshape(2, 8, 4))
    cache.cached_kpe.copy_(torch.arange(32, dtype=torch.float32).reshape(2, 8, 2))
    part = cache.copy_rows(2, 3)
    assert part.max_length == 3 and part.cache_index.tolist() == [3]
    assert torch.equal(part.cached_ckv[0], cache.cached_ckv[0, 2:5])
    fresh = LatentCache(1, 8, 4, 2, torch.float32)
    fresh.load_rows(part, 3)
    assert fresh.cache_index.tolist() == [3] and torch.equal(fresh.cached_kpe[0, :3],
                                                             cache.cached_kpe[0, 2:5])
    cache.insert_rows(part, 1, 1, 2)
    assert torch.equal(cache.cached_ckv[1, :2], part.cached_ckv[0, 1:3])
    assert cache.cache_index.tolist() == [0, 2]
    twin = cache.clone()
    assert twin.cached_ckv.data_ptr() != cache.cached_ckv.data_ptr()
    assert all(torch.equal(a, b) for a, b in zip(twin.leaves().values(),
                                                  cache.leaves().values()))
    assert cache.nbytes() == (2 * 8 * 4 + 2 * 8 * 2) * 4 + 2 * 4


def test_paged_cache_is_refused():
    cfg, port, _, _ = _pair([])
    with pytest.raises(ValueError, match="paged_attention=true does not serve"):
        port.init_paged_cache(8, 4)
