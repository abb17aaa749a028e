"""Chunked prefill (``Engine.prefill_chunked``, the ``cache_offset`` write and
the chunk's attention over everything cached so far) and the prefix cache
(``infer/prefix_cache.PrefixCache``, ``Engine.prefill_cached``) of the
PyTorch package against the JAX package on the CPU, float32.

Tolerances: last logits 2e-4 (the JAX package's own bar for chunked against
full prefill: the chunk's attention sums over more masked rows, in another
order), 2e-3 with an int8 cache (a K/V value on a rounding boundary may take
the neighbouring code in one package: one code step, |x|max/127, moves the
logits by ~4e-4); cache rows 1e-5 (the same float32 projections); int8
cache rows one code step of their scale. Greedy token streams, segment ids, write indices and the prefix
cache's counters are compared exactly.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.infer.prefix_cache import PrefixCache as JaxPrefixCache
from maxtext_indextts2_tpu.models import attention as jax_attn
from maxtext_indextts2_tpu_torch.infer.prefix_cache import PrefixCache
from maxtext_indextts2_tpu_torch.models import attention as attn
from maxtext_indextts2_tpu_torch.utils.param_bridge import tree_to_state_dict
from torch_port_helpers import engine_pair, prompt

TOL_LOGITS = 2e-4
TOL_ROWS = 1e-5

VARIANTS = {
    "tts": [],
    "mistral_window8": ["decoder_block=mistral", "sliding_window_size=8"],
    "int8_kv": ["quantize_kvcache=true"],
}


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    return request.param, engine_pair(VARIANTS[request.param], slots=2)


def tol_logits(name):
    return 2e-3 if name == "int8_kv" else TOL_LOGITS


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _jax_leaves(jcache) -> dict:
    """JAX cache tree -> {(unit, sub-layer): {leaf name: numpy}}."""
    out = {}
    for path, leaf in tree_to_state_dict(jax.tree.map(np.asarray, jcache)).items():
        parts = path.split(".")
        unit = next(int(p[len("layers_"):]) for p in parts if p.startswith("layers_"))
        sub = next(int(p[len("self_attention_"):]) for p in parts
                   if p.startswith("self_attention_"))
        out.setdefault((unit, sub), {})[parts[-1]] = leaf.numpy()
    return out


def assert_cache_rows_match(cache, jcache, n):
    """Rows [0, n) of a batch-1 prefix cache against the JAX prefix's."""
    jleaves = _jax_leaves(jcache)
    for u, unit in enumerate(cache):
        for j, c in enumerate(unit):
            want = jleaves[(u, j)]
            np.testing.assert_array_equal(_np(c.cache_index), want["cache_index"])
            np.testing.assert_array_equal(_np(c.cached_segment_ids)[:, :n],
                                          want["cached_segment_ids"][:, :n])
            for name in ("cached_key", "cached_value"):
                got, exp = _np(getattr(c, name))[:, :n], want[name][:, :n]
                if c.quantize:
                    scale_name = "key_scale" if name == "cached_key" else "value_scale"
                    scale = want[scale_name][:, :n, :, None]
                    np.testing.assert_allclose(_np(getattr(c, scale_name))[:, :n],
                                               want[scale_name][:, :n], rtol=1e-5)
                    np.testing.assert_allclose(got * scale, exp * scale,
                                               atol=float(scale.max()) + 1e-6, err_msg=name)
                else:
                    np.testing.assert_allclose(got, exp, atol=TOL_ROWS, err_msg=name)


def _decode(eng, prefix, first, steps, slot=1):
    state = eng.insert(prefix, eng.init_decode_state(), slot)
    out = [int(_np(first)[0])]
    for _ in range(steps):
        state, toks = eng.generate(state)
        out.append(int(_np(toks)[slot]))
    return out


def test_prefill_chunked_matches_jax(pair):
    name, (eng, jeng) = pair
    p = prompt(11, 40)  # past max_prefill_predict_length (16): chunked only
    prefix, first = eng.prefill_chunked(p, len(p), chunk_size=8)
    jprefix, jfirst = jeng.prefill_chunked(p, len(p), chunk_size=8)
    np.testing.assert_allclose(_np(prefix["logits"]), _np(jprefix["logits"]),
                               atol=tol_logits(name))
    assert int(_np(first)[0]) == int(_np(jfirst)[0])
    assert prefix["length"] == 40 and int(_np(prefix["pos"])[0]) == 40
    assert_cache_rows_match(prefix["cache"], jprefix["cache"], 40)
    got, want = _decode(eng, prefix, first, 8), _decode(jeng, jprefix, jfirst, 8)
    assert got == want, name
    assert len(set(got)) > 2, "a degenerate stream would prove little"


def test_prefill_chunked_matches_full_prefill(pair):
    """A ragged last chunk (13 = 8 + 5) and chunks of 4 give the full
    prefill's logits and stream. With an int8 cache a chunk attends over the
    DEQUANTIZED rows cached before it, where a full prefill attends over the
    raw ones (in the JAX package too): there the reference is one chunk as
    long as the prompt."""
    name, (eng, _) = pair
    p = prompt(12, 13)
    full, ffirst = (eng.prefill_chunked(p, len(p), len(p)) if name == "int8_kv"
                    else eng.prefill(p, len(p)))
    want = _decode(eng, full, ffirst, 6)
    for chunk in (8, 4):
        prefix, first = eng.prefill_chunked(p, len(p), chunk_size=chunk)
        np.testing.assert_allclose(_np(prefix["logits"]), _np(full["logits"]), atol=TOL_LOGITS)
        assert _decode(eng, prefix, first, 6) == want, chunk


def test_prefill_cached_matches_jax(pair):
    name, (eng, jeng) = pair
    shared = prompt(13, 16)  # two chunks of 8
    p1 = np.concatenate([shared, prompt(14, 3)])
    p2 = np.concatenate([shared, prompt(15, 5)])
    pc, jpc = PrefixCache(chunk_size=8), JaxPrefixCache(chunk_size=8)
    outs = []
    for p in (p1, p2, p1):
        prefix, first = eng.prefill_cached(p, len(p), pc)
        jprefix, jfirst = jeng.prefill_cached(p, len(p), jpc)
        assert pc.stats() == jpc.stats()
        np.testing.assert_allclose(_np(prefix["logits"]), _np(jprefix["logits"]),
                                   atol=tol_logits(name))
        whole, _ = eng.prefill_chunked(p, len(p), len(p))  # one chunk: no prefix reused
        np.testing.assert_allclose(_np(prefix["logits"]), _np(whole["logits"]), atol=TOL_LOGITS)
        assert_cache_rows_match(prefix["cache"], jprefix["cache"], len(p))
        got, want = _decode(eng, prefix, first, 6), _decode(jeng, jprefix, jfirst, 6)
        assert got == want
        outs.append(got)
    assert pc.stats() == {"entries": 2, "hits": 2, "misses": 1}
    assert outs[0] == outs[2]


def test_prefix_cache_snapshots_are_copies_and_lru(pair):
    """A stored snapshot owns its rows (a later prefill into the same buffers
    cannot change it) and the store keeps ``max_entries``, dropping the least
    recently used."""
    _, (eng, _) = pair
    pc = PrefixCache(chunk_size=4, max_entries=2)
    p = prompt(16, 10)
    prefix, _ = eng.prefill_cached(p, len(p), pc)  # stores the 4- and 8-token prefixes
    assert pc.stats()["entries"] == 2
    offset, snap = pc.lookup(p, len(p))
    assert offset == 8 and snap[0][0].max_length == 8
    before = snap[0][0].cached_key.clone()
    prefix["cache"][0][0].cached_key.add_(1)
    assert torch.equal(snap[0][0].cached_key, before)
    assert snap[0][0].cached_key.data_ptr() != prefix["cache"][0][0].cached_key.data_ptr()
    q = prompt(17, 10)
    eng.prefill_cached(q, len(q), pc)  # two more entries push p's out
    assert pc.lookup(p, len(p)) == (0, None)


@pytest.mark.parametrize("kw", [dict(sliding_window_size=8), dict(chunk_attn_window_size=8),
                                dict(attn_logits_soft_cap=20.0)],
                         ids=["window8", "chunk8", "soft_cap"])
def test_chunked_prefill_attention_module_matches_jax(kw):
    """One attention module, 24 tokens prefilled in chunks of 8 (the chunk
    attention's causal, window and chunk masks over the cache), against the
    JAX module: every chunk's output and the cache."""
    e, nq, nkv, d, s = 32, 4, 2, 16, 32
    jmod = jax_attn.Attention(num_query_heads=nq, num_kv_heads=nkv, head_dim=d,
                              max_target_length=s, dtype=jnp.float32, **kw)
    x = np.random.default_rng(3).normal(size=(1, 24, e)).astype(np.float32)
    pos = np.arange(24, dtype=np.int32)[None, :]
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x[:, :8]), jnp.asarray(x[:, :8]),
                       jnp.asarray(pos[:, :8]), jnp.ones((1, 8), jnp.int32),
                       mode=jax_attn.MODE_PREFILL)["params"]
    params = flax.linen.meta.unbox(params)
    mod = attn.Attention(e, nq, nkv, d, max_target_length=s, dtype=torch.float32, **kw)
    mod.load_state_dict({k: v.float() for k, v in
                         tree_to_state_dict(jax.tree.map(np.asarray, params)).items()})
    cache = mod.init_cache(1, s, "cpu")
    variables = {"params": params}
    for off in range(0, 24, 8):
        xs, ps = x[:, off:off + 8], pos[:, off:off + 8]
        want, jvars = jmod.apply(variables, jnp.asarray(xs), jnp.asarray(xs), jnp.asarray(ps),
                                 jnp.ones((1, 8), jnp.int32), mode=jax_attn.MODE_PREFILL,
                                 cache_offset=off, mutable=["cache"])
        variables = {"params": params, "cache": jvars["cache"]}
        got = mod(torch.from_numpy(xs), torch.from_numpy(xs), torch.from_numpy(ps),
                  torch.ones((1, 8), dtype=torch.int32), mode=attn.MODE_PREFILL, cache=cache,
                  cache_offset=off)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL_ROWS, err_msg=str(off))
    jcache = jvars["cache"]["kv_cache"]
    np.testing.assert_array_equal(_np(cache.cache_index), np.asarray(jcache["cache_index"]))
    np.testing.assert_array_equal(_np(cache.cached_segment_ids),
                                  np.asarray(jcache["cached_segment_ids"]))
    np.testing.assert_allclose(_np(cache.cached_key), np.asarray(jcache["cached_key"]),
                               atol=TOL_ROWS)


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
def test_kvcache_prefill_at_an_offset_matches_jax(quantize):
    b, s, nkv, d = 2, 16, 2, 32
    jcache = jax_attn.KVCache(max_length=s, num_kv_heads=nkv, head_dim=d, dtype=jnp.float32,
                              quantize=quantize)
    cache = attn.KVCache(b, s, nkv, d, torch.float32, quantize)
    variables = {}
    rng = np.random.default_rng(5)
    for off, n, lengths in ((0, 6, [6, 6]), (6, 6, [6, 4])):
        k = rng.normal(size=(b, n, nkv, d)).astype(np.float32)
        v = rng.normal(size=(b, n, nkv, d)).astype(np.float32)
        tl = np.array(lengths, np.int32)
        _, variables = jcache.apply(variables, jnp.asarray(k), jnp.asarray(v),
                                    jax_attn.MODE_PREFILL, jnp.asarray(tl), off,
                                    method="update", mutable=["cache"])
        cache.update(torch.from_numpy(k), torch.from_numpy(v), attn.MODE_PREFILL,
                     torch.from_numpy(tl), cache_offset=off)
    want = variables["cache"]
    for name, leaf in cache.leaves().items():  # stores and copies only: exact
        np.testing.assert_array_equal(_np(leaf), np.asarray(want[name]), err_msg=name)
    np.testing.assert_array_equal(_np(cache.cache_index), [12, 10])
    with pytest.raises(ValueError, match="past"):
        cache.update(torch.zeros((b, 6, nkv, d)), torch.zeros((b, 6, nkv, d)),
                     attn.MODE_PREFILL, cache_offset=12)
