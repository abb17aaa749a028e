"""The paged KV cache and paged decode attention of the PyTorch package
against the JAX package's, on the CPU.

- ``write_prefill`` / ``write_decode_step`` / the gather route
  (``infer/paged_attention.py``) against the JAX functions of the same names:
  the writes exactly, the attention within 2e-5 (float32, summation order).
- K4's plain version (``ops/ragged_decode_attention.paged_decode_attention_v2``
  on a CPU tensor) against the JAX package's Pallas kernel in interpret mode,
  with pages shuffled over the pool: float32 within 2e-5 (the JAX package's
  own kernel tests), bfloat16 within 2e-2 of the largest value (K1's: the TPU
  kernel rounds the probabilities to bfloat16 before the PV product, the
  port keeps them float32). A slot of length 0 gets zeros in the port; the
  TPU kernel returns the mean of the null page's V rows there, so that slot
  is checked for zeros and left out of the comparison.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.infer import page_manager as jpm
from maxtext_indextts2_tpu.infer import paged_attention as jpa
from maxtext_indextts2_tpu.ops import ragged_decode_attention as jax_rda
from maxtext_indextts2_tpu_torch.infer import page_manager as pm
from maxtext_indextts2_tpu_torch.infer import paged_attention as pa
from maxtext_indextts2_tpu_torch.ops import ragged_decode_attention as rda

torch.set_num_threads(1)

ATOL_F32 = 2e-5
REL_BF16 = 2e-2


def _paged_inputs(seed, tpp, max_pages, nq, nkv, d, lengths):
    """q, pools and page map (numpy float32 / int32) with each slot's pages
    shuffled over the pool; page 0 is the null page and belongs to nobody."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    held = [-(-min(int(n), tpp * max_pages) // tpp) for n in lengths]
    num_pages = 1 + sum(held) + 3
    order = rng.permutation(np.arange(1, num_pages))
    page_map = np.zeros((b, max_pages), np.int32)
    off = 0
    for i, n in enumerate(held):
        page_map[i, :n] = order[off:off + n]
        off += n
    q = rng.normal(size=(b, nq, d)).astype(np.float32)
    kp = rng.normal(size=(num_pages, tpp, nkv, d)).astype(np.float32)
    vp = rng.normal(size=(num_pages, tpp, nkv, d)).astype(np.float32)
    return q, kp, vp, page_map, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("nq,nkv", [(4, 4), (4, 2), (8, 2)], ids=["group1", "group2", "group4"])
@pytest.mark.parametrize("tpp", [4, 16, 64])
def test_k4_plain_matches_the_pallas_kernel(tpp, nq, nkv, d, dtype):
    max_pages = 3
    full = tpp * max_pages
    lengths = [0, 1, tpp - 1, tpp, tpp + 1, full] if tpp > 1 else [0, 1, 2, full]
    q, kp, vp, page_map, lens = _paged_inputs(tpp * 7 + nq + d, tpp, max_pages, nq, nkv, d,
                                              lengths)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax_rda.paged_decode_attention_v2(
        jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(page_map), jnp.asarray(lens), interpret=True).astype(jnp.float32))
    got = rda.paged_decode_attention_v2(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt), torch.from_numpy(vp).to(tdt),
        torch.from_numpy(page_map), torch.from_numpy(lens))
    assert got.dtype == tdt and got.shape == (len(lengths), nq, d)
    got = got.float().numpy()
    rows = lens > 0
    atol = ATOL_F32 if dtype == "float32" else REL_BF16 * float(np.abs(want[rows]).max())
    np.testing.assert_allclose(got[rows], want[rows], atol=atol, rtol=0)
    assert np.all(got[~rows] == 0.0), "an empty slot gives zeros and reads no page"


def test_k4_plain_clamps_lengths_past_the_page_map_as_the_pallas_kernel_does():
    tpp, max_pages, nq, nkv, d = 8, 2, 4, 2, 64
    q, kp, vp, page_map, _ = _paged_inputs(3, tpp, max_pages, nq, nkv, d, [16, 16, 9])
    lens = np.array([16, 1000, 9], np.int32)  # slot 1 asks past its 16 rows
    want = np.asarray(jax_rda.paged_decode_attention_v2(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(page_map),
        jnp.asarray(lens), interpret=True))
    got = rda.paged_decode_attention_v2(*[torch.from_numpy(a) for a in (q, kp, vp, page_map,
                                                                      lens)]).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL_F32, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tpp,max_pages", [(16, 16), (12, 24), (5, 40)],
                         ids=["tpp16_shift", "tpp12_counter", "tpp5_counter"])
def test_k4_plain_at_the_cluster_split_edges_matches_the_pallas_kernel(tpp, max_pages, dtype):
    """The CUDA kernel splits a slot's rows over a cluster of C blocks and
    walks each block's pages with a counter (a shift and a mask where tpp is
    a power of two): lengths at the split's edges, and lengths whose blocks'
    ranges cross page boundaries inside one block, as on the card."""
    from maxtext_indextts2_tpu_torch.ops import smoke

    nq, nkv, d = 4, 2, 64
    cap = tpp * max_pages
    lengths = smoke.split_edge_lengths(cap) + [3 * tpp + 5, 7 * tpp - 2, cap // 2 + 1]
    q, kp, vp, page_map, lens = _paged_inputs(tpp * 13 + max_pages, tpp, max_pages, nq, nkv,
                                              d, lengths)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax_rda.paged_decode_attention_v2(
        jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(page_map), jnp.asarray(lens), interpret=True).astype(jnp.float32))
    got = rda.paged_decode_attention_v2(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt), torch.from_numpy(vp).to(tdt),
        torch.from_numpy(page_map), torch.from_numpy(lens)).float().numpy()
    rows = lens > 0
    atol = ATOL_F32 if dtype == "float32" else REL_BF16 * float(np.abs(want[rows]).max())
    np.testing.assert_allclose(got[rows], want[rows], atol=atol, rtol=0)
    assert np.all(got[~rows] == 0.0)


def test_k4_wrapper_takes_int64_negative_and_past_the_map_lengths_on_the_cpu_route():
    tpp, max_pages, nq, nkv, d = 8, 2, 4, 2, 64
    q, kp, vp, page_map, _ = _paged_inputs(5, tpp, max_pages, nq, nkv, d, [16, 16, 9, 0])
    lens = torch.tensor([16, 2 ** 40, -4, 0], dtype=torch.int64)
    args = [torch.from_numpy(a) for a in (q, kp, vp)]
    got = rda.paged_decode_attention_v2(*args, torch.from_numpy(page_map).long(), lens)
    want = rda.paged_decode_attention_v2_plain(
        *args, torch.from_numpy(page_map), torch.tensor([16, 16, 0, 0], dtype=torch.int32))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert torch.all(got[2:] == 0)


def test_k4_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((2, 4, 64))
    pools = torch.zeros((5, 4, 2, 64))
    pmap = torch.zeros((2, 3), dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    call = rda.paged_decode_attention_v2
    with pytest.raises(TypeError, match="float32 or bfloat16 pools"):
        call(q, pools.to(torch.int8), pools.to(torch.int8), pmap, lens)
    with pytest.raises(TypeError, match="q is"):
        call(q.to(torch.bfloat16), pools, pools, pmap, lens)
    with pytest.raises(ValueError, match="does not match the pools"):
        call(torch.zeros((2, 4, 32)), pools, pools, pmap, lens)
    with pytest.raises(ValueError, match="does not match the pools"):
        call(torch.zeros((2, 3, 64)), pools, pools, pmap, lens)  # 3 heads over 2 kv heads
    with pytest.raises(ValueError, match=r"need q \[B,nq,d\]"):
        call(q, pools, pools[:4], pmap, lens)
    with pytest.raises(ValueError, match="page_map must be"):
        call(q, pools, pools, pmap[:1], lens)
    with pytest.raises(ValueError, match="page_map must be"):
        call(q, pools, pools, pmap, lens[:1])
    with pytest.raises(TypeError, match="integer"):
        call(q, pools, pools, pmap.float(), lens)
    # a CPU tensor sent to the kernel: an error, never the plain version
    with pytest.raises(ValueError, match="CUDA device"):
        call(q, pools, pools, pmap, lens, impl="cuda")
    with pytest.raises(ValueError, match="impl must be"):
        call(q, pools, pools, pmap, lens, impl="triton")
    assert isinstance(rda.paged_launch_count, int)


def _state_pair(tpp, max_pages, slots, num_pages, prompt_lens):
    state = pm.init_page_state(num_pages, slots, max_pages)
    jstate = jpm.init_page_state(num_pages, slots, max_pages)
    ids = {}
    for slot, n in prompt_lens.items():
        state, ids[slot] = pm.allocate_prefill(state, slot, n, tpp, max_pages)
        jstate, _ = jpm.allocate_prefill(jstate, slot, jnp.asarray(n, jnp.int32), tpp, max_pages)
    return state, jstate, ids


def _pools_equal(cache, jcache):
    np.testing.assert_array_equal(cache.key_pages.numpy(), np.asarray(jcache.key_pages))
    np.testing.assert_array_equal(cache.value_pages.numpy(), np.asarray(jcache.value_pages))


@pytest.mark.parametrize("tpp", [4, 8])
def test_writes_match_jax(tpp):
    """Prefill of whole pages (the JAX function takes only those), then
    decode steps across boundaries with an empty slot beside: equal pools."""
    rng = np.random.default_rng(tpp)
    nkv, d, max_pages, slots, num_pages = 2, 16, 6, 3, 20
    state, jstate, ids = _state_pair(tpp, max_pages, slots, num_pages, {0: 2 * tpp, 2: tpp})
    cache = pa.init_paged_cache(num_pages, tpp, nkv, d, torch.float32)
    jcache = jpa.init_paged_cache(num_pages, tpp, nkv, d, jnp.float32)
    for slot, n in ((0, 2 * tpp), (2, tpp)):
        k = rng.normal(size=(1, n, nkv, d)).astype(np.float32)
        v = rng.normal(size=(1, n, nkv, d)).astype(np.float32)
        pa.write_prefill(cache, ids[slot], torch.from_numpy(k), torch.from_numpy(v))
        jcache = jpa.write_prefill(jcache, jstate.page_map[slot], jnp.asarray(k), jnp.asarray(v))
    _pools_equal(cache, jcache)
    for _ in range(tpp + 2):
        state = pm.allocate_decode_step(state, tpp)
        jstate = jpm.allocate_decode_step(jstate, tpp)
        k = rng.normal(size=(slots, 1, nkv, d)).astype(np.float32)
        v = rng.normal(size=(slots, 1, nkv, d)).astype(np.float32)
        pa.write_decode_step(cache, state, torch.from_numpy(k), torch.from_numpy(v))
        jcache = jpa.write_decode_step(jcache, jstate, jnp.asarray(k), jnp.asarray(v))
        _pools_equal(cache, jcache)


def test_prefill_write_takes_a_prompt_of_any_length_and_touches_only_its_rows():
    tpp, nkv, d = 4, 1, 8
    state, _, ids = _state_pair(tpp, 4, 2, 10, {1: 6})
    cache = pa.init_paged_cache(10, tpp, nkv, d, torch.float32)
    k = torch.arange(6, dtype=torch.float32)[None, :, None, None].expand(1, 6, nkv, d) + 1
    pa.write_prefill(cache, ids[1], k, -k)
    written = (cache.key_pages != 0).any(-1).any(-1)  # [pages, tpp]
    p0, p1 = int(ids[1][0]), int(ids[1][1])
    assert written.sum() == 6 and written[p0].all() and written[p1, :2].all()
    assert not written[0].any(), "the null page is never written"
    assert torch.equal(cache.value_pages[p1, 1, 0], torch.full((d,), -6.0))


@pytest.mark.parametrize("soft_cap", [0.0, 30.0], ids=["no_cap", "soft_cap"])
def test_gather_route_matches_jax(soft_cap):
    tpp, max_pages, nq, nkv, d = 4, 5, 4, 2, 16
    lengths = [7, 0, 20, 1]
    q, kp, vp, page_map, lens = _paged_inputs(11, tpp, max_pages, nq, nkv, d, lengths)
    state = pm.PageState(torch.zeros(kp.shape[0], dtype=torch.int32),
                         torch.from_numpy(page_map), torch.from_numpy(lens))
    jstate = jpm.PageState(jnp.zeros(kp.shape[0], jnp.int32), jnp.asarray(page_map),
                           jnp.asarray(lens))
    got = pa.paged_decode_attention(torch.from_numpy(q)[:, None],
                                    pa.PagedKVCache(torch.from_numpy(kp), torch.from_numpy(vp)),
                                    state, soft_cap).numpy()
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q)[:, None], jpa.PagedKVCache(jnp.asarray(kp), jnp.asarray(vp)), jstate,
        soft_cap))
    rows = lens > 0  # an empty slot: a softmax over masked logits on both sides
    np.testing.assert_allclose(got[rows], want[rows], atol=ATOL_F32, rtol=0)
    assert got.shape == (len(lengths), 1, nq, d)
