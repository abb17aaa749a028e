"""The PyTorch package's kernel wrappers on the CPU (their plain versions)
against the JAX package's Pallas kernels in interpret mode and its jnp
reference. Inputs come from a numpy seed and go to both sides.

Tolerances: float32 results differ by summation order only, atol 2e-5 on
O(1) values (what the JAX package's own kernel tests use); the in-place
row update is a copy and must be exactly equal.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.ops import inplace_update as jax_iu
from maxtext_indextts2_tpu.ops import quantization as jax_q
from maxtext_indextts2_tpu.ops import ragged_decode_attention as jax_rda
from maxtext_indextts2_tpu_torch.ops import inplace_update as iu
from maxtext_indextts2_tpu_torch.ops import ragged_decode_attention as rda
from maxtext_indextts2_tpu_torch.ops import smoke

# tiny shapes: one thread is enough, and the cores stay free for the other test workers
torch.set_num_threads(1)

ATOL = 2e-5


def _qkv(seed, b, s, nq, nkv, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, nq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, nkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, nkv, d)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# lengths include 1, S, > S (clamped on both sides) and 0; rows of length 0
# are left out of the comparison: the TPU kernel returns a finite mean of
# masked rows there, the jnp reference NaN, this package zeros.
LENGTHS = np.array([1, 37, 128, 200, 0, 77], np.int32)
S = 128


@pytest.mark.parametrize("nq,nkv", [(4, 4), (4, 2), (8, 2)], ids=["group1", "group2", "group4"])
@pytest.mark.parametrize("window", [0, 24], ids=["global", "window24"])
def test_ragged_plain_matches_pallas_v2_and_reference(nq, nkv, window):
    b, d = len(LENGTHS), 32
    q, k, v = _qkv(nq * 10 + window, b, S, nq, nkv, d)
    got = rda.ragged_decode_attention_v2(
        *_t(q, k, v, LENGTHS), sliding_window=window).numpy()
    clamped = np.minimum(LENGTHS, S)
    kernel = np.asarray(jax_rda.ragged_decode_attention_v2(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(LENGTHS),
        block_kv=64, interpret=True, sliding_window=window))
    ref = np.asarray(jax_rda.ragged_decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(clamped),
        sliding_window=window))
    rows = LENGTHS > 0
    np.testing.assert_allclose(got[rows], kernel[rows], atol=ATOL)
    np.testing.assert_allclose(got[rows], ref[rows], atol=ATOL)
    assert np.all(got[~rows] == 0.0), "an empty slot gives zeros, never NaN"
    assert np.isfinite(got).all()


@pytest.mark.parametrize("window", [0, 24], ids=["global", "window24"])
def test_ragged_plain_int8_matches_pallas_v2(window):
    b, nq, nkv, d = len(LENGTHS), 4, 2, 32
    q, k, v = _qkv(5 + window, b, S, nq, nkv, d)
    kq, ks = jax_q.quantize_kv(jnp.asarray(k))
    vq, vs = jax_q.quantize_kv(jnp.asarray(v))
    kernel = np.asarray(jax_rda.ragged_decode_attention_v2(
        jnp.asarray(q), kq, vq, jnp.asarray(LENGTHS), block_kv=64, interpret=True,
        sliding_window=window, k_scale=ks, v_scale=vs))
    ref = np.asarray(jax_rda.ragged_decode_attention_reference(
        jnp.asarray(q), jax_q.dequantize_kv(kq, ks, jnp.float32),
        jax_q.dequantize_kv(vq, vs, jnp.float32), jnp.asarray(np.minimum(LENGTHS, S)),
        sliding_window=window))
    tq, tk, tv, tl, tks, tvs = _t(q, kq, vq, LENGTHS, ks, vs)
    got = rda.ragged_decode_attention_v2(
        tq, tk, tv, tl, sliding_window=window, k_scale=tks, v_scale=tvs).numpy()
    rows = LENGTHS > 0
    # the scales multiply scores and probabilities instead of the cache:
    # same value up to float32 rounding of the products, atol 5e-5 as in the
    # JAX package's own int8 kernel test
    np.testing.assert_allclose(got[rows], kernel[rows], atol=5e-5)
    np.testing.assert_allclose(got[rows], ref[rows], atol=5e-5)
    assert np.all(got[~rows] == 0.0)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_ragged_v1_signature_entry_matches_pallas_v1(int8):
    lengths = np.array([1, 64, 128, 90], np.int32)
    q, k, v = _qkv(9, 4, S, 4, 2, 32)
    if int8:
        kq, ks = jax_q.quantize_kv(jnp.asarray(k))
        vq, vs = jax_q.quantize_kv(jnp.asarray(v))
        kw = dict(k_scale=ks[..., None], v_scale=vs[..., None])
        kj, vj = kq, vq
    else:
        kw, kj, vj = {}, jnp.asarray(k), jnp.asarray(v)
    want = jax_rda.ragged_decode_attention(
        jnp.asarray(q), kj, vj, jnp.asarray(lengths), block_kv=64, interpret=True, **kw)
    tkw = {n: torch.from_numpy(np.array(a)) for n, a in kw.items()}
    got = rda.ragged_decode_attention(*_t(q, kj, vj, lengths), block_kv=64, **tkw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5 if int8 else ATOL)


def test_ragged_wrapper_rejects_what_no_kernel_takes():
    q, k, v = _t(*_qkv(0, 2, 16, 4, 2, 32))
    lengths = torch.tensor([3, 4], dtype=torch.int32)
    with pytest.raises(ValueError):
        rda.ragged_decode_attention_v2(q, k, v[:, :8], lengths)
    with pytest.raises(TypeError):  # int8 cache without scales
        rda.ragged_decode_attention_v2(q, k.to(torch.int8), v.to(torch.int8), lengths)
    with pytest.raises(ValueError):  # a CPU tensor cannot go to the CUDA kernel
        rda.ragged_decode_attention_v2(q, k, v, lengths, impl="cuda")
    with pytest.raises(ValueError):
        rda.ragged_decode_attention_v2(q, k, v, lengths, impl="triton")


# The CUDA kernel splits a slot's rows over a cluster of C blocks (ceil(n / C)
# rows a block, C in 1, 2, 4, 8): the lengths at that split's edges (blocks
# with no row, multiples of C and one past, S and past it, 0) that the card's
# cases use, and windows that are no multiple of C. The plain version serves
# them as the Pallas kernel does.
SPLIT_LENGTHS = np.array(smoke.split_edge_lengths(S), np.int32)


@pytest.mark.parametrize("nq,nkv", [(4, 4), (4, 2), (8, 2)], ids=["group1", "group2", "group4"])
@pytest.mark.parametrize("window", [0, 13, 29], ids=["global", "window13", "window29"])
def test_ragged_plain_at_the_cluster_split_edges_matches_pallas_v2(nq, nkv, window):
    b, d = len(SPLIT_LENGTHS), 32
    q, k, v = _qkv(nq * 100 + window, b, S, nq, nkv, d)
    got = rda.ragged_decode_attention_v2(
        *_t(q, k, v, SPLIT_LENGTHS), sliding_window=window).numpy()
    kernel = np.asarray(jax_rda.ragged_decode_attention_v2(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(SPLIT_LENGTHS),
        block_kv=64, interpret=True, sliding_window=window))
    ref = np.asarray(jax_rda.ragged_decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(np.minimum(SPLIT_LENGTHS, S)), sliding_window=window))
    rows = SPLIT_LENGTHS > 0
    np.testing.assert_allclose(got[rows], kernel[rows], atol=ATOL)
    np.testing.assert_allclose(got[rows], ref[rows], atol=ATOL)
    assert np.all(got[~rows] == 0.0)


@pytest.mark.parametrize("v1_entry", [False, True], ids=["v2", "v1_entry"])
@pytest.mark.parametrize("window", [0, 13], ids=["global", "window13"])
def test_ragged_plain_int8_at_the_cluster_split_edges_matches_pallas(v1_entry, window):
    b, nq, nkv, d = len(SPLIT_LENGTHS), 4, 2, 32
    q, k, v = _qkv(7 + window, b, S, nq, nkv, d)
    kq, ks = jax_q.quantize_kv(jnp.asarray(k))
    vq, vs = jax_q.quantize_kv(jnp.asarray(v))
    tq, tk, tv, tl, tks, tvs = _t(q, kq, vq, SPLIT_LENGTHS, ks, vs)
    if v1_entry:  # K3: scales with a trailing unit axis, a float32 result
        want = jax_rda.ragged_decode_attention(
            jnp.asarray(q), kq, vq, jnp.asarray(SPLIT_LENGTHS), block_kv=64, interpret=True,
            k_scale=ks[..., None], v_scale=vs[..., None], sliding_window=window)
        got = rda.ragged_decode_attention(tq, tk, tv, tl, k_scale=tks[..., None],
                                          v_scale=tvs[..., None], sliding_window=window)
        assert got.dtype == torch.float32
    else:
        want = jax_rda.ragged_decode_attention_v2(
            jnp.asarray(q), kq, vq, jnp.asarray(SPLIT_LENGTHS), block_kv=64, interpret=True,
            sliding_window=window, k_scale=ks, v_scale=vs)
        got = rda.ragged_decode_attention_v2(tq, tk, tv, tl, sliding_window=window,
                                             k_scale=tks, v_scale=tvs)
    got, want = got.numpy(), np.asarray(want)
    rows = SPLIT_LENGTHS > 0
    np.testing.assert_allclose(got[rows], want[rows], atol=5e-5)  # as the int8 test above
    assert np.all(got[~rows] == 0.0)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
def test_ragged_wrapper_takes_negative_wide_and_past_the_cache_lengths(dtype):
    """The wrapper no longer clamps on its CUDA route (the kernel does): on the
    CPU route the same lengths give the plain version's result, equal to the
    clamped lengths' result, and an empty slot's zeros."""
    huge = 2 ** 40 if dtype == torch.int64 else 2 ** 30
    lengths = torch.tensor([-5, 0, 3, S, S + 1, 3 * S, huge], dtype=dtype)
    q, k, v = _t(*_qkv(11, len(lengths), S, 4, 2, 32))
    got = rda.ragged_decode_attention_v2(q, k, v, lengths)
    want = rda.ragged_decode_attention_plain(q, k, v, torch.clamp(lengths, 0, S).to(torch.int32))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert torch.all(got[:2] == 0)


def test_the_kernel_route_passes_int32_lengths_through_and_clamps_only_wider_ones():
    """No eager op for the serving path's contiguous int32 lengths (the kernel
    clamps them); an int64 length past int32 is clamped before its cast, so it
    cannot wrap into the valid range."""
    lengths = torch.tensor([0, 5, 900], dtype=torch.int32)
    assert rda._as_int32(lengths, 64) is lengths
    wide = torch.tensor([-3, 5, 2 ** 32 + 7, 2 ** 40], dtype=torch.int64)
    got = rda._as_int32(wide, 64)
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert got.tolist() == [-1, 5, 64, 64]
    strided = torch.arange(8, dtype=torch.int32)[::2]
    assert rda._as_int32(strided, 64).is_contiguous()


@pytest.mark.parametrize("resident", [1, 660, 10 ** 6])
@pytest.mark.parametrize("b_sz,nkv", [(1, 1), (32, 8), (128, 8), (7, 3), (4096, 16)])
@pytest.mark.parametrize("max_len", [1, 31, 64, 2048, 32768])
def test_cluster_size_is_a_power_of_two_in_1_to_8_from_static_shapes(b_sz, nkv, max_len,
                                                                   resident):
    """The cluster size takes only static shapes (slots, kv heads, the cache's
    max length, the blocks the card holds): no length tensor reaches it, so
    a decode step reads nothing back to the host. Within 1..8, a power of
    two; never more blocks than max_len / 32; 2 or more where the cache
    allows; never larger for more slots."""
    c = rda.cluster_size(b_sz, nkv, max_len, resident)
    assert c in (1, 2, 4, 8)
    assert c == 1 or c * rda.MIN_ROWS_PER_BLOCK <= max_len
    if max_len >= 2 * rda.MIN_ROWS_PER_BLOCK:
        assert c >= 2
    assert rda.cluster_size(2 * b_sz, nkv, max_len, resident) <= c
    params = list(inspect.signature(rda.cluster_size).parameters)
    assert params == ["b_sz", "nkv", "max_len", "resident_blocks"]


def test_cluster_size_keeps_the_serving_grid_within_one_wave():
    # 32 slots x 8 kv heads of tts-1b at 660 resident blocks (5 an SM x 132):
    # 2 blocks a pair, 512 blocks; 128 slots: still 2
    assert rda.cluster_size(32, 8, 2048, 660) == 2
    assert rda.cluster_size(128, 8, 2048, 660) == 2
    assert rda.cluster_size(4, 8, 32768, 660) == 8
    assert rda.cluster_size(4, 8, 64, 660) == 2


def test_the_kernel_route_refuses_a_cache_that_does_not_start_on_16_bytes():
    """The kernel copies K/V rows in 16-byte pieces (cp.async): a view whose
    start is not 16-byte aligned raises before any launch."""
    base = torch.zeros(4 * 16 * 2 * 32 + 4)
    rda._check_16_byte_rows(base[:8], base[4:12])
    with pytest.raises(ValueError, match="16-byte"):
        rda._check_16_byte_rows(base[1:9])


def test_the_decode_attention_bench_times_the_card_checks_split_edges():
    """tools/bench_decode_attention.py keeps its own copy of the edges (it
    also times older checkouts of the package, whose smoke has none)."""
    from maxtext_indextts2_tpu_torch.tools import bench_decode_attention as bench

    for max_len in (31, 64, 160, 512, 3840):
        assert bench._edges(max_len) == smoke.split_edge_lengths(max_len)


@pytest.mark.parametrize("tpp,shift", [(1, 0), (2, 1), (4, 2), (7, -1), (12, -1), (16, 4),
                                       (64, 6), (96, -1), (128, 7), (2 ** 20, 20)])
def test_tpp_shift_is_log2_only_for_powers_of_two(tpp, shift):
    assert rda.tpp_shift(tpp) == shift
    if shift >= 0:
        assert 1 << shift == tpp


@pytest.mark.parametrize("ndim", [4, 3], ids=["kv4d", "scale3d"])
@pytest.mark.parametrize("span", [1, 4], ids=["K1", "K4"])
def test_inplace_row_update_matches_pallas(ndim, span):
    rng = np.random.default_rng(ndim * 10 + span)
    b, s = 5, 16
    inner = (2, 32) if ndim == 4 else (128,)
    cache = rng.normal(size=(b, s) + inner).astype(np.float32)
    kv = rng.normal(size=(b, span) + inner).astype(np.float32)
    # slot 1 ends exactly at the cache end; slot 3 starts past it and needs
    # the clamp (with K=1 only: rows of one span that clamp onto the same
    # target are written in no fixed order, and callers keep idx+K <= S)
    idx = np.array([0, s - span, 7, s + 5 if span == 1 else 3, 2], np.int32)
    want = np.asarray(jax_iu.inplace_row_update(
        jnp.asarray(cache), jnp.asarray(kv), jnp.asarray(idx), interpret=True))
    tc, tkv, tidx = _t(cache.copy(), kv, idx)
    got = iu.inplace_row_update(tc, tkv, tidx)
    assert got is tc, "the cache is updated in place and returned"
    np.testing.assert_array_equal(got.numpy(), want)
    untouched = np.ones((b, s), bool)
    for bi in range(b):
        untouched[bi, np.minimum(idx[bi] + np.arange(span), s - 1)] = False
    np.testing.assert_array_equal(got.numpy()[untouched], cache[untouched])


def test_inplace_row_update_casts_rows_to_cache_dtype():
    rng = np.random.default_rng(3)
    cache = torch.zeros((2, 8, 2, 32), dtype=torch.bfloat16)
    kv = torch.from_numpy(rng.normal(size=(2, 1, 2, 32)).astype(np.float32))
    idx = torch.tensor([1, 6], dtype=torch.int32)
    iu.inplace_row_update(cache, kv, idx)
    want = np.asarray(jax_iu.inplace_row_update(
        jnp.zeros((2, 8, 2, 32), jnp.bfloat16), jnp.asarray(kv.numpy()).astype(jnp.bfloat16),
        jnp.asarray(idx.numpy()), interpret=True).astype(jnp.float32))
    np.testing.assert_array_equal(cache.float().numpy(), want)


def test_inplace_wrapper_rejects_bad_arguments():
    cache = torch.zeros((2, 8, 4))
    with pytest.raises(ValueError):
        iu.inplace_row_update(cache, torch.zeros((2, 1, 5)), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError):
        iu.inplace_row_update(cache, torch.zeros((2, 1, 4)), torch.zeros(2))
    with pytest.raises(ValueError):
        iu.inplace_row_update(cache, torch.zeros((2, 1, 4)),
                              torch.zeros(2, dtype=torch.int32), impl="cuda")


def test_cpu_calls_launch_no_kernel():
    before = (rda.launch_count, iu.launch_count)
    q, k, v = _t(*_qkv(1, 2, 16, 4, 2, 32))
    rda.ragged_decode_attention_v2(q, k, v, torch.tensor([3, 4], dtype=torch.int32))
    iu.inplace_row_update(torch.zeros((2, 8, 4)), torch.ones((2, 1, 4)),
                          torch.zeros(2, dtype=torch.int32))
    assert (rda.launch_count, iu.launch_count) == before
