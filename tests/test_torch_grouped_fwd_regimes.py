"""The bfloat16 grouped forward's two regimes, on the CPU.

On the card ``grouped_matmul`` runs one of two kernels of
``csrc/grouped_matmul.cu``, picked by a host rule on the shape
(``forward_plan``): the persistent ``wgmma`` kernel where the groups hold
many rows (R >= 32 G), the split weight stream where they hold few. Here the
wrappers take their plain versions, which the kernels are held to on the
card; this file holds those plain versions to the JAX package at the edge
shapes of both regimes, and the host rules on their boundary values:

- ``grouped_matmul`` on bfloat16 operands against ``jax.lax.ragged_dot(x, w,
  group_sizes, preferred_element_type=float32).astype(bfloat16)``
  (``models/moe.py:268-281``): empty groups, 1-row groups, groups ending
  inside a 16-row and a 64-row tile, K and N multiples of 8 but not of 64.
  Tolerance 2**-7 of max(1, max |JAX value|): both round one float32 sum of
  exact products to bfloat16, summed in another order, so a value may sit
  one bfloat16 step apart.
- ``grouped_matmul_int8`` against the JAX int8 experts' arithmetic
  (``moe.py:241-266``: ``ragged_dot`` with int32 sums, then (float(sum) x
  row scale) x the expert's channel scale): the sums exactly equal, the
  rescaled bfloat16 result bitwise equal (the same float32 operations).
- ``many_rows``, ``tile_rows``, ``few_row_tiles`` and ``forward_plan``
  at their boundaries; the wrappers route only CPU tensors to the plain
  version and raise on a kernel request for tensors off the card.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu_torch.ops import grouped_matmul as gm

torch.set_num_threads(1)

TOL_BF16 = 2.0 ** -7

# (group sizes, K, N): the few-rows regime's edges, then the many-rows one's
EDGES = {
    "one_row_groups": ([1] * 12 + [0] * 4, 72, 136),
    "few_rows_mid_tile": ([1, 0, 3, 16, 17, 0, 5, 2, 8, 15, 1, 0, 30, 4], 520, 200),
    "empty_groups": ([0, 0, 24, 0, 0, 0, 0, 0], 40, 24),
    "many_rows_tile_edges": ([1, 63, 65, 0, 127, 129], 200, 136),
    "one_group_holds_all": ([0, 0, 0, 203, 0], 104, 56),
}


def _bf16(a: np.ndarray) -> np.ndarray:
    return a.astype(ml_dtypes.bfloat16)


def _operands(sizes, k, n, seed):
    rng = np.random.default_rng(seed)
    r, g = int(sum(sizes)), len(sizes)
    x = _bf16(rng.normal(size=(r, k)))
    w = _bf16(rng.normal(size=(g, k, n)) / np.sqrt(k))
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32)
    return x, w, offsets


def _torch_bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("case", sorted(EDGES))
def test_bf16_forward_matches_ragged_dot(case):
    sizes, k, n = EDGES[case]
    x, w, offsets = _operands(sizes, k, n, seed=len(case))
    want = jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes, jnp.int32),
                              preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    want = np.asarray(want.astype(jnp.float32))
    before = dict(gm.launch_counts)
    got = gm.grouped_matmul(_torch_bf16(x), _torch_bf16(w), offsets)
    assert gm.launch_counts == before  # the CPU takes the plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    err = np.abs(got.float().numpy() - want).max()
    assert err <= TOL_BF16 * max(1.0, np.abs(want).max()), err
    # the regime these edges stand for on the card
    many = gm.forward_plan(int(sum(sizes)), len(sizes), k, n, sms=132) == (0, 0)
    assert many == case.startswith(("many_rows", "one_group"))


@pytest.mark.parametrize("case", ["one_row_groups", "few_rows_mid_tile", "many_rows_tile_edges"])
def test_int8_forward_matches_the_jax_int8_experts(case):
    sizes, k, n = EDGES[case]
    k, n = -(-k // 16) * 16, -(-n // 16) * 16  # the int8 kernel's K and N
    rng = np.random.default_rng(7 + len(case))
    r, g = int(sum(sizes)), len(sizes)
    xq = rng.integers(-127, 128, size=(r, k)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(g, k, n)).astype(np.int8)
    rs = rng.uniform(0.5, 1.5, size=(r, 1)).astype(np.float32) / 127
    ws = rng.uniform(0.5, 1.5, size=(g, 1, n)).astype(np.float32) / (127 * k)
    group_of = np.repeat(np.arange(g), sizes)
    sums = jax.lax.ragged_dot(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(sizes, jnp.int32),
                              preferred_element_type=jnp.int32)
    scaled = (sums.astype(jnp.float32) * jnp.asarray(rs)
              * jnp.take(jnp.asarray(ws)[:, 0], jnp.asarray(group_of), axis=0))
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32)
    got_sums = gm.grouped_matmul_int8(torch.from_numpy(xq), torch.from_numpy(wq), offsets)
    np.testing.assert_array_equal(got_sums.numpy(), np.asarray(sums))
    got = gm.grouped_matmul_int8(torch.from_numpy(xq), torch.from_numpy(wq), offsets,
                                 torch.from_numpy(rs), torch.from_numpy(ws))
    want = np.asarray(scaled.astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("groups", [1, 8, 128])
def test_many_rows_boundary(groups):
    assert gm.many_rows(32 * groups, groups)
    assert not gm.many_rows(32 * groups - 1, groups)
    assert gm.tile_rows(32 * groups, groups) == 64
    assert gm.tile_rows(32 * groups - 1, groups) == 16
    assert gm.forward_plan(32 * groups, groups, 2048, 768, sms=132) == (0, 0)
    assert gm.forward_plan(32 * groups - 1, groups, 2048, 768, sms=132)[0] >= 1


@pytest.mark.parametrize("rows,groups,want", [
    (8, 128, 8),      # fewer rows than groups: a tile that does work holds a row
    (64, 128, 64),
    (15, 1, 1), (16, 1, 1), (17, 1, 2),  # one group: ceil(R / 16) exactly
    (16, 8, 8),       # mixtral at 8 slots: 8 groups of up to 16 rows
    (24, 8, 9),       # 8 groups, 16 rows more: one more tile at most
    (256, 8, 23),     # 8 + 248 // 16
    (1, 1, 1),
])
def test_few_row_tiles(rows, groups, want):
    assert gm.few_row_tiles(rows, groups) == want


@pytest.mark.parametrize("seed", range(20))
def test_few_row_tiles_bounds_every_routing(seed):
    """No split of R rows over G groups fills more tiles than the grid has."""
    rng = np.random.default_rng(seed)
    groups = int(rng.integers(1, 40))
    rows = int(rng.integers(1, 200))
    for _ in range(50):
        if rng.random() < 0.5:  # every row on its own group where it can
            counts = np.bincount(rng.permutation(rows) % groups, minlength=groups)
        else:
            counts = np.bincount(rng.integers(0, groups, rows), minlength=groups)
        assert int(np.sum(-(-counts // 16))) <= gm.few_row_tiles(rows, groups)


@pytest.mark.parametrize("rows,groups,k,n,want", [
    (64, 128, 2048, 768, (1, 4)),    # qwen3 decode: 384 blocks, more than the SMs: no split
    (256, 128, 2048, 768, (1, 4)),   # 32 slots
    (8, 128, 2048, 768, (2, 4)),     # 8 rows over 128 experts: 48 blocks, split by 132 // 48
    (8, 128, 2048, 128, (8, 4)),     # 8 blocks: the cluster's limit of 8
    (8, 128, 256, 128, (1, 4)),      # K of one 256-row split
    (8, 128, 257, 128, (2, 4)),      # K just past it
    (8, 128, 520, 128, (3, 4)),      # K 520: three splits of 3 stages of 64
    (16, 8, 14336, 4096, (1, 6)),    # mixtral decode wo: K >= 8192, 226 working blocks
    (8, 16, 8192, 5120, (1, 4)),     # llama4 decode wo: 8 tiles x 40 = 320 > 264 can fill
    (16, 8, 8184, 4096, (1, 4)),     # K just under 8192
    (8, 16, 5120, 8192, (1, 3)),     # llama4 decode wi: 413 working blocks, four an SM
    (16, 8, 4096, 14336, (1, 4)),    # mixtral decode wi: 790, past every ring's slots
    (48, 64, 2048, 1408, (1, 4)),    # deepseek decode wi: 373, three an SM
    (100, 24, 2056, 136, (2, 4)),
])
def test_forward_plan(rows, groups, k, n, want):
    assert gm.forward_plan(rows, groups, k, n, sms=132) == want


@pytest.mark.parametrize("rows,groups,n,want", [
    (8, 16, 128, 16 * (1 - (15 / 16) ** 8)),     # the expected touched experts
    (64, 128, 768, 6 * 128 * (1 - (127 / 128) ** 64)),
    (1, 64, 256, 2.0),                           # one row: one group, two column tiles
    (1000, 4, 128, 4.0),                         # every group touched
])
def test_working_blocks(rows, groups, n, want):
    assert gm.working_blocks(rows, groups, n) == pytest.approx(want)
    assert gm.working_blocks(rows, groups, n) <= gm.few_row_tiles(rows, groups) * -(-n // 128)


@pytest.mark.parametrize("k", [8, 64, 72, 256, 264, 520, 2000, 2056, 14336])
@pytest.mark.parametrize("n", [8, 128, 136, 768])
@pytest.mark.parametrize("rows,groups", [(1, 64), (8, 128), (31, 1), (100, 24)])
def test_forward_plan_never_leaves_a_split_empty(k, n, rows, groups):
    s, stages = gm.forward_plan(rows, groups, k, n, sms=132)
    assert 1 <= s <= gm.MAX_SPLITS and stages in (3, 4, 6)
    blocks = gm.few_row_tiles(rows, groups) * -(-n // gm.FEW_COLS)
    assert stages != 6 or (k >= gm.DEEP_RING_MIN_K and blocks * s <= 2 * 132)
    stages_k = -(-k // 64)
    per_split = -(-stages_k // s) * 64  # the kernel's own split of K
    assert (s - 1) * per_split < k <= s * per_split
    # a split only while the blocks are fewer than the SMs
    blocks = gm.few_row_tiles(rows, groups) * -(-n // gm.FEW_COLS)
    assert s == 1 or blocks * s <= 132


def test_wrappers_route_cpu_tensors_to_plain_and_refuse_a_kernel_off_the_card():
    x, w = torch.ones((6, 8), dtype=torch.bfloat16), torch.ones((2, 8, 16), dtype=torch.bfloat16)
    offsets = torch.tensor([0, 2, 6], dtype=torch.int32)
    before = dict(gm.launch_counts)
    assert torch.equal(gm.grouped_matmul(x, w, offsets),
                       gm.grouped_matmul(x, w, offsets, impl="plain"))
    assert gm.launch_counts == before
    with pytest.raises(ValueError, match="one CUDA device"):
        gm.grouped_matmul(x, w, offsets, impl="cuda")
    with pytest.raises(ValueError, match="one CUDA device"):
        gm.grouped_matmul_int8(x.to(torch.int8), w.to(torch.int8), offsets, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        gm.grouped_matmul(x, w, offsets, impl="triton")
    assert gm.launch_counts == before
