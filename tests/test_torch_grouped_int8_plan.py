"""The host plans of the int8 and float32 grouped kernels, and the int8
plain version at the int8 kernels' edge shapes, on the CPU.

On the card ``grouped_matmul_int8`` runs one of two kernels of
``csrc/grouped_matmul.cu`` as ``int8_plan`` says: the persistent kernel of
64-row tiles where the groups hold many rows (R >= 32 G), else the few-rows
weight stream with K split over a cluster and a ring of 3 or 4 stages of 128
of K. The float32 forward and dgrad (``csrc/grouped_matmul_f32.cu``) take
their tile's rows from ``f32_tile_rows``. Both plans are pure functions of
the shape and the card's SM count; this file holds them at their boundaries
and checks that no split of K is left empty. It also holds the plain int8
version, which the kernels are held to on the card, to the JAX package's
int8 experts (``maxtext_indextts2_tpu/models/moe.py:251-258``:
``ragged_dot(int8, int8, preferred_element_type=int32)``, then
``(float(sum) * row_scale) * channel_scale`` rounded once to bfloat16) at
groups of 0-17 rows, a K of 2056 (no multiple of the kernel's 128-deep
stage) and one group holding every row: the sums exactly equal, the rescaled
result bitwise equal (the same float32 operations in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu_torch.ops import grouped_matmul as gm

torch.set_num_threads(1)

SMS = 132  # an H100 SXM


@pytest.mark.parametrize("rows,groups,k,n,want", [
    (64, 128, 2048, 768, (1, 4)),     # qwen3 decode wi: 302 working blocks fit three an SM
    (64, 128, 768, 2048, (1, 3)),     # qwen3 decode wo: 805 working blocks, past them
    (256, 128, 2048, 768, (1, 3)),    # qwen3 at 32 slots: 664
    (16, 8, 4096, 14336, (1, 3)),     # mixtral decode wi
    (16, 8, 14336, 4096, (1, 3)),     # mixtral decode wo: a long K takes the shallow ring
    (48, 64, 2048, 1408, (1, 4)),     # deepseek decode wi: 370
    (48, 64, 1408, 2048, (1, 3)),     # deepseek decode wo: 537
    (8, 16, 5120, 8192, (1, 3)),      # llama4 decode wi
    (8, 16, 8192, 5120, (1, 3)),      # llama4 decode wo
    (8, 128, 2048, 768, (2, 4)),      # 8 rows over 128 experts: 48 blocks, K split in 2
    (8, 128, 2048, 128, (4, 4)),      # 8 blocks: 4 splits of at least 512 of K
    (8, 128, 512, 128, (1, 4)),       # K of one 512-deep split
    (8, 128, 528, 128, (2, 4)),       # K just past it: the second split a 16-deep stage
    (100, 24, 2064, 144, (2, 3)),     # the split-edges case: K 2064 past the short-K ring
    (102, 14, 528, 208, (2, 4)),
    (16384, 128, 2048, 768, (0, 0)),  # qwen3 prefill: the persistent kernel
    (32 * 8, 8, 4096, 14336, (0, 0)),  # exactly 32 rows a group
])
def test_int8_plan(rows, groups, k, n, want):
    assert gm.int8_plan(rows, groups, k, n, sms=SMS) == want


@pytest.mark.parametrize("k", [16, 128, 144, 512, 528, 2048, 2056, 2064, 14336])
@pytest.mark.parametrize("n", [16, 128, 144, 768])
@pytest.mark.parametrize("rows,groups", [(1, 64), (8, 128), (31, 1), (100, 24), (17, 3)])
def test_int8_plan_never_leaves_a_split_empty(k, n, rows, groups):
    k = -(-k // 16) * 16  # the kernel's K: a multiple of 16
    splits, stages = gm.int8_plan(rows, groups, k, n, sms=SMS)
    assert 1 <= splits <= gm.MAX_SPLITS and stages in (3, 4)
    per_split = -(-(-(-k // 128)) // splits) * 128  # the kernel's own split of K
    assert (splits - 1) * per_split < k <= splits * per_split
    blocks = gm.few_row_tiles(rows, groups) * -(-n // gm.FEW_COLS)
    assert splits == 1 or blocks * splits <= SMS  # a split only while SMs would idle
    assert splits <= -(-k // gm.INT8_SPLIT_MIN_DEPTH)  # each split about 512 of K at least


@pytest.mark.parametrize("groups", [1, 8, 128])
def test_int8_plan_regimes_meet_at_32_rows_a_group(groups):
    assert gm.int8_plan(32 * groups, groups, 2048, 768, sms=SMS) == (0, 0)
    assert gm.int8_plan(32 * groups - 1, groups, 2048, 768, sms=SMS)[0] >= 1
    assert gm.tile_rows(32 * groups, groups) == 64 and gm.tile_rows(32 * groups - 1, groups) == 16


@pytest.mark.parametrize("rows,groups,want", [
    (8192, 128, 64),     # qwen3's parity step: 64 rows a group
    (127 * 64, 64, 64),
    (128 * 64, 64, 128),  # 128 rows a group
    (24576, 64, 128),    # deepseek's training step: 384
    (24, 128, 64),       # decode-sized: fewer rows than groups
    (1000, 1, 128),
])
def test_f32_tile_rows(rows, groups, want):
    assert gm.f32_tile_rows(rows, groups) == want


# (group sizes, K, N)
INT8_EDGES = {
    "groups_of_0_to_17_rows": ([1, 0, 3, 16, 17, 0, 5, 2, 8, 15, 1, 0, 17, 4], 2056, 48),
    "one_group_holds_all": ([0, 0, 203, 0], 2056, 32),
    "many_rows_tile_edges": ([1, 63, 65, 0, 127, 129], 136, 40),
}


@pytest.mark.parametrize("case", sorted(INT8_EDGES))
def test_int8_plain_matches_the_jax_int8_experts_at_the_kernel_edges(case):
    sizes, k, n = INT8_EDGES[case]
    rng = np.random.default_rng(21 + len(case))
    r, g = int(sum(sizes)), len(sizes)
    xq = rng.integers(-127, 128, size=(r, k)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(g, k, n)).astype(np.int8)
    rs = rng.uniform(0.5, 1.5, size=(r, 1)).astype(np.float32) / 127
    ws = rng.uniform(0.5, 1.5, size=(g, 1, n)).astype(np.float32) / (127 * k)
    sums = jax.lax.ragged_dot(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(sizes, jnp.int32),
                              preferred_element_type=jnp.int32)
    group_of = np.repeat(np.arange(g), sizes)
    scaled = (sums.astype(jnp.float32) * jnp.asarray(rs)
              * jnp.take(jnp.asarray(ws)[:, 0], jnp.asarray(group_of), axis=0))
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32)
    before = dict(gm.launch_counts)
    got_sums = gm.grouped_matmul_int8(torch.from_numpy(xq), torch.from_numpy(wq), offsets)
    np.testing.assert_array_equal(got_sums.numpy(), np.asarray(sums))
    got = gm.grouped_matmul_int8(torch.from_numpy(xq), torch.from_numpy(wq), offsets,
                                 torch.from_numpy(rs), torch.from_numpy(ws))
    assert got.dtype == torch.bfloat16
    want = np.asarray(scaled.astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert gm.launch_counts == before  # the CPU takes the plain version
