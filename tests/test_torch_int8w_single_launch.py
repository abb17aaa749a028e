"""``int8w_matmul``'s single-launch design, on the CPU.

On the card the bfloat16 path runs one launch of ``csrc/int8w_matmul.cu``
whose K axis ``split_plan`` splits over a cluster of blocks (the partial sums
merged in distributed shared memory). Here the wrapper takes its plain
version, which the kernel is held to on the card; this file holds that plain
version to the JAX package's ``DenseGeneral._serve_quantized``
(``models/layers.py:168-174``: ``dot(x.astype(bf16), kernel.astype(bf16) *
scale.astype(bf16), preferred_element_type=float32).astype(bf16)``, then the
bias) at the new shapes' edges: M = 1, 160 (the speculative verify span) and
256 (``KERNEL_MAX_ROWS``), N = 1001 with a bias, K no multiple of a stage;
and the host rules (``split_plan``, the rows a block) on their boundaries.

Tolerance: bfloat16 within one bfloat16 step of the output's largest entry,
2**-7 of it (both round one float32 sum, taken in another order, so an entry
may land one step apart; a step is 2**-8 to 2**-7 of the entry, the bound
``ops/smoke.py`` holds the kernel to), float32 within 1e-6 of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.models.layers import DenseGeneral as JaxDense
from maxtext_indextts2_tpu_torch.models.layers import DenseGeneral
from maxtext_indextts2_tpu_torch.ops import int8w_matmul as iw

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k,n,bias", [
    (1, 64, 40, False),
    (160, 96, 56, False),
    (256, 64, 48, True),
    (32, 80, 1001, True),
    (8, 200, 72, False),   # K no multiple of a 128- or 256-row stage
], ids=["m1", "m160_verify", "m256", "n1001_bias", "k_not_a_stage"])
def test_plain_matches_serve_quantized(m, k, n, bias, dtype):
    rng = np.random.default_rng(m + k + n)
    kernel = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    scale = (rng.uniform(0.5, 2, size=(1, n)) / 127).astype(np.float32)
    params = {"kernel": kernel, "kernel_scale": scale}
    if bias:
        params["bias"] = rng.normal(size=(n,)).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    jdt = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[dtype]
    tdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    jm = JaxDense(features=(n,), axis=(-1,), quantization="int8w_serve", dtype=jdt, use_bias=bias)
    want = jax.jit(jm.apply)({"params": {kk: jnp.asarray(v) for kk, v in params.items()}},
                             jnp.asarray(x).astype(jdt))
    want = np.asarray(want.astype(jnp.float32))
    tm = DenseGeneral((k,), (n,), axis=(-1,), quantization="int8w_serve", dtype=tdt,
                      use_bias=bias)
    tm.load_state_dict({kk: torch.from_numpy(v) for kk, v in params.items()})
    before = iw.launch_count
    with torch.no_grad():
        got = tm(torch.from_numpy(x).to(tdt))
    assert iw.launch_count == before  # the CPU takes the plain version
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())
    # the wrapper on the same operands is the plain version, bit for bit
    direct = iw.int8w_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(kernel),
                             torch.from_numpy(scale),
                             torch.from_numpy(params["bias"]) if bias else None)
    assert torch.equal(direct, got.reshape(direct.shape))


@pytest.mark.parametrize("m,want", [(1, 16), (16, 16), (17, 32), (32, 32), (33, 64),
                                    (64, 64), (160, 64), (256, 64)])
def test_rows_a_block(m, want):
    assert iw._rows_a_block(m, torch.bfloat16) == want
    assert iw._rows_a_block(m, torch.float32) == (8 if m <= 8 else 16)


@pytest.mark.parametrize("m,k,n,want", [
    (32, 2048, 8192, (2, 1024)),    # tts-1b's main path: 64 tiles, split by 132 // 64
    (32, 2048, 2048, (8, 256)),     # 16 tiles: the cluster's limit of 8
    (8, 3840, 15360, (1, 3840)),    # the flagship: 120 tiles, no split
    (8, 15360, 3840, (4, 3840)),
    (160, 2048, 8192, (1, 2048)),   # the verify span: 3 row blocks x 64 tiles
    (256, 2048, 2048, (2, 1024)),   # 4 row blocks x 16 tiles
    (256, 256, 2048, (1, 256)),     # K of one 256-row split
    (1, 257, 128, (2, 256)),        # K just past it
    (7, 200, 77, (1, 256)),
    (8, 3840, 4096, (3, 1280)),     # 15 stages, at most 4 splits: the even 3, not 4
    (8, 3840, 2048, (5, 768)),      # at most 8: the even 5
    (8, 1792, 2048, (7, 256)),      # 7 stages, at most 8: all 7
    (8, 1792, 4096, (4, 512)),      # 7 stages, at most 4: no even count >= 2, so 4
])
def test_split_plan(m, k, n, want):
    assert iw.split_plan(m, k, n, sms=132) == want


@pytest.mark.parametrize("k", [1, 200, 256, 257, 2000, 2048, 3840, 15360])
@pytest.mark.parametrize("m,n", [(1, 128), (8, 1001), (32, 8192), (160, 2048), (256, 4096)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_plan_fills_k_with_no_empty_split(k, m, n, dtype):
    splits, per_split = iw.split_plan(m, k, n, sms=132, dtype=dtype)
    assert 1 <= splits <= iw.MAX_SPLITS and per_split % 256 == 0
    assert (splits - 1) * per_split < k <= splits * per_split
    tiles = -(-n // 128) * -(-m // iw._rows_a_block(m, dtype))
    assert splits == 1 or tiles * splits <= 132  # one block an SM at most


def test_wrapper_refuses_a_kernel_off_the_card():
    x = torch.ones((160, 64), dtype=torch.bfloat16)
    q = torch.ones((64, 1001), dtype=torch.int8)
    s = torch.full((1001,), 0.01)
    before = iw.launch_count
    with pytest.raises(ValueError, match="one CUDA device"):
        iw.int8w_matmul(x, q, s, impl="cuda")
    assert iw.launch_count == before
    assert torch.equal(iw.int8w_matmul(x, q, s), iw.int8w_matmul_plain(x, q, s))
    assert iw.launch_count == before
