"""The float32 grouped products against ``jax.lax.ragged_dot``, on the CPU.

On the card, float32 operands of ``ops/grouped_matmul`` run the CUDA-core
kernels of ``csrc/grouped_matmul_f32.cu`` (the forward, dgrad and wgrad);
here, on the CPU, the wrappers take their plain versions, which those
kernels are held to on the card. This file holds the plain versions to the
JAX package's arithmetic: ``ragged_dot(x, w, group_sizes,
preferred_element_type=float32)`` on float32 operands and the two products
of its ``jax.vjp`` (dx and dw), with empty groups, one group holding every
row, skewed rows and groups of 1, 63, 65, 127 and 129 rows (either side of
the kernels' 64-row tiles). The group bounds go to the port as ``offsets``
[G + 1] int32, to JAX as group sizes.

Tolerance: 2e-5 of max(1, max |JAX value|): the same exact float32 products,
summed in another order. Nothing here runs a kernel (the launch counts stay).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu_torch.ops import grouped_matmul as gm

torch.set_num_threads(1)

TOL_F32 = 2e-5

# (group sizes, K, N)
CASES = {
    "ragged": ([5, 0, 9, 3, 0, 7], 48, 40),
    "empty_groups": ([0, 0, 24, 0, 0, 0, 0, 0], 64, 32),
    "one_group_holds_all": ([0, 0, 0, 37, 0], 40, 24),
    "skewed_rows": ([61, 2, 0, 1, 44, 0, 0, 3], 72, 56),
    "tile_edges": ([1, 63, 65, 0, 127, 129], 24, 20),
}


def _data(sizes, k, n, seed):
    rng = np.random.default_rng(seed)
    r, g = int(sum(sizes)), len(sizes)
    x = rng.normal(size=(r, k)).astype(np.float32)
    w = (rng.normal(size=(g, k, n)) / np.sqrt(k)).astype(np.float32)
    c = rng.normal(size=(r, n)).astype(np.float32)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32)
    return x, w, c, offsets


def _jax(x, w, c, sizes):
    def f(a, b):
        return jax.lax.ragged_dot(a, b, jnp.asarray(sizes, jnp.int32),
                                  preferred_element_type=jnp.float32)

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(c))
    return {"y": np.asarray(y), "dx": np.asarray(dx), "dw": np.asarray(dw)}


def _close(got: torch.Tensor, want: np.ndarray, what: str):
    assert got.dtype == torch.float32, what
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=TOL_F32 * max(1.0, float(np.abs(want).max())), err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_products_match_ragged_dot_and_its_vjp(case):
    sizes, k, n = CASES[case]
    x, w, c, offsets = _data(sizes, k, n, seed=len(case))
    want = _jax(x, w, c, sizes)
    tx, tw, tc = (torch.from_numpy(t) for t in (x, w, c))
    before = dict(gm.launch_counts)
    _close(gm.grouped_matmul(tx, tw, offsets), want["y"], f"{case} y")
    _close(gm.grouped_matmul_dgrad(tc, tw, offsets), want["dx"], f"{case} dx")
    dw = gm.grouped_matmul_wgrad(tx, tc, offsets)
    _close(dw, want["dw"], f"{case} dw")
    assert gm.launch_counts == before  # the CPU takes the plain versions: no launch
    empty = torch.tensor(sizes) == 0
    if bool(empty.any()):  # an empty group's weight gradient is zero
        assert (dw[empty] == 0).all()


@pytest.mark.parametrize("case", ["ragged", "skewed_rows"])
def test_autograd_function_in_float32_matches_jax_vjp(case):
    """``GroupedMatmul``'s backward (dgrad and wgrad) on float32 operands:
    the gradients' dtype stays float32, as ``jax.vjp`` gives it."""
    sizes, k, n = CASES[case]
    x, w, c, offsets = _data(sizes, k, n, seed=7)
    want = _jax(x, w, c, sizes)
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    y = gm.grouped_matmul(tx, tw, offsets)
    assert type(y.grad_fn).__name__ == "GroupedMatmulBackward"
    y.backward(torch.from_numpy(c))
    _close(y, want["y"], "y")
    _close(tx.grad, want["dx"], "dx")
    _close(tw.grad, want["dw"], "dw")


def test_float32_counts_are_kernels_of_their_own():
    """The three float32 products count their launches apart from the bf16
    kernels', one count each, and name the kernel's mode."""
    names = ("grouped_matmul_f32", "grouped_matmul_f32_dgrad", "grouped_matmul_f32_wgrad")
    assert all(name in gm.launch_counts for name in names)
    assert [gm._F32_MODES[name] for name in names] == [0, 1, 2]


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_other_dtypes_still_refused_by_the_kernel_route(dtype):
    """The CUDA route takes bfloat16 and float32 and raises on anything else
    before it reaches a kernel (checked through the backward's gate, which
    needs no card)."""
    t = torch.zeros((4, 8), dtype=dtype)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        gm._bwd_kernel_ready((t, t), "grouped_matmul_dgrad", 8, 8)
