"""Flash attention (K9-K11) at the GQA groups of the other presets, on the CPU.

The presets the port builds include group 5 (qwen3-14b and the llama4
models: 40 query / 8 kv heads), group 6 (mixtral-8x22b: 48 / 8) and group
16 (llama3-405b: 128 / 8). The kernels take the group from H / Hkv at run
time, so the CUDA route's shape check takes any group that divides H and
refuses only one that does not. The port's plain route (what the CPU runs)
is held against the JAX package's ``flash_attention`` at those groups,
forward and the three gradients, with the JAX Pallas kernels in interpret
mode, as ``tests/test_torch_flash_attention.py`` does at groups 1-8.

Tolerances, as there: float32, 2e-5 on the output and 5e-4 on the
gradients (only the summation order differs). Nothing here runs a kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.ops import flash_attention as jfa
from maxtext_indextts2_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

TOL_F32, TOL_F32_GRAD = 2e-5, 5e-4

# (query heads, kv heads): groups 5, 6 and 16 at a few kv heads
GROUP_SHAPES = {"group5": (10, 2), "group6": (12, 2), "group16": (16, 1)}


def _inputs(h, hkv, seed, b=2, s=128, d=64, seg="pad"):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, s, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    g = rng.normal(size=(b, h, s, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    if seg == "packed":  # two documents, then a segment-0 padding tail
        segs = np.concatenate([np.full(s // 2, 1), np.full(s // 2 - 16, 2), np.zeros(16)])
    else:  # one document, then padding
        segs = np.where(np.arange(s) < s - 24, 1, 0)
    return q, k, v, g, pos, np.broadcast_to(segs.astype(np.int32), (b, s)).copy()


def _jax(q, k, v, g, pos, seg, causal):
    jp, js = jnp.asarray(pos), jnp.asarray(seg)

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, jp, jp, js, js, causal, 0, 0, 0.0, None, 128, 128)

    o, vjp = jax.vjp(f, *(jnp.asarray(t) for t in (q, k, v)))
    return [np.asarray(t) for t in (o, *vjp(jnp.asarray(g)))]


def _port(q, k, v, g, pos, seg, causal):
    tq, tk, tv = (torch.tensor(t).requires_grad_(True) for t in (q, k, v))
    tp, ts = torch.tensor(pos), torch.tensor(seg)
    o = tfa.flash_attention(tq, tk, tv, tp, tp, ts, ts, causal, 0, 0, 0.0)
    o.backward(torch.tensor(g))
    return [t.detach().numpy() for t in (o, tq.grad, tk.grad, tv.grad)]


@pytest.mark.parametrize("seg,causal", [("pad", True), ("packed", True), ("pad", False)],
                         ids=["causal", "packed", "noncausal"])
@pytest.mark.parametrize("group", list(GROUP_SHAPES))
def test_plain_route_matches_jax_kernels_at_group(group, seg, causal):
    h, hkv = GROUP_SHAPES[group]
    q, k, v, g, pos, segs = _inputs(h, hkv, seed=h + hkv, seg=seg)
    want = _jax(q, k, v, g, pos, segs, causal)
    got = _port(q, k, v, g, pos, segs, causal)
    for what, a, b, tol in zip(("o", "dq", "dk", "dv"), got, want,
                               (TOL_F32, TOL_F32_GRAD, TOL_F32_GRAD, TOL_F32_GRAD)):
        assert a.shape == b.shape, what
        assert np.isfinite(a).all(), what
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=f"{group} {what}")


@pytest.mark.parametrize("h,hkv", [(40, 8), (48, 8), (128, 8), (10, 2), (12, 2), (16, 1),
                                   (3, 1), (7, 7)])
def test_kernel_args_take_every_group_that_divides_h(h, hkv):
    q = torch.zeros((1, h, 16, 128))
    k = torch.zeros((1, hkv, 16, 128))
    assert tfa._kernel_args(q, k, k) == (1, h, hkv, 16, 16, 128)


@pytest.mark.parametrize("h,hkv", [(10, 4), (40, 16), (12, 5)])
def test_kernel_args_refuse_a_group_that_does_not_divide_h(h, hkv):
    q = torch.zeros((1, h, 16, 128))
    k = torch.zeros((1, hkv, 16, 128))
    with pytest.raises(ValueError, match="do not split into groups"):
        tfa._kernel_args(q, k, k)
