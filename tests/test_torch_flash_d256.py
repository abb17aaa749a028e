"""Flash attention (K9-K11) at head dim 256, the flagship's, against the JAX package.

The JAX kernels take any head dim (their blocks span the whole head); the
port's CUDA kernels are built for D in ``HEAD_DIMS`` = (64, 128, 256). On the
CPU the port's wrappers take their plain versions, which are width-agnostic;
the JAX side runs its Pallas kernels in interpret mode, forward and
``jax.vjp``. Both get the same numpy-made q, k, v, positions, segment ids and
output cotangent at D = 256, 4 query / 2 kv heads, S = 256 (two 128-row
blocks), in the flagship's training masks: causal, packed documents with a
segment-0 tail, a sliding window, chunks, and a soft cap. o, lse, dq, dk and
dv are compared.

Tolerances, those of ``tests/test_torch_flash_attention.py`` (the two sides
differ in summation order, and in bfloat16 in the max that the unnormalised
probabilities are rounded against): float32 2e-5 on o and lse, 5e-4 on the
gradients; bfloat16 2e-2 on o, 6e-2 on the gradients (a few bfloat16 steps
at |g| of a few units; a sum over D = 256 instead of 64 scales the logits,
not their relative rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.ops import flash_attention as jfa
from maxtext_indextts2_tpu_torch.ops import flash_attention as tfa

from test_torch_flash_attention import (
    TOL_BF16,
    TOL_BF16_GRAD,
    TOL_F32,
    TOL_F32_GRAD,
    _inputs,
    _jax_side,
    _torch_side,
)

torch.set_num_threads(1)

D = 256
SHAPE = dict(B=1, H=4, HKV=2, S=256, D=D)
CASES = {
    "causal": dict(seg="none"),
    "packed": dict(seg="packed"),
    "sliding64": dict(seg="none", sliding_window=64),
    "chunk128_softcap30": dict(seg="pad200", chunk_size=128, soft_cap=30.0),
    "softcap20": dict(seg="pad200", soft_cap=20.0),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_flash_attention_at_d256_matches_jax_kernels(name, dtype):
    case = dict(CASES[name])
    mask_kw = {k: case.pop(k) for k in ("sliding_window", "chunk_size", "soft_cap") if k in case}
    q, k, v, g, pos, seg = _inputs(**SHAPE, seed=7, **case)
    want = _jax_side(q, k, v, g, pos, seg, dtype, mask_kw, block=128)
    got = _torch_side(q, k, v, g, pos, seg, dtype, mask_kw)
    tol = (TOL_F32, TOL_F32_GRAD) if dtype == torch.float32 else (TOL_BF16, TOL_BF16_GRAD)
    for what, a, b, t in zip(("o", "dq", "dk", "dv"), got, want, (tol[0],) + (tol[1],) * 3):
        assert a.shape == b.shape and a.shape[-1] == D, what
        assert np.isfinite(a).all(), what
        np.testing.assert_allclose(a, b, atol=t, rtol=0, err_msg=what)


@pytest.mark.parametrize("name", ["causal", "packed", "chunk128_softcap30"])
def test_forward_lse_at_d256_matches_the_jax_kernel(name):
    case = dict(CASES[name])
    mask = (case.pop("sliding_window", 0), case.pop("chunk_size", 0), case.pop("soft_cap", 0.0))
    q, k, v, _, pos, seg = _inputs(**SHAPE, seed=8, **case)
    o, lse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                            jnp.asarray(pos), jnp.asarray(seg), jnp.asarray(seg), True, *mask,
                            1.0 / np.sqrt(D), 128, 128)
    to, tlse = tfa.flash_fwd(*(torch.tensor(x) for x in (q, k, v, pos, pos, seg, seg)),
                             True, *mask)
    np.testing.assert_allclose(to.numpy(), np.asarray(o), atol=TOL_F32, rtol=0)
    valid = np.broadcast_to((seg != 0)[:, None, :, None], lse.shape)
    np.testing.assert_allclose(tlse.numpy()[valid], np.asarray(lse)[valid], atol=TOL_F32,
                               rtol=0)
    assert np.isneginf(tlse.numpy()[~valid]).all()


@pytest.mark.parametrize("d,ok", [(64, True), (128, True), (256, True), (96, False),
                                  (192, False), (512, False)])
def test_kernel_route_takes_the_built_head_dims_and_names_them(d, ok):
    """The CUDA route's shape check: D in HEAD_DIMS passes, any other width
    raises with the list (the plain version, the CPU's route, takes any)."""
    assert tfa.HEAD_DIMS == (64, 128, 256)
    q = torch.zeros((1, 16, 4, d), dtype=torch.bfloat16).transpose(1, 2)
    k = torch.zeros((1, 16, 2, d), dtype=torch.bfloat16).transpose(1, 2)
    if ok:
        assert tfa._kernel_args(q, k, k) == (1, 4, 2, 16, 16, d)
    else:
        with pytest.raises(ValueError, match=r"head dim \d+ not in \(64, 128, 256\)"):
            tfa._kernel_args(q, k, k)
