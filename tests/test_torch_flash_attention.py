"""The PyTorch package's flash attention (K9-K11) against the JAX package's.

On the CPU the port's wrappers take their plain versions (the materialised
masked softmax with the kernels' rounding points); the JAX side runs its
Pallas kernels in interpret mode, forward and ``jax.grad``. Both get the
same numpy-made q, k, v, positions, segment ids and output cotangent, in
the mask variants of the JAX package's own flash tests.

Tolerances. float32: 2e-5 on the outputs and 5e-4 on the gradients, the
JAX package's own test's (there: kernel against the einsum reference); the
two sides differ only in summation order. bfloat16: the JAX kernel rounds
its unnormalised probabilities against a running max over 128-wide blocks,
the plain version against the row's max, so the outputs may differ by one
bfloat16 step (2**-7 at |o| < 1, 2**-6 below 2): 2e-2; the gradients are
float32 sums of such products rounded to bfloat16 at |g| of a few units:
6e-2 (a few steps). The JAX kernel needs S to be a multiple of its block, so
the S = 200 case runs it with 40-row blocks.
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
TOL_BF16, TOL_BF16_GRAD = 2e-2, 6e-2


def _inputs(B=2, H=4, HKV=2, S=256, D=64, seed=0, seg="pad200"):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = rng.normal(size=(B, HKV, S, D)).astype(np.float32)
    v = rng.normal(size=(B, HKV, S, D)).astype(np.float32)
    g = rng.normal(size=(B, H, S, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    if seg == "pad200":  # a segment-0 padding tail, as in the JAX package's test
        segs = np.where(np.arange(S) < min(200, S - 8), 1, 0).astype(np.int32)
    elif seg == "packed":  # two documents, then padding
        segs = np.concatenate([np.full(S // 2, 1), np.full(S // 2 - 16, 2),
                               np.zeros(16)]).astype(np.int32)
    else:
        segs = np.ones(S, np.int32)
    return q, k, v, g, pos, np.broadcast_to(segs, (B, S)).copy()


def _jax_side(q, k, v, g, pos, seg, dtype, kw, block):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    args = dict(causal=kw.get("causal", True), sliding_window=kw.get("sliding_window", 0),
                chunk_size=kw.get("chunk_size", 0), soft_cap=kw.get("soft_cap", 0.0))
    jq, jk, jv, jg = (jnp.asarray(x).astype(jdt) for x in (q, k, v, g))
    jp, js = jnp.asarray(pos), jnp.asarray(seg)

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, jp, jp, js, js, args["causal"],
                                   args["sliding_window"], args["chunk_size"], args["soft_cap"],
                                   None, block, block)

    o, vjp = jax.vjp(f, jq, jk, jv)
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *vjp(jg))]


def _torch_side(q, k, v, g, pos, seg, dtype, kw):
    tq, tk, tv = (torch.tensor(x).to(dtype).requires_grad_(True) for x in (q, k, v))
    tp, ts = torch.tensor(pos), torch.tensor(seg)
    o = tfa.flash_attention(tq, tk, tv, tp, tp, ts, ts, kw.get("causal", True),
                            kw.get("sliding_window", 0), kw.get("chunk_size", 0),
                            kw.get("soft_cap", 0.0))
    o.backward(torch.tensor(g).to(dtype))
    return [x.detach().float().numpy() for x in (o, tq.grad, tk.grad, tv.grad)]


CASES = {
    "default": dict(),
    "sliding32": dict(sliding_window=32),
    "chunk64": dict(chunk_size=64),
    "softcap20": dict(soft_cap=20.0),
    "noncausal": dict(causal=False),
    "packed_segments": dict(seg="packed"),
    "no_padding_gqa_4_2": dict(seg="none"),
    "mha_4_4": dict(HKV=4),
    "s200_ragged_tail": dict(S=200),
    "d128_group4": dict(H=4, HKV=1, S=128, D=128),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_flash_attention_matches_jax_kernels(name, dtype):
    """Forward and the three gradients; padding rows (segment 0) included:
    o = 0 and zero gradients there on both sides."""
    case = dict(CASES[name])
    mask_kw = {k: case.pop(k) for k in ("sliding_window", "chunk_size", "soft_cap", "causal")
               if k in case}
    q, k, v, g, pos, seg = _inputs(**case)
    # the JAX kernel needs S to be a multiple of its block (a ragged last block
    # reads past the arrays: NaN in interpret mode), the port takes any S
    block = 128 if q.shape[2] % 128 == 0 else 40
    want = _jax_side(q, k, v, g, pos, seg, dtype, mask_kw, block=block)
    got = _torch_side(q, k, v, g, pos, seg, dtype, mask_kw)
    tol = (TOL_F32, TOL_F32_GRAD) if dtype == torch.float32 else (TOL_BF16, TOL_BF16_GRAD)
    for what, a, b, t in zip(("o", "dq", "dk", "dv"), got, want, (tol[0],) + (tol[1],) * 3):
        assert a.shape == b.shape, what
        assert np.isfinite(a).all(), what
        np.testing.assert_allclose(a, b, atol=t, rtol=0, err_msg=what)
    if case.get("seg", "pad200") != "none":
        pad = seg == 0
        assert (got[0].transpose(0, 2, 1, 3)[pad] == 0).all(), "padding rows give o = 0"
        assert (got[1].transpose(0, 2, 1, 3)[pad] == 0).all(), "and dq = 0"


def test_forward_lse_matches_the_jax_kernel_and_is_minus_inf_on_padding():
    q, k, v, _, pos, seg = _inputs(S=200)
    o, lse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                            jnp.asarray(pos), jnp.asarray(seg), jnp.asarray(seg), True, 0, 0,
                            0.0, 1.0 / np.sqrt(64), 40, 40)
    to, tlse = tfa.flash_fwd(*(torch.tensor(x) for x in (q, k, v, pos, pos, seg, seg)))
    assert tuple(tlse.shape) == lse.shape == (2, 4, 200, 1)
    np.testing.assert_allclose(to.numpy(), np.asarray(o), atol=TOL_F32, rtol=0)
    valid = np.broadcast_to((seg != 0)[:, None, :, None], lse.shape)
    np.testing.assert_allclose(tlse.numpy()[valid], np.asarray(lse)[valid], atol=TOL_F32,
                               rtol=0)
    assert np.isneginf(tlse.numpy()[~valid]).all() and np.isneginf(np.asarray(lse)[~valid]).all()


def test_sharded_entry_takes_the_model_layout():
    """``flash_attention_sharded`` on one device: [B,S,N,D] in and out, no
    segment ids means one segment, as the JAX package's single-device branch."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 96, 4, 64)).astype(np.float32)
    k = rng.normal(size=(2, 96, 2, 64)).astype(np.float32)
    v = rng.normal(size=(2, 96, 2, 64)).astype(np.float32)
    want = jfa.flash_attention_sharded(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                                       block_q=32, block_kv=32)
    got = tfa.flash_attention_sharded(torch.tensor(q), torch.tensor(k), torch.tensor(v), None)
    assert tuple(got.shape) == (2, 96, 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_F32, rtol=0)
    with pytest.raises(NotImplementedError, match="port queue: 6"):
        tfa.flash_attention_sharded(torch.tensor(q), torch.tensor(k), torch.tensor(v), None,
                                    algorithm="ring")


@pytest.mark.parametrize("cp", [1, 2, 4])
def test_load_balanced_reorder_matches_jax_and_inverts(cp):
    x = np.arange(2 * 64 * 3).reshape(2, 64, 3)
    got = tfa.load_balanced_reorder(torch.tensor(x), cp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfa.load_balanced_reorder(
        jnp.asarray(x), cp)))
    np.testing.assert_array_equal(tfa.load_balanced_inverse(got, cp).numpy(), x)


def test_kernel_route_raises_on_what_it_cannot_take(monkeypatch):
    """Routed to the kernel, a wrapper checks head dim, group and strides and
    raises; it never hands such tensors to the plain version."""
    from maxtext_indextts2_tpu_torch.ops import _build

    def no_build(*a, **k):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tfa, "route", lambda *a, **k: "cuda")
    monkeypatch.setattr(_build, "load_library", no_build)
    ids = (torch.zeros((1, 8), dtype=torch.int32),) * 4
    with pytest.raises(ValueError, match="head dim 48"):
        tfa.flash_fwd(torch.ones((1, 2, 8, 48)), torch.ones((1, 1, 8, 48)),
                      torch.ones((1, 1, 8, 48)), *ids)
    with pytest.raises(ValueError, match="group 3"):
        tfa.flash_fwd(torch.ones((1, 3, 8, 64)), torch.ones((1, 1, 8, 64)),
                      torch.ones((1, 1, 8, 64)), *ids)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tfa.flash_fwd(torch.ones((1, 2, 8, 64)), torch.ones((1, 1, 8, 64)),
                      torch.ones((1, 1, 8, 64)), *ids)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_fwd(torch.ones((1, 2, 8, 64), dtype=torch.float16),
                      torch.ones((1, 1, 8, 64)), torch.ones((1, 1, 8, 64)), *ids)
    with pytest.raises(ValueError, match="CUDA device"):
        monkeypatch.undo()
        tfa.flash_fwd(torch.ones((1, 2, 8, 64)), torch.ones((1, 1, 8, 64)),
                      torch.ones((1, 1, 8, 64)), *ids, impl="cuda")


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("which", ["q", "k", "v", "do"])
@pytest.mark.parametrize("fault", ["start", "stride"])
def test_kernel_args_refuse_bf16_rows_that_are_not_16_byte_pieces(which, fault):
    """The bfloat16 kernels copy rows 16 bytes at a time (cp.async): the
    wrapper raises on an operand whose start is not 16-byte aligned or whose
    batch, sequence or head stride is not a multiple of 8 elements, and takes
    the model's [B, S, N, D] projection views."""
    b, h, hkv, s, d = 2, 4, 2, 16, 64
    ops = {"q": _bf16(b, s, h, d).transpose(1, 2), "k": _bf16(b, s, hkv, d).transpose(1, 2),
           "v": _bf16(b, s, hkv, d).transpose(1, 2), "do": _bf16(b, s, h, d).transpose(1, 2)}
    assert tfa._kernel_args(ops["q"], ops["k"], ops["v"], ops["do"]) == (b, h, hkv, s, s, d)
    shape = ops[which].shape
    if fault == "start":  # one element into the allocation: 2 bytes off
        bad = _bf16(ops[which].numel() + 1)[1:].view(shape)
    else:  # rows padded to d + 4 elements: a sequence stride of 68
        bad = _bf16(shape[0], shape[1], shape[2], d + 4)[..., :d]
    ops[which] = bad
    with pytest.raises(ValueError, match="16-byte"):
        tfa._kernel_args(ops["q"], ops["k"], ops["v"], ops["do"])
    # float32 operands keep the scalar loads of the CUDA-core kernels: any start
    f32 = {n: torch.zeros(t.numel() + 1)[1:].view(t.shape) for n, t in ops.items()}
    assert f32[which].data_ptr() % 16
    tfa._kernel_args(f32["q"], f32["k"], f32["v"], f32["do"])
