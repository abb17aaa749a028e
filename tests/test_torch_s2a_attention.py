"""K12, the S2A sampler's attention (``ops/s2a_attention.py``), on the CPU:
its plain PyTorch version against the JAX package's Pallas kernel in
interpret mode, the denoiser's fixed-length route through it against the
JAX package, and the wrapper's routing.

Tolerances, and why: float32 results sum in another order: atol 3e-5 on
O(1) outputs (the JAX package's own test of its kernel uses 3e-5). bfloat16:
both sides compute float32 logits and round the normalised probabilities and
the output to bfloat16, and a probability whose float32 value straddles a
rounding boundary moves by one bfloat16 step: atol 2e-2 (one step is 2**-8 of
|out| <= 4; the JAX test allows 0.03). The float32 denoiser (2 layers) against
the JAX einsum path: atol 2e-5, as the other float32 modules of the S2A port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_audio_helpers as h
from maxtext_indextts2_tpu.ops.s2a_attention import s2a_attention as jax_s2a_attention
from maxtext_indextts2_tpu_torch.ops import _build
from maxtext_indextts2_tpu_torch.ops import s2a_attention as k12

# tiny shapes: one thread is enough, and the cores stay free for the other test workers
torch.set_num_threads(1)

ATOL = {"float32": 3e-5, "bfloat16": 2e-2}
ATOL_DENOISER_F32 = 2e-5
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(dtype, b, s, n=4, d=64, seed=1):
    """Seeded q (scale folded in), k, v as numpy float32 arrays already
    rounded to ``dtype``, so both packages start from the same values."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, s, n, d)).astype(np.float32) for _ in range(3)]
    arrs[0] /= np.sqrt(d)
    return [np.array(jnp.asarray(a).astype(JDT[dtype]).astype(jnp.float32)) for a in arrs]


def _both(dtype, q, k, v, variant=None):
    want = jax_s2a_attention(*(jnp.asarray(a).astype(JDT[dtype]) for a in (q, k, v)),
                             interpret=True, variant=variant)
    got = k12.s2a_attention(*(torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v)))
    assert got.dtype == TDT[dtype] and got.shape == q.shape and got.is_contiguous()
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dtype,b,s", [
    ("float32", 2, 128), ("float32", 2, 70), ("bfloat16", 2, 130), ("float32", 5, 1),
    ("bfloat16", 3, 63)], ids=["f32_s128", "f32_s70", "bf16_s130", "f32_b5_s1", "bf16_b3_s63"])
def test_plain_version_matches_the_pallas_kernel(dtype, b, s):
    got, want = _both(dtype, *_qkv(dtype, b, s, seed=s))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("variant", ["heads", "bn"])
def test_plain_version_matches_both_tilings_of_the_pallas_kernel(variant):
    got, want = _both("float32", *_qkv("float32", 2, 70, seed=3), variant=variant)
    np.testing.assert_allclose(got, want, atol=ATOL["float32"], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_takes_strided_views_of_one_projection(dtype):
    """q, k, v as views of one [B, S, 3*N*D] tensor, as the denoiser's qkv
    product gives them: the same result as contiguous copies."""
    b, s, n, d = 2, 45, 4, 64
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.normal(size=(b, s, 3 * n * d)).astype(np.float32)).to(TDT[dtype])
    q, k, v = (t.reshape(b, s, n, d) for t in torch.split(qkv, n * d, dim=-1))
    assert not q.is_contiguous() and q.stride() == (s * 3 * n * d, 3 * n * d, d, 1)
    got = k12.s2a_attention(q, k, v)
    want = k12.s2a_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)
    ref, jref = _both(dtype, *(t.float().numpy() for t in (q, k, v)))
    np.testing.assert_allclose(ref, jref, atol=ATOL[dtype], rtol=0)


def test_denoiser_fixed_length_route_matches_the_jax_einsum_path():
    """A float32 tiny denoiser with every key valid: the PyTorch package takes
    ``s2a_attention``, the JAX package (no switch set) its einsum path."""
    tm, jm, params = h.s2a_pair("float32")
    rng = np.random.default_rng(5)
    b, s, hid = 3, 40, h.TINY["hidden_size"]
    x = rng.normal(size=(b, s, hid)).astype(np.float32)
    cond = rng.normal(size=(b, s, hid)).astype(np.float32)
    t = rng.uniform(size=(b,)).astype(np.float32)
    pad = np.ones((b, s), np.int32)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond), jnp.asarray(pad),
                    True, method=lambda m, *a: m.denoiser(*a))
    k12.launch_count = 0
    got = tm.denoiser(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond),
                      torch.from_numpy(pad), all_valid=True)
    assert k12.launch_count == 0  # CPU tensors: the plain version, no kernel
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL_DENOISER_F32,
                               rtol=0)
    # the masked route (all ones) computes the same function
    masked = tm.denoiser(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond),
                         torch.from_numpy(pad))
    np.testing.assert_allclose(got.detach().numpy(), masked.detach().numpy(),
                               atol=ATOL_DENOISER_F32, rtol=0)


@pytest.mark.parametrize("mode", ["bfloat16", "int8_offline"])
def test_denoiser_fixed_length_route_matches_the_jax_kernel_branch(mode, monkeypatch):
    """The serving modes' fixed-length route (bfloat16 operands) against the
    JAX package's own ``s2a_attention`` branch (Pallas, interpret mode):
    within the modes' tolerances of ``test_torch_s2a.py``."""
    h.use_jax_s2a_attention_kernel(monkeypatch)
    tm, jm, params = h.s2a_pair(mode)
    rng = np.random.default_rng(6)
    b, s, hid = 2, 40, h.TINY["hidden_size"]
    x, cond = (rng.normal(size=(b, s, hid)).astype(np.float32) for _ in range(2))
    t = rng.uniform(size=(b,)).astype(np.float32)
    pad = np.ones((b, s), np.int32)
    jdt = jm.cfg.dtype
    want = np.asarray(jm.apply(params, jnp.asarray(x).astype(jdt), jnp.asarray(t),
                               jnp.asarray(cond).astype(jdt), jnp.asarray(pad), True,
                               method=lambda m, *a: m.denoiser(*a)).astype(jnp.float32))
    got = tm.denoiser(torch.from_numpy(x).to(tm.cfg.dtype), torch.from_numpy(t),
                      torch.from_numpy(cond).to(tm.cfg.dtype), torch.from_numpy(pad),
                      all_valid=True).detach().float().numpy()
    err = np.abs(got - want)
    if mode == "bfloat16":
        assert err.max() <= 5e-3, err.max()
    else:
        assert err.mean() <= 0.03 and err.max() <= 0.25, (err.mean(), err.max())


def test_route_cpu_tensor_takes_the_plain_version_and_impl_is_honoured(monkeypatch):
    q, k, v = (torch.from_numpy(a) for a in _qkv("float32", 1, 9))
    k12.launch_count = 0
    want = k12.s2a_attention_plain(q, k, v)
    assert torch.equal(k12.s2a_attention(q, k, v), want)
    assert torch.equal(k12.s2a_attention(q, k, v, impl="plain"), want)
    assert k12.launch_count == 0
    with pytest.raises(ValueError, match="CUDA device"):
        k12.s2a_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="impl must be"):
        k12.s2a_attention(q, k, v, impl="triton")
    with pytest.raises(TypeError, match="share float32 or bfloat16"):
        k12.s2a_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="one shape"):
        k12.s2a_attention(q, k[:, :4], v)

    # a tensor routed to the kernel never comes back through the plain version
    monkeypatch.setattr(k12, "route", lambda *a, **kw: "cuda")

    def no_build(*a, **kw):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load_library", no_build)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        k12.s2a_attention(q, k, v)
    assert k12.launch_count == 0


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _projection_views(dtype, b=2, s=16, n=4, d=64):
    """q, k, v as ``audio/s2a.py`` hands them over: views of one [B, S, 3*N*D]
    projection output."""
    qkv = torch.zeros((b, s, 3 * n * d), dtype=dtype)
    return [t.reshape(b, s, n, d) for t in torch.split(qkv, n * d, dim=-1)]


@pytest.mark.parametrize("which", ["q", "k", "v"])
@pytest.mark.parametrize("fault", ["start", "stride"])
def test_kernel_args_refuse_bf16_rows_that_are_not_16_byte_pieces(which, fault, monkeypatch):
    """The bfloat16 kernel copies rows 16 bytes at a time (cp.async): routed to
    the kernel, the wrapper raises on an operand whose start is not 16-byte
    aligned or whose sequence stride is not a multiple of 8 elements, before
    any library load, and takes the denoiser's projection views. float32
    operands keep the scalar loads of the CUDA-core kernel: any start and
    stride."""
    ops = dict(zip("qkv", _projection_views(torch.bfloat16)))
    k12._kernel_args(ops["q"], ops["k"], ops["v"])
    shape = ops[which].shape
    b, s, n, d = shape
    if fault == "start":  # one element into the allocation: 2 bytes off
        bad = _bf16(ops[which].numel() + 1)[1:].view(shape)
    else:  # sequence rows padded by 4 elements: a sequence stride of N*D + 4
        bad = _bf16(b, s, n * d + 4)[..., :n * d].unflatten(-1, (n, d))
        assert bad.stride(1) == n * d + 4 and bad.stride(2) == d
    ops[which] = bad
    with pytest.raises(ValueError, match="16-byte"):
        k12._kernel_args(ops["q"], ops["k"], ops["v"])

    monkeypatch.setattr(k12, "route", lambda *a, **kw: "cuda")

    def no_build(*a, **kw):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load_library", no_build)
    k12.launch_count = 0
    with pytest.raises(ValueError, match="16-byte"):
        k12.s2a_attention(ops["q"], ops["k"], ops["v"])
    assert k12.launch_count == 0

    f32 = {name: torch.zeros(t.numel() + 1)[1:].view(t.shape) for name, t in ops.items()}
    f32[which] = torch.zeros(b, s, n * d + 4)[..., :n * d].unflatten(-1, (n, d))
    assert f32["q" if which != "q" else "k"].data_ptr() % 16
    k12._kernel_args(f32["q"], f32["k"], f32["v"])
    with pytest.raises(RuntimeError, match="nvcc not found"):  # past every check
        k12.s2a_attention(f32["q"], f32["k"], f32["v"])


@pytest.mark.parametrize("n,d", [(16, 64), (8, 32), (4, 128)])
def test_kernel_args_take_the_denoisers_projection_views(n, d):
    """The views ``audio/s2a.py`` makes of its [B, S, 3*N*D] projection are
    16-byte rows at every head dim the kernel takes, B = 1 included."""
    for b in (1, 3):
        q, k, v = _projection_views(torch.bfloat16, b=b, s=405, n=n, d=d)
        assert not q.is_contiguous()
        k12._kernel_args(q, k, v)


@pytest.mark.parametrize("b,s,n", [(1, 405, 16), (1, 256, 16), (8, 768, 16), (3, 130, 8),
                                   (1, 1, 1), (64, 4096, 16)])
def test_block_rows_is_the_largest_that_fills_the_card(b, s, n):
    """The bfloat16 kernel's query rows a block: the largest of ``BLOCK_ROWS``
    whose grid has ``MIN_BLOCKS`` blocks, else the smallest."""
    rows = k12.block_rows(b, s, n)
    blocks = {r: b * n * -(-s // r) for r in k12.BLOCK_ROWS}
    assert rows in k12.BLOCK_ROWS
    larger = [r for r in k12.BLOCK_ROWS if r > rows]
    assert all(blocks[r] < k12.MIN_BLOCKS for r in larger)
    assert blocks[rows] >= k12.MIN_BLOCKS or rows == min(k12.BLOCK_ROWS)


def test_kernel_route_refuses_a_block_size_it_has_no_kernel_for(monkeypatch):
    q, k, v = _projection_views(torch.bfloat16)
    monkeypatch.setattr(k12, "route", lambda *a, **kw: "cuda")
    with pytest.raises(ValueError, match="rows 32"):
        k12.s2a_attention(q, k, v, rows=32)
