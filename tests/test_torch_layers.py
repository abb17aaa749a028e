"""Module-by-module parity of the PyTorch package against the JAX package
on the CPU. Inputs and weights are made from a numpy seed and handed to
both sides.

Tolerances: float32 atol 1e-5 (same arithmetic, other summation order);
bfloat16 atol 2e-2 on O(1) activations, because the two frameworks round to
bfloat16 at different places (XLA fuses a cast into the product, PyTorch
rounds each intermediate), and one bfloat16 step near 2 is 2**-7 ~ 8e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.models import attention as jax_attn
from maxtext_indextts2_tpu.models import layers as jax_layers
from maxtext_indextts2_tpu.models import rope as jax_rope
from maxtext_indextts2_tpu.ops import quantization as jax_q
from maxtext_indextts2_tpu_torch.models import attention as attn
from maxtext_indextts2_tpu_torch.models import layers
from maxtext_indextts2_tpu_torch.models import rope
from maxtext_indextts2_tpu_torch.ops import quantization as quant

# tiny shapes: one thread is enough, and the cores stay free for the other test workers
torch.set_num_threads(1)

F32_ATOL = 1e-5
BF16_ATOL = 2e-2
DTYPES = [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)]


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _jnp_np(a):
    return np.asarray(a.astype(jnp.float32))


def _set(param, array):
    with torch.no_grad():
        param.copy_(_t(array))


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("case", ["last_axis", "to_heads", "from_heads", "bias"])
def test_dense_general(case, dtype, atol):
    x = _rand(0, 2, 5, 64, scale=0.5)
    if case == "to_heads":
        in_shape, features, axis = 64, (4, 16), -1
    elif case == "from_heads":
        in_shape, features, axis = (4, 16), 48, (-2, -1)
        x = x.reshape(2, 5, 4, 16)
    else:
        in_shape, features, axis = 64, 48, -1
    use_bias = case == "bias"
    feats = features if isinstance(features, tuple) else (features,)
    ins = in_shape if isinstance(in_shape, tuple) else (in_shape,)
    kernel = _rand(1, *ins, *feats, scale=0.125)
    params = {"kernel": jnp.asarray(kernel)}
    if use_bias:
        bias = _rand(2, *feats)
        params["bias"] = jnp.asarray(bias)
    jdt = jnp.dtype(dtype)
    want = jax_layers.DenseGeneral(features=features, axis=axis, dtype=jdt,
                                   use_bias=use_bias).apply({"params": params}, jnp.asarray(x))
    mod = layers.DenseGeneral(in_shape, features, axis=axis, dtype=layers.to_dtype(dtype),
                              use_bias=use_bias)
    _set(mod.kernel, kernel)
    if use_bias:
        _set(mod.bias, bias)
    got = mod(_t(x))
    assert str(got.dtype) == f"torch.{dtype}" and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _jnp_np(want), atol=atol)


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("plus_one", [False, True], ids=["scale", "scale_plus_one"])
def test_rmsnorm(plus_one, dtype, atol):
    x = _rand(3, 2, 7, 64)
    scale = _rand(4, 64, scale=0.3) + (0.0 if plus_one else 1.0)
    jdt = jnp.dtype(dtype)
    want = jax_layers.RMSNorm(dtype=jdt, scale_plus_one=plus_one).apply(
        {"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x).astype(jdt))
    mod = layers.RMSNorm(64, dtype=layers.to_dtype(dtype), scale_plus_one=plus_one)
    _set(mod.scale, scale)
    got = mod(_t(x).to(layers.to_dtype(dtype)))
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(_np(got), _jnp_np(want), atol=atol)


@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_embed_and_attend(dtype, atol):
    table = _rand(5, 96, 32, scale=0.2)
    ids = np.random.default_rng(6).integers(0, 96, size=(2, 9)).astype(np.int32)
    hidden = _rand(7, 2, 9, 32)
    jdt = jnp.dtype(dtype)
    jmod = jax_layers.Embed(num_embeddings=96, features=32, dtype=jdt)
    variables = {"params": {"embedding": jnp.asarray(table)}}
    mod = layers.Embed(96, 32, dtype=layers.to_dtype(dtype))
    _set(mod.embedding, table)
    want = jmod.apply(variables, jnp.asarray(ids))
    got = mod(_t(ids))
    np.testing.assert_array_equal(_np(got), _jnp_np(want))  # a lookup and one cast: exact
    for normalize in (True, False):
        want = jmod.apply(variables, jnp.asarray(hidden), normalize, method="attend")
        got = mod.attend(_t(hidden), normalize=normalize)
        assert got.dtype == torch.float32  # float32 logits on both sides
        np.testing.assert_allclose(_np(got), _jnp_np(want), atol=atol)


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("acts", [("silu", "linear"), ("gelu",)], ids=["swiglu", "gelu"])
def test_mlp_block(acts, dtype, atol):
    x = _rand(8, 2, 6, 32, scale=0.5)
    names = [f"wi_{i}" if len(acts) > 1 else "wi" for i in range(len(acts))]
    weights = {n: _rand(10 + i, 32, 64, scale=0.18) for i, n in enumerate(names)}
    weights["wo"] = _rand(20, 64, 32, scale=0.125)
    params = {n: {"kernel": jnp.asarray(w)} for n, w in weights.items()}
    jdt = jnp.dtype(dtype)
    want = jax_layers.MlpBlock(intermediate_dim=64, activations=acts, dtype=jdt).apply(
        {"params": params}, jnp.asarray(x))
    mod = layers.MlpBlock(32, 64, acts, dtype=layers.to_dtype(dtype))
    for n, w in weights.items():
        _set(getattr(mod, n).kernel, w)
    np.testing.assert_allclose(_np(mod(_t(x))), _jnp_np(want), atol=atol)


@pytest.mark.parametrize("name", sorted(layers.ACTIVATIONS))
def test_activations(name):
    x = _rand(9, 64) * 3
    want = np.asarray(jax_layers.ACTIVATIONS[name](jnp.asarray(x)))
    np.testing.assert_allclose(_np(layers.ACTIVATIONS[name](_t(x))), want, atol=F32_ATOL)


def test_unported_layer_options_name_the_roadmap():
    from maxtext_indextts2_tpu_torch.models.attention import Attention

    # llama4's l2 qk-norm and temperature tuning are ported (item 6; parity:
    # tests/test_torch_model_families.py); an unknown qk-norm type is an error
    assert Attention(16, 2, 2, 8, use_qk_norm=True, qk_norm_type="l2").l2_qk_norm
    assert Attention(16, 2, 2, 8, use_temperature_tuning=True).use_temperature_tuning
    with pytest.raises(ValueError, match="unknown qk_norm_type"):
        Attention(16, 2, 2, 8, use_qk_norm=True, qk_norm_type="layer")
    # ported since (item 5.6): every quantization and LoRA; an unknown mode is an error
    for kw in (dict(quantization="int8"), dict(quantization="int8w"), dict(quantization="fp8"),
               dict(quantization="int8w_serve"), dict(lora_rank=4)):
        layers.DenseGeneral(8, 8, **kw)
    with pytest.raises(ValueError, match="unknown quantization"):
        layers.DenseGeneral(8, 8, quantization="int4")


@pytest.mark.parametrize("rope_type", ["default", "llama3.1", "yarn"])
def test_rope_frequencies(rope_type):
    want = jax_rope.rope_frequencies(64, rope_type)
    np.testing.assert_allclose(rope.rope_frequencies(64, rope_type), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("interleave", [False, True], ids=["halves", "interleaved"])
def test_apply_rope(interleave, dtype, atol):
    x = _rand(11, 2, 6, 4, 32)
    positions = np.array([[0, 1, 2, 3, 4, 5], [40, 41, 0, 1, 2, 63]], np.int32)
    inv = jax_rope.rope_frequencies(32)
    jdt = jnp.dtype(dtype)
    want = jax_rope.apply_rope(jnp.asarray(x).astype(jdt), jnp.asarray(positions), inv,
                               interleave=interleave)
    got = rope.apply_rope(_t(x).to(layers.to_dtype(dtype)), _t(positions),
                          rope.rope_frequencies(32), interleave=interleave)
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(_np(got), _jnp_np(want), atol=atol)


def test_quantize_and_dequantize_kv():
    x = _rand(12, 2, 5, 3, 32) * 2
    x[0, 0, 0] = 0.0  # an all-zero row: scale 0, values 0, no NaN
    qv, qs = jax_q.quantize_kv(jnp.asarray(x))
    gv, gs = quant.quantize_kv(_t(x))
    assert gv.dtype == torch.int8 and tuple(gs.shape) == (2, 5, 3)  # the reduced axis is dropped
    np.testing.assert_array_equal(gv.numpy(), np.asarray(qv))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(qs))
    want = jax_q.dequantize_kv(qv, qs, jnp.float32)
    np.testing.assert_array_equal(quant.dequantize_kv(gv, gs, torch.float32).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("kw", [dict(), dict(causal=False), dict(sliding_window=3),
                                dict(chunk_size=4), dict(segments=False)],
                         ids=["causal", "full", "sliding", "chunk", "no_segments"])
def test_make_attention_mask(kw):
    kw = dict(kw)
    segments = kw.pop("segments", True)
    qp = np.array([[0, 1, 2, 3, 0, 1, 2, 0], [0, 1, 2, 3, 4, 5, 6, 7]], np.int32)
    seg = np.array([[1, 1, 1, 1, 2, 2, 2, 0], [1, 1, 1, 1, 1, 1, 1, 1]], np.int32)
    js = jnp.asarray(seg) if segments else None
    ts = _t(seg) if segments else None
    want = jax_attn.make_attention_mask(jnp.asarray(qp), jnp.asarray(qp), js, js, **kw)
    got = attn.make_attention_mask(_t(qp), _t(qp), ts, ts, **kw)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("soft_cap", [0.0, 5.0], ids=["nocap", "softcap"])
def test_dot_product_attention(soft_cap, dtype, atol):
    q, k, v = _rand(13, 2, 6, 4, 32), _rand(14, 2, 6, 2, 32), _rand(15, 2, 6, 2, 32)
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    seg = np.array([[1, 1, 1, 2, 2, 0], [1] * 6], np.int32)
    jmask = jax_attn.make_attention_mask(jnp.asarray(pos), jnp.asarray(pos),
                                         jnp.asarray(seg), jnp.asarray(seg))
    jdt, tdt = jnp.dtype(dtype), layers.to_dtype(dtype)
    want = jax_attn.dot_product_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), jmask, soft_cap, True)
    got = attn.dot_product_attention(
        *(_t(a).to(tdt) for a in (q, k, v)), _t(np.asarray(jmask)), soft_cap, True)
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(_np(got), _jnp_np(want), atol=atol)


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
def test_kvcache_prefill_then_autoregressive(quantize):
    b, s, nkv, d, n = 3, 16, 2, 32, 6
    jcache = jax_attn.KVCache(max_length=s, num_kv_heads=nkv, head_dim=d, dtype=jnp.float32,
                              quantize=quantize)
    cache = attn.KVCache(b, s, nkv, d, torch.float32, quantize)
    k0, v0 = _rand(16, b, n, nkv, d), _rand(17, b, n, nkv, d)
    true_lengths = np.array([6, 3, 1], np.int32)
    _, variables = jcache.apply({}, jnp.asarray(k0), jnp.asarray(v0), jax_attn.MODE_PREFILL,
                                jnp.asarray(true_lengths), method="update", mutable=["cache"])
    cache.update(_t(k0), _t(v0), attn.MODE_PREFILL, _t(true_lengths))
    for step in range(3):
        k1, v1 = _rand(20 + step, b, 1, nkv, d), _rand(30 + step, b, 1, nkv, d)
        _, variables = jcache.apply(
            variables, jnp.asarray(k1), jnp.asarray(v1), jax_attn.MODE_AUTOREGRESSIVE,
            method="update", mutable=["cache"])
        out = cache.update(_t(k1), _t(v1), attn.MODE_AUTOREGRESSIVE)
    assert out[0] is cache.cached_key  # the buffers themselves, updated in place
    want = variables["cache"]
    leaves = cache.leaves()
    assert set(leaves) == set(want)
    for name, leaf in leaves.items():  # stores and copies only: exact
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[name]), err_msg=name)
    np.testing.assert_array_equal(cache.cache_index.numpy(), true_lengths + 3)


def test_kvcache_write_past_the_end_lands_on_the_last_row():
    cache = attn.KVCache(2, 4, 1, 32, torch.float32)
    cache.cache_index.copy_(torch.tensor([3, 9]))
    k = torch.ones((2, 1, 1, 32))
    cache.update(k, 2 * k, attn.MODE_AUTOREGRESSIVE)
    assert cache.cached_key[1, 3].eq(1).all() and cache.cached_key[1, :3].eq(0).all()
    assert cache.cached_value[0, 3].eq(2).all()
    np.testing.assert_array_equal(cache.cache_index.numpy(), [4, 10])


def test_unported_attention_options_raise():
    base = dict(emb_dim=32, num_query_heads=2, num_kv_heads=2, head_dim=16)
    # llama4's options build (item 6); a qk-norm type the JAX package lacks does not
    assert attn.Attention(**base, qk_norm_type="l2", use_qk_norm=True).query_norm is None
    assert attn.Attention(**base, use_temperature_tuning=True).use_temperature_tuning
    with pytest.raises(ValueError, match="unknown qk_norm_type"):
        attn.Attention(**base, qk_norm_type="layer", use_qk_norm=True)
    # bucketed decode and the verify span are ported (tests/test_torch_bucketed_decode.py,
    # tests/test_torch_speculative.py); an unknown decode route or mode is an error
    assert attn.Attention(**base, decode_attention="bucketed").decode_attention == "bucketed"
    with pytest.raises(ValueError, match="unknown decode_attention"):
        attn.Attention(**base, decode_attention="paged")
    # attention=flash is ported (K9-K11, the training step); an unknown kernel is an error
    assert attn.Attention(**base, attention_kernel="flash").attention_kernel == "flash"
    with pytest.raises(ValueError, match="unknown attention kernel"):
        attn.Attention(**base, attention_kernel="splash")
    mod = attn.Attention(**base)
    x = torch.zeros((1, 2, 32))
    pos = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown attention mode"):
        mod(x, x, pos, None, mode="draft", cache=mod.init_cache(1, 8, "cpu"))
