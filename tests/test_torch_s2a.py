"""The S2A denoiser and its masked-diffusion sampler in the PyTorch package
against the JAX package, on the CPU at a tiny size (hidden 128, 2 layers, 4
heads, 3 quantizers, codebook 64). Weights and inputs come from a numpy seed
and go to both sides; the sampler gets JAX's own uniform draws.

On the CPU the PyTorch wrappers of the row kernels run their plain versions;
the JAX package runs its unfused jnp forms there (its Pallas kernels are held
against the plain versions in ``test_torch_s2a_kernels_plain.py``).

Tolerances, and why:

* float32 modules: matrix products sum in another order: atol 2e-5 on O(1)
  values. The float32 sampler must give IDENTICAL codes from the same noise.
* ``bfloat16`` serving mode (float32 weights and residual stream, bfloat16
  attention logits and probabilities): the bfloat16 roundings inside attention
  fall on values that differ in their last float32 bit: atol 5e-3 on outputs
  of magnitude ~4.5. The sampled codes were identical in every case tried;
  the test demands 0.98.
* ``int8`` / ``int8_offline`` (bfloat16 residual stream): both sides round to
  bfloat16 after every operation, but XLA on the CPU keeps float32 inside the
  operations it fuses (``jax.nn.silu``, the scans of the sampler) and sums
  bfloat16 products in another order, so values straddle bfloat16 and int8
  rounding boundaries differently. One denoiser forward: mean error under
  0.03 and largest under 0.25 (8 bfloat16 steps at magnitude 4-8; measured
  0.015 and 0.12). The sampler feeds each step's codes to the next, so a
  flipped code spreads: at least 0.75 of the codes equal (measured 0.82-0.94).
* Parameter conversion (offline int8 kernels, scales, bfloat16 casts): leaf by
  leaf exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_audio_helpers as h
from maxtext_indextts2_tpu.audio import s2a as jax_s2a
from maxtext_indextts2_tpu_torch.audio import s2a as s2a_lib
from maxtext_indextts2_tpu_torch.models import rope as rope_lib
from maxtext_indextts2_tpu_torch.utils.param_bridge import (
    params_to_jax, s2a_params_from_jax,
)

ATOL_F32 = 2e-5
ATOL_BF16_MODE = 5e-3
INT8_MEAN, INT8_MAX = 0.03, 0.25
MIN_AGREEMENT = {"float32": 1.0, "bfloat16": 0.98, "int8": 0.75, "int8_offline": 0.75}

B, S, H = 3, 40, 128
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _check_mode(got, want, mode, valid=None):
    """Outputs of one module in a serving mode, within that mode's tolerance."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    if valid is not None:
        g, w = g[valid], w[valid]
    err = np.abs(g - w)
    if mode == "float32":
        assert err.max() <= ATOL_F32, err.max()
    elif mode == "bfloat16":
        assert err.max() <= ATOL_BF16_MODE, err.max()
    else:
        assert err.mean() <= INT8_MEAN and err.max() <= INT8_MAX, (err.mean(), err.max())


def _inputs(seed=0, masked=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H)).astype(np.float32)
    cond = rng.normal(size=(B, S, H)).astype(np.float32)
    t = rng.uniform(size=(B,)).astype(np.float32)
    pad = np.ones((B, S), np.int32)
    if masked:
        pad[1, 25:] = 0
        pad[2, 1:] = 0  # a dummy row: one valid position
    return x, cond, t, pad


def _dtype_name(model):
    return "bfloat16" if model.cfg.int8_matmul else "float32"


# ------------------------------------------------------------------ small parts
def test_serving_s2a_config_matches_jax():
    base, jbase = s2a_lib.S2AConfig(**h.TINY), jax_s2a.S2AConfig(**h.TINY)
    for mode in ["", *h.MODES]:
        got, want = s2a_lib.serving_s2a_config(base, mode), jax_s2a.serving_s2a_config(jbase, mode)
        assert got.int8_matmul == want.int8_matmul
        assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
    with pytest.raises(ValueError):
        s2a_lib.serving_s2a_config(base, "fp8")


def test_time_embedding_schedule_and_token_embedding_match_jax():
    t = np.array([0.0, 0.3, 1.0], np.float32)
    np.testing.assert_allclose(
        s2a_lib.sinusoidal_time_emb(torch.from_numpy(t), 128).numpy(),
        np.asarray(jax_s2a.sinusoidal_time_emb(jnp.asarray(t), 128)), atol=2e-6)
    np.testing.assert_allclose(s2a_lib.mask_prob_schedule(torch.from_numpy(t)).numpy(),
                               np.asarray(jax_s2a.mask_prob_schedule(jnp.asarray(t))), atol=1e-7)
    tm, jm, params = h.s2a_pair("float32")
    codes = np.random.default_rng(0).integers(0, 64, size=(2, 7, 3))
    for n in (1, 3):
        want = jm.apply(params, jnp.asarray(codes), n, method=jm.embed_tokens_upto)
        got = tm.embed_tokens_upto(torch.from_numpy(codes), n)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-6)
    want = jm.apply(params, jnp.asarray(codes), method=jm.embed_tokens_upto_stacked)
    np.testing.assert_allclose(_f32(tm.embed_tokens_upto_stacked(torch.from_numpy(codes))),
                               _f32(want), atol=1e-6)


@pytest.mark.parametrize("v,k", [(64, 1), (64, 5), (1024, 20), (1024, 200), (256, 3)])
def test_kth_largest_matches_jax(v, k):
    x = np.random.default_rng(v + k).normal(size=(2, 5, v)).astype(np.float32)
    x[0, 0, :4] = x[0, 0, 4]  # ties
    want = jax_s2a._kth_largest(jnp.asarray(x), k)
    got = s2a_lib._kth_largest(torch.from_numpy(x), k)
    assert got.shape == (2, 5, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantize_out", [False, True], ids=["float_out", "quantize_out"])
def test_adaptive_rmsnorm_matches_jax(dtype, quantize_out):
    rng = np.random.default_rng(1)
    kernel = (0.05 * rng.normal(size=(H, H))).astype(np.float32)
    bias = (1.0 + 0.1 * rng.normal(size=(H,))).astype(np.float32)
    x = (1.5 * rng.normal(size=(B, S, H))).astype(np.float32)
    cond = rng.normal(size=(B, H)).astype(np.float32)
    tn = s2a_lib.AdaptiveRMSNorm(H, device="cpu")
    tn.load_state_dict({"to_weight.kernel": torch.from_numpy(kernel),
                        "to_weight.bias": torch.from_numpy(bias)})
    jparams = {"params": {"to_weight": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}}
    want = jax_s2a.AdaptiveRMSNorm(H).apply(
        jparams, jnp.asarray(x).astype(JDT[dtype]), jnp.asarray(cond), quantize_out)
    got = tn(torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(cond), quantize_out)
    if not quantize_out:
        assert got.dtype == TDT[dtype]
        rtol = 2e-6 if dtype == "float32" else 2.0 ** -7
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=1e-6)
        return
    (q, s), (qw, sw) = got, want
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (B, S)
    steps = np.abs(q.numpy().astype(int) - np.asarray(qw).astype(int))
    assert steps.max() <= 1 and (steps > 0).mean() <= 1e-2
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(sw),
                               rtol=1e-6 if dtype == "float32" else 2.0 ** -7)


def test_adaptive_rmsnorm_takes_a_per_position_condition():
    """cond [B,S,D]: each position a row with its own scale, equal to the JAX
    package's unfused arithmetic."""
    rng = np.random.default_rng(2)
    tn = s2a_lib.AdaptiveRMSNorm(16, device="cpu")
    kernel = (0.1 * rng.normal(size=(16, 16))).astype(np.float32)
    tn.to_weight.kernel.data = torch.from_numpy(kernel)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    cond = rng.normal(size=(2, 5, 16)).astype(np.float32)
    jparams = {"params": {"to_weight": {"kernel": jnp.asarray(kernel), "bias": jnp.ones((16,))}}}
    want = jax_s2a.AdaptiveRMSNorm(16).apply(jparams, jnp.asarray(x), jnp.asarray(cond))
    np.testing.assert_allclose(_f32(tn(torch.from_numpy(x), torch.from_numpy(cond))), _f32(want),
                               atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("how", ["dynamic", "offline", "prequantized_dynamic",
                                 "prequantized_offline"])
def test_int8_dense_matches_jax(how, dtype):
    rng = np.random.default_rng(3)
    k, n = 64, 48
    w = (rng.normal(size=(k, n)) / 8).astype(np.float32)
    x = rng.normal(size=(2, 9, k)).astype(np.float32)
    offline = how.endswith("offline")
    td = s2a_lib.Int8Dense(k, n, offline=offline, device="cpu")
    if offline:
        amax = np.maximum(np.abs(w).max(0, keepdims=True), 1e-9).astype(np.float32)
        scale = (amax / np.float32(127.0)).astype(np.float32)
        wq = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
        td.load_state_dict({"kernel": torch.from_numpy(wq), "kernel_scale": torch.from_numpy(scale)})
        jparams = {"params": {"kernel": jnp.asarray(wq), "kernel_scale": jnp.asarray(scale)}}
    else:
        td.load_state_dict({"kernel": torch.from_numpy(w)})
        jparams = {"params": {"kernel": jnp.asarray(w)}}
    if how.startswith("prequantized"):
        xq = rng.integers(-127, 128, size=(2, 9, k)).astype(np.int8)
        xs = rng.uniform(0.001, 0.02, size=(2, 9)).astype(np.float32)
        jd = jax_s2a.Int8Dense(n, offline=offline, out_dtype=JDT[dtype])
        want = jd.apply(jparams, None, xq=jnp.asarray(xq), xs=jnp.asarray(xs))
        got = td(None, xq=torch.from_numpy(xq), xs=torch.from_numpy(xs), out_dtype=TDT[dtype])
    else:
        jd = jax_s2a.Int8Dense(n, offline=offline)
        want = jd.apply(jparams, jnp.asarray(x).astype(JDT[dtype]))
        got = td(torch.from_numpy(x).to(TDT[dtype]))
    assert got.dtype == TDT[dtype] and got.shape == (2, 9, n)
    # integer accumulation is exact; the float32 scaling may differ in its last bit
    np.testing.assert_allclose(_f32(got), _f32(want),
                               rtol=1e-6 if dtype == "float32" else 2.0 ** -7, atol=1e-7)


def test_int8_matmul_pads_few_rows_and_is_exact():
    rng = np.random.default_rng(4)
    a = rng.integers(-127, 128, size=(5, 32)).astype(np.int8)
    w = rng.integers(-127, 128, size=(32, 24)).astype(np.int8)
    got = s2a_lib.int8_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int32) @ w.astype(np.int32))


# ------------------------------------------------------------- blocks and denoiser
@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "pad_masks"])
@pytest.mark.parametrize("mode", h.MODES)
def test_nar_block_matches_jax(mode, masked):
    tm, jm, params = h.s2a_pair(mode)
    x, _, _, pad = _inputs(5, masked)
    t_cond = np.random.default_rng(6).normal(size=(B, H)).astype(np.float32)
    name = _dtype_name(tm)
    jblock = jax_s2a.NARBlock(jm.cfg)
    want = jblock.apply({"params": params["params"]["denoiser"]["layers_1"]},
                        jnp.asarray(x).astype(JDT[name]), jnp.asarray(t_cond).astype(JDT[name]),
                        jnp.asarray(pad))
    pos = torch.arange(S, dtype=torch.int32)[None, :].expand(B, S)
    sin_cos = rope_lib.rope_sin_cos(pos, tm.denoiser.inv_freq)
    got = tm.denoiser.layers_1(
        torch.from_numpy(x).to(TDT[name]), torch.from_numpy(t_cond).to(TDT[name]),
        s2a_lib._attention_masks(torch.from_numpy(pad)), sin_cos)
    assert got.dtype == TDT[name]
    _check_mode(got, want, mode, pad.astype(bool))


@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "pad_masks"])
@pytest.mark.parametrize("mode", h.MODES)
def test_nar_denoiser_matches_jax(mode, masked):
    tm, jm, params = h.s2a_pair(mode)
    x, cond, t, pad = _inputs(7, masked)
    jdt, tdt = jm.cfg.dtype, tm.cfg.dtype
    want = jm.apply(params, jnp.asarray(x).astype(jdt), jnp.asarray(t),
                    jnp.asarray(cond).astype(jdt), jnp.asarray(pad),
                    method=lambda m, *a: m.denoiser(*a))
    got = tm.denoiser(torch.from_numpy(x).to(tdt), torch.from_numpy(t),
                      torch.from_numpy(cond).to(tdt), torch.from_numpy(pad))
    assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
    _check_mode(got, want, mode, pad.astype(bool))


def test_prefix_denoiser_matches_jax():
    cfg = s2a_lib.S2AConfig(**h.TINY)
    rng = np.random.default_rng(8)
    td = s2a_lib.PrefixNARDenoiser(cfg, device="cpu")
    state = {}
    for name, p in td.state_dict().items():
        w = rng.normal(size=tuple(p.shape)) / np.sqrt(p.shape[0])
        if name.endswith("to_weight.bias"):
            w = 1.0 + 0.1 * w
        state[name] = torch.from_numpy(w.astype(np.float32))
    td.load_state_dict(state)
    params = {"params": h.to_jnp(params_to_jax(state))}
    jd = jax_s2a.PrefixNARDenoiser(jax_s2a.S2AConfig(**h.TINY))
    x, _, t, pad = _inputs(9, masked=True)
    phone = rng.normal(size=(B, 11, H)).astype(np.float32)
    pmask = np.ones((B, 11), np.int32)
    pmask[0, 6:] = 0
    want = jd.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(phone),
                    jnp.asarray(pad), jnp.asarray(pmask))
    got = td(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(phone),
             torch.from_numpy(pad), torch.from_numpy(pmask))
    assert got.shape == (B, S, H)
    _check_mode(got, want, "float32", pad.astype(bool))
    # without a condition: an unconditional denoiser over x alone
    want = jd.apply(params, jnp.asarray(x), jnp.asarray(t))
    _check_mode(td(torch.from_numpy(x), torch.from_numpy(t)), want, "float32")


# -------------------------------------------------------------- parameter trees
@pytest.mark.parametrize("mode", h.MODES)
def test_serving_parameter_trees_equal_jax_leaf_by_leaf(mode):
    """``quantize_s2a_params`` and ``cast_denoiser_params`` of the two packages
    on the same float weights, compared through ``s2a_params_from_jax``."""
    tm, _, params = h.s2a_pair(mode)
    want = s2a_params_from_jax(h.to_numpy_tree(params))
    got = tm.state_dict()
    assert set(got) == set(want)
    for name, leaf in got.items():
        assert leaf.dtype == want[name].dtype, (name, leaf.dtype, want[name].dtype)
        assert leaf.shape == want[name].shape, name
        assert torch.equal(leaf, want[name]), name
    kinds = {name.rsplit(".", 1)[-1]: leaf.dtype for name, leaf in got.items()
             if name.startswith("denoiser.layers_0.qkv")}
    if mode == "int8_offline":
        assert kinds == {"kernel": torch.int8, "kernel_scale": torch.float32}
        assert got["denoiser.layers_0.qkv.kernel_scale"].shape == (1, 3 * H)
    elif mode == "int8":
        assert kinds == {"kernel": torch.bfloat16}
    else:
        assert kinds == {"kernel": torch.float32}
    if mode.startswith("int8"):  # embeddings and logit heads stay float32
        assert got["denoiser.c0.kernel"].dtype == torch.bfloat16
        assert {got[k].dtype for k in ("token_emb", "to_logits_w", "cond_emb", "mask_emb")} \
            == {torch.float32}


def test_offline_kernel_layout_survives_loading():
    """The int8 kernel keeps the tree's [in, out] shape but lies output-major
    in memory, whatever layout the loaded tensor had."""
    tm, _, _ = h.s2a_pair("int8_offline")
    k = tm.denoiser.layers_0.gate.kernel
    assert k.shape == (H, 4 * H) and k.stride() == (1, H)


def test_s2a_state_dict_round_trips_through_the_jax_tree():
    weights = h.s2a_weights(seed=3)
    tree = params_to_jax({k: torch.from_numpy(v) for k, v in weights.items()})
    assert set(tree) >= {"denoiser", "token_emb", "cond_emb"}
    back = s2a_params_from_jax({"params": tree})
    assert set(back) == set(weights)
    for k, v in weights.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


# --------------------------------------------------------------------- sampler
P, T = 16, 24
SAMPLER_CASES = {
    "fixed_length": dict(),
    "masked_rows_of_different_lengths": dict(masked=True),
    "cfg_until_half": dict(masked=True, cfg_until=0.5),
    "one_step_layer": dict(n_timesteps=(3, 1, 2)),
    "no_prompt": dict(no_prompt=True),
    "no_guidance": dict(cfg=0.0),
}


def _sampler_args(case):
    kw = dict(SAMPLER_CASES[case])
    rng = np.random.default_rng(10)
    cond = rng.integers(0, h.TINY["cond_codebook_size"], size=(B, P + T))
    prompt = rng.integers(0, h.TINY["codebook_size"], size=(B, P, h.TINY["num_quantizers"]))
    if kw.pop("no_prompt", False):
        cond, prompt = cond[:, P:], prompt[:, :0]
    # filter_thres 0.8 keeps 12 of the 64 candidates: at the default 0.98 only
    # the largest logit would survive and the Gumbel draw would decide nothing
    common = dict(n_timesteps=kw.pop("n_timesteps", (4, 2, 2)), cfg=kw.pop("cfg", 2.5),
                  filter_thres=0.8)
    masks = None
    if kw.pop("masked", False):
        xm = np.ones((B, T), np.int32)
        xm[1, 15:] = 0
        xm[2, 1:] = 0
        pm = np.ones((B, P), np.int32)
        pm[1, 9:] = 0
        pm[2, 1:] = 0
        masks = (xm, pm)
    return cond, prompt, {**common, **kw}, masks


@pytest.mark.parametrize("case", list(SAMPLER_CASES))
@pytest.mark.parametrize("mode", h.MODES)
def test_reverse_diffusion_matches_jax_with_its_noise(mode, case, monkeypatch):
    """Without pad masks every key is valid and the PyTorch sampler's
    attention is ``s2a_attention`` (float32 logits); the JAX package is made to
    take its own ``s2a_attention`` branch there, so like is held to like."""
    tm, jm, params = h.s2a_pair(mode)
    cond, prompt, kw, masks = _sampler_args(case)
    if masks is None:
        h.use_jax_s2a_attention_kernel(monkeypatch)
    key = jax.random.PRNGKey(7)
    jkw, tkw = dict(kw), dict(kw)
    valid = np.ones((B, T), bool)
    if masks is not None:
        jkw.update(x_mask=jnp.asarray(masks[0]), prompt_mask=jnp.asarray(masks[1]))
        tkw.update(x_mask=torch.from_numpy(masks[0]), prompt_mask=torch.from_numpy(masks[1]))
        valid = masks[0].astype(bool)
    want = np.asarray(jm.apply(params, jnp.asarray(cond), jnp.asarray(prompt), key,
                               method=jm.reverse_diffusion, **jkw))
    got = tm.reverse_diffusion(torch.from_numpy(cond), torch.from_numpy(prompt),
                               noise=h.jax_noise(key), **tkw).numpy()
    assert got.shape == want.shape == (B, T, 3)
    assert got.min() >= 0 and got.max() < h.TINY["codebook_size"]
    agree = (got == want)[valid].mean()
    assert agree >= MIN_AGREEMENT[mode], agree
    assert len(np.unique(got[valid])) > 8  # a sampler, not a constant


def test_reverse_diffusion_unrolled_jax_gives_the_same_codes():
    tm, jm, params = h.s2a_pair("float32")
    cond, prompt, kw, _ = _sampler_args("fixed_length")
    key = jax.random.PRNGKey(11)
    want = np.asarray(jm.apply(params, jnp.asarray(cond), jnp.asarray(prompt), key,
                               method=jm.reverse_diffusion, unroll=True, **kw))
    got = tm.reverse_diffusion(torch.from_numpy(cond), torch.from_numpy(prompt),
                               noise=h.jax_noise(key), unroll=True, **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_reverse_diffusion_with_a_generator_is_deterministic_per_seed():
    tm, _, _ = h.s2a_pair("int8_offline")
    cond, prompt, kw, _ = _sampler_args("fixed_length")
    cond, prompt = torch.from_numpy(cond), torch.from_numpy(prompt)
    runs = [tm.reverse_diffusion(cond, prompt, generator=torch.Generator().manual_seed(s), **kw)
            for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert runs[0].dtype == torch.int64 and 0 <= int(runs[0].min()) and int(runs[0].max()) < 64


def test_reverse_diffusion_rejects_bad_arguments():
    tm, _, _ = h.s2a_pair("float32")
    cond, prompt, kw, _ = _sampler_args("fixed_length")
    cond, prompt = torch.from_numpy(cond), torch.from_numpy(prompt)
    with pytest.raises(ValueError, match="exactly one"):
        tm.reverse_diffusion(cond, prompt, **kw)
    with pytest.raises(ValueError, match="exactly one"):
        tm.reverse_diffusion(cond, prompt, generator=torch.Generator(),
                             noise=lambda *a: None, **kw)
    with pytest.raises(ValueError, match="n_timesteps"):
        tm.reverse_diffusion(cond, prompt, generator=torch.Generator(), n_timesteps=(4, 2))
