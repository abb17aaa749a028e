"""S2A training in the PyTorch package against the JAX package's:
``S2AModel.compute_loss`` and ``train/s2a_train.py``.

The tiny S2A model of ``torch_audio_helpers`` gets the same numpy weights in
both packages; the loss's randomness is the JAX package's own draws (the six
keys of ``jax.random.split(rng, 6)``), handed to the port as an ``S2ANoise``.

Tolerances:
- float32 loss 1e-5 relative; every gradient 1e-4 of its own largest entry
  (``max |g_port - g_jax| / max |g_jax|``, the max norm), float32 on both
  sides, sums in other orders;
- bfloat16 (the denoiser's attention logits and probabilities in bfloat16,
  float32 parameters): the loss within rtol 2e-2 of the JAX package's bf16
  loss, the bar of the JAX package's ``test_s2a_bf16_loss_parity_with_f32``;
- int8_matmul dynamic (float32 residual stream): the loss within 2e-3
  relative of JAX's (measured 2.5e-4). Each package rounds float32 rows to
  int8 codes, but XLA on the CPU fuses ``silu(g) * u`` and sums products in
  another order, so a value on a rounding boundary moves its code by one step
  (1/127 of its row's abs-max) on one side; a wrong scale or mask moves the
  loss by its own size. The int8 loss also within the JAX package's 2e-2 of
  the float32 loss, and offline within 1e-6 of the port's dynamic loss, the
  JAX package's own bar between its two modes;
- the sequence-flash route (the plain flash attention on the CPU) against the
  JAX package's flash route (its Pallas kernel in interpret mode): a block's
  valid rows within 1e-5 of their largest entry, the loss 1e-5 relative,
  every gradient 1e-4 of its largest entry;
- ``train_s2a``: three float32 steps from the same weights, batches and
  draws: every loss within 1e-4 relative; the trained weights within 1e-4
  absolute (a tenth of one Adam step of the 1e-3 rate).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_audio_helpers import TINY, _TPUView, s2a_weights, to_jnp

from maxtext_indextts2_tpu.audio import s2a as jax_s2a
from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.train import s2a_train as jax_s2a_train
from maxtext_indextts2_tpu_torch.audio import s2a as s2a_lib
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.train import s2a_train
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_to_jax, s2a_params_from_jax

B, T = 2, 24
# rng seeds whose draws cover mask layer 0 (whose masked positions also count
# a mask embedding) and layers 1 and 2, with and without the prompt
SEEDS = [0, 1, 2, 4, 10]
TOL_LOSS_F32, TOL_GRAD_F32 = 1e-5, 1e-4


def _inputs(t=T, pad=5, seed=7):
    rng = np.random.default_rng(seed)
    x0 = rng.integers(0, TINY["codebook_size"], (B, t, TINY["num_quantizers"])).astype(np.int32)
    cond = rng.integers(0, TINY["cond_codebook_size"], (B, t)).astype(np.int32)
    mask = np.ones((B, t), np.int32)
    mask[1, t - pad:] = 0  # a padded tail on one row
    return x0, mask, cond


def jax_draws(jcfg, rng, b, tlen) -> s2a_lib.S2ANoise:
    """The JAX package's ``compute_loss`` draws from ``rng`` as an S2ANoise."""
    r_t, r_layer, r_mask, _, r_drop, r_plen = jax.random.split(rng, 6)
    t = jnp.clip(jax.random.uniform(r_t, (b,)), 1e-5, 1.0)
    layer = jax.random.choice(r_layer, jcfg.num_quantizers,
                              p=jnp.asarray(jax_s2a._layer_weights(jcfg)))
    use_prompt = jax.random.uniform(r_drop, ()) > jcfg.cfg_dropout
    plen = jax.random.randint(r_plen, (b,), min(tlen // 4, 5), max(tlen // 2, 6))
    bern = jax.random.bernoulli(r_mask, jax_s2a.mask_prob_schedule(t)[:, None], (b, tlen))
    return s2a_lib.S2ANoise(torch.from_numpy(np.array(t)), int(layer),
                            torch.from_numpy(np.array(bern)), bool(use_prompt),
                            torch.from_numpy(np.array(plen)))


def _models(dtype=torch.float32, int8=False, weights=None):
    weights = weights if weights is not None else s2a_weights()
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    model = s2a_lib.S2AModel(s2a_lib.S2AConfig(**TINY, dtype=dtype, int8_matmul=int8),
                             device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    jmodel = jax_s2a.S2AModel(jax_s2a.S2AConfig(**TINY, dtype=jdtype, int8_matmul=int8))
    return model, jmodel, {"params": to_jnp(params_to_jax(weights))}


def _port_loss_and_grads(model, x0, mask, cond, noise, **kw):
    named = dict(model.named_parameters())
    loss, aux = model.compute_loss(torch.from_numpy(x0), torch.from_numpy(mask),
                                   torch.from_numpy(cond), noise, **kw)
    grads = torch.autograd.grad(loss, list(named.values()))
    return float(loss.detach()), aux, dict(zip(named, grads))


def _jax_loss_and_grads(jmodel, params, x0, mask, cond, rng):
    def f(p):
        return jmodel.apply(p, jnp.asarray(x0), jnp.asarray(mask), jnp.asarray(cond), rng)

    (loss, aux), grads = jax.value_and_grad(f, has_aux=True)(params)
    return float(loss), aux, {k: v.numpy() for k, v in
                              s2a_params_from_jax(jax.tree.map(np.asarray, grads)).items()}


def _assert_grads_close(got, want, tol):
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max()) / scale
        assert np.isfinite(g).all() and err <= tol, (name, err)


def test_seeds_cover_every_kind_of_draw():
    jcfg = jax_s2a.S2AConfig(**TINY)
    draws = [jax_draws(jcfg, jax.random.PRNGKey(s), B, T) for s in SEEDS]
    assert {d.mask_layer for d in draws} == {0, 1, 2}
    assert {d.use_prompt for d in draws} == {True, False}


@pytest.mark.parametrize("seed", SEEDS)
def test_compute_loss_and_gradients_equal_the_jax_package_in_float32(seed):
    x0, mask, cond = _inputs()
    model, jmodel, params = _models()
    rng = jax.random.PRNGKey(seed)
    noise = jax_draws(jmodel.cfg, rng, B, T)
    loss, aux, grads = _port_loss_and_grads(model, x0, mask, cond, noise)
    jloss, jaux, jgrads = _jax_loss_and_grads(jmodel, params, x0, mask, cond, rng)
    assert int(aux["mask_layer"]) == int(jaux["mask_layer"])
    assert float(aux["masked_tokens"]) == float(jaux["masked_tokens"])
    assert abs(loss - jloss) <= TOL_LOSS_F32 * abs(jloss), (loss, jloss)
    _assert_grads_close(grads, jgrads, TOL_GRAD_F32)


@pytest.mark.parametrize("seed", [0, 2])
def test_compute_loss_in_bfloat16_equals_the_jax_package(seed):
    x0, mask, cond = _inputs()
    model, jmodel, params = _models(torch.bfloat16)
    rng = jax.random.PRNGKey(seed)
    loss, _, grads = _port_loss_and_grads(model, x0, mask, cond,
                                          jax_draws(jmodel.cfg, rng, B, T))
    jloss, _ = jmodel.apply(params, jnp.asarray(x0), jnp.asarray(mask), jnp.asarray(cond), rng)
    assert np.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values())
    np.testing.assert_allclose(loss, float(jloss), rtol=2e-2)


def test_compute_loss_with_int8_matmuls_equals_the_jax_package():
    x0, mask, cond = _inputs()
    weights = s2a_weights()
    model, jmodel, params = _models(int8="dynamic", weights=weights)
    rng = jax.random.PRNGKey(1)
    noise = jax_draws(jmodel.cfg, rng, B, T)
    args = (torch.from_numpy(x0), torch.from_numpy(mask), torch.from_numpy(cond), noise)
    with torch.no_grad():
        loss = float(model.compute_loss(*args)[0])
    jloss, _ = jmodel.apply(params, jnp.asarray(x0), jnp.asarray(mask), jnp.asarray(cond), rng)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, float(jloss), rtol=2e-3)
    f32, _, _ = _models(weights=weights)
    with torch.no_grad():
        np.testing.assert_allclose(loss, float(f32.compute_loss(*args)[0]), rtol=2e-2)
    # offline: the pre-quantized state dict gives the dynamic loss
    offline = s2a_lib.S2AModel(dataclasses.replace(model.cfg, int8_matmul="offline"),
                               device="cpu")
    float_sd = {k: torch.from_numpy(v) for k, v in weights.items()}
    offline.load_state_dict(s2a_lib.quantize_s2a_params(float_sd, offline))
    with torch.no_grad():
        loss_off = float(offline.compute_loss(*args)[0])
    np.testing.assert_allclose(loss_off, loss, rtol=1e-6)


def _jax_seq_flash(monkeypatch):
    """The JAX package's S2A takes its sequence-flash branch (a TPU backend
    as that module sees it, ``MTT_S2A_SEQ_FLASH=1``); its flash kernel runs
    in interpret mode off the TPU, its other TPU-only kernels stay off."""
    monkeypatch.setenv("MTT_S2A_SEQ_FLASH", "1")
    monkeypatch.setenv("MTT_S2A_FLASH", "0")
    monkeypatch.setenv("MTT_FUSED_QUANT", "0")
    monkeypatch.setenv("MTT_FUSED_ADALN", "0")
    monkeypatch.setattr(jax_s2a, "jax", _TPUView())


FLASH_T, FLASH_PAD = 512, 100


def test_sequence_flash_block_equals_the_jax_flash_route_on_valid_rows(monkeypatch):
    _jax_seq_flash(monkeypatch)
    weights = s2a_weights()
    model, _, params = _models(weights=weights)
    jcfg = jax_s2a.S2AConfig(**TINY)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, FLASH_T, TINY["hidden_size"])).astype(np.float32)
    t_cond = (1.0 + 0.2 * rng.normal(size=(B, TINY["hidden_size"]))).astype(np.float32)
    mask = np.ones((B, FLASH_T), np.int32)
    mask[1, FLASH_T - FLASH_PAD:] = 0
    block = jax_s2a.NARBlock(jcfg)
    want = np.asarray(block.apply({"params": params["params"]["denoiser"]["layers_0"]},
                                  jnp.asarray(x), jnp.asarray(t_cond), jnp.asarray(mask)))
    den = model.denoiser
    xt = torch.from_numpy(x)
    pos = torch.arange(FLASH_T, dtype=torch.int32)[None].expand(B, FLASH_T)
    sin_cos = s2a_lib.rope_lib.rope_sin_cos(pos, den.inv_freq)
    masks = s2a_lib._attention_masks(torch.from_numpy(mask))
    with torch.no_grad():
        got = den.layers_0(xt, torch.from_numpy(t_cond), masks, sin_cos, seq_flash=True).numpy()
        dense = den.layers_0(xt, torch.from_numpy(t_cond), masks, sin_cos).numpy()
    valid = mask > 0
    scale = float(np.abs(want[valid]).max())
    assert float(np.abs(got[valid] - want[valid]).max()) <= 1e-5 * scale
    # the materialised route agrees on valid rows; padding query rows differ
    # (flash: attention 0 there; materialised: a softmax over the valid keys)
    assert float(np.abs(dense[valid] - got[valid]).max()) <= 1e-5 * scale
    assert not np.allclose(dense[~valid], got[~valid])


def test_sequence_flash_loss_and_gradients_equal_the_jax_flash_route(monkeypatch):
    _jax_seq_flash(monkeypatch)
    x0, mask, cond = _inputs(t=FLASH_T, pad=FLASH_PAD)
    model, jmodel, params = _models()
    rng = jax.random.PRNGKey(0)
    noise = jax_draws(jmodel.cfg, rng, B, FLASH_T)
    loss, _, grads = _port_loss_and_grads(model, x0, mask, cond, noise, seq_flash=True)
    jloss, _, jgrads = _jax_loss_and_grads(jmodel, params, x0, mask, cond, rng)
    assert abs(loss - jloss) <= TOL_LOSS_F32 * abs(jloss), (loss, jloss)
    _assert_grads_close(grads, jgrads, TOL_GRAD_F32)
    # the two routes of the port give the same loss: it reads valid rows only
    dense, _, _ = _port_loss_and_grads(model, x0, mask, cond, noise, seq_flash=False)
    assert abs(loss - dense) <= TOL_LOSS_F32 * abs(dense)


def test_seq_flash_route_condition(monkeypatch):
    """The JAX package's condition, with a CUDA tensor for a TPU backend."""
    q = torch.zeros((1, 512, 2, 8))
    monkeypatch.setenv("MTT_S2A_SEQ_FLASH", "1")
    assert not s2a_lib._seq_flash_route(None, q, 512)  # a CPU tensor
    assert s2a_lib._seq_flash_route(True, q, 24) and not s2a_lib._seq_flash_route(False, q, 512)

    class _Cuda:
        is_cuda = True

    assert s2a_lib._seq_flash_route(None, _Cuda(), 512)
    assert s2a_lib._seq_flash_route(None, _Cuda(), 768)
    assert not s2a_lib._seq_flash_route(None, _Cuda(), 256)  # S < 512
    assert not s2a_lib._seq_flash_route(None, _Cuda(), 640)  # S % 256 != 0
    monkeypatch.setenv("MTT_S2A_SEQ_FLASH", "0")
    assert not s2a_lib._seq_flash_route(None, _Cuda(), 512)


def test_draw_s2a_noise_has_the_jax_distributions():
    cfg = s2a_lib.S2AConfig(**TINY)
    gen = torch.Generator().manual_seed(0)
    draws = [s2a_lib.draw_s2a_noise(cfg, 4, 40, gen) for _ in range(400)]
    t = torch.cat([d.t for d in draws])
    assert float(t.min()) >= 1e-5 and float(t.max()) <= 1.0
    plen = torch.cat([d.plen for d in draws])
    assert int(plen.min()) == min(40 // 4, 5) and int(plen.max()) == max(40 // 2, 6) - 1
    share = np.mean([d.use_prompt for d in draws])
    assert abs(share - (1 - cfg.cfg_dropout)) < 0.06
    layers = np.bincount([d.mask_layer for d in draws], minlength=3) / len(draws)
    np.testing.assert_allclose(layers, jax_s2a._layer_weights(jax_s2a.S2AConfig(**TINY)),
                               atol=0.07)
    # the Bernoulli mask follows sin(t pi / 2) row by row
    d = draws[0]
    assert d.bernoulli.shape == (4, 40) and d.bernoulli.dtype == torch.bool


S2A_CFG = ["dtype=float32", "steps=3", "learning_rate=1e-3", "warmup_steps_fraction=0.2",
           "max_target_length=24", "s2a_hidden_size=128", "s2a_num_layers=2",
           "s2a_num_heads=4", "s2a_num_quantizers=3", "s2a_codebook_size=64",
           "s2a_cond_codebook_size=96"]


def test_train_s2a_losses_equal_the_jax_trainer(tmp_path):
    import json

    jcfg = jax_load_config(S2A_CFG + ["per_device_batch_size=0.25",
                                      f"metrics_file={tmp_path / 'jax.jsonl'}"])
    cfg = load_config(S2A_CFG + ["per_device_batch_size=2", "enable_checkpointing=true",
                                 f"checkpoint_dir={tmp_path}"])
    assert cfg.global_batch_size_to_train_on == jcfg.global_batch_size_to_train_on == 2

    def batch_fn(step):  # one padded tail, so the pad mask is exercised
        b = jax_s2a_train.synthetic_s2a_batch(jcfg, step)
        b["mask"][1, -3:] = 0
        return b

    jout = jax_s2a_train.train_s2a(jcfg, batch_fn=batch_fn)
    with open(tmp_path / "jax.jsonl") as fh:
        jlosses = [json.loads(line)["loss"] for line in fh]
    # the JAX trainer's initial weights and per-step draws
    scfg = jax_s2a_train.s2a_config_from(jcfg)
    rng = jax.random.PRNGKey(jcfg.init_weights_seed)
    b0 = batch_fn(0)
    init = jax_s2a.S2AModel(scfg).init(rng, jnp.asarray(b0["acoustic"]),
                                        jnp.asarray(b0["mask"]), jnp.asarray(b0["semantic"]), rng)
    keys = []
    for _ in range(jcfg.steps):
        rng, srng = jax.random.split(rng)
        keys.append(srng)
    out = s2a_train.train_s2a(
        cfg, batch_fn=batch_fn, device="cpu",
        params=s2a_params_from_jax(jax.tree.map(np.asarray, init)),
        noise_fn=lambda step, b, tlen: jax_draws(scfg, keys[step], b, tlen), quiet=True)
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == len(jlosses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] == float(out["loss"])
    # the trained weights: three Adam steps of up to 1e-3 each
    trained = out["params"]
    jtrained = s2a_params_from_jax(jax.tree.map(np.asarray, jout["params"]))
    for name, w in jtrained.items():
        assert float((trained[name] - w).abs().max()) <= 1e-4, name
    # the params-only checkpoint of the trained weights
    from maxtext_indextts2_tpu_torch.train.checkpointing import load_params_only

    saved = load_params_only(str(tmp_path / "s2a_params"))
    assert all(torch.equal(saved[k], trained[k]) for k in trained)


def test_synthetic_s2a_batch_equals_the_jax_package():
    jcfg = jax_load_config(S2A_CFG + ["per_device_batch_size=0.25"])
    cfg = load_config(S2A_CFG + ["per_device_batch_size=2"])
    for step in (0, 5):
        ours, theirs = s2a_train.synthetic_s2a_batch(cfg, step), \
            jax_s2a_train.synthetic_s2a_batch(jcfg, step)
        assert set(ours) == set(theirs)
        for k in ours:
            assert ours[k].dtype == theirs[k].dtype
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert s2a_train.s2a_config_from(cfg) == s2a_lib.S2AConfig(
        num_quantizers=3, hidden_size=128, num_layers=2, num_heads=4, codebook_size=64,
        cond_codebook_size=96, dtype=torch.float32)


def test_s2a_train_cli_runs_on_the_cpu_when_asked(capsys):
    out = s2a_train.main(["device=cpu", "steps=2"] + S2A_CFG[2:] + ["per_device_batch_size=1"])
    assert "step 1:" in capsys.readouterr().out and np.isfinite(out["loss"])


def test_s2a_train_refuses_to_run_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        s2a_train.main(["steps=1"] + S2A_CFG[2:])
