"""The PyTorch package's LM training step against the JAX package's.

A tiny audio-LM (2 layers, 4 query / 2 kv heads, float32) gets the same
numpy weights and the same synthetic batch in both packages; both take
three ``train_step``s (adamw, warmup then cosine, global-norm clipping,
remat ``full``) with ``attention=dot_product`` and with ``attention=flash``
(the JAX side runs its Pallas kernels in interpret mode, the port its plain
versions on the CPU). Per step: loss, grad_norm and param_norm; at the end
every parameter and both Adam moments, carried back by the bridge.

Tolerances (float32 on both sides; the frameworks sum in other orders):
loss 2e-5 absolute (values ~6), grad_norm and param_norm 1e-5 relative;
parameters after three Adam updates of up to 1e-3 each: 2e-6 absolute for
all but one in a thousand, and 5e-5 (5 % of one update) for every one, since
Adam's normalised step m / (sqrt(v) + eps) turns a float32 difference in a
near-zero gradient into a visible share of the step; moments 1e-5 relative
plus 1e-4 of the leaf's largest moment (a gradient element near zero
carries the float32 differences of sums over much larger terms).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import TINY_TTS, configs, jax_tree, numpy_weights

from maxtext_indextts2_tpu.models import Transformer as JaxTransformer
from maxtext_indextts2_tpu.train import optimizers as joptim
from maxtext_indextts2_tpu.train import train as jtrain
from maxtext_indextts2_tpu.train.data import synthetic as jsynthetic
from maxtext_indextts2_tpu.utils import flops as jflops
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.ops import flash_attention as tfa
from maxtext_indextts2_tpu_torch.train import train as ttrain
from maxtext_indextts2_tpu_torch.train.data import synthetic
from maxtext_indextts2_tpu_torch.utils import flops
from maxtext_indextts2_tpu_torch.utils.param_bridge import opt_state_to_jax, params_to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TTS_1B = os.path.join(REPO, "maxtext_indextts2_tpu_torch", "configs", "models", "tts-1b.yml")

TRAIN = ["max_target_length=32", "learning_rate=1e-3", "warmup_steps_fraction=0.2",
         "steps=5", "dataset_type=synthetic", "remat_policy=full"]
STEPS = 3
ROWS = 8  # the JAX test harness has eight CPU devices: the batch divides among them


def _batch(cfg, padded):
    batch = synthetic.make_batch(cfg, 0, ROWS)
    batch = {k: np.array(v) for k, v in batch.items()}
    if padded:  # a second document in some rows and a segment-0 tail: packed training data
        for r in range(0, ROWS, 2):
            batch["inputs_segmentation"][r, 20:] = 2
            batch["inputs_position"][r, 20:] -= 20
            batch["inputs_segmentation"][r, 28:] = 0
        batch["targets_segmentation"] = batch["inputs_segmentation"].copy()
    return batch


def _jax_run(jcfg, weights, batch):
    model = JaxTransformer(cfg=jcfg)
    tx = joptim.get_optimizer(jcfg, joptim.create_learning_rate_schedule(jcfg))
    state = jtrain.TrainState.create(apply_fn=model.apply, params=jax_tree(weights), tx=tx)
    step = jax.jit(functools.partial(jtrain.train_step, model, jcfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    history = []
    for _ in range(STEPS):
        state, m = step(state, jbatch, jax.random.PRNGKey(0))
        history.append({k: float(v) for k, v in m.items()})
    return state, history


def _torch_run(cfg, weights, batch):
    state = ttrain.setup_train_state(
        cfg, device="cpu", params={k: torch.from_numpy(v) for k, v in weights.items()})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    history = [{k: float(v) for k, v in ttrain.train_step(cfg, state, tbatch).items()}
               for _ in range(STEPS)]
    return state, history


@pytest.mark.parametrize("attention,padded", [
    ("dot_product", False), ("flash", False), ("flash", True)],
    ids=["dot_product", "flash", "flash_packed_padding"])
def test_train_steps_match_jax(attention, padded):
    cfg, jcfg = configs(TRAIN + [f"attention={attention}"], slots=ROWS)
    jcfg = dataclasses.replace(jcfg, flash_block_sizes=(16, 16))
    weights = numpy_weights(cfg, seed=7)
    batch = _batch(cfg, padded)
    jstate, jhist = _jax_run(jcfg, weights, batch)
    tstate, thist = _torch_run(cfg, weights, batch)

    for step, (got, want) in enumerate(zip(thist, jhist)):
        np.testing.assert_allclose(got["loss"], want["loss"], atol=2e-5, rtol=0,
                                   err_msg=f"loss, step {step}")
        for key in ("grad_norm", "param_norm"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=f"{key} {step}")
    assert thist[0]["loss"] == thist[1]["loss"] or abs(thist[0]["loss"] - thist[1]["loss"]) < 1e-6
    assert thist[2]["loss"] < thist[1]["loss"]  # warmup: step 0 moves nothing

    got = params_to_jax({k: v.detach() for k, v in tstate.params.items()})
    want = jax.tree.map(np.asarray, jstate.params)
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        keys = [p.key for p in path]
        node = got
        for k in keys:
            node = node[k]
        _assert_adam_close(node, leaf, "/".join(keys))
    adam = jstate.opt_state[0]
    ours = opt_state_to_jax(tstate.opt_state)
    assert int(ours["count"]) == int(adam.count) == STEPS
    for name in ("mu", "nu"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(getattr(adam, name)):
            node = ours[name]
            for p in path:
                node = node[p.key]
            leaf = np.asarray(leaf)
            np.testing.assert_allclose(node, leaf, rtol=1e-5, atol=1e-4 * np.abs(leaf).max())


def _assert_adam_close(got, want, what):
    """Parameters after a few Adam updates of ~1e-3 (see the module's note)."""
    diff = np.abs(got - want)
    assert diff.max() <= 5e-5, (what, diff.max())
    assert (diff > 2e-6).mean() <= 1e-3, (what, int((diff > 2e-6).sum()))


def _tiny(extra=()):
    return load_config(TINY_TTS + TRAIN + ["per_device_batch_size=4"] + list(extra))


def _grads(cfg, weights, batch, policy):
    cfg = dataclasses.replace(cfg, remat_policy=policy)
    state = ttrain.setup_train_state(
        cfg, device="cpu", params={k: torch.from_numpy(v) for k, v in weights.items()})
    loss, _ = ttrain.loss_fn(state.model, cfg, batch)
    names = list(state.params)
    grads = torch.autograd.grad(loss, list(state.params.values()))
    return float(loss.detach()), dict(zip(names, grads))


@pytest.mark.parametrize("attention", ["dot_product", "flash"])
@pytest.mark.parametrize("policy", ["full", "minimal", "save_attn_out", "save_attn_and_mlp",
                                    "save_dot_except_mlp", "save_qkv_proj"])
def test_every_remat_policy_gives_the_gradients_of_none(policy, attention, monkeypatch):
    """Rematerialisation recomputes; it changes no number. The flash forward
    runs once per layer without remat and twice with it (the recompute of
    the attention region: no anchor holds the kernel's residuals)."""
    cfg = _tiny([f"attention={attention}"])
    weights = numpy_weights(cfg, seed=1)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in synthetic.make_batch(cfg, 0, 4).items()}
    calls = {"n": 0}
    real = tfa.flash_fwd_plain

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(tfa, "flash_fwd_plain", counted)
    loss0, want = _grads(cfg, weights, batch, "none")
    n_none, calls["n"] = calls["n"], 0
    loss, got = _grads(cfg, weights, batch, policy)
    assert loss == loss0
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=1e-7, rtol=0,
                                   err_msg=name)
    layers = cfg.num_decoder_layers
    if attention == "flash":
        assert (n_none, calls["n"]) == (layers, 2 * layers)
    else:
        assert (n_none, calls["n"]) == (0, 0)


def test_unknown_remat_policy_raises():
    cfg = _tiny(["remat_policy=save_everything"])
    with pytest.raises(ValueError, match="unknown remat_policy"):
        ttrain.setup_train_state(cfg, device="cpu")


def test_gradient_accumulation_equals_one_big_batch():
    """Two microbatches of 2 rows, summed and halved, against one batch of 4."""
    cfg1 = _tiny(["gradient_clipping_threshold=0", "per_device_batch_size=4"])
    cfg2 = _tiny(["gradient_clipping_threshold=0", "per_device_batch_size=2",
                  "gradient_accumulation_steps=2"])
    assert cfg1.global_batch_size_to_train_on == cfg2.global_batch_size_to_train_on == 4
    weights = numpy_weights(cfg1, seed=2)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in synthetic.make_batch(cfg1, 0, 4).items()}
    out = []
    for cfg in (cfg1, cfg2):
        state = ttrain.setup_train_state(
            cfg, device="cpu", params={k: torch.from_numpy(v) for k, v in weights.items()})
        m = [ttrain.train_step(cfg, state, batch) for _ in range(2)]
        out.append((m, state))
    (m1, s1), (m2, s2) = out
    for a, b in zip(m1, m2):
        np.testing.assert_allclose(float(a["loss"]), float(b["loss"]), atol=1e-5, rtol=0)
        np.testing.assert_allclose(float(a["grad_norm"]), float(b["grad_norm"]), rtol=1e-5)
    for name, p in s1.params.items():
        _assert_adam_close(p.detach().numpy(), s2.params[name].detach().numpy(), name)


def test_clipping_keeps_bfloat16_gradients_bfloat16():
    g = {"a": torch.full((3, 4), 2.0, dtype=torch.bfloat16),
         "b": torch.full((5,), -1.0, dtype=torch.float32)}
    clipped, norm = ttrain._clip_by_global_norm(g, 1.0)
    assert norm.dtype == torch.float32
    np.testing.assert_allclose(float(norm), np.sqrt(12 * 4 + 5), rtol=1e-6)
    assert clipped["a"].dtype == torch.bfloat16 and clipped["b"].dtype == torch.float32
    scale = torch.tensor(1.0 / np.sqrt(53), dtype=torch.float32)
    assert torch.equal(clipped["a"], g["a"] * scale.to(torch.bfloat16))
    # below the threshold nothing changes
    same, _ = ttrain._clip_by_global_norm(g, 100.0)
    assert all(torch.equal(same[k], g[k]) for k in g)


def test_six_steps_lower_the_loss_with_bfloat16_weights():
    cfg = _tiny(["steps=6", "weight_dtype=bfloat16", "dtype=bfloat16", "attention=flash",
                 "remat_policy=save_attn_and_mlp", "cast_logits_to_fp32=false"])
    out = ttrain.train_loop(cfg, device="cpu", quiet=True)
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5, losses
    state_dtypes = {p.dtype for p in ttrain.setup_train_state(cfg, "cpu").params.values()}
    assert state_dtypes == {torch.bfloat16}


def test_cli_runs_on_the_cpu_when_asked(capsys):
    out = ttrain.main([TTS_1B, "device=cpu", "dataset_type=synthetic", "steps=2",
                       "base_emb_dim=64", "base_mlp_dim=128", "base_num_decoder_layers=1",
                       "base_num_query_heads=2", "base_num_kv_heads=1", "head_dim=64",
                       "vocab_size=256", "max_target_length=16", "per_device_batch_size=2",
                       "attention=flash", "remat_policy=save_attn_and_mlp",
                       "weight_dtype=bfloat16", "cast_logits_to_fp32=false"])
    printed = capsys.readouterr().out
    assert "step 1:" in printed and np.isfinite(out["loss"])


@pytest.mark.parametrize("extra,item", [
    (["dataset_type=emilia_audio"], "4b"), (["enable_checkpointing=true"], "4b"),
    (["mtp_num_layers=1"], "6"), (["zero1_fsdp_ag_once=true"], "6"),
    (["fused_vocab_ce_chunk=64"], "4b"), (["fused_vocab_ce_tile=128"], "4b"),
], ids=["emilia_data", "checkpointing", "mtp", "zero1", "fused_ce_chunk", "fused_ce_tile"])
def test_unported_training_features_name_their_queue_item(extra, item):
    cfg = _tiny(extra + ["steps=1"])
    with pytest.raises(NotImplementedError, match=f"port queue: {item}"):
        ttrain.train_loop(cfg, device="cpu", quiet=True)


def _refuse_dataset(kind):
    ttrain.create_data_iterator(load_config([f"dataset_type={kind}"]), "cpu")


def _refuse_tokenizer(kind):
    from maxtext_indextts2_tpu_torch.train.data import tokenizer

    tokenizer.build_tokenizer(load_config([f"tokenizer_type={kind}"]))


def _refuse_weights(where):
    from maxtext_indextts2_tpu_torch.audio import conformer, pipeline, semantic_tokenizer

    {"conformer": lambda: conformer.params_from_hf({}, conformer.ConformerConfig()),
     "semantic_tokenizer": lambda: semantic_tokenizer.SemanticTokenizer.load_hf_encoder(None, {}),
     "pipeline": lambda: pipeline.TTSPipeline.load_torch_audio_weights(None)}[where]()


@pytest.mark.parametrize("refuse,arg,item", [
    (_refuse_dataset, "emilia_audio", "4b.3"), (_refuse_dataset, "grain", "4b.3"),
    (_refuse_dataset, "c4_mlperf", "4b.3"), (_refuse_tokenizer, "sentencepiece", "4b.1"),
    (_refuse_weights, "conformer", "4b.1"), (_refuse_weights, "semantic_tokenizer", "4b.1"),
    (_refuse_weights, "pipeline", "4b.1"),
])
def test_unported_data_and_weight_paths_say_not_ported_and_claim_no_missing_file(refuse, arg,
                                                                                 item):
    """The JAX package runs these on data, models and stubs a test makes, so
    the port's refusal says only that the path is not ported yet and names
    its queue item; it does not claim that a file is missing."""
    with pytest.raises(NotImplementedError) as err:
        refuse(arg)
    text = str(err.value)
    assert "not ported" in text and f"item {item}" in text
    assert "file" not in text and "in the repo" not in text


def test_make_batch_equals_the_jax_package():
    cfg, jcfg = configs(TRAIN, slots=ROWS)
    for step in (0, 3):
        ours, theirs = synthetic.make_batch(cfg, step, ROWS), jsynthetic.make_batch(jcfg, step,
                                                                                   ROWS)
        assert set(ours) == set(theirs)
        for k in ours:
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_flops_of_the_tts_1b_step_equal_the_jax_accounting():
    """The recipe's 4 x 2048 tokens: 66.8 TFLOP a step by both packages'
    formula (the JAX config has 8 devices, so 0.5 rows a device there)."""
    cfg = load_config([TTS_1B, "per_device_batch_size=4", "dataset_type=synthetic"])
    from maxtext_indextts2_tpu.config import load_config as jax_load_config

    jcfg = jax_load_config([os.path.join(REPO, "maxtext_indextts2_tpu", "configs", "models",
                                         "tts-1b.yml"), "per_device_batch_size=0.5"])
    assert cfg.global_batch_size_to_train_on == jcfg.global_batch_size_to_train_on == 4
    ours = flops.training_tflops_per_step(cfg)
    assert ours == pytest.approx(jflops.training_tflops_per_step(jcfg), rel=1e-12)
    assert 66.0 < ours < 67.5
    assert flops.mfu(ours, 1.0) == pytest.approx(ours / 989.0)
    from maxtext_indextts2_tpu_torch.models import Transformer

    with torch.device("meta"):
        n = sum(p.numel() for p in Transformer(cfg, device="meta").parameters())
    assert n == 1_294_031_872


def _jax_flash_kernels_in_grad(policy):
    """Flash kernels in the JAX package's gradient program, by kind: the
    forward has 7 operands, the backward kernels 10 (dq one result, dk/dv two)."""
    cfg, jcfg = configs(TRAIN + ["attention=flash", f"remat_policy={policy}"], slots=ROWS)
    jcfg = dataclasses.replace(jcfg, flash_block_sizes=(16, 16))
    model = JaxTransformer(cfg=jcfg)
    params = jax_tree(numpy_weights(cfg, seed=0))
    batch = {k: jnp.asarray(v) for k, v in synthetic.make_batch(cfg, 0, ROWS).items()}
    jaxpr = jax.make_jaxpr(jax.grad(
        lambda p: jtrain.loss_fn(model, jcfg, p, batch, jax.random.PRNGKey(0))[0]))(params)
    kinds = {(7, 2): "flash_fwd", (10, 1): "flash_bwd_dq", (10, 2): "flash_bwd_dkv"}
    counts = dict.fromkeys(kinds.values(), 0)

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "pallas_call":
                counts[kinds[(len(eqn.invars), len(eqn.outvars))]] += 1
            for v in eqn.params.values():
                for sub in v if isinstance(v, (list, tuple)) else [v]:
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(jaxpr.jaxpr)
    return cfg, counts


@pytest.mark.parametrize("policy", ["none", "save_attn_and_mlp", "full"])
def test_flash_kernels_a_step_equal_what_the_jax_program_runs(policy, monkeypatch):
    """The JAX package recomputes the flash forward under every remat policy
    (its custom VJP's residuals carry no name); the port's step calls each
    of the three kernels as often as the JAX gradient program holds them."""
    cfg, want = _jax_flash_kernels_in_grad(policy)
    cfg = dataclasses.replace(cfg, remat_policy=policy)
    got = dict.fromkeys(want, 0)
    for kernel in want:
        real = getattr(tfa, f"{kernel}_plain")

        def counted(*a, _real=real, _kernel=kernel, **k):
            got[_kernel] += 1
            return _real(*a, **k)

        monkeypatch.setattr(tfa, f"{kernel}_plain", counted)
    state = ttrain.setup_train_state(cfg, device="cpu", params={
        k: torch.from_numpy(v) for k, v in numpy_weights(cfg, seed=0).items()})
    batch = {k: torch.from_numpy(np.array(v)) for k, v in synthetic.make_batch(cfg, 0, 4).items()}
    ttrain.train_step(cfg, state, batch)
    layers = cfg.num_decoder_layers
    assert got == want
    assert want["flash_fwd"] == (1 if policy == "none" else 2) * layers


def test_eval_step_matches_jax_and_run_eval_averages():
    """``eval_step`` (no gradient) against the JAX package's on the same
    weights and batch (loss 2e-5, as the training steps); ``run_eval``
    weights every synthetic batch by its valid tokens."""
    cfg, jcfg = configs(TRAIN + ["attention=flash"], slots=ROWS)
    jcfg = dataclasses.replace(jcfg, flash_block_sizes=(16, 16))
    weights = numpy_weights(cfg, seed=3)
    batch = _batch(cfg, padded=True)
    model = JaxTransformer(cfg=jcfg)
    tx = joptim.get_optimizer(jcfg, joptim.create_learning_rate_schedule(jcfg))
    jstate = jtrain.TrainState.create(apply_fn=model.apply, params=jax_tree(weights), tx=tx)
    want = jtrain.eval_step(model, jcfg, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.PRNGKey(0))
    state = ttrain.setup_train_state(
        cfg, device="cpu", params={k: torch.from_numpy(v) for k, v in weights.items()})
    got = ttrain.eval_step(cfg, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got["eval_loss"]), float(want["eval_loss"]), atol=2e-5)
    assert float(got["eval_total_weights"]) == float(want["eval_total_weights"]) == (
        batch["targets_segmentation"] != 0).sum()
    out = ttrain.run_eval(cfg, state, num_batches=2)
    assert out["eval_weight"] == 2 * cfg.global_batch_size_to_eval_on * cfg.max_target_length
    assert np.isfinite(out["eval_loss"])


@pytest.mark.parametrize("attention,flash_calls", [("autoselected", 0), ("flash", 2)])
def test_autoselected_attention_takes_flash_only_on_a_cuda_device(attention, flash_calls,
                                                                 monkeypatch):
    """At S >= 1024 ``autoselected`` takes flash on a CUDA device (the JAX
    package: on a TPU); on the CPU it stays with the einsum attention."""
    cfg = load_config(TINY_TTS + TRAIN + ["per_device_batch_size=1", "max_target_length=1024",
                                          f"attention={attention}"])
    calls = {"n": 0}
    real = tfa.flash_fwd_plain

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(tfa, "flash_fwd_plain", counted)
    state = ttrain.setup_train_state(cfg, device="cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in synthetic.make_batch(cfg, 0, 1).items()}
    ttrain.eval_step(cfg, state, batch)
    assert cfg.num_decoder_layers == 2 and calls["n"] == flash_calls
