"""The tensor split inside the layers (``tensor`` and ``autoregressive``,
``parallel/tensor.py``) on gloo ranks against the JAX package on one CPU
device, from the same numpy weights (float32, greedy):

- serving on two ranks (``Engine(mesh=...)``: q / k / v and ``out`` split
  over the heads, the MLP over its width, the vocabulary of the embedding
  and the logits, the logits all-gathered before sampling), dense
  (``dot_product``), paged (the gather route of ``infer/paged_attention``)
  and, over ``autoregressive``, through K1's plain version (``ragged``), and
  with ``int8w_serve`` weights quantized from the same float ones (the JAX
  engine holding its own quantization of them): each greedy stream and a
  two-slot run equal the JAX engine's token for token, on every rank; the
  teacher-forced logits within 1e-5 of the largest; the same for the
  deepseek block (multi-head latent attention split over its heads, the
  latent cache whole on every rank, MoE experts split over their ``mlp``);
- training on four ranks, ``fsdp`` 2 x ``tensor`` 2, ``sequence`` 2 x
  ``tensor`` 2 and ``tensor_sequence`` 2 x ``fsdp`` 2 (the vocabulary-parallel
  cross-entropy, each tensor-split weight's gradient summed over the batch
  ranks only; the sequence's K/V all-gathered in attention; Megatron's
  sequence parallelism): three steps against the JAX ``train_step`` on the
  global batch, with ``tests/test_torch_fsdp_train.py``'s tolerances;
- the autograd collectives of the splits (``comm.CopyToGroup`` "f",
  ``comm.ReduceFromGroup`` "g", ``comm.AllToAllV``) against their one-rank
  identities.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_helpers import run_ranks
from torch_spawn_once import run_ranks_once
from torch_port_helpers import TINY_TTS, configs, jax_tree, numpy_weights, prompt

from maxtext_indextts2_tpu.infer.engine import Engine as JaxEngine
from maxtext_indextts2_tpu.models import Transformer as JaxTransformer
from maxtext_indextts2_tpu.ops.quantization import (
    quantize_params_for_serving as jax_quantize_params,
)
from maxtext_indextts2_tpu.train import optimizers as joptim
from maxtext_indextts2_tpu.train import train as jtrain
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.train.data import synthetic
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_from_jax

STEPS = 8
SLOTS = 4
PAGED = ["paged_attention=true", "pagedattn_tokens_per_page=4", "pagedattn_num_pages=40"]
# multi-head latent attention with MoE layers after a dense one (the
# deepseek block, tiny): q / kv heads split, the latent cache whole
MLA = ["decoder_block=deepseek", "base_num_query_heads=4", "base_num_kv_heads=4",
       "kv_lora_rank=32", "q_lora_rank=24", "qk_nope_head_dim=16", "qk_rope_head_dim=8",
       "v_head_dim=16", "num_experts=4", "num_experts_per_tok=2", "moe_mlp_dim=64",
       "first_num_dense_layers=1"]
SERVE = {  # name: (the port's mesh, the decode route of both engines, the model's args)
    "tensor_dense": (["ici_tensor_parallelism=2"], [], []),
    "tensor_paged": (["ici_tensor_parallelism=2"], PAGED, []),
    "autoregressive_ragged": (["ici_autoregressive_parallelism=2"],
                              ["decode_attention=ragged"], []),
    # int8w_serve: a column split's int8 kernel and channel scales are the
    # rank's columns; a row split sums the ranks' int8w_matmul partials
    "tensor_int8w": (["ici_tensor_parallelism=2"],
                     ["decode_attention=ragged", "quantization=int8w_serve"], []),
    "tensor_mla": (["ici_tensor_parallelism=2"], [], MLA),
}
# seeded weights (no checkpoint) on a split engine: each rank's pieces are
# its cut of the one-rank engine's draws
MOE = ["decoder_block=qwen3", "num_experts=4", "num_experts_per_tok=2", "moe_mlp_dim=64"]
SEEDED = {"tensor": ["ici_tensor_parallelism=2"],
          "tensor_int8w": ["ici_tensor_parallelism=2", "quantization=int8w_serve",
                           "decode_attention=ragged"],
          "expert": MOE + ["ici_expert_parallelism=2"],
          "tensor_mla": MLA + ["ici_tensor_parallelism=2"]}
PROMPTS = [prompt(1, 5), prompt(2, 9), prompt(3, 16)]
SAMPLED = ["decode_sampling_strategy=weighted", "decode_sampling_temperature=0.8"]
TRAIN = ["max_target_length=32", "learning_rate=1e-3", "warmup_steps_fraction=0.2", "steps=5",
         "dataset_type=synthetic", "remat_policy=full", "attention=flash"]
TRAIN_STEPS = 3
ROWS = 8


def _weights(model=()):
    return numpy_weights(configs(model, slots=SLOTS)[0], seed=0)


def _train_setup(model=()):
    cfg, _ = configs(TRAIN + list(model), slots=ROWS)
    batch = {k: np.array(v) for k, v in synthetic.make_batch(cfg, 0, ROWS).items()}
    for r in range(0, ROWS, 2):  # packed rows: a second document and a padded tail
        batch["inputs_segmentation"][r, 20:] = 2
        batch["inputs_position"][r, 20:] -= 20
        batch["inputs_segmentation"][r, 28:] = 0
    batch["targets_segmentation"] = batch["inputs_segmentation"].copy()
    return numpy_weights(cfg, seed=7), batch


@pytest.fixture(scope="module")
def serve_ranks(tmp_path_factory):
    weights = {name: _weights(model) for name, (_, _, model) in SERVE.items()}
    cases = [(TINY_TTS + model + mesh + route + [f"per_device_batch_size={SLOTS // 2}"],
              weights[name], PROMPTS, STEPS) for name, (mesh, route, model) in SERVE.items()]
    # weighted sampling: every rank draws the same noise from its seeded generator
    cases.append((TINY_TTS + SAMPLED + ["ici_tensor_parallelism=2",
                                        f"per_device_batch_size={SLOTS // 2}"],
                  weights["tensor_dense"], PROMPTS, STEPS))
    x = np.random.default_rng(0).normal(size=(2, 6, 3)).astype(np.float32)
    g = np.random.default_rng(1).normal(size=(2, 6, 3)).astype(np.float32)
    mla_weights, mla_batch = _train_setup(MLA)
    mla_train = (TINY_TTS + TRAIN + MLA + ["ici_tensor_parallelism=2",
                                           f"per_device_batch_size={ROWS // 2}"],
                 mla_weights, mla_batch)
    seeded = [TINY_TTS + extra + [f"per_device_batch_size={SLOTS // 2}"]
              for extra in SEEDED.values()]
    ranks = run_ranks_once(tmp_path_factory, "tp_serve", 2, "several",
                      [("serve", (cases,)), ("collectives", ([(x, g)],)),
                       ("train", ([mla_train], TRAIN_STEPS)), ("seeded", (seeded,))])
    return {"serve": {name: [r[0][i] for r in ranks] for i, name in enumerate(SERVE)},
            "sampled": [r[0][len(SERVE)] for r in ranks],
            "collectives": [r[1][0] for r in ranks], "x": x, "g": g, "weights": weights,
            "mla_train": [r[2][0] for r in ranks],
            "seeded": {name: [r[3][i] for r in ranks] for i, name in enumerate(SEEDED)}}


def _jax_engine(route, weights):
    _, jcfg = configs(list(route), SLOTS)
    jcfg = dataclasses.replace(jcfg, scan_layers=False)
    params = jax_tree(weights)
    if jcfg.quantization == "int8w_serve":  # as the JAX engine's load_params makes it
        import flax.linen as nn

        model = JaxTransformer(cfg=jcfg)
        dummy = jnp.zeros((1, 4), jnp.int32)
        abstract = jax.eval_shape(lambda r: model.init(r, dummy, dummy, dummy)["params"],
                                  jax.random.PRNGKey(0))
        params = jax_quantize_params(params, nn.meta.unbox(abstract))
    return JaxEngine(jcfg, params=params)


@pytest.mark.parametrize("name", list(SERVE))
def test_split_serving_streams_equal_the_jax_engine(name, serve_ranks):
    _, route, model = SERVE[name]
    jeng = _jax_engine(model + route, serve_ranks["weights"][name])
    want = [jeng.generate_stream(p, STEPS) for p in PROMPTS]
    # the JAX side admits each prompt alone: its packed prefill of the deepseek
    # block disagrees with its own single prefill (ROADMAP queue 3), the
    # port's does not
    jstate, jfirst = jeng.init_decode_state(), []
    for slot, p in enumerate(PROMPTS[:2]):
        prefix, first = jeng.prefill(p, len(p))
        jstate = jeng.insert(prefix, jstate, slot)
        jfirst.append(int(np.asarray(first)[0]))
    jstate, jtoks = jeng.generate_n(jstate, STEPS)
    for rank in serve_ranks["serve"][name]:  # every rank samples the same tokens
        assert rank["streams"] == want
        np.testing.assert_array_equal(rank["first"], np.asarray(jfirst))
        np.testing.assert_array_equal(rank["multi"], np.asarray(jtoks)[:, :2])
        assert rank["captures"] == 0  # the dispatch on a mesh runs eagerly
        assert rank["calls"].get("tp_all_reduce", 0) > 0
    # the teacher-forced logits of the first stream, gathered over the vocabulary
    full = np.concatenate([PROMPTS[0], np.array(want[0][:-1], np.int32)])
    tokens = jnp.asarray(full)[None]
    jlogits = np.asarray(jeng.model.apply({"params": jeng.params}, tokens,
                                          jnp.arange(len(full))[None], jnp.ones_like(tokens)))[0]
    for rank in serve_ranks["serve"][name]:
        np.testing.assert_allclose(rank["logits"], jlogits, rtol=0,
                                   atol=1e-5 * np.abs(jlogits).max())


def test_split_sampling_draws_the_same_tokens_on_every_rank(serve_ranks):
    """Weighted sampling over tensor 2: each rank draws its noise from the
    engine's generator seeded alike, so every rank samples the same tokens,
    and they are the one-rank engine's from the same seed and weights."""
    cfg, _ = configs(SAMPLED, slots=SLOTS)
    eng = Engine(cfg, device="cpu")
    weights = serve_ranks["weights"]["tensor_dense"]
    eng.set_params({k: torch.from_numpy(v) for k, v in weights.items()})
    want = [eng.generate_stream(p, STEPS) for p in PROMPTS]
    for rank in serve_ranks["sampled"]:
        assert rank["streams"] == want


def test_each_rank_caches_its_own_kv_heads(serve_ranks):
    cfg, _ = configs(slots=SLOTS)
    runs = serve_ranks["serve"]
    heads = cfg.num_kv_heads // 2
    for rank in runs["tensor_dense"] + runs["autoregressive_ragged"] + runs["tensor_int8w"]:
        assert rank["shapes"]["cached_key"] == (SLOTS, cfg.max_target_length, heads,
                                                cfg.head_dim)
    for rank in runs["tensor_paged"]:
        assert rank["shapes"]["key_pages"] == (40, 4, heads, cfg.head_dim)


@pytest.mark.parametrize("name", list(SEEDED))
def test_split_engine_seeds_each_rank_with_its_piece_of_the_one_rank_draws(name, serve_ranks):
    for rank in serve_ranks["seeded"][name]:
        assert rank["differ"] == []
        assert rank["bytes"] < rank["one_rank_bytes"]


@pytest.mark.parametrize("extra", [[], MOE, MLA], ids=["tts", "moe", "mla"])
def test_seeded_weights_are_the_init_params_draws(extra):
    """``Engine._seeded_weights`` (a module's weights at a time) draws what
    ``Transformer.init_params`` draws over the whole model."""
    from maxtext_indextts2_tpu_torch.models import Transformer

    cfg, _ = configs(extra, slots=SLOTS)
    got = dict(Engine(cfg, device="cpu")._seeded_weights())
    want = Transformer(cfg, device="cpu").init_params(cfg.init_weights_seed).state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[n], want[n]) for n in want)


def test_split_collectives_equal_their_one_rank_identities(serve_ranks):
    x, g = serve_ranks["x"], serve_ranks["g"]
    ranks = serve_ranks["collectives"]
    for r, res in enumerate(ranks):
        y, dx = res["f"]  # identity forward, the gradients' sum backward
        np.testing.assert_array_equal(y.numpy(), x[r])
        np.testing.assert_allclose(dx.numpy(), g.sum(0), rtol=1e-6)
        y, dx = res["g"]  # the inputs' sum forward, identity backward
        np.testing.assert_allclose(y.numpy(), x.sum(0), rtol=1e-6)
        np.testing.assert_array_equal(dx.numpy(), g[r])
        # the equal-split all-to-all: chunk r of every rank, in rank order
        np.testing.assert_array_equal(res["all_to_all"].numpy(),
                                      np.concatenate([x[j][3 * r:3 * r + 3] for j in range(2)]))
    # the variable splits: rank r sent r + 1 rows to rank 0 and 1 row to rank 1
    y0, dx0, _, _ = ranks[0]["all_to_all_v"]
    y1, dx1, _, _ = ranks[1]["all_to_all_v"]
    np.testing.assert_array_equal(y0.numpy(), np.concatenate([x[0][:1], x[1][:2]]))
    np.testing.assert_array_equal(y1.numpy(), np.concatenate([x[0][1:2], x[1][2:3]]))
    # the backward is the reverse exchange: each row's gradient comes home
    w0 = np.arange(y0.numel(), dtype=np.float32).reshape(y0.shape)
    w1 = np.arange(y1.numel(), dtype=np.float32).reshape(y1.shape)
    np.testing.assert_array_equal(dx0.numpy(), np.concatenate([w0[:1], w1[:1]]))
    np.testing.assert_array_equal(dx1.numpy(), np.concatenate([w0[1:3], w1[1:2]]))


def _jax_train(weights, batch, model=()):
    _, jcfg = configs(TRAIN + list(model), slots=ROWS)
    jcfg = dataclasses.replace(jcfg, flash_block_sizes=(16, 16))
    model = JaxTransformer(cfg=jcfg)
    tx = joptim.get_optimizer(jcfg, joptim.create_learning_rate_schedule(jcfg))
    state = jtrain.TrainState.create(apply_fn=model.apply, params=jax_tree(weights), tx=tx)
    step = jax.jit(functools.partial(jtrain.train_step, model, jcfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    history = []
    for _ in range(TRAIN_STEPS):
        state, m = step(state, jbatch, jax.random.PRNGKey(0))
        history.append({k: float(v) for k, v in m.items()})
    return state, history


TRAIN_MESHES = {  # name: (the port's mesh, per-device rows)
    "fsdp2_tensor2": (["ici_fsdp_parallelism=2", "ici_tensor_parallelism=2"], ROWS // 2),
    # the sequence split between the layers (K/V all-gathered over it) beside the tensor split
    "sequence2_tensor2": (["ici_sequence_parallelism=2", "ici_tensor_parallelism=2",
                           "ici_fsdp_parallelism=1"], ROWS // 4),
    # Megatron's sequence parallelism: the residual stream on length shards,
    # all-gathered before each column split and reduce-scattered after each row split
    "tensor_sequence2_fsdp2": (["ici_tensor_sequence_parallelism=2", "ici_fsdp_parallelism=2"],
                               ROWS // 2),
}


@pytest.fixture(scope="module")
def train_ranks(tmp_path_factory):
    weights, batch = _train_setup()
    cases = [(TINY_TTS + TRAIN + mesh + [f"per_device_batch_size={rows}"], weights, batch)
             for mesh, rows in TRAIN_MESHES.values()]
    ranks = run_ranks_once(tmp_path_factory, "tp_train", 4, "train", cases, TRAIN_STEPS)
    return {name: [r[i] for r in ranks] for i, name in enumerate(TRAIN_MESHES)}


@pytest.mark.parametrize("name", list(TRAIN_MESHES))
def test_split_training_matches_jax(name, train_ranks):
    weights, batch = _train_setup()
    _assert_steps_match_jax(train_ranks[name], weights, batch)
    # the weights are stored over fsdp (or sequence) x tensor: a rank holds
    # about a quarter
    total = sum(v.nbytes for v in weights.values())
    for rank in train_ranks[name]:
        assert rank["piece_bytes"] < 0.27 * total, rank["piece_bytes"]
        assert rank["counts"] == {"gathers": TRAIN_STEPS, "reductions": TRAIN_STEPS}


def test_latent_attention_training_over_tensor_matches_jax(serve_ranks):
    """The deepseek block over tensor 2 on two ranks: latent attention's
    heads and each expert's ``mlp`` split, three steps as the other splits."""
    weights, batch = _train_setup(MLA)
    _assert_steps_match_jax(serve_ranks["mla_train"], weights, batch, MLA)


def _assert_steps_match_jax(ranks, weights, batch, model=()):
    jstate, jhist = _jax_train(weights, batch, model)
    for rank in ranks:
        for step, (got, want) in enumerate(zip(rank["history"], jhist)):
            np.testing.assert_allclose(got["loss"], want["loss"], atol=2e-5, rtol=0,
                                       err_msg=f"loss, step {step}")
            for key in ("grad_norm", "param_norm"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                           err_msg=f"{key} {step}")
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    got = ranks[0]["params"]
    assert set(got) == set(want)
    for n, w in want.items():
        diff = np.abs(got[n].numpy() - w.numpy())
        assert diff.max() <= 5e-5, (n, diff.max())
        assert (diff > 2e-6).mean() <= 1e-3, (n, int((diff > 2e-6).sum()))
        for other in ranks[1:]:  # one state, gathered on every rank
            assert torch.equal(other["params"][n], got[n]), n
    adam = jstate.opt_state[0]
    for key in ("mu", "nu"):
        jm = params_from_jax(jax.tree.map(np.asarray, getattr(adam, key)))
        for n, w in jm.items():
            w = w.numpy()
            np.testing.assert_allclose(ranks[0][key][n].numpy(), w, rtol=1e-5,
                                       atol=1e-4 * np.abs(w).max(), err_msg=f"{key} {n}")


def test_ulysses_checks_the_heads_a_rank_holds_after_the_tensor_split():
    """q / k / v of a tensor-split layer hold this rank's heads: tts at 4 q /
    2 kv heads over tensor 2 leaves 2 / 1, which context 2 cannot split into
    Ulysses' head shards (the JAX package checks the per-device heads the same way)."""
    import types

    from maxtext_indextts2_tpu_torch.ops.flash_attention import flash_attention_sharded

    mesh = types.SimpleNamespace(shape={"context": 2}, group=lambda axes: None)
    q = torch.zeros((1, 8, 2, 32))
    kv = torch.zeros((1, 8, 1, 32))
    with pytest.raises(ValueError, match=r"per-rank query heads \(2\) and kv heads \(1\)"):
        flash_attention_sharded(q, kv, kv, None, mesh=mesh, algorithm="ulysses")


PIPE = ["base_emb_dim=64", "base_mlp_dim=128", "base_num_query_heads=2", "base_num_kv_heads=2",
        "head_dim=32", "vocab_size=256", "max_target_length=32", "dtype=float32",
        "attention=dot_product", "decoder_block=tts", "scan_layers=false"]


def test_pipeline_stages_by_tensor_match_jax(tmp_path):
    """Stage 2 x tensor 2 on four ranks (the ``tts_pp2_fsdp2_tp2`` golden's
    axes, executed): each stage rank holds its units' pieces of the tensor
    split; the logits (gathered over the vocabulary) and the gradients of
    mean(logits**2) against the JAX package's unpipelined model on the same
    weights, within 1e-5 as ``tests/test_torch_pipeline.py`` holds the
    pipeline."""
    args = PIPE + ["base_num_decoder_layers=4", "ici_stage_parallelism=2",
                   "ici_tensor_parallelism=2", "ici_fsdp_parallelism=1",
                   "num_pipeline_microbatches=4", "per_device_batch_size=2"]
    cfg, jcfg = configs(PIPE + ["base_num_decoder_layers=4"], slots=8)
    weights = numpy_weights(cfg, seed=5)
    tokens = np.random.default_rng(5).integers(1, 256, size=(8, 32)).astype(np.int32)
    ranks = [r[0] for r in run_ranks(tmp_path, 4, "pipeline_split", [(args, weights, tokens)])]
    model = JaxTransformer(cfg=dataclasses.replace(jcfg, scan_layers=False))
    tok = jnp.asarray(tokens)
    pos = jnp.broadcast_to(jnp.arange(32)[None], tok.shape)

    def loss(p):
        logits = model.apply({"params": p}, tok, pos, jnp.ones_like(tok))
        return jnp.mean(jnp.square(logits.astype(jnp.float32))), logits

    (_, jlogits), jgrads = jax.value_and_grad(loss, has_aux=True)(jax_tree(weights))
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    jlogits = np.asarray(jlogits)
    for rank in ranks:
        np.testing.assert_allclose(rank["logits"].numpy(), jlogits, rtol=0,
                                   atol=1e-5 * np.abs(jlogits).max())
        assert set(rank["grads"]) == set(want)
        for n, w in want.items():
            w = w.numpy()
            np.testing.assert_allclose(rank["grads"][n].numpy(), w, rtol=0,
                                       atol=1e-5 * max(np.abs(w).max(), 1e-6), err_msg=n)
    # layer r*S + s on stage s
    assert ranks[0]["units"] == ["layers_0", "layers_2"] and ranks[1]["units"] == ranks[0]["units"]
    assert ranks[2]["units"] == ["layers_1", "layers_3"]
