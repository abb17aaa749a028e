"""The decode cache split over ``context_autoregressive`` on two gloo ranks
against the JAX package's engine on one CPU device (float32, greedy), from
the same numpy weights.

Each rank holds ``max_target_length / 2`` rows of every slot (plus the spare
row that takes the decode writes of the rows the other rank owns); the
prompt's rows go to their owners at insert, a decode step writes its row on
the owner only, and ``dot_product`` decode merges the two ranks' partial
softmaxes by log-sum-exp. The greedy streams, a two-slot run and the
teacher-forced logits (1e-5 of the largest) equal the JAX engine's, on both
ranks. The JAX engine's two guards are the port's refusals, in its words:
``decode_attention`` other than ``dot_product``, and ``paged_attention``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
from torch_dist_helpers import run_ranks
from torch_port_helpers import TINY_TTS, configs, jax_tree, numpy_weights, prompt

from maxtext_indextts2_tpu.infer.engine import Engine as JaxEngine
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer.engine import Engine

STEPS = 8
SLOTS = 4
PROMPTS = [prompt(1, 5), prompt(2, 9)]
# a prompt of 16 rows and 40 steps: its stream crosses the ranks' boundary (row 32)
LONG = prompt(3, 16)
CA = ["ici_context_autoregressive_parallelism=2"]


def test_sequence_split_decode_equals_the_jax_engine(tmp_path):
    cfg, jcfg = configs(slots=SLOTS)
    weights = numpy_weights(cfg, seed=0)
    long_steps = 40
    case = (TINY_TTS + CA + [f"per_device_batch_size={SLOTS // 2}"], weights, PROMPTS, STEPS)
    case_long = (case[0], weights, [LONG], long_steps)
    ranks = run_ranks(tmp_path, 2, "serve", [case, case_long])
    jeng = JaxEngine(dataclasses.replace(jcfg, scan_layers=False), params=jax_tree(weights))
    want = [jeng.generate_stream(p, STEPS) for p in PROMPTS]
    want_long = jeng.generate_stream(LONG, long_steps)
    jstate, jfirst = jeng.prefill_insert_many(jeng.init_decode_state(), PROMPTS, [0, 1])
    jstate, jtoks = jeng.generate_n(jstate, STEPS)
    full = np.concatenate([PROMPTS[0], np.array(want[0][:-1], np.int32)])
    tokens = jnp.asarray(full)[None]
    jlogits = np.asarray(jeng.model.apply({"params": jeng.params}, tokens,
                                          jnp.arange(len(full))[None], jnp.ones_like(tokens)))[0]
    for r, (short, long) in enumerate(ranks):
        assert short["streams"] == want
        assert long["streams"] == [want_long]
        np.testing.assert_array_equal(short["first"], np.asarray(jfirst))
        np.testing.assert_array_equal(short["multi"], np.asarray(jtoks)[:, :2])
        np.testing.assert_allclose(short["logits"], jlogits, rtol=0,
                                   atol=1e-5 * np.abs(jlogits).max())
        # half the rows of every slot, and the spare row
        assert short["shapes"]["cached_key"] == (SLOTS, cfg.max_target_length // 2 + 1,
                                                 cfg.num_kv_heads, cfg.head_dim)
        assert short["captures"] == 0
        assert short["calls"]["cache_all_reduce"] > 0


@pytest.mark.parametrize("extra,match", [
    (["decode_attention=ragged"], "requires decode_attention=dot_product, got 'ragged'"),
    (["decode_attention=bucketed"], "requires decode_attention=dot_product"),
    (["paged_attention=true"], "incompatible with paged_attention"),
], ids=["ragged", "bucketed", "paged"])
def test_sequence_split_guards_refuse_what_the_jax_engine_refuses(extra, match, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    cfg = load_config(TINY_TTS + CA + extra + ["per_device_batch_size=2"])
    with pytest.raises(ValueError, match=match):
        Engine(cfg, device="cpu")
