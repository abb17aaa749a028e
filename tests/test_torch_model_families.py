"""The other model families (ROADMAP item 6, serving) end to end on the CPU:
gpt3 (LayerNorm, learned positions, biases, gelu), llama4 text (chunked
attention, a NoPE layer with temperature tuning, the l2 qk-norm, experts with
the weight on the input and a shared expert), deepseek (MLA's latent cache,
leading dense layers, routed and shared experts), mixtral and qwen3 with
experts, each served by the PyTorch package's ``Engine`` against the JAX
package's ``Engine`` holding the same numpy-seeded weights.

- The JAX package's decode matrix (``tests/test_engine.py:329``): the cached
  greedy stream equals the argmax of a teacher-forced forward over prompt +
  stream, for each family, across a window / chunk boundary; and the port's
  stream equals the JAX engine's, token for token.
- The windowed chunked prefill (``tests/test_engine.py:374``): chunked and
  whole prefill give the same last logits (2e-4, that test's tolerance: the
  chunks sum in another order), and the port's chunked logits equal the JAX
  package's within 2e-5.
- Speculative decoding on an MLA target (``tests/test_speculative.py:86``):
  the stream is exactly the target's greedy stream.
- Serving through the ``Orchestrator`` with packed admission, int8w_serve
  experts, and the two faults of the reference these ports found (packed
  admission and paged decode of an MLA model serve wrong streams in the JAX
  package; the port serves the first right and refuses the second).

Tolerances: float32 logits within 2e-5 (as ``tests/test_engine.py:325``);
greedy streams token for token.
"""

import dataclasses

import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.infer.engine import Engine as JaxEngine
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.infer.server import Orchestrator
from maxtext_indextts2_tpu_torch.infer.speculative import SpeculativeEngine
from maxtext_indextts2_tpu_torch.models import MODE_PREFILL
from torch_port_helpers import JAX_DEVICES, jax_tree, numpy_weights

TOL = 2e-5
TOL_CHUNKED = 2e-4
BASE = ["base_emb_dim=128", "base_mlp_dim=256", "base_num_decoder_layers=2",
        "base_num_query_heads=4", "base_num_kv_heads=2", "head_dim=32", "vocab_size=512",
        "max_target_length=64", "max_prefill_predict_length=16",
        "decode_sampling_strategy=greedy", "dtype=float32", "scan_layers=false"]
MLA = ["q_lora_rank=32", "kv_lora_rank=32", "qk_nope_head_dim=32", "qk_rope_head_dim=16",
       "v_head_dim=32"]
FAMILIES = {
    "gpt3": ["decoder_block=gpt3"],
    "llama4": ["decoder_block=llama4", "chunk_attn_window_size=8", "num_experts=4",
               "num_experts_per_tok=1", "moe_mlp_dim=256", "base_num_decoder_layers=4",
               "attn_temperature_floor_scale=4"],
    "deepseek": ["decoder_block=deepseek", "num_experts=1"] + MLA,
    "deepseek_moe": ["decoder_block=deepseek", "num_experts=8", "num_experts_per_tok=3",
                     "shared_experts=2", "moe_mlp_dim=64", "first_num_dense_layers=1",
                     "base_num_decoder_layers=3"] + MLA,
    "deepseek_v3_routing": ["decoder_block=deepseek", "num_experts=8", "num_experts_per_tok=2",
                            "shared_experts=1", "moe_mlp_dim=64", "first_num_dense_layers=1",
                            "base_num_decoder_layers=3", "routed_score_func=sigmoid",
                            "normalize_topk_weights=true", "routed_bias=true",
                            "n_routing_groups=4", "topk_routing_group=2", "rope_type=yarn",
                            "rope_factor=4"] + MLA,
    "mixtral": ["decoder_block=mixtral", "num_experts=4", "num_experts_per_tok=2",
                "normalize_topk_weights=true", "moe_mlp_dim=128"],
    "qwen3_moe": ["decoder_block=qwen3", "num_experts=8", "num_experts_per_tok=2",
                  "moe_mlp_dim=64"],
}


def _pair(args, slots=1, seed=0):
    cfg = load_config(args + [f"per_device_batch_size={slots}"])
    jcfg = jax_load_config(args + [f"per_device_batch_size={slots / JAX_DEVICES}"])
    weights = numpy_weights(cfg, seed)
    eng = Engine(cfg, device="cpu")
    eng.set_params({k: torch.from_numpy(v) for k, v in weights.items()})
    jeng = JaxEngine(dataclasses.replace(jcfg, scan_layers=False), params=jax_tree(weights))
    return eng, jeng


def _teacher_forced(eng, prompt, stream):
    full = np.concatenate([prompt, np.asarray(stream[:-1], np.int32)])
    toks = torch.as_tensor(full)[None, :]
    pos = torch.arange(len(full), dtype=torch.int32)[None, :]
    with torch.no_grad():
        logits = eng.model(toks, pos, torch.ones_like(toks), mode=MODE_PREFILL,
                           cache=eng.model.init_cache(1, len(full)))
    return logits[0].argmax(-1)[len(prompt) - 1:].tolist()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_engine_decode_matrix(family):
    eng, jeng = _pair(BASE + FAMILIES[family])
    prompt = np.array([3, 5, 7, 11, 13], np.int32)
    out = eng.generate_stream(prompt, 12)  # crosses the window / chunk of 8
    assert out == _teacher_forced(eng, prompt, out), family
    assert out == jeng.generate_stream(prompt, 12), family


@pytest.mark.parametrize("family", ["llama4", "deepseek_moe"])
def test_chunked_prefill_windowed_attention(family):
    args = BASE + FAMILIES[family] + ["max_prefill_predict_length=32"]
    eng, jeng = _pair(args)
    prompt = np.random.default_rng(0).integers(1, 512, size=24).astype(np.int32)
    full, _ = eng.prefill(prompt, 24)
    chunked, _ = eng.prefill_chunked(prompt, 24, chunk_size=8)
    np.testing.assert_allclose(chunked["logits"].numpy(), full["logits"].numpy(),
                               atol=TOL_CHUNKED)
    jfull, _ = jeng.prefill(prompt, 24)
    np.testing.assert_allclose(full["logits"].numpy(), np.asarray(jfull["logits"]), atol=TOL)
    jchunked, _ = jeng.prefill_chunked(prompt, 24, chunk_size=8)
    if family == "llama4":
        np.testing.assert_allclose(chunked["logits"].numpy(),
                                   np.asarray(jchunked["logits"]), atol=TOL)
    else:
        # a fault of the reference (ROADMAP queue 3): the JAX MLAttention takes
        # no chunk offset, so every chunk overwrites the latent rows from 0
        assert np.abs(np.asarray(jchunked["logits"]) - np.asarray(jfull["logits"])).max() > 0.1


def test_speculative_mla_exactness():
    """An MLA target with a random draft: its latent cache takes the verify
    span (written at the index, which stays), and the stream is exactly the
    target's greedy stream (the port's and the JAX engine's)."""
    args = BASE + FAMILIES["deepseek"] + ["max_target_length=96",
                                          "max_prefill_predict_length=32"]
    cfg = load_config(args + ["per_device_batch_size=1"])
    dcfg = load_config(BASE + ["per_device_batch_size=1", "max_target_length=96",
                               "max_prefill_predict_length=32", "base_num_decoder_layers=1",
                               "base_emb_dim=64"])
    eng, jeng = _pair(args)
    prompt = np.arange(3, 15, dtype=np.int32)
    want = eng.generate_stream(prompt, 20)
    assert want == jeng.generate_stream(prompt, 20)
    spec = SpeculativeEngine(cfg, dcfg, device="cpu", num_draft_tokens=3)
    spec.target.set_params(eng.params)
    spec.draft.load_params()
    got, rounds = spec.generate_stream(prompt, 20)
    assert got == want and rounds <= 20


@pytest.mark.parametrize("family", ["deepseek_moe", "mixtral", "llama4"])
def test_orchestrator_packed_admission_equals_single_streams(family):
    """More requests than slots through the Orchestrator (fused admission:
    several prompts packed in one prefill): each stream equals its prompt's
    single-stream decode. For MLA the JAX engine's packed prefill lets only
    the first prompt attend (``test_the_jax_packed_mla_admission_fault``)."""
    eng, _ = _pair(BASE + FAMILIES[family], slots=3)
    rng = np.random.default_rng(11)
    jobs = [(rng.integers(1, 512, size=int(n)).astype(np.int32), int(m))
            for n, m in zip(rng.integers(3, 16, size=6), rng.integers(2, 9, size=6))]
    orch = Orchestrator(eng, steps_per_dispatch=2)
    orch.start()
    try:
        reqs = [orch.submit(p, n) for p, n in jobs]
        assert all(r.done.wait(120) for r in reqs)
    finally:
        orch.stop()
    assert orch.stats["admission_dispatches_total"] < len(jobs)
    for (p, n), r in zip(jobs, reqs):
        assert r.error is None and r.tokens == eng.generate_stream(p, n)


def test_the_jax_packed_mla_admission_fault():
    """A fault of the reference (ROADMAP queue 3): the JAX ``MLAttention``
    masks a prefill with the latent cache's validity as the key segment id
    (0 or 1), so in a packed prefill the prompts of segments 2.. attend
    nothing, and ``prefill_insert_many`` serves them a wrong stream. The
    port's packed admission gives the single-stream decode."""
    eng, jeng = _pair(BASE + FAMILIES["deepseek"], slots=2)
    p1, p2 = np.arange(3, 12, dtype=np.int32), np.arange(40, 47, dtype=np.int32)
    want = [eng.generate_stream(p, 6) for p in (p1, p2)]
    assert want == [jeng.generate_stream(p, 6) for p in (p1, p2)]

    def packed(engine):
        state, firsts = engine.prefill_insert_many(engine.init_decode_state(), [p1, p2], [0, 1])
        rows = [np.asarray(firsts).tolist()]
        for _ in range(5):
            state, toks = engine.generate(state)
            rows.append(np.asarray(toks).tolist())
        return [[r[i] for r in rows] for i in (0, 1)]

    assert packed(eng) == want
    jax_packed = packed(jeng)
    assert jax_packed[0] == want[0] and jax_packed[1] != want[1]


def test_paged_mla_is_refused_where_the_jax_engine_serves_a_wrong_stream():
    """A fault of the reference (ROADMAP queue 3): the JAX engine builds a
    paged deepseek engine, but its paged insert writes only ``key_pages`` /
    ``value_pages`` and never the prompt's latents, so the stream differs
    from the dense one. The port refuses the configuration."""
    paged = ["paged_attention=true", "pagedattn_num_pages=40", "pagedattn_tokens_per_page=4"]
    args = BASE + FAMILIES["deepseek"]
    eng, jeng = _pair(args)
    prompt = np.arange(3, 12, dtype=np.int32)
    want = eng.generate_stream(prompt, 6)
    jcfg = jax_load_config(args + paged + [f"per_device_batch_size={1 / JAX_DEVICES}"])
    jpaged = JaxEngine(dataclasses.replace(jcfg, scan_layers=False), params=jeng.params)
    assert jpaged.generate_stream(prompt, 6) != want
    with pytest.raises(ValueError, match="paged_attention=true does not serve multi-head"):
        Engine(load_config(args + paged + ["per_device_batch_size=1"]), device="cpu")


@pytest.mark.parametrize("family", ["qwen3_moe", "deepseek_moe"])
def test_int8w_serve_experts_stream_equals_the_jax_engine(family):
    """``int8w_serve``: int8 experts with per-(expert, channel) scales (and
    int8 attention / dense kernels), quantized from the same float weights in
    both engines; the greedy streams equal."""
    from maxtext_indextts2_tpu_torch.ops.quantization import quantize_params_for_serving
    from maxtext_indextts2_tpu_torch.utils.param_bridge import params_to_jax

    args = BASE + FAMILIES[family] + ["quantization=int8w_serve"]
    cfg = load_config(args + ["per_device_batch_size=1"])
    jcfg = jax_load_config(args + [f"per_device_batch_size={1 / JAX_DEVICES}"])
    weights = numpy_weights(dataclasses.replace(cfg, quantization=""), seed=3)
    eng = Engine(cfg, device="cpu")
    params = eng.set_params({k: torch.from_numpy(v) for k, v in weights.items()})
    moe = [k for k in params if k.endswith("moe_0.wi_0")]
    assert moe and all(params[k].dtype == torch.int8 for k in moe)
    assert all(tuple(params[f"{k}_scale"].shape) == (cfg.num_experts, 1, cfg.moe_mlp_dim)
               for k in moe)
    q = quantize_params_for_serving({k: torch.from_numpy(v) for k, v in weights.items()},
                                    eng.model.state_dict())
    jq = jax_tree({k: v.numpy() for k, v in q.items()})
    jeng = JaxEngine(dataclasses.replace(jcfg, scan_layers=False), params=jq)
    assert params_to_jax(q).keys() == jq.keys()
    prompt = np.array([3, 5, 7, 11, 13], np.int32)
    assert eng.generate_stream(prompt, 10) == jeng.generate_stream(prompt, 10)


def test_gpt3_positions_and_layernorm_params():
    """gpt3's learned positions are an ``Embed`` of ``max_target_length``
    rows and its norms carry a bias; nothing else of the llama layout."""
    from maxtext_indextts2_tpu_torch.models import Transformer

    cfg = load_config(BASE + FAMILIES["gpt3"])
    names = Transformer(cfg, device="meta").state_dict()
    assert tuple(names["position_embedder.embedding"].shape) == (64, 128)
    assert "decoder_norm.bias" in names and "decoder.layers_0.pre_mlp_norm_0.bias" in names
    assert "decoder.layers_0.mlp_0.wi.bias" in names
    assert "decoder.layers_0.self_attention_0.query.bias" in names
    assert "logits_dense.kernel" not in names  # tied


def test_llama4_attention_is_chunked_and_nope_tuned():
    from maxtext_indextts2_tpu_torch.models import Transformer

    cfg = load_config(BASE + FAMILIES["llama4"])
    unit = Transformer(cfg, device="meta").decoder.layers_0
    chunk = [getattr(unit, f"self_attention_{i}") for i in range(4)]
    assert [a.chunk_attn_window_size for a in chunk] == [8, 8, 8, 0]
    assert [a.l2_qk_norm for a in chunk] == [True, True, True, False]
    assert [a.use_temperature_tuning for a in chunk] == [False, False, False, True]
    assert chunk[3].inv_freq is None and chunk[0].query_norm is None
    assert all(hasattr(unit, f"moe_{i}") and not hasattr(unit, f"mlp_{i}") for i in range(4))
