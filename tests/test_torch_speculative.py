"""Speculative decoding (``infer/speculative.SpeculativeEngine``, the verify
span of ``MODE_VERIFY``) of the PyTorch package against the JAX package on
the CPU, in the regimes of the JAX package's ``tests/test_speculative.py``:
a random draft (float32, int8 and bfloat16 KV), the target as its own draft
(every round commits K+1 tokens), a sliding window, two slots at once, the
verify span's cache rows and masks, and ``decode.main`` with ``spec_draft=``.

With greedy sampling the speculative stream IS the target's plain greedy
stream, whatever the draft: token streams are compared exactly, against the
JAX package's speculative stream and the port's own plain decode. The verify
pass's outputs are held to 1e-5 (float32, the same arithmetic in another
order); cache rows, segment ids and write indices exactly.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.infer.speculative import SpeculativeEngine as JaxSpeculativeEngine
from maxtext_indextts2_tpu.models import attention as jax_attn
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer import decode as decode_cli
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.infer.speculative import SpeculativeEngine
from maxtext_indextts2_tpu_torch.models import attention as attn
from maxtext_indextts2_tpu_torch.utils.param_bridge import tree_to_state_dict
from torch_port_helpers import JAX_DEVICES, TINY_TTS, jax_tree, numpy_weights, prompt

TOL = 1e-5
# the draft: the target's vocabulary, lengths and slots, narrower and 1 layer
DRAFT = ["base_emb_dim=64", "base_mlp_dim=128", "base_num_decoder_layers=1",
         "base_num_query_heads=2", "base_num_kv_heads=1"]


def _pair_cfgs(args, slots):
    cfg = load_config(args + [f"per_device_batch_size={slots}"])
    jcfg = jax_load_config(args + [f"per_device_batch_size={slots / JAX_DEVICES}"])
    return cfg, dataclasses.replace(jcfg, scan_layers=False)


def spec_pair(extra=(), draft_extra=None, slots=1, k=3, draft_is_target=False):
    """(port SpeculativeEngine on the CPU, JAX SpeculativeEngine, port target
    Engine alone) holding the same numpy weights."""
    t_args = TINY_TTS + list(extra)
    d_args = t_args + (DRAFT if draft_extra is None else list(draft_extra))
    if draft_is_target:
        d_args = t_args
    cfg, jcfg = _pair_cfgs(t_args, slots)
    dcfg, jdcfg = _pair_cfgs(d_args, slots)
    tw = numpy_weights(cfg, seed=0)
    dw = tw if draft_is_target else numpy_weights(dcfg, seed=1)
    spec = SpeculativeEngine(cfg, dcfg, device="cpu", num_draft_tokens=k)
    spec.target.set_params({n: torch.from_numpy(v) for n, v in tw.items()})
    spec.draft.set_params({n: torch.from_numpy(v) for n, v in dw.items()})
    jspec = JaxSpeculativeEngine(jcfg, jdcfg, num_draft_tokens=k)
    jspec.target.params, jspec.draft.params = jax_tree(tw), jax_tree(dw)
    plain = Engine(cfg, device="cpu")
    plain.set_params({n: torch.from_numpy(v) for n, v in tw.items()})
    return spec, jspec, plain


@pytest.mark.parametrize("extra", [[], ["quantize_kvcache=true"], ["dtype=bfloat16"]],
                         ids=["f32_kv", "int8_kv", "bf16"])
def test_random_draft_gives_the_target_stream(extra):
    spec, jspec, plain = spec_pair(extra)
    p = prompt(3, 12)
    got, rounds = spec.generate_stream(p, 24)
    want, jrounds = jspec.generate_stream(p, 24)
    assert got == plain.generate_stream(p, 24)
    if "dtype=bfloat16" not in extra:  # the two packages round bfloat16 differently
        assert got == want
    assert rounds <= 24 and jrounds <= 24
    assert len(set(got)) > 2, "a degenerate stream would prove little"


def test_target_as_draft_commits_k_plus_1_every_round():
    """24 tokens after the prefill's, 4 a round: 6 rounds. The JAX round
    leaves the last accepted draft's row out of the draft's cache, so there
    the draft's later proposals go wrong and it takes more rounds (its own
    test allows up to 12); the stream is the same."""
    spec, jspec, plain = spec_pair(draft_is_target=True, k=3)
    p = prompt(4, 7)
    got, rounds = spec.generate_stream(p, 25)
    want, jrounds = jspec.generate_stream(p, 25)
    assert got == want == plain.generate_stream(p, 25)
    assert rounds == 6 and 6 <= jrounds <= 12
    state = spec.insert(spec.prefill(p, len(p))[0], spec.init_decode_state(), 0)
    for _ in range(3):
        state, toks, n_new = spec.generate(state)
        assert int(n_new[0]) == 4
    assert int(state["target"]["pos"][0]) == len(p) + 12 == int(state["draft"]["pos"][0])


def test_sliding_window_gives_the_target_stream():
    window = ["decoder_block=mistral", "sliding_window_size=8"]
    spec, jspec, plain = spec_pair(window, k=4)
    p = prompt(5, 12)
    got, _ = spec.generate_stream(p, 20)
    assert got == jspec.generate_stream(p, 20)[0] == plain.generate_stream(p, 20)


def test_two_slots_decode_independently():
    spec, jspec, plain = spec_pair(slots=2, k=3)
    prompts = [prompt(6, 8), prompt(7, 15)]
    want = [plain.generate_stream(p, 16) for p in prompts]
    got, jgot = {}, {}
    for eng, out in ((spec, got), (jspec, jgot)):
        state = eng.init_decode_state()
        for slot, p in enumerate(prompts):
            prefix, first = eng.prefill(p, len(p))
            state = eng.insert(prefix, state, slot)
            out[slot] = [int(np.asarray(first)[0])]
        while min(len(v) for v in out.values()) < 16:
            state, toks, n_new = eng.generate(state)
            toks, n_new = np.asarray(toks), np.asarray(n_new)
            for s in (0, 1):
                out[s].extend(int(t) for t in toks[s, :n_new[s]])
    assert [got[s][:16] for s in (0, 1)] == want == [jgot[s][:16] for s in (0, 1)]


def test_paged_cache_and_sampling_are_refused():
    cfg = load_config(TINY_TTS + ["per_device_batch_size=1"])
    paged = load_config(TINY_TTS + ["per_device_batch_size=1", "paged_attention=true",
                                    "pagedattn_tokens_per_page=4", "pagedattn_num_pages=40"])
    with pytest.raises(ValueError, match="paged"):
        SpeculativeEngine(paged, cfg, device="cpu")
    weighted = load_config(TINY_TTS + ["per_device_batch_size=1",
                                       "decode_sampling_strategy=weighted"])
    with pytest.raises(ValueError, match="greedy"):
        SpeculativeEngine(weighted, cfg, device="cpu")


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
def test_kvcache_verify_span_matches_jax(quantize):
    """The span lands at each slot's cache_index (through K2's plain version
    here), clamped at the cache's end; cache_index stays."""
    b, s, nkv, d, n = 3, 16, 2, 32, 6
    jcache = jax_attn.KVCache(max_length=s, num_kv_heads=nkv, head_dim=d, dtype=jnp.float32,
                              quantize=quantize)
    cache = attn.KVCache(b, s, nkv, d, torch.float32, quantize)
    rng = np.random.default_rng(8)
    k0, v0 = (rng.normal(size=(b, n, nkv, d)).astype(np.float32) for _ in range(2))
    lengths = np.array([6, 3, 1], np.int32)
    _, variables = jcache.apply({}, jnp.asarray(k0), jnp.asarray(v0), jax_attn.MODE_PREFILL,
                                jnp.asarray(lengths), method="update", mutable=["cache"])
    cache.update(torch.from_numpy(k0), torch.from_numpy(v0), attn.MODE_PREFILL,
                 torch.from_numpy(lengths))
    cache.cache_index.copy_(torch.tensor([6, 3, 13]))  # the last span runs past the end
    variables = {"cache": dict(variables["cache"], cache_index=jnp.asarray([6, 3, 13]))}
    k1, v1 = (rng.normal(size=(b, 5, nkv, d)).astype(np.float32) for _ in range(2))
    _, variables = jcache.apply(variables, jnp.asarray(k1), jnp.asarray(v1),
                                jax_attn.MODE_VERIFY, method="update", mutable=["cache"])
    cache.update(torch.from_numpy(k1), torch.from_numpy(v1), attn.MODE_VERIFY)
    want = variables["cache"]
    for name, leaf in cache.leaves().items():  # stores and copies only: exact
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[name]), err_msg=name)
    np.testing.assert_array_equal(cache.cache_index.numpy(), [6, 3, 13])


@pytest.mark.parametrize("kw", [dict(), dict(sliding_window_size=6),
                                dict(chunk_attn_window_size=8), dict(attn_logits_soft_cap=20.0)],
                         ids=["causal", "window6", "chunk8", "soft_cap"])
def test_verify_attention_module_matches_jax(kw):
    """Prefill 13 tokens, then one verify span of 5 at positions 13..17:
    the span's output (its masks over the whole cache) and the cache."""
    e, nq, nkv, d, s = 32, 4, 2, 16, 32
    jmod = jax_attn.Attention(num_query_heads=nq, num_kv_heads=nkv, head_dim=d,
                              max_target_length=s, dtype=jnp.float32, **kw)
    x = np.random.default_rng(9).normal(size=(2, 18, e)).astype(np.float32)
    pos = np.broadcast_to(np.arange(18, dtype=np.int32), (2, 18)).copy()
    seg = np.ones((2, 13), np.int32)
    params = flax.linen.meta.unbox(jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x[:, :13]), jnp.asarray(x[:, :13]),
        jnp.asarray(pos[:, :13]), jnp.asarray(seg), mode=jax_attn.MODE_PREFILL)["params"])
    mod = attn.Attention(e, nq, nkv, d, max_target_length=s, dtype=torch.float32, **kw)
    mod.load_state_dict({k: v.float() for k, v in
                         tree_to_state_dict(jax.tree.map(np.asarray, params)).items()})
    cache = mod.init_cache(2, s, "cpu")
    _, jvars = jmod.apply({"params": params}, jnp.asarray(x[:, :13]), jnp.asarray(x[:, :13]),
                          jnp.asarray(pos[:, :13]), jnp.asarray(seg),
                          mode=jax_attn.MODE_PREFILL, mutable=["cache"])
    mod(torch.from_numpy(x[:, :13]), torch.from_numpy(x[:, :13]),
        torch.from_numpy(pos[:, :13]), torch.from_numpy(seg), mode=attn.MODE_PREFILL,
        cache=cache)
    xv, pv = x[:, 13:], pos[:, 13:]
    want, jvars = jmod.apply({"params": params, "cache": jvars["cache"]}, jnp.asarray(xv),
                             jnp.asarray(xv), jnp.asarray(pv), jnp.ones((2, 5), jnp.int32),
                             mode=jax_attn.MODE_VERIFY, mutable=["cache"])
    got = mod(torch.from_numpy(xv), torch.from_numpy(xv), torch.from_numpy(pv),
              torch.ones((2, 5), dtype=torch.int32), mode=attn.MODE_VERIFY, cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    jcache = jvars["cache"]["kv_cache"]
    np.testing.assert_array_equal(cache.cache_index.numpy(), [13, 13])
    np.testing.assert_array_equal(cache.cache_index.numpy(), np.asarray(jcache["cache_index"]))
    np.testing.assert_array_equal(cache.cached_segment_ids.numpy(),
                                  np.asarray(jcache["cached_segment_ids"]))
    np.testing.assert_allclose(cache.cached_key.numpy(), np.asarray(jcache["cached_key"]),
                               atol=TOL)


def test_decode_cli_with_a_draft(tmp_path, capsys):
    """``spec_num_draft_tokens`` and ``spec_draft=<yml>``: the completion of
    the plain decode (both seeded), in fewer target passes."""
    args = TINY_TTS + ["device=cpu", "prompt=3,5,7,11", "max_new_tokens=9",
                      "per_device_batch_size=1"]
    plain = decode_cli.main(args)
    draft_yml = tmp_path / "draft.yml"
    draft_yml.write_text("\n".join(a.replace("=", ": ", 1) for a in TINY_TTS + DRAFT) + "\n")
    got = decode_cli.main(args + ["spec_num_draft_tokens=3", f"spec_draft={draft_yml}"])
    assert got == plain
    assert "speculative: 9 tokens in" in capsys.readouterr().out
