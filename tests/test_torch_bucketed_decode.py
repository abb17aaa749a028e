"""``decode_attention=bucketed`` of the PyTorch package against the JAX
package on the CPU (the JAX package's ``tests/test_engine.py``
``test_bucketed_decode_matches_masked`` regime: a prompt past the prefill
limit, chunked, then greedy steps that cross buckets), float32, with a float
and an int8 KV cache.

The port reads the smallest power-of-two prefix of the cache (from 256)
that covers every slot through a whole dispatch, from a bound the engine
keeps on the host; the JAX attention picks it per step from the device's
lengths. Rows past a slot's length are masked and add nothing, so the
function is the same: greedy token streams are compared exactly, with the
JAX bucketed stream and the port's ``dot_product`` stream.
"""

import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu_torch.infer.engine import bucket_widths
from torch_port_helpers import engine_pair, prompt

LONG = ["max_target_length=640", "max_prefill_predict_length=256"]


@pytest.fixture(scope="module", params=[[], ["quantize_kvcache=true"]],
                ids=["float_kv", "int8_kv"])
def engines(request):
    bucketed = engine_pair(LONG + ["decode_attention=bucketed"] + request.param, slots=2)
    masked = engine_pair(LONG + request.param, slots=2)
    return bucketed, masked


def _stream(eng, p, steps, n=1, slot=0):
    prefix, first = eng.prefill_chunked(p, len(p), 256)
    state = eng.insert(prefix, eng.init_decode_state(), slot)
    out = [int(np.asarray(first.cpu() if isinstance(first, torch.Tensor) else first)[0])]
    for _ in range(steps // n):
        if isinstance(first, torch.Tensor):
            state, toks = eng.generate_n(state, n)
            out.extend(int(t) for t in toks[:, slot].tolist())
        else:
            state, toks = eng.generate(state)
            out.append(int(np.asarray(toks)[slot]))
    return out


def test_bucketed_stream_matches_jax_bucketed_and_masked(engines):
    (eng, jeng), (masked, _) = engines
    p = (np.arange(1, 251, dtype=np.int32) % 511) + 1  # 250 rows: the steps cross 256
    want = _stream(jeng, p, 40)
    assert _stream(eng, p, 40) == want
    assert _stream(eng, p, 40, n=4, slot=1) == want  # 4 steps a dispatch, the other slot
    assert _stream(masked, p, 40) == want
    assert len(set(want)) > 2, "a degenerate stream would prove little"


def test_width_covers_every_slot_through_the_dispatch(engines):
    (eng, _), _ = engines
    assert bucket_widths(640) == [256, 512, 640] and bucket_widths(64) == [256]
    state = eng.init_decode_state()
    assert eng._decode_width(state, 4) == 256
    prefix, _ = eng.prefill_chunked(prompt(1, 253), 253, 256)
    state = eng.insert(prefix, state, 1)
    assert eng._decode_width(state, 3) == 256  # rows 0..255 cover 253 + 3
    assert eng._decode_width(state, 4) == 512
    state, _ = eng.generate_n(state, 3)
    assert eng._decode_width(state, 1) == 512
    assert eng._decode_width(state, 1000) == 640  # never past the cache
    # a state the engine did not make reads the whole cache
    foreign = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in state.items()}
    assert eng._decode_width(foreign, 1) == 640


def test_bucketed_attention_reads_only_the_width():
    """Rows past the width are never read: garbage there changes nothing."""
    (eng, _), _ = engine_pair(LONG + ["decode_attention=bucketed"], slots=2), None
    p = prompt(2, 40)
    prefix, _ = eng.prefill(p[:16], 16)
    state = eng.insert(prefix, eng.init_decode_state(), 0)
    twin = eng.insert(prefix, eng.init_decode_state(), 0)
    for unit in twin["cache"]:
        for c in unit:
            c.cached_key[:, 256:] = float("nan")
            c.cached_value[:, 256:] = float("nan")
    a = eng.generate_n(state, 6)[1]
    b = eng.generate_n(twin, 6)[1]
    assert torch.equal(a, b)
