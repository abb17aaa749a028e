"""What the CPU can hold of the captured decode dispatch (``infer/cuda_graphs.py``).

A CUDA graph replays its kernels at the addresses they had at capture and
cannot read a value back to the host in the middle. So:

- every tensor of a decode state keeps its storage (``data_ptr``) through
  every engine call that touches the state: ``generate_n``, ``insert``,
  ``prefill_insert_many``, ``release_slot(s)``, dense and paged, and a
  speculative round;
- a decode step (``Engine._generate_step``: dense, paged, bucketed, with
  weighted sampling, with experts and with MLA's latent cache, the MoE
  layer's sparse route included) and a speculative round (``SpeculativeEngine._round``)
  make no device-to-host read: no ``aten._local_scalar_dense`` (``.item()``,
  ``int(t)``), ``aten.item``, ``aten.nonzero`` or ``aten.masked_select``, and
  no indexing by a boolean mask (whose result's size the host must read);
  and no host-to-device copy: no ``aten.lift_fresh``, the tensor that
  ``torch.tensor(...)`` or ``t[i] = 1`` makes on the host and a CUDA graph
  cannot copy in. A dispatch mode watches for each;
- a graph's kernel launches are counted once a replay (``ops/launch_counts``).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer.cuda_graphs import state_tensors
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.infer.speculative import SpeculativeEngine
from maxtext_indextts2_tpu_torch.ops import inplace_update, launch_counts
from maxtext_indextts2_tpu_torch.ops import ragged_decode_attention as rda
from torch_port_helpers import TINY_TTS, prompt

aten = torch.ops.aten
HOST_DEVICE_COPIES = {aten._local_scalar_dense, aten.item, aten.nonzero, aten.masked_select,
                  aten.lift_fresh}
INDEXING = {aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_}

ROUTES = {
    "dense_ragged": ["decode_attention=ragged"],
    "dense_dot_product": [],
    "dense_int8_kv": ["decode_attention=ragged", "quantize_kvcache=true"],
    "bucketed": ["decode_attention=bucketed"],
    "paged": ["paged_attention=true", "pagedattn_tokens_per_page=4", "pagedattn_num_pages=40"],
    "weighted_sampling": ["decode_sampling_strategy=weighted"],
    "topk_sampling": ["decode_sampling_strategy=topk", "decode_sampling_top_k=5"],
    "int8w_serve": ["decode_attention=ragged", "quantization=int8w_serve"],
    "int8w_serve_paged": ["quantization=int8w_serve", "paged_attention=true",
                          "pagedattn_tokens_per_page=4", "pagedattn_num_pages=40"],
    "aqt_int8": ["decode_attention=ragged", "quantization=int8"],
    "lora": ["decode_attention=ragged", "lora_rank=4"],
    "scanned": ["decode_attention=ragged", "scan_layers=true", "serve_unroll_layers=false"],
    # ROADMAP item 6: experts (the dense route on the CPU; the sparse route's
    # own test below) and MLA's latent cache with leading dense layers
    "moe": ["decode_attention=ragged", "num_experts=4", "num_experts_per_tok=2",
            "shared_experts=1"],
    "mla": ["decoder_block=deepseek", "kv_lora_rank=32", "qk_nope_head_dim=16",
            "qk_rope_head_dim=8", "v_head_dim=16", "num_experts=4", "num_experts_per_tok=2",
            "first_num_dense_layers=1", "base_num_decoder_layers=3"],
    # the gemma blocks scale the embedding by sqrt(E) (ROADMAP item 6, vision:
    # gemma3-4b serves image prompts through the captured step)
    "gemma3": ["decoder_block=gemma3", "base_num_decoder_layers=6", "sliding_window_size=8"],
}


class NoHostDeviceCopy(TorchDispatchMode):
    """Fails on any operator that copies between the host and the device."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in HOST_DEVICE_COPIES or (
                func.overloadpacket in INDEXING and any(
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in args[1])):
            raise AssertionError(f"a host-device copy inside a captured step: {func}")
        return func(*args, **(kwargs or {}))


def _engine(extra, slots=4):
    eng = Engine(load_config(TINY_TTS + extra + [f"per_device_batch_size={slots}"]),
                 device="cpu")
    eng.load_params()
    return eng


def _ptrs(state):
    return [t.data_ptr() for t in state_tensors(state)]


def _populated(eng):
    state = eng.init_decode_state()
    state, _ = eng.prefill_insert_many(state, [prompt(1, 5), prompt(2, 9)], [0, 2])
    prefix, _ = eng.prefill(prompt(3, 7), 7)
    return eng.insert(prefix, state, 3)


@pytest.mark.parametrize("route", ["dense_ragged", "dense_int8_kv", "paged", "int8w_serve",
                                   "scanned", "moe", "mla"])
def test_state_tensors_keep_their_storage(route):
    eng = _engine(ROUTES[route])
    state = eng.init_decode_state()
    ptrs = _ptrs(state)
    tensors = state_tensors(state)
    state, _ = eng.prefill_insert_many(state, [prompt(1, 5), prompt(2, 9)], [0, 2])
    state = eng.insert(eng.prefill(prompt(3, 7), 7)[0], state, 3)
    state, _ = eng.generate_n(state, 3)
    state, _ = eng.generate(state)
    state = eng.release_slot(state, 2)
    state, _ = eng.generate_n(state, 5)  # a page boundary on the paged route
    state = eng.release_slots(state, [0, 3])
    state, _ = eng.prefill_insert_many(state, [prompt(4, 6)], [2])
    state, _ = eng.generate_n(state, 2)
    assert _ptrs(state) == ptrs
    assert all(a is b for a, b in zip(state_tensors(state), tensors))


@pytest.mark.parametrize("route", list(ROUTES))
def test_a_decode_step_copies_nothing_between_host_and_device(route):
    eng = _engine(ROUTES[route])
    state = _populated(eng)
    uniform = eng._draw_uniform(eng.num_slots)
    assert (uniform is None) == (route not in ("weighted_sampling", "topk_sampling"))
    width = eng._decode_width(state, 1)
    assert (width is not None) == (route == "bucketed")
    with NoHostDeviceCopy():
        toks, logits = eng._generate_step(state, None, uniform, width)
    assert toks.shape == (eng.num_slots,) and torch.isfinite(logits).all()


@pytest.mark.parametrize("route", ["moe", "mla"])
def test_the_sparse_moe_route_copies_nothing(route, monkeypatch):
    """The MoE layer's sparse route (a CUDA tensor's route) run on the CPU
    inside a decode step: the stable sort by expert, the counts built with
    ``scatter_add_`` and ``cumsum``, the gathers and the ordered sum back
    read nothing on the host. The grouped products stand in by a gathered
    product over the device offsets (the kernel reads them on the device; its
    plain version reads them on the host), and the stream equals the dense
    route's."""
    from maxtext_indextts2_tpu_torch.models import moe as moe_lib

    def grouped(x, w, offsets, impl=None):
        rows = torch.arange(x.shape[0], dtype=torch.int32)
        group = torch.searchsorted(offsets[1:].contiguous(), rows, right=True)
        return torch.einsum("rk,rkn->rn", x, w[group]).to(x.dtype)

    eng = _engine(ROUTES[route])
    want = eng.generate_stream(prompt(5, 6), 5)
    calls = []

    def sparse_instead(self, x, top_idx, top_w, wi_0, wi_1, wo):
        calls.append(1)
        return self.sparse_experts(x, top_idx, top_w, wi_0, wi_1, wo)

    monkeypatch.setattr(moe_lib, "grouped_matmul", grouped)
    monkeypatch.setattr(moe_lib.RoutedMoE, "dense_experts", sparse_instead)
    state = _populated(eng)
    with NoHostDeviceCopy():
        toks, logits = eng._generate_step(state)
    assert calls and torch.isfinite(logits).all()
    got = eng.generate_stream(prompt(5, 6), 5)
    assert got == want


def test_the_dispatch_mode_sees_a_read_back():
    mask = torch.tensor([True, False, True])
    x = torch.zeros(3, dtype=torch.int32)
    for copy in (lambda: torch.ones(3).sum().item(), lambda: torch.ones(3)[mask],
                 lambda: x.__setitem__(torch.arange(2), 1), lambda: torch.tensor(2.0)):
        with pytest.raises(AssertionError, match="host-device copy"):
            with NoHostDeviceCopy():
                copy()


@pytest.mark.parametrize("extra", [[], ["quantize_kvcache=true"]], ids=["float", "int8_kv"])
def test_a_speculative_round_copies_nothing_and_keeps_storage(extra):
    args = TINY_TTS + ["decode_attention=ragged", "per_device_batch_size=2"] + extra
    spec = SpeculativeEngine(load_config(args), load_config(args + ["base_num_decoder_layers=1"]),
                             device="cpu", num_draft_tokens=3)
    spec.load_params()
    state = spec.init_decode_state()
    for slot, n in ((0, 5), (1, 11)):
        state = spec.insert(spec.prefill(prompt(slot, n), n)[0], state, slot)
    ptrs = _ptrs(state["target"]) + _ptrs(state["draft"])
    with NoHostDeviceCopy():
        toks, n_new = spec._round(state)
    assert toks.shape == (2, 4) and n_new.shape == (2,)
    state, _, _ = spec.generate(state)
    assert _ptrs(state["target"]) + _ptrs(state["draft"]) == ptrs


def test_launch_counts_add_a_captured_delta():
    """What a replay adds: the counts a capture made, once a replay, spans too."""
    before = launch_counts.snapshot()
    rda.launch_count += 20
    inplace_update.launch_count += 40
    inplace_update.span_launch_counts[5] = inplace_update.span_launch_counts.get(5, 0) + 4
    delta = launch_counts.diff(launch_counts.snapshot(), before)
    launch_counts.restore(before)
    assert launch_counts.snapshot() == before
    launch_counts.add(delta, times=3)
    after = launch_counts.snapshot()
    assert after[(rda.__name__, "launch_count")] == before[(rda.__name__, "launch_count")] + 60
    assert inplace_update.span_launch_counts[5] == before.get(
        (inplace_update.__name__, "span_launch_counts", 5), 0) + 12
    launch_counts.restore(before)
    assert 5 not in inplace_update.span_launch_counts or \
        (inplace_update.__name__, "span_launch_counts", 5) in before


def test_a_dispatch_draws_its_noise_before_its_steps():
    """Weighted sampling: a dispatch of n steps draws [n, slots, vocabulary]
    uniform noise from the engine's generator first (a captured graph reads
    it as an input), so one seed gives one stream again, and the tokens are
    the draws' argmax over logits + Gumbel noise."""
    runs = []
    for _ in range(2):
        eng = _engine(ROUTES["weighted_sampling"])
        state = _populated(eng)
        eng.generator.manual_seed(7)
        runs.append(torch.cat([eng.generate_n(state, 4)[1] for _ in range(2)]).numpy())
    np.testing.assert_array_equal(runs[0], runs[1])
    assert runs[0].shape == (8, 4) and len(np.unique(runs[0])) > 4
    eng.generator.manual_seed(7)
    u = eng._draw_uniform(4, eng.num_slots)
    assert u.shape == (4, eng.num_slots, eng.cfg.vocab_size) and 0 <= float(u.min())
