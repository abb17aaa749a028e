"""How far apart two bf16 computations of one MoE training step's gradients
lie, and how far each lies from a float32 step.

``qwen3-30b-a3b`` at full width, cut to 2 of its 48 layers (as ``chip_smoke.py``'s
``moe_train``: float32 weights, bf16 compute, remat ``full``, 1024-token rows,
K9-K11 on the autoselected route). For each (weights seed, synthetic batch)
pair, on one routing pinned to the first pass's expert selection, one step's
loss gradients are taken four times:

- ``sparse``: the sparse route through the grouped kernels (forward, dgrad,
  wgrad);
- ``sparse_plain``: the same route through the grouped products' plain
  versions (the same rounding points, another summation order);
- ``dense``: the dense einsum route;
- ``dense_f32``: the dense route with the whole step in float32.

For each pair of them it prints the worst leaf's ``max |a - b| / max |b|``
and the mean of that over the leaves, one JSON line a (batch size, pair).
Two bf16 steps that differ only in summation order move later bf16 roundings,
so their gap is the floor that any route comparison in bf16 sits on.

Run on the machine with the GPU::

    python -m maxtext_indextts2_tpu_torch.tools.moe_route_noise [batch=1,4] [pairs=3]
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import sys

import numpy as np
import torch

from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer.engine import resolve_device
from maxtext_indextts2_tpu_torch.models import Transformer
from maxtext_indextts2_tpu_torch.models import moe as moe_module
from maxtext_indextts2_tpu_torch.models.moe import RoutedMoE
from maxtext_indextts2_tpu_torch.tools.profile_decode import _card
from maxtext_indextts2_tpu_torch.train import train
from maxtext_indextts2_tpu_torch.train.data.synthetic import make_batch

QWEN3_TRAIN_ARGS = ["model_name=qwen3-30b-a3b", "base_num_decoder_layers=2",
                    "dataset_type=synthetic", "weight_dtype=float32", "dtype=bfloat16",
                    "scan_layers=false", "remat_policy=full", "max_target_length=1024",
                    "max_prefill_predict_length=1024"]
COMPARISONS = (("sparse", "dense"), ("sparse", "sparse_plain"), ("sparse", "dense_f32"),
               ("dense", "dense_f32"), ("sparse_plain", "dense_f32"), ("sparse_plain", "dense"))


@contextlib.contextmanager
def pinned_routing(models, selection: dict, flips: list):
    """Every RoutedMoE's expert selection pinned, by its name in the model:
    the first pass records each layer's top-k (``selection`` empty), later
    passes (of any of ``models``) take the recorded one through
    ``RoutedMoE.route``'s ``top_idx``, their combine weights from their own
    scores (the gradient path); ``flips`` gets, a call, the tokens whose
    selection that pass's own scores would have changed. A bf16 step's
    last-bit differences move a router near a tie to another expert, which
    takes a whole token's row from one expert's gradient to another's: two
    routes are compared on one routing."""
    pinned_modules = []
    for model in models:
        for name, m in model.named_modules():
            if not isinstance(m, RoutedMoE):
                continue

            def route(inputs, m=m, name=name):  # the same in every call: remat recomputes it
                own = RoutedMoE.route(m, inputs)[0]
                pinned = selection.setdefault(name, own)
                flips.append(int((torch.sort(pinned, -1).values
                                  != torch.sort(own, -1).values).any(-1).sum()))
                return RoutedMoE.route(m, inputs, top_idx=pinned)

            m.route = route
            pinned_modules.append(m)
    try:
        yield
    finally:
        for m in pinned_modules:
            del m.route


def shared_model(cfg, state=None):
    """A trainable Transformer on the GPU without an optimizer: seeded
    weights, or the tensors of ``state`` shared (not copied)."""
    model = Transformer(cfg, device=resolve_device(None))
    if state is None:
        model.init_params(cfg.init_weights_seed)
    else:
        model.load_state_dict(state, strict=True, assign=True)
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def rel_gaps(a: list, b: list) -> list:
    """max |a - b| / max |b| of each pair of tensors."""
    return [float((x.float() - y.float()).abs().max() / y.float().abs().max().clamp(min=1e-30))
            for x, y in zip(a, b)]


def measure(batch_size: int, pairs: int) -> list[dict]:
    args = QWEN3_TRAIN_ARGS + [f"per_device_batch_size={batch_size}"]
    cfg = load_config(args)
    cfg32 = load_config(args + ["dtype=float32"])
    model = shared_model(cfg)
    model32 = shared_model(cfg32, model.state_dict())
    names = [n for n, _ in model.named_parameters()]
    device = model.token_embedder.embedding.device
    grouped = moe_module.grouped_matmul
    out = []
    for i in range(pairs):
        if i:  # drawn in place: the float32 model shares the weights
            model.init_params(cfg.init_weights_seed + i)
        batch = {k: torch.from_numpy(np.array(v)).to(device)
                 for k, v in make_batch(cfg, i).items()}
        grads, selection, flips = {}, {}, []
        with pinned_routing((model, model32), selection, flips):
            for name, m, c in (("sparse", model, cfg), ("sparse_plain", model, cfg),
                               ("dense", model, cfg), ("dense_f32", model32, cfg32)):
                for moe in m.modules():
                    if isinstance(moe, RoutedMoE):
                        moe.cfg = dataclasses.replace(c, sparse_matmul=name.startswith("sparse"))
                if name == "sparse_plain":
                    moe_module.grouped_matmul = (
                        lambda x, w, o, impl=None: grouped(x, w, o, impl="plain"))
                try:
                    loss, _ = train.loss_fn(m, c, batch)
                    g = train._grads(loss, list(m.parameters()))
                finally:
                    moe_module.grouped_matmul = grouped
                grads[name] = [t.float().cpu() for t in g]
                del loss, g
                torch.cuda.empty_cache()
        res = {"batch_size": batch_size, "pair": i, "weights_seed": cfg.init_weights_seed + i,
               "routing_flips_of_the_later_passes": flips}
        for a, b in COMPARISONS:
            gaps = dict(zip(names, rel_gaps(grads[a], grads[b])))
            worst = max(gaps, key=gaps.get)
            res[f"{a}_vs_{b}"] = {"worst": [worst, gaps[worst]],
                                  "mean": float(np.mean(list(gaps.values())))}
        out.append(res)
        del grads
    del model, model32
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    opts = {"batch": "1,4", "pairs": "3"}
    for a in (sys.argv[1:] if argv is None else argv):
        k, _, v = a.partition("=")
        if k not in opts:
            raise SystemExit(f"unknown option {k!r}; known: {sorted(opts)}")
        opts[k] = v
    card = _card()
    for bsz in (int(b) for b in opts["batch"].split(",")):
        for res in measure(bsz, int(opts["pairs"])):
            print(json.dumps({"card": card, **res}), flush=True)


if __name__ == "__main__":
    main()
