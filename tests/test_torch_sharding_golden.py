"""The port's weight layout against the JAX package's sharding goldens
(``tests/sharding_info``): at each golden's configuration, ``param_spec`` of
every parameter of the port's model equals the golden's ``PartitionSpec``
leaf for leaf, with the golden's scan-stacked ``layers`` dimension taken by
the unit's placement (None, or ``stage`` for a pipeline unit).

Each golden also fixes what a layer computes on (``parallel/tensor.compute_spec``):
the heads, ``mlp`` and vocabulary over ``tensor``, the experts over
``expert``, and nothing else; a storage axis outside it is gathered.
"""

import json
import math
import os
import re

import pytest

from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.models import Transformer
from maxtext_indextts2_tpu_torch.parallel.sharding import entry_axes, param_spec
from maxtext_indextts2_tpu_torch.parallel.tensor import compute_spec

GOLDENS = os.path.join(os.path.dirname(__file__), "sharding_info")
# each golden's configuration, as tests/test_sharding_golden.py builds it
TTS = ["decoder_block=tts", "base_emb_dim=256", "base_mlp_dim=512",
       "base_num_query_heads=4", "base_num_kv_heads=4", "head_dim=64",
       "max_target_length=128", "scan_layers=false"]
CASES = {
    "tts_fsdp4_tp2": TTS + ["base_num_decoder_layers=2", "vocab_size=9344",
                            "ici_fsdp_parallelism=4", "ici_tensor_parallelism=2"],
    "moe_ep4_tp2": ["decoder_block=mixtral", "base_emb_dim=256", "base_mlp_dim=512",
                    "moe_mlp_dim=512", "base_num_decoder_layers=2", "base_num_query_heads=4",
                    "base_num_kv_heads=4", "head_dim=64", "vocab_size=1024",
                    "max_target_length=128", "num_experts=8", "num_experts_per_tok=2",
                    "ici_expert_parallelism=4", "ici_tensor_parallelism=2",
                    "scan_layers=false"],
    "tts_pp2_fsdp2_tp2": TTS + ["base_num_decoder_layers=4", "vocab_size=9344",
                                "ici_stage_parallelism=2", "ici_fsdp_parallelism=2",
                                "ici_tensor_parallelism=2", "num_pipeline_repeats=2"],
}


class _Mesh:
    """A mesh's shape without ranks: what ``param_spec`` reads."""

    def __init__(self, cfg):
        self.axis_names = tuple(cfg.mesh_axes)
        self.shape = {ax: getattr(cfg, f"ici_{ax}_parallelism") for ax in self.axis_names}

    def axes_size(self, axes) -> int:
        return math.prod(self.shape.get(ax, 1) for ax in axes)


def _golden_key(name: str, pipelined: bool) -> str:
    """The JAX tree path of a port parameter: the unrolled ``layers_<i>``
    is the scan-stacked ``layers`` (``layers``/``layers`` when pipelined)."""
    parts = name.split(".")
    if parts[0] == "decoder" and re.fullmatch(r"layers_\d+", parts[1]):
        parts[1:2] = ["layers", "layers"] if pipelined else ["layers"]
    return "".join(f"['{p}']" for p in parts)


def _spec_text(entries) -> str:
    return "PartitionSpec(" + ", ".join(repr(e) for e in entries) + \
        ("," if len(entries) == 1 else "") + ")"


def _port_specs(name, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "8")
    cfg = load_config(CASES[name])
    mesh = _Mesh(cfg)
    pipelined = mesh.shape["stage"] > 1
    model = Transformer(cfg, device="meta")
    out = {}
    for pname, p in model.named_parameters():
        unit = pipelined and pname.startswith("decoder.layers_")
        spec = param_spec(pname, tuple(p.shape), cfg.emb_dim, mesh, unit_axis=unit)
        layered = pname.startswith("decoder.layers_")
        full = ((("stage" if unit else None),) if layered else ()) + spec
        key = _golden_key(pname, pipelined)
        assert out.setdefault(key, full) == full, key  # every layer alike
        out[key + "/compute"] = compute_spec(pname, tuple(p.shape), cfg.emb_dim, mesh)
        out[key + "/storage"] = spec
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_param_spec_equals_the_jax_golden(name, monkeypatch):
    with open(os.path.join(GOLDENS, f"{name}.json")) as fh:
        golden = json.load(fh)
    specs = _port_specs(name, monkeypatch)
    got = {k: _spec_text(v) for k, v in specs.items() if "/" not in k}
    assert set(got) == set(golden)
    for key, want in golden.items():
        assert got[key] == want, (key, got[key], want)


@pytest.mark.parametrize("name", list(CASES))
def test_compute_spec_splits_heads_mlp_vocab_and_experts_only(name, monkeypatch):
    specs = _port_specs(name, monkeypatch)
    for key in [k for k in specs if k.endswith("/compute")]:
        compute, storage = specs[key], specs[key.replace("/compute", "/storage")]
        for c, s in zip(compute, storage):
            assert set(entry_axes(c)) <= set(entry_axes(s)) & {"tensor", "expert"}, key
        if key.startswith(("['token_embedder']", "['logits_dense']")):
            assert "tensor" in [ax for c in compute for ax in entry_axes(c)], key
        if re.search(r"\['(query|key|value|out|wi_0|wi_1|wo)'\]", key):
            assert "tensor" in [ax for c in compute for ax in entry_axes(c)], key
        if re.search(r"norm", key):
            assert all(c is None for c in compute), key
    if name == "moe_ep4_tp2":
        assert specs["['decoder']['layers']['moe_0']['wi_0']/compute"] == ("expert", None,
                                                                             "tensor")

