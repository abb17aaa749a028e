"""The port's mesh, logical sharding and parallel data paths against the
JAX package's (``parallel/``, ``train/data/multihost.py``,
``train/data/colocated.py``).

- ``resolve`` over every logical name and the weights' name tuples, on
  several meshes, equals the JAX ``resolve`` (pure Python on both sides);
- each parameter's logical names (``sharding.param_logical_axes``) equal the
  names the JAX model attaches to the same weight (dense, MoE and MLA models);
- the config fills the degrees of a world of 8 ranks as the JAX package
  fills its 8 devices;
- a degree above 1 on an axis that needs collectives inside the layers is
  refused at mesh creation, naming its queue item;
- on two gloo ranks: the mesh's layout (DTensor placements, a rank's piece
  of a batch, a multi-host batch), and the training entry point on the mesh
  with checkpoints (written by rank 0 under the one-rank names) and a resume,
  equal to one process on the same global batch (loss 2e-5);
- the colocated input pipeline yields the in-process batches from a spawned
  process, resumes by its state, and trains.
"""

import dataclasses
import os
import types

import flax
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_helpers import run_ranks
from torch_port_helpers import TINY_TTS

from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.models import Transformer as JaxTransformer
from maxtext_indextts2_tpu.parallel import create_device_mesh as jax_mesh
from maxtext_indextts2_tpu.parallel import resolve as jax_resolve
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.parallel import create_device_mesh
from maxtext_indextts2_tpu_torch.parallel.sharding import (
    LOGICAL_AXIS_RULES,
    assert_params_sufficiently_sharded,
    param_logical_axes,
    resolve,
)
from maxtext_indextts2_tpu_torch.train import checkpointing
from maxtext_indextts2_tpu_torch.train import train as ttrain
from maxtext_indextts2_tpu_torch.train.data import synthetic
from maxtext_indextts2_tpu_torch.train.data.colocated import ColocatedDataIterator

MESHES = {
    "fsdp8": ["ici_fsdp_parallelism=8"],
    "data2_fsdp4": ["ici_data_parallelism=2", "ici_fsdp_parallelism=4"],
    "fsdp2_context4": ["ici_fsdp_parallelism=2", "ici_context_parallelism=4"],
    "stage2_fsdp2_transpose2": ["ici_stage_parallelism=2", "ici_fsdp_parallelism=2",
                                "ici_fsdp_transpose_parallelism=2"],
    "fsdp4_tensor2": ["ici_fsdp_parallelism=4", "ici_tensor_parallelism=2"],
}
WEIGHT_NAMES = [
    ("vocab", "embed"), ("embed", "vocab"), ("embed", "q_heads", "kv_head_dim"),
    ("embed", "kv_heads", "kv_head_dim"), ("heads", "kv_head_dim", "embed"), ("embed", "mlp"),
    ("mlp", "embed"), ("exp", "embed_no_exp", "mlp"), ("exp", "mlp", "embed_no_exp"),
    ("embed", "q_lora"), ("kv_lora", "kv_heads", "kv_head_dim"), ("norm",), ("layers", "embed"),
    ("activation_batch", "activation_length", "activation_embed"),
    ("activation_embed_and_logits_batch", "activation_length", "activation_vocab"),
]


@pytest.mark.parametrize("mesh_name", [None] + list(MESHES))
def test_resolve_equals_the_jax_resolve(mesh_name):
    jmesh = None if mesh_name is None else jax_mesh(jax_load_config(MESHES[mesh_name]))
    pmesh = None if jmesh is None else types.SimpleNamespace(shape=dict(jmesh.shape))
    for names in [(n,) for n in LOGICAL_AXIS_RULES] + WEIGHT_NAMES + [(None, "embed")]:
        want = tuple(jax_resolve(names, mesh=jmesh))
        assert resolve(names, mesh=pmesh) == want, names


@pytest.mark.parametrize("extra", [[], ["num_experts=4", "num_experts_per_tok=2"],
                                   ["model_name=deepseek-v2-lite", "base_num_decoder_layers=2",
                                    "base_emb_dim=256", "base_mlp_dim=512",
                                    "moe_mlp_dim=128", "num_experts=4", "num_experts_per_tok=2",
                                    "first_num_dense_layers=1", "q_lora_rank=64",
                                    "kv_lora_rank=32"]],
                         ids=["dense", "moe", "mla"])
def test_param_logical_names_equal_the_jax_model(extra):
    args = TINY_TTS + extra
    jcfg = jax_load_config(args + ["per_device_batch_size=1"])
    cfg = load_config(args)
    tokens = jnp.zeros((1, 8), jnp.int32)
    abstract = jax.eval_shape(JaxTransformer(cfg=jcfg).init, jax.random.PRNGKey(0), tokens,
                              tokens, tokens)
    specs = flax.traverse_util.flatten_dict(nn.get_partition_spec(abstract)["params"])
    shapes = flax.traverse_util.flatten_dict(nn.meta.unbox(abstract)["params"])
    assert specs
    for key, spec in specs.items():
        name = ".".join(key)
        want = tuple(spec) if spec is not None else (None,) * len(shapes[key].shape)
        assert param_logical_axes(name, shapes[key].shape, cfg.emb_dim) == want, name


@pytest.mark.parametrize("extra", [
    ["ici_fsdp_parallelism=-1"], ["ici_data_parallelism=2", "ici_fsdp_parallelism=4"],
    ["ici_stage_parallelism=2", "ici_fsdp_parallelism=4"],
    ["ici_context_parallelism=4", "ici_fsdp_parallelism=-1",
     "context_parallel_algorithm=ring"],
    ["ici_fsdp_parallelism=8", "gradient_accumulation_steps=2", "per_device_batch_size=2"],
], ids=["fill", "data_fsdp", "stage", "context", "accumulation"])
def test_config_fills_a_world_of_ranks_as_the_jax_package(extra, monkeypatch):
    args = ["maxtext_indextts2_tpu_torch/configs/tiny.yml"] + extra
    want = dataclasses.asdict(jax_load_config(
        [args[0].replace("_torch", "")] + extra))
    monkeypatch.setenv("WORLD_SIZE", "8")
    got = dataclasses.asdict(load_config(args))
    keys = [k for k in want if k.startswith(("ici_", "dcn_", "using_", "num_pipeline",
                                             "global_batch", "micro_batch"))]
    assert {k: got[k] for k in keys + ["num_devices"]} == \
        {k: want[k] for k in keys + ["num_devices"]}


@pytest.mark.parametrize("axis", ["tensor", "tensor_transpose", "tensor_sequence", "sequence",
                                  "expert", "autoregressive", "context_autoregressive"])
def test_mesh_refuses_axes_with_collectives_inside_the_layers(axis):
    cfg = dataclasses.replace(load_config(TINY_TTS), **{f"ici_{axis}_parallelism": 2})
    with pytest.raises(NotImplementedError, match=f"'{axis}' mesh axis.*port queue: 6b"):
        create_device_mesh(cfg)


def test_sufficiently_sharded_counts_whole_parameter_bytes():
    mesh = types.SimpleNamespace(shape={"fsdp": 2, "data": 2})
    specs = {"a": (900, ("fsdp", None)), "b": (100, (None,))}
    assert assert_params_sufficiently_sharded(specs, mesh, 0.2) == 0.1
    with pytest.raises(AssertionError, match="fully replicated"):
        assert_params_sufficiently_sharded(specs, mesh, 0.05)
    assert assert_params_sufficiently_sharded(specs, types.SimpleNamespace(shape={"data": 2}),
                                              0.0) == 0.0


TRAIN = TINY_TTS + ["max_target_length=32", "learning_rate=1e-3", "dataset_type=synthetic",
                    "attention=dot_product", "remat_policy=full"]


def test_two_ranks_lay_out_the_mesh_and_train_with_checkpoints(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    ranks = run_ranks(tmp_path, 2, "mesh_and_loop",
                      TRAIN + ["ici_fsdp_parallelism=2", "per_device_batch_size=2"], ckpt)
    for r, out in enumerate(ranks):
        assert out["summary"] == {"fsdp": 2} and out["rank"] == r
        assert out["coords"]["fsdp"] == r
        assert out["placements"] == ["Shard(dim=0)"]  # "embed" over fsdp; "mlp" whole
        assert torch.equal(out["piece"], torch.arange(32).reshape(4, 8)[2 * r:2 * r + 2])
        assert torch.equal(out["multihost"], torch.arange(16).reshape(2, 8).int())
    assert ranks[0]["losses"] == ranks[1]["losses"]
    # one process on the same global batch of 4 rows, 4 steps in one run
    cfg = load_config(TRAIN + ["per_device_batch_size=4", "steps=4"])
    want = [h["loss"] for h in ttrain.train_loop(cfg, device="cpu", quiet=True)["history"]]
    np.testing.assert_allclose(ranks[0]["losses"], want, atol=2e-5, rtol=0)
    # rank 0 wrote the one-rank state dict
    saved = checkpointing.load_params_only(os.path.join(ckpt, "3"))
    model = ttrain.setup_train_state(cfg, "cpu").params
    assert set(saved) == set(model)
    assert all(tuple(saved[n].shape) == tuple(p.shape) for n, p in model.items())


def test_colocated_input_matches_the_in_process_batches_and_resumes():
    cfg = load_config(TRAIN + ["per_device_batch_size=2", "colocated_python_data_input=true"])
    it = ColocatedDataIterator(cfg)
    try:
        want = synthetic.make_batch(cfg, 0)
        for _ in range(3):
            got = next(it)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        state = it.get_state()
    finally:
        it.close()
    again = ColocatedDataIterator(cfg)
    again.set_state(state)
    try:
        assert again._consumed == 3
        np.testing.assert_array_equal(next(again)["inputs"], want["inputs"])
        assert again._consumed == 4
    finally:
        again.close()


def test_training_through_the_colocated_sidecar_equals_in_process():
    args = TRAIN + ["per_device_batch_size=2", "steps=2"]
    got = ttrain.train_loop(load_config(args + ["colocated_python_data_input=true"]),
                            device="cpu", quiet=True)
    want = ttrain.train_loop(load_config(args), device="cpu", quiet=True)
    assert [h["loss"] for h in got["history"]] == [h["loss"] for h in want["history"]]
