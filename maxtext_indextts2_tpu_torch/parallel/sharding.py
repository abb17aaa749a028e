"""Logical-axis sharding rules on the port's mesh.

Counterpart of the JAX package's ``parallel/sharding.py``: the same rule
table (``tests/test_torch_port_hygiene.py`` holds it equal to the JAX dict)
and the same greedy per-axis :func:`resolve`, which returns, for each
logical dimension name, None, one mesh-axis name or a tuple of them (the
entries of the JAX ``PartitionSpec``). There is no compiler to insert
collectives here: :func:`shard` takes a rank's piece of a global tensor (the
batch, split over ``activation_batch`` and ``activation_length``), and
``train/train.py`` gathers and reduce-scatters the weights that
:func:`param_spec` shards. :func:`logical_to_placements` gives the same
layout as ``DTensor`` placements over the mesh's ``DeviceMesh``.

The port's parameters carry no logical names of their own: :func:`param_logical_axes`
gives each the names that the JAX package attaches to the same weight.
"""

from __future__ import annotations

import re

import torch

# Logical axis name -> ordered mesh axes it may shard over.
LOGICAL_AXIS_RULES: dict[str, tuple[str, ...]] = {
    # activations
    "activation_batch": ("data", "fsdp", "fsdp_transpose", "expert"),
    "activation_batch_no_exp": ("data", "fsdp", "fsdp_transpose"),
    "activation_embed_and_logits_batch": ("data", "stage", "fsdp", "fsdp_transpose", "expert"),
    "activation_heads": ("tensor", "tensor_transpose", "sequence", "tensor_sequence"),
    "activation_kv_heads": ("tensor", "tensor_transpose", "sequence", "tensor_sequence"),
    "activation_length": ("sequence", "context"),
    "activation_norm_length": ("tensor_sequence", "sequence", "context"),
    "activation_q_length": ("context",),
    "activation_kv_length": (),
    "activation_embed": ("tensor", "tensor_transpose"),
    "activation_mlp": ("tensor", "tensor_transpose", "tensor_sequence"),
    "activation_kv": ("tensor", "tensor_transpose", "tensor_sequence"),
    "activation_kv_batch": ("data", "fsdp", "fsdp_transpose", "expert"),
    "activation_kv_head_dim": ("tensor", "tensor_transpose", "tensor_sequence"),
    "activation_vocab": ("tensor", "tensor_transpose", "sequence", "tensor_sequence"),
    "activation_stage": ("stage",),
    "activation_exp": ("expert",),
    "decode_batch": ("data", "fsdp", "fsdp_transpose", "expert"),
    "decode_length": (),
    # weights
    "embed": ("fsdp", "fsdp_transpose", "sequence", "tensor_transpose", "context", "expert"),
    "embed_no_exp": ("fsdp", "fsdp_transpose", "sequence", "tensor_transpose", "context"),
    "q_lora": ("fsdp", "fsdp_transpose", "sequence", "context", "expert"),
    "kv_lora": ("fsdp", "fsdp_transpose", "sequence", "context", "expert"),
    "norm": ("tensor", "tensor_transpose", "tensor_sequence"),
    "heads": ("tensor", "tensor_transpose", "tensor_sequence", "autoregressive"),
    "q_heads": ("tensor", "tensor_transpose", "tensor_sequence", "autoregressive"),
    "kv_heads": ("tensor", "tensor_transpose", "tensor_sequence", "autoregressive"),
    "kv_head_dim": (),
    "vocab": ("tensor", "tensor_transpose", "tensor_sequence", "autoregressive"),
    "mlp": ("tensor", "tensor_sequence", "fsdp_transpose", "autoregressive"),
    "exp": ("expert",),
    "layers": ("stage",),
    "mtp": (),
    # kv-cache (inference)
    "cache_batch_prefill": (),
    "cache_batch": ("data", "fsdp", "fsdp_transpose", "expert"),
    "cache_heads": ("tensor", "tensor_transpose", "tensor_sequence", "autoregressive"),
    "cache_kv": (),
    "cache_sequence": ("context_autoregressive",),
    "cache_scale_batch": ("data", "fsdp", "fsdp_transpose", "expert"),
    "cache_scale_heads": ("tensor", "tensor_transpose", "tensor_sequence", "autoregressive"),
    "cache_scale_kv": (),
    "cache_scale_sequence": (),
    "paged_kv_pages": (),
    "paged_kv_heads": ("tensor", "tensor_transpose", "autoregressive"),
    # audio stack
    "audio_channels": ("tensor",),
    "audio_time": (),
    "codebook": (),
    "codebook_dim": (),
}

# the mesh axes that may hold a shard of a parameter
SHARDING_AXES = ("fsdp", "fsdp_transpose", "sequence", "context", "tensor", "tensor_transpose",
                 "tensor_sequence", "stage", "expert", "autoregressive")


def resolve(names, rules: dict | None = None, mesh=None) -> tuple:
    """Resolve logical dim names greedily per mesh axis: each dimension takes
    every axis of its rule that an earlier dimension has not taken. With a
    ``mesh``, axes of degree 1 are dropped. One entry a dimension: None, an
    axis name, or a tuple of axis names."""
    rules = rules if rules is not None else LOGICAL_AXIS_RULES
    used: set[str] = set()
    out = []
    for name in names:
        if name is None:
            out.append(None)
            continue
        if name not in rules:
            raise ValueError(f"unknown logical axis name: {name!r}")
        take = [ax for ax in rules[name] if ax not in used]
        if mesh is not None:
            take = [ax for ax in take if mesh.shape.get(ax, 1) > 1]
        used.update(take)
        out.append(None if not take else take[0] if len(take) == 1 else tuple(take))
    return tuple(out)


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one :func:`resolve` entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def logical_to_mesh_axes(names, rules=None) -> tuple:
    return resolve(names, rules)


def logical_to_placements(names, mesh, rules=None) -> list:
    """``DTensor`` placements over ``mesh.device_mesh`` (one a mesh dimension
    of degree above 1): ``Shard(d)`` where dimension d is split over that
    axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    spec = resolve(names, rules, mesh=mesh)
    placements = []
    for ax in mesh.active:
        dims = [d for d, entry in enumerate(spec) if ax in entry_axes(entry)]
        placements.append(Shard(dims[0]) if dims else Replicate())
    return placements


def local_piece(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's piece of the global tensor ``x`` under ``spec`` (one
    :func:`resolve` entry a dimension): each split dimension is cut into the
    product of its axes' degrees, and the rank keeps the chunk at its
    row-major index over those axes."""
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        n = mesh.axes_size(axes)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over "
                             f"{axes} ({n} ranks)")
        x = x.chunk(n, dim=dim)[mesh.index(axes)]
    return x


def shard(x: torch.Tensor, *names, mesh=None, rules=None) -> torch.Tensor:
    """This rank's piece of the global activation ``x`` whose dimensions have
    the logical ``names`` (``x`` itself without a mesh or on one rank)."""
    from maxtext_indextts2_tpu_torch.parallel.mesh import current_mesh

    mesh = mesh or current_mesh()
    if mesh is None or mesh.size == 1:
        return x
    return local_piece(x, resolve(tuple(names), rules, mesh=mesh), mesh)


# leaf name patterns -> the logical names the JAX package gives the weight
_PARAM_RULES = (
    (r"token_embedder\.embedding$", ("vocab", "embed")),
    (r"logits_dense\.kernel$", ("embed", "vocab")),
    (r"\.(query|wq)\.kernel$", ("embed", "q_heads", "kv_head_dim")),
    (r"\.(key|value)\.kernel$", ("embed", "kv_heads", "kv_head_dim")),
    (r"\.wq_a\.kernel$", ("embed", "q_lora")),
    (r"\.wq_b\.kernel$", ("q_lora", "q_heads", "kv_head_dim")),
    (r"\.wkv_a\.kernel$", ("embed", "kv_lora")),
    (r"\.wkv_b\.kernel$", ("kv_lora", "kv_heads", "kv_head_dim")),
    (r"self_attention_\d+\.out\.kernel$", ("heads", "kv_head_dim", "embed")),
    (r"\.moe_\d+\.(wi_0|wi_1)$", ("exp", "embed", "mlp")),
    (r"\.moe_\d+\.wo$", ("exp", "mlp", "embed")),
    (r"\.moe_\d+\.(wi_0|wi_1)_scale$", ("exp", None, "mlp")),
    (r"\.moe_\d+\.wo_scale$", ("exp", None, "embed")),
    (r"\.(query|key)_norm\.scale$", ("kv_head_dim",)),
    (r"\.gate\.kernel$", ("embed", None)),
    (r"\.wi(_\d+)?\.kernel$", ("embed", "mlp")),
    (r"\.wo\.kernel$", ("mlp", "embed")),
    (r"(norm(_\d+)?|norm)\.scale$", ("norm",)),
)


def param_logical_axes(name: str, shape, emb_dim: int) -> tuple:
    """The logical names of parameter ``name`` of ``shape``; a weight the
    table does not name takes ``embed`` on its first dimension of the model
    width (LoRA factors, MTP projections, biases) and None elsewhere."""
    for pattern, names in _PARAM_RULES:
        if re.search(pattern, name) and len(names) == len(shape):
            return names
    out, embed = [], False
    for n in shape:
        if n == emb_dim and not embed:
            out.append("embed")
            embed = True
        else:
            out.append(None)
    return tuple(out)


def param_spec(name: str, shape, emb_dim: int, mesh, unit_axis: bool = False) -> tuple:
    """The :func:`resolve` entries of a parameter on ``mesh``, keeping only
    the axes that divide their dimension (a dimension that does not split
    stays whole on every rank). ``unit_axis``: the parameter is a pipeline
    unit's, which lives on one ``stage`` rank: its ``layers`` name is
    carried by the unit's placement, not by a dimension."""
    names = param_logical_axes(name, shape, emb_dim)
    if unit_axis:  # the greedy rule then sees "stage" taken
        spec = resolve(("layers",) + tuple(names), mesh=mesh)[1:]
    else:
        spec = resolve(names, mesh=mesh)
    out = []
    for n, entry in zip(shape, spec):
        axes = entry_axes(entry)
        out.append(entry if axes and n % mesh.axes_size(axes) == 0 else None)
    return tuple(out)


def assert_params_sufficiently_sharded(specs: dict, mesh, tolerance: float = 0.02) -> float:
    """The share of parameter bytes left whole on every rank over the active
    sharding axes must be below ``tolerance``. ``specs``: name -> (bytes,
    spec). Returns that share."""
    active = {ax for ax in SHARDING_AXES if mesh.shape.get(ax, 1) > 1}
    if not active:
        return 0.0
    total = unsharded = 0
    for nbytes, spec in specs.values():
        total += nbytes
        used = {ax for entry in spec for ax in entry_axes(entry)}
        if not used & active:
            unsharded += nbytes
    frac = unsharded / max(total, 1)
    if frac > tolerance:
        raise AssertionError(
            f"{frac:.1%} of parameter bytes are fully replicated over active mesh axes "
            f"{sorted(active)} (tolerance {tolerance:.1%})")
    return frac
