"""The splits inside the layers: what a rank computes on each mesh axis
whose collectives run inside the model.

The JAX package states a layout and lets GSPMD insert the collectives; here
each layer issues its own, in Megatron's pattern:

- ``tensor`` x ``autoregressive`` (:func:`tensor_split`): the heads of q /
  k / v and of ``out``, the ``mlp`` width of ``wi_*`` / ``wo`` (dense, in
  each expert and in the shared experts) and the vocabulary of the embedding
  and of the logits are split over the group of both axes. A column-split
  product's input goes through ``comm.CopyToGroup`` ("f"), a row-split
  product's float32 partial sums through ``comm.ReduceFromGroup`` ("g")
  (:meth:`Split.enter`, :meth:`Split.leave`); the residual stream stays
  whole on every rank (JAX shards ``activation_embed`` over ``tensor``: a
  layout choice of GSPMD, not a semantic one).
- ``tensor_sequence`` (training): the same split of the weights, with
  Megatron's sequence parallelism between the layers (the JAX package's
  ``activation_norm_length``): the residual stream and the norms hold this
  rank's rows of the length, "f" all-gathers them and "g" reduce-scatters
  the partial sums along the length.
- ``expert`` (:func:`expert_split`): each rank holds ``num_experts / n``
  experts; ``models/moe.py`` sends each routed row to its expert's rank by a
  variable-split all-to-all and back.
- ``context_autoregressive`` (:func:`cache_split`): each rank holds
  ``max_target_length / n`` rows of every decode-cache slot;
  ``models/attention.py`` merges the ranks' partial softmaxes by log-sum-exp.

A parameter's STORAGE follows the JAX layout (``sharding.param_spec``: the
goldens of ``tests/sharding_info``); what a layer COMPUTES on is
:func:`compute_spec`, the part of that layout that splits heads, ``mlp``,
``vocab`` (over ``tensor`` / ``autoregressive``) or ``exp`` (over
``expert``). A storage axis the compute does not use is gathered before the
layer runs (``parallel/fsdp.ShardedParams``). The model is built whole (so
that seeded weights are the one-rank ones); :func:`split_model` tells its
modules their split, and the caller gives each parameter its compute piece
(``sharding.local_piece`` of :func:`compute_spec`: ``Engine.set_params``,
``ShardedParams.gather``).

What the port does not split yet is refused by :func:`check_model`, naming
ROADMAP item 6b: the JAX package would keep such a dimension whole.
"""

from __future__ import annotations

import dataclasses
import re

import torch

from maxtext_indextts2_tpu_torch.parallel.mesh import REFUSED_AXES_ITEM
from maxtext_indextts2_tpu_torch.parallel.sharding import (
    entry_axes,
    param_logical_axes,
    param_spec,
)
from maxtext_indextts2_tpu_torch.unported import _unsupported

TENSOR_AXES = ("tensor", "tensor_sequence", "autoregressive")
SEQUENCE_SPLIT_AXIS = "tensor_sequence"
EXPERT_AXES = ("expert",)
CACHE_AXES = ("context_autoregressive",)
# the logical names a tensor split divides, and the one an expert split does
TENSOR_NAMES = frozenset({"heads", "q_heads", "kv_heads", "mlp", "vocab"})
# whole weights that a tensor split's ranks apply to their own heads: each
# rank's gradient is a part of the whole one
_SPLIT_REGION_WEIGHTS = re.compile(r"\.(query|key)_norm\.scale$")


@dataclasses.dataclass(frozen=True)
class Split:
    """This rank's place in a split: the group over ``axes``, its size and
    this rank's index in it (the chunk of a split dimension it holds)."""

    axes: tuple
    group: object
    size: int
    rank: int

    @property
    def seq(self) -> bool:
        """Megatron's sequence parallelism: the residual stream between the
        layers holds this rank's rows of the length."""
        return SEQUENCE_SPLIT_AXIS in self.axes

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """"f": a column-split product's input ``[B, S, ...]`` (the length
        all-gathered under sequence parallelism)."""
        from maxtext_indextts2_tpu_torch.parallel import comm

        return comm.AllGather.apply(x, self.group, 1) if self.seq else \
            comm.copy_to_group(x, self.group)

    def leave(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """"g": a row-split product's partial sums ``[B, S, ...]`` summed in
        float32 and rounded to ``dtype`` (reduce-scattered along the length
        under sequence parallelism)."""
        from maxtext_indextts2_tpu_torch.parallel import comm

        return comm.ReduceScatter.apply(x, self.group, 1, dtype) if self.seq else \
            comm.reduce_from_group(x, self.group, dtype)

    def chunk(self, n: int) -> int:
        return n // self.size

    def bounds(self, n: int) -> tuple[int, int]:
        """[start, end) of this rank's chunk of a dimension of ``n``."""
        c = n // self.size
        return self.rank * c, (self.rank + 1) * c


def split_of(mesh, axes) -> Split | None:
    """The split over the active ones of ``axes`` (None: none is active)."""
    if mesh is None:
        return None
    axes = tuple(ax for ax in mesh.axis_names if ax in axes and mesh.shape[ax] > 1)
    if not axes:
        return None
    return Split(axes, mesh.group(axes), mesh.axes_size(axes), mesh.index(axes))


def tensor_split(mesh) -> Split | None:
    return split_of(mesh, TENSOR_AXES)


def expert_split(mesh) -> Split | None:
    return split_of(mesh, EXPERT_AXES)


def cache_split(mesh) -> Split | None:
    return split_of(mesh, CACHE_AXES)


def compute_spec(name: str, shape, emb_dim: int, mesh) -> tuple:
    """The part of ``param_spec`` a layer computes on: per dimension, the
    tensor axes of a heads / ``mlp`` / ``vocab`` dimension, the expert axis
    of an ``exp`` one, else None. An ``int8w_serve`` channel scale
    (``<layer>.kernel_scale``, its kernel's shape with 1 on the contracted
    dimensions) is split as its kernel's output channels."""
    if name.endswith(".kernel_scale"):
        kernel = name[:-len("_scale")]
        spec = compute_spec(kernel, shape, emb_dim, mesh)
        return tuple(None if n == 1 else e for n, e in zip(shape, spec))
    names = param_logical_axes(name, shape, emb_dim)
    out = []
    for logical, entry in zip(names, param_spec(name, shape, emb_dim, mesh)):
        keep = TENSOR_AXES if logical in TENSOR_NAMES else EXPERT_AXES if logical == "exp" \
            else ()
        took = tuple(ax for ax in entry_axes(entry) if ax in keep)
        out.append(None if not took else took[0] if len(took) == 1 else took)
    return tuple(out)


def partial_grad_axes(name: str, mesh) -> tuple:
    """The tensor axes over which ``name``'s gradient is summed although the
    weight is whole on their ranks (a qk-norm scale: each rank normalises
    its own heads)."""
    split = tensor_split(mesh)
    return split.axes if split is not None and _SPLIT_REGION_WEIGHTS.search(name) else ()


def _check_sequence_split(cfg, mesh, block) -> None:
    """What Megatron's sequence parallelism runs here: the dense and qk-norm
    blocks alone on the ``tensor_sequence`` axis, in training."""
    for ax in ("tensor", "autoregressive", "sequence", "context", "stage"):
        if mesh.shape.get(ax, 1) > 1:
            refuse(f"tensor_sequence with the {ax} axis")
    if cfg.num_experts > 1 or block.use_mla:
        refuse("tensor_sequence with mixture-of-experts or latent attention layers")
    if cfg.enable_dropout and cfg.dropout_rate > 0:
        refuse("MLP dropout under tensor_sequence")


def refuse(what: str) -> None:
    """Raise the refusal of a feature the splits do not run yet (item 6b)."""
    _unsupported(what, REFUSED_AXES_ITEM)


class _Degrees:
    """The degrees of a config's mesh, without ranks (what :func:`check_model`
    reads before a mesh exists)."""

    def __init__(self, cfg):
        self.axis_names = tuple(cfg.mesh_axes)
        self.shape = {ax: max(getattr(cfg, f"ici_{ax}_parallelism"), 1)
                      * max(getattr(cfg, f"dcn_{ax}_parallelism"), 1) for ax in self.axis_names}


def _size(mesh, axes) -> int:
    n = 1
    for ax in axes:
        n *= mesh.shape.get(ax, 1)
    return n


def tensor_degree(cfg) -> int:
    """The size of ``cfg``'s tensor split (``tensor`` x ``autoregressive``)."""
    return _size(_Degrees(cfg), TENSOR_AXES)


def check_model(cfg, mesh=None) -> None:
    """Refuse, before any weight is made, a model the splits of ``mesh``
    (without one: of ``cfg``'s degrees) cannot run: a dimension that does
    not divide its split, or a feature whose layers take no split yet."""
    from maxtext_indextts2_tpu_torch.models.registry import get_block_style
    from maxtext_indextts2_tpu_torch.ops.quantization import AQT_MODES

    mesh = mesh if mesh is not None else _Degrees(cfg)
    n, n_exp = _size(mesh, TENSOR_AXES), _size(mesh, EXPERT_AXES)
    if n > 1:
        dims = {"query heads": cfg.num_query_heads, "kv heads": cfg.num_kv_heads,
                "mlp_dim": cfg.mlp_dim, "vocab_size": cfg.vocab_size}
        if cfg.num_experts > 1:
            dims["moe_mlp_dim"] = cfg.moe_mlp_dim
        for what, size in dims.items():
            if size % n:
                refuse(f"a tensor split of {n} over {what} = {size} (it does not divide)")
        block = get_block_style(cfg.decoder_block)
        if mesh.shape.get(SEQUENCE_SPLIT_AXIS, 1) > 1:
            _check_sequence_split(cfg, mesh, block)
        if block.use_attn_bias or block.use_mlp_bias:
            refuse("attention or MLP biases under a tensor split")
        if mesh.shape.get("fsdp_transpose", 1) > 1:
            refuse("the fsdp_transpose axis with a tensor split")
        if cfg.lora_rank > 0:
            refuse("LoRA adapters under a tensor split")
        if cfg.quantization in AQT_MODES:
            refuse(f"quantization={cfg.quantization} under a tensor split")
        if cfg.quantization == "int8w_serve" and cfg.num_experts > 1:
            refuse("int8 experts under a tensor split")
        if cfg.mtp_num_layers > 0:
            refuse("multi-token prediction under a tensor split")
    if n_exp > 1 and cfg.num_experts > 1:
        if cfg.num_experts % n_exp:
            refuse(f"an expert split of {n_exp} over num_experts = {cfg.num_experts}")
        if cfg.quantization == "int8w_serve":
            refuse("int8 experts under an expert split")
        if mesh.shape.get("stage", 1) > 1:
            refuse("a pipeline stage axis with an expert split")
    if mesh.shape.get("sequence", 1) > 1:
        if mesh.shape.get("context", 1) > 1:
            refuse("the sequence axis with context parallelism")
        if cfg.mtp_num_layers > 0:
            refuse("multi-token prediction under the sequence axis")
    if _size(mesh, CACHE_AXES) > 1 and get_block_style(cfg.decoder_block).use_mla:
        refuse("a latent cache split over context_autoregressive")


def split_model(model, mesh) -> None:
    """Tell every module that takes a split which one it computes on (the
    parameters keep their whole shape until the caller gives them their
    compute pieces)."""
    tp, ep = tensor_split(mesh), expert_split(mesh)
    for module in model.modules():
        if hasattr(module, "tp"):
            module.tp = tp
        if hasattr(module, "ep"):
            module.ep = ep
