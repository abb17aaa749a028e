"""Weights carried between the JAX package's parameter tree and this
package's state dict.

The caller flattens nothing and converts nothing but the leaves: it hands
over the JAX tree with every leaf already a numpy array (this package never
sees a ``jax.Array``). Module and parameter names are the same in both
packages and every kernel keeps the JAX layout ``[in..., out...]``, so the
bridge is a rename of ``a/b/c`` to ``a.b.c`` plus, for scan-stacked
checkpoints, the split of the leading layer axis::

    decoder/layers_3/self_attention_0/query/kernel   (unrolled)
    decoder/layers/self_attention_0/query/kernel[3]  (scan-stacked, axis 0)
      -> decoder.layers_3.self_attention_0.query.kernel

The same holds for deepseek's two regions, ``dense_layers`` and
``moe_layers`` (``decoder.moe_layers_0.moe_0.wi_0``: an expert tensor
``[E, emb, mlp]``, a direct parameter of ``RoutedMoE``; ``wi_0_scale`` and its
siblings under ``int8w_serve``; ``shared_experts.wi_0.kernel``), the MLA
projections (``self_attention_0.wkv_a.kernel``, ``kv_norm.scale``, ...), the
LayerNorm biases (``pre_mlp_norm_0.bias``) and the learned positions
(``position_embedder.embedding``).

The multi-token-prediction depths cross as they are (``mtp_1/layer/
self_attention_0/...`` -> ``mtp_1.layer.self_attention_0....``: top-level
modules, beside the decoder), and so do the vision modules' trees
(:func:`tree_to_state_dict`: ``models/vision.VisionEncoder``,
``Gemma3MultiModalProjector`` and ``Llama4VisionEncoder`` keep the JAX
modules' names and layouts, the patch convolution's kernel ``[P, P, 3, E]``
included; back with :func:`params_to_jax`).

The optimizer state crosses the same way (:func:`opt_state_from_jax`,
:func:`opt_state_to_jax`): ``count``, ``mu`` and ``nu`` of adamw and
adam_pax (optax's ``ScaleByAdamState``, alone or inside adamw's chain) and
sgd's ``count``, with ``mu`` and ``nu`` under the parameters' names.

The S2A model, the acoustic codec and the semantic tokenizer cross the same
way (:func:`s2a_params_from_jax`, :func:`codec_params_from_jax`,
:func:`codec_decoder_params_from_jax`, :func:`semantic_tokenizer_params_from_jax`;
back with :func:`params_to_jax`, bfloat16 tensors as float32 arrays): float,
dynamic-int8 (float kernels) and offline-int8 trees (``kernel`` int8
``[in, out]``, ``kernel_scale`` float32 ``[1, out]``), bfloat16 leaves as
``ml_dtypes`` numpy arrays. Convolution kernels keep flax's ``[k, in /
groups, out]`` on both sides (``audio.layers.Conv1d`` permutes at the call),
so a depthwise kernel (``feature_group_count = C``) crosses as ``[k, 1, C]``.

A module with state besides its parameters crosses with all its flax
variable collections (:func:`variables_from_jax`, :func:`variables_to_jax`):
``audio.quantize_extended.VectorQuantize``'s EMA codebook keeps the JAX
package's ``"codebook"`` collection (``initted``, ``cluster_size``, ``embed``,
``embed_avg``, ``step``) as buffers of the same names, so
``{"params": {"in_proj": ...}, "codebook": {"codebook": {"embed": ...}}}``
becomes ``in_proj.kernel``, ..., ``codebook.embed``.

A paged decode state crosses with :func:`paged_decode_state_from_jax`: the
JAX engine's page pools (its ``cache`` tree, ``.../kv_cache/key_pages``) and
its ``PageState`` (numpy leaves) become this engine's per-layer
``PagedKVCache`` list and ``PageState``, so that both packages can start from
one populated state.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

# the decoder's layer regions (``models/decoder.layer_regions``)
LAYER_REGIONS = ("layers", "dense_layers", "moe_layers")


def is_unrolled_key(key: str) -> bool:
    """``layers_3``, ``dense_layers_0``, ``moe_layers_12``: an unrolled unit."""
    base, _, idx = key.rpartition("_")
    return base in LAYER_REGIONS and idx.isdigit()


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A tensor that owns writable, contiguous memory. numpy has no native
    bfloat16: such leaves arrive as ``ml_dtypes`` arrays and cross bit for
    bit."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().float().numpy() if leaf.dtype == torch.bfloat16 \
            else leaf.detach().cpu().numpy()
    if not isinstance(leaf, np.ndarray):
        raise TypeError(
            f"leaves must be numpy arrays (convert on the caller's side), got {type(leaf)}")
    return leaf


def _flatten(node, prefix, out):
    for key, val in node.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            _flatten(val, path, out)
        else:
            out[path] = _to_numpy(val)


def params_from_jax(tree, cfg=None) -> dict[str, torch.Tensor]:
    """JAX parameter tree (nested mapping, numpy leaves; the ``params``
    level may be present or not) -> state dict for ``Transformer`` /
    ``Engine.set_params``. Handles both layer layouts. ``cfg``, when given,
    checks the number of layers."""
    flat = _flat_from_jax(tree)
    if cfg is not None:
        units = {p.split(".")[1] for p in flat
                 if p.startswith("decoder.") and is_unrolled_key(p.split(".")[1])}
        from maxtext_indextts2_tpu_torch.models.decoder import layer_regions
        from maxtext_indextts2_tpu_torch.models.registry import get_block_style

        group = len(get_block_style(cfg.decoder_block).attention_pattern)
        want = sum(n for _, n, _ in layer_regions(cfg, group))
        if len(units) != want:
            raise ValueError(f"tree has {len(units)} decoder units, config wants {want}")
    # np.array copies: the tensors own writable, contiguous memory
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


def _flat_from_jax(tree) -> dict[str, np.ndarray]:
    """A parameter-shaped JAX tree -> flat ``a.b.c`` names, scan-stacked
    layers split into ``layers_{i}``."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    flat: dict[str, np.ndarray] = {}
    top = {}
    for key, val in tree.items():
        if key == "decoder" and isinstance(val, Mapping):
            dec = {}
            for name, sub in val.items():
                if name in LAYER_REGIONS and isinstance(sub, Mapping):
                    stacked: dict[str, np.ndarray] = {}
                    _flatten(sub, "", stacked)
                    n_layers = {a.shape[0] for a in stacked.values()}
                    if len(n_layers) != 1:
                        raise ValueError(f"scan-stacked leaves disagree on the layer axis: {n_layers}")
                    for i in range(n_layers.pop()):
                        for path, arr in stacked.items():
                            flat[f"decoder.{name}_{i}.{path}"] = arr[i]
                else:
                    dec[name] = sub
            top[key] = dec
        else:
            top[key] = val
    _flatten(top, "", flat)
    return flat


def _field(node, name):
    if isinstance(node, Mapping):
        return node.get(name)
    if name in getattr(node, "_fields", ()):  # a named tuple (a plain tuple has .count too)
        return getattr(node, name)
    return None


def _find_state(node, name):
    """The first node of an optimizer state (a mapping, a named tuple or a
    tuple of them, as optax nests them) that has field ``name``."""
    if _field(node, name) is not None:
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find_state(child, name)
            if found is not None:
                return found
    return None


def opt_state_from_jax(opt_state) -> dict:
    """The JAX package's optimizer state (numpy leaves) -> this package's
    ``train/optimizers.py`` state: ``{"count": int, "mu": {name: tensor},
    "nu": {name: tensor}}`` for adamw and adam_pax, ``{"count": int}`` for
    sgd. Moments keep their dtype (bfloat16 as ``ml_dtypes`` arrays)."""
    adam = _find_state(opt_state, "mu")
    if adam is not None:
        return {"count": int(np.asarray(_field(adam, "count"))),
                "mu": {k: _to_tensor(v) for k, v in _flat_from_jax(_field(adam, "mu")).items()},
                "nu": {k: _to_tensor(v) for k, v in _flat_from_jax(_field(adam, "nu")).items()}}
    counted = _find_state(opt_state, "count")
    if counted is None:
        raise ValueError("no optimizer state with a count or moments found")
    return {"count": int(np.asarray(_field(counted, "count")))}


def opt_state_to_jax(state: dict) -> dict:
    """The inverse: ``{"count": int32 array, "mu": tree, "nu": tree}`` with
    numpy leaves in the JAX package's unrolled layout (bfloat16 moments as
    float32 arrays); the caller wraps them in optax's state types."""
    out = {"count": np.asarray(state["count"], np.int32)}
    for name in ("mu", "nu"):
        if name in state:
            out[name] = params_to_jax(state[name])
    return out


def params_to_jax(state_dict, scan_layers: bool = False) -> dict:
    """The inverse: state dict -> nested dict of numpy arrays in the JAX
    package's layout (unrolled, or scan-stacked on a leading layer axis)."""
    tree: dict = {}
    for name, tensor in state_dict.items():
        node = tree
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _to_numpy(tensor)
    if scan_layers and "decoder" in tree:
        dec = tree["decoder"]

        def stack(nodes):
            if isinstance(nodes[0], dict):
                return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
            return np.stack(nodes)

        for region in LAYER_REGIONS:
            units = sorted((k for k in dec
                            if is_unrolled_key(k) and k.rpartition("_")[0] == region),
                           key=lambda k: int(k.rpartition("_")[2]))
            if units:
                dec[region] = stack([dec.pop(u) for u in units])
    return tree


def tree_to_state_dict(tree) -> dict[str, torch.Tensor]:
    """Nested mapping with numpy leaves (the ``params`` level may be present
    or not) -> flat ``a.b.c`` state dict, leaves unchanged."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    flat: dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return {k: _to_tensor(v) for k, v in flat.items()}


def variables_from_jax(variables) -> dict[str, torch.Tensor]:
    """A flax module's variables (every collection, numpy leaves) -> one
    state dict: parameters and buffers share their module paths, so the
    collections merge; a name in two collections raises."""
    out: dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        flat: dict[str, np.ndarray] = {}
        _flatten(tree, "", flat)
        clash = out.keys() & flat.keys()
        if clash:
            raise ValueError(f"collection {collection!r} repeats {sorted(clash)}")
        out.update({k: _to_tensor(v) for k, v in flat.items()})
    return out


def variables_to_jax(module: torch.nn.Module) -> dict:
    """The inverse for a module: its parameters under ``"params"`` and its
    buffers (when it has any) under ``"codebook"`` (the one collection of
    state the JAX package's modules keep), numpy leaves."""
    out = {"params": params_to_jax(dict(module.named_parameters()))}
    buffers = dict(module.named_buffers())
    if buffers:
        out["codebook"] = params_to_jax(buffers)
    return out


def s2a_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The JAX package's ``S2AModel`` parameter tree -> state dict of this
    package's ``audio.s2a.S2AModel`` (float, dynamic-int8 or offline-int8;
    the names are the same)."""
    return tree_to_state_dict(tree)


def codec_decoder_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The decode side of the JAX package's ``AcousticCodec`` parameter tree
    -> state dict for ``audio.acoustic.AcousticCodec.load_state_dict(...,
    strict=False)``: the ``encoder`` subtree is left out (serving that only
    detokenizes needs no encoder weights)."""
    return {k: v for k, v in tree_to_state_dict(tree).items() if not k.startswith("encoder.")}


def codec_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The JAX package's ``AcousticCodec`` tree -> state dict of this
    package's ``audio.acoustic.AcousticCodec``, encoder and decoder."""
    return tree_to_state_dict(tree)


def semantic_tokenizer_params_from_jax(params) -> dict[str, torch.Tensor]:
    """The JAX package's ``SemanticTokenizer.params`` (``{"encoder": <the
    SemanticEncoder tree, with stat_mean / stat_std>, "repcodec": <the RepCodec
    tree>}``, each with or without its ``params`` level, numpy leaves) ->
    state dict of this package's ``audio.semantic_tokenizer.SemanticTokenizer``."""
    return {f"{half}.{name}": leaf for half in ("encoder", "repcodec")
            for name, leaf in tree_to_state_dict(params[half]).items()}


def paged_decode_state_from_jax(cache_tree, page_state, device=None):
    """The JAX engine's paged decode cache (a nested mapping with numpy leaves
    ``decoder/layers_{i}/self_attention_{j}/kv_cache/{key,value}_pages``) and
    its ``PageState`` (``page_status``, ``page_map``, ``seq_lens`` as numpy
    arrays, a named tuple or a mapping) -> (this engine's cache: a list per
    unit of a list per sub-layer of ``PagedKVCache``, and its ``PageState``),
    on ``device``."""
    from maxtext_indextts2_tpu_torch.infer.page_manager import PageState
    from maxtext_indextts2_tpu_torch.infer.paged_attention import PagedKVCache

    flat: dict[str, np.ndarray] = {}
    _flatten(cache_tree, "", flat)
    pools: dict[int, dict[int, dict[str, torch.Tensor]]] = {}
    for path, leaf in flat.items():
        parts = path.split(".")
        if parts[-1] not in ("key_pages", "value_pages"):
            continue
        unit = next(int(p[len("layers_"):]) for p in parts if p.startswith("layers_"))
        sub = next(int(p[len("self_attention_"):]) for p in parts
                   if p.startswith("self_attention_"))
        pools.setdefault(unit, {}).setdefault(sub, {})[parts[-1]] = \
            _to_tensor(leaf).to(device)
    if not pools:
        raise KeyError("the cache tree holds no key_pages/value_pages leaves")
    cache = [[PagedKVCache(pools[u][j]["key_pages"], pools[u][j]["value_pages"])
              for j in sorted(pools[u])] for u in sorted(pools)]
    fields = {name: _to_numpy(_field(page_state, name))
              for name in ("page_status", "page_map", "seq_lens")}
    state = PageState(**{name: _to_tensor(arr.astype(np.int32)).to(device)
                         for name, arr in fields.items()})
    return cache, state
