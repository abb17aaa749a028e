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
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_SCAN_REGIONS = ("layers",)


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
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    flat: dict[str, np.ndarray] = {}
    top = {}
    for key, val in tree.items():
        if key == "decoder" and isinstance(val, Mapping):
            dec = {}
            for name, sub in val.items():
                if name in _SCAN_REGIONS and isinstance(sub, Mapping):
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
    if cfg is not None:
        units = {p.split(".")[1] for p in flat if p.startswith("decoder.layers_")}
        from maxtext_indextts2_tpu_torch.models.registry import get_block_style

        want = cfg.num_decoder_layers // len(get_block_style(cfg.decoder_block).attention_pattern)
        if len(units) != want:
            raise ValueError(f"tree has {len(units)} decoder units, config wants {want}")
    # np.array copies: the tensors own writable, contiguous memory
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


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
        units = sorted((k for k in dec if k.startswith("layers_")),
                       key=lambda k: int(k.rpartition("_")[2]))

        def stack(nodes):
            if isinstance(nodes[0], dict):
                return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
            return np.stack(nodes)

        if units:
            stacked = stack([dec.pop(u) for u in units])
            dec["layers"] = stacked
    return tree
