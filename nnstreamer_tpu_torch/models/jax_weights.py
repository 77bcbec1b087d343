"""Carry the JAX package's param trees over to the port's modules.

The reference keeps a model's weights as nested dicts and lists of arrays
(``nnstreamer_tpu/models/*.py init_params``) and overlays an npz of leaves
``p{i}`` in ``jax.tree_util`` flatten order (dict keys sorted, lists in
order; ``nnstreamer_tpu/models/zoo.py _load_params_overlay``). A model of
the port lists the paths of those leaves in the same order; this module
maps each path to its state-dict key and its layout:

- ``(..., "bn", leaf)`` → ``<module>.<leaf>`` (a :class:`~.nn.ConvBN`
  buffer), ``(..., "w")`` → ``<module>.weight``, ``(..., "b")`` →
  ``<module>.bias``;
- conv weights HWIO → OIHW (depthwise (3, 3, 1, C) → (C, 1, 3, 3) falls
  out of the same transpose), dense (cin, cout) → (cout, cin), vectors
  unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

BN_LEAVES = ("bias", "mean", "scale", "var")  # sorted: tree-flatten order


def conv_bn_paths(prefix: Tuple) -> List[Tuple]:
    """Leaf paths of one ``{"w", "bn": {...}}`` conv in flatten order."""
    return [(*prefix, "bn", k) for k in BN_LEAVES] + [(*prefix, "w")]


def state_key(path: Tuple) -> str:
    """Reference param path → key of the port module's state dict."""
    if len(path) > 1 and path[-2] == "bn":
        module, leaf = path[:-2], path[-1]
    else:
        module, leaf = path[:-1], {"w": "weight", "b": "bias"}[path[-1]]
    return ".".join(str(p) for p in module) + "." + leaf


def convert_leaf(value: np.ndarray) -> torch.Tensor:
    """Layout carry-over of one leaf (see the module docstring)."""
    a = np.asarray(value, dtype=np.float32)
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    elif a.ndim == 2:
        a = a.T
    return torch.tensor(np.ascontiguousarray(a))


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def state_dict_from_tree(params, paths: List[Tuple]) -> Dict[str, torch.Tensor]:
    """A reference param tree (converted to numpy) → a state dict."""
    return {state_key(p): convert_leaf(_get(params, p)) for p in paths}


def load_npz(model: nn.Module, path: str, paths: List[Tuple]) -> None:
    """Overlay leaves ``p{i}`` of an npz (reference tree-flatten order,
    ``paths[i]`` naming leaf i) onto ``model``; leaves the file lacks keep
    their current values. A leaf of the wrong shape raises."""
    blob = np.load(path, allow_pickle=False)
    state = model.state_dict()
    for i, p in enumerate(paths):
        if f"p{i}" not in blob:
            continue
        key = state_key(p)
        new = convert_leaf(blob[f"p{i}"])
        if tuple(new.shape) != tuple(state[key].shape):
            raise ValueError(
                f"{path}: leaf p{i} ({key}) has shape {tuple(new.shape)}, "
                f"model wants {tuple(state[key].shape)}"
            )
        state[key] = new
    model.load_state_dict(state)
