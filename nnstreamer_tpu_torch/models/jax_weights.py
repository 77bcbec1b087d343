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

The transformer LM's stacked block leaves follow rules of their own
(:func:`transformer_from_jax`).
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


#: the reference transformer's leaves in tree-flatten order (dict keys
#: sorted): the stacked block leaves [L, ...], then the top-level ones
TRANSFORMER_BLOCK_LEAVES = ("ln1", "ln2", "w_down", "w_gate", "w_up", "wo", "wqkv")
TRANSFORMER_TOP_LEAVES = ("embed", "head", "ln_f")


def _transformer_leaf(name: str, value) -> Dict[str, torch.Tensor]:
    """One reference transformer leaf → the port's state-dict entries.

    The generic :func:`convert_leaf` does not apply here: a stacked block
    leaf is [L, cin, cout] (3-D, which it would leave as it is), so it is
    split per layer and each dense slice transposed to ``nn.Linear``'s
    [cout, cin]; and ``embed`` [vocab, d] is a lookup table, not a dense
    weight, so it keeps its layout while ``head`` [d, vocab] is
    transposed."""
    if isinstance(value, dict):
        raise NotImplementedError(
            f"transformer leaf {name!r} is weight-only int8 ({sorted(value)}); "
            "models/quantize.py is not ported yet"
        )
    a = np.asarray(value, dtype=np.float32)

    def t(x: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(x))

    if name in TRANSFORMER_BLOCK_LEAVES:
        out = {}
        for i, layer in enumerate(a):
            if layer.ndim == 2:
                out[f"blocks.{i}.{name}.weight"] = t(layer.T)
            else:
                out[f"blocks.{i}.{name}"] = t(layer)
        return out
    if name == "head":
        return {"head.weight": t(a.T)}
    return {name: t(a)}


def transformer_from_jax(params) -> Dict[str, torch.Tensor]:
    """A reference ``transformer.init_params`` tree (arrays or numpy) → the
    state dict of the port's :class:`~.transformer.TransformerLM`."""
    state: Dict[str, torch.Tensor] = {}
    for name in TRANSFORMER_BLOCK_LEAVES:
        state.update(_transformer_leaf(name, params["blocks"][name]))
    for name in TRANSFORMER_TOP_LEAVES:
        state.update(_transformer_leaf(name, params[name]))
    return state


def load_transformer_npz(model: nn.Module, path: str) -> None:
    """Overlay an npz of reference transformer leaves ``p{i}`` (tree-flatten
    order, :data:`TRANSFORMER_BLOCK_LEAVES` then
    :data:`TRANSFORMER_TOP_LEAVES`) onto ``model``; leaves the file lacks
    keep their values, a leaf of the wrong shape or depth raises."""
    blob = np.load(path, allow_pickle=False)
    state = model.state_dict()
    for i, name in enumerate(TRANSFORMER_BLOCK_LEAVES + TRANSFORMER_TOP_LEAVES):
        if f"p{i}" not in blob:
            continue
        for key, new in _transformer_leaf(name, blob[f"p{i}"]).items():
            if key not in state or tuple(new.shape) != tuple(state[key].shape):
                want = tuple(state[key].shape) if key in state else "no such weight"
                raise ValueError(
                    f"{path}: leaf p{i} ({key}) has shape {tuple(new.shape)}, "
                    f"model wants {want}"
                )
            state[key] = new
    model.load_state_dict(state)


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
