"""Checkpoint / resume of training state, in a format of the port's own.

The counterpart of ``nnstreamer_tpu/parallel/checkpoint.py``, which writes
orbax's format; the port cannot use orbax, and neither package reads the
other's checkpoints. A checkpoint is a directory:

- ``manifest.json`` (one a process on a mesh that spans processes:
  ``manifest-<rank>.json``): the format's name and version, the tree's
  structure (dicts, lists, tuples; leaves numbered in order) and, for
  each leaf, its dtype, shape, kind and pieces, each piece a file name
  and the [start, stop) it covers on every dim;
- one raw file a piece (C order, little-endian), ``<leaf>.<piece>.bin``.

A leaf is a ``torch.Tensor``, a numpy array or scalar, a Python number or
a :class:`~.spmd.ShardedTensor`, of which each distinct piece is written
once (by the process holding its first copy). The directory is written
under a temporary name and renamed when complete, as orbax's is. On
restore with ``shardings``, each position reads the range it covers from
the pieces that overlap it, so a checkpoint saved on one mesh factoring
restores onto another.
"""

from __future__ import annotations

import json
import os
import shutil
import uuid
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.parallel import multihost
from nnstreamer_tpu_torch.parallel.mesh import Sharding
from nnstreamer_tpu_torch.parallel.spmd import ShardedTensor

_log = get_logger("parallel.checkpoint")

FORMAT = "nnstreamer_tpu_torch.checkpoint"
VERSION = 1
#: files that mark an orbax checkpoint directory (the JAX package's format)
ORBAX_MARKERS = ("_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt", "_sharding", "checkpoint")
_RAW = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}  # slicing dtype by item size


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _flatten(tree, leaves: list):
    if isinstance(tree, dict):
        return {"dict": {str(k): _flatten(v, leaves) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {type(tree).__name__: [_flatten(v, leaves) for v in tree]}
    if tree is None:
        return {"none": None}
    leaves.append(tree)
    return {"leaf": len(leaves) - 1}


def _unflatten(node, make):
    (kind, body), = node.items()
    if kind == "dict":
        return {k: _unflatten(v, make) for k, v in body.items()}
    if kind in ("list", "tuple"):
        out = [_unflatten(v, make) for v in body]
        return out if kind == "list" else tuple(out)
    if kind == "none":
        return None
    return make(body)


def _leaf_paths(node, prefix=()):
    (kind, body), = node.items()
    if kind == "dict":
        return [p for k, v in body.items() for p in _leaf_paths(v, (*prefix, k))]
    if kind in ("list", "tuple"):
        return [p for i, v in enumerate(body) for p in _leaf_paths(v, (*prefix, i))]
    return [prefix] if kind == "leaf" else []


def _write(path: str, t: torch.Tensor) -> None:
    t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy().tofile(path)


def _leaf_entry(i: int, leaf, tmp: str, rank: int) -> dict:
    """Write leaf ``i``'s pieces (this process's share) → its manifest entry."""
    if isinstance(leaf, ShardedTensor):
        sh, mesh = leaf.sharding, leaf.mesh
        pieces, seen = [], set()
        for idx in np.ndindex(*mesh.devices.shape):
            key = sh.piece_key(idx)
            if key in seen:
                continue
            seen.add(key)  # the first copy of each piece writes it
            if mesh.is_local(idx):
                name = f"{i}.{len(seen) - 1}.bin"
                _write(os.path.join(tmp, name), leaf.pieces[idx])
                pieces.append({"file": name, "range": sh.piece_range(idx, leaf.shape)})
        return {"kind": "torch", "dtype": _dtype_name(leaf.dtype), "shape": list(leaf.shape),
                "pieces": pieces}
    kind = "torch" if isinstance(leaf, torch.Tensor) else \
        "python" if isinstance(leaf, (bool, int, float)) else "numpy"
    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))
    entry = {"kind": kind, "dtype": _dtype_name(t.dtype), "shape": list(t.shape), "pieces": []}
    if rank == 0:  # a whole leaf: the primary writes it
        _write(os.path.join(tmp, f"{i}.0.bin"), t)
        entry["pieces"] = [{"file": f"{i}.0.bin", "range": [[0, n] for n in t.shape]}]
    return entry


def save(path: str, state: Any, force: bool = True) -> None:
    """Write ``state`` (a tree of leaves, see the module docstring) as a
    checkpoint at ``path``; on a mesh that spans processes every process
    calls it with its own pieces. ``force`` replaces an existing one."""
    path = os.path.abspath(path)
    leaves: list = []
    tree = _flatten(state, leaves)
    info = multihost.process_info()
    rank, world = info["process_index"], info["process_count"]
    if os.path.exists(path) and not force:
        raise FileExistsError(f"checkpoint {path} exists (force=False)")
    # one temporary directory every process writes into, renamed when all are done
    tmp = f"{path}.tmp" if world > 1 else f"{path}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    if rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    multihost.barrier("checkpoint-tmp")
    entries = [_leaf_entry(i, leaf, tmp, rank) for i, leaf in enumerate(leaves)]
    manifest = {"format": FORMAT, "version": VERSION, "tree": tree, "leaves": entries}
    name = "manifest.json" if world == 1 else f"manifest-{rank}.json"
    with open(os.path.join(tmp, name), "w") as f:
        json.dump(manifest, f)
    multihost.barrier("checkpoint-written")
    if rank == 0:
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    multihost.barrier("checkpoint-renamed")
    _log.info("checkpoint saved: %s", path)


def _manifests(path: str) -> List[dict]:
    names = []
    if os.path.isdir(path):
        names = sorted(n for n in os.listdir(path)
                       if n.startswith("manifest") and n.endswith(".json"))
    if not names:
        if os.path.isdir(path) and any(os.path.exists(os.path.join(path, m))
                                       for m in ORBAX_MARKERS):
            raise ValueError(
                f"{path} is an orbax checkpoint (the JAX package's format); this package "
                f"reads its own ({FORMAT}: a manifest.json and a raw file a piece)")
        raise FileNotFoundError(f"no checkpoint at {path}")
    out = []
    for n in names:
        with open(os.path.join(path, n)) as f:
            m = json.load(f)
        if m.get("format") != FORMAT or m.get("version") != VERSION:
            raise ValueError(f"{path}/{n}: format {m.get('format')!r} v{m.get('version')}, "
                             f"want {FORMAT!r} v{VERSION}")
        out.append(m)
    return out


class _Leaf:
    """One saved leaf: its dtype, shape and every process's pieces."""

    def __init__(self, path: str, entries: List[dict]) -> None:
        self.path = path
        self.kind = entries[0]["kind"]
        self.dtype = getattr(torch, entries[0]["dtype"])
        self.shape = tuple(entries[0]["shape"])
        self.pieces = [p for e in entries for p in e["pieces"]]
        self._item = torch.empty((), dtype=self.dtype).element_size()

    def read(self, rng) -> torch.Tensor:
        """The block [start, stop) of every dim, assembled from the pieces
        that overlap it."""
        raw = _RAW[self._item]
        out = np.zeros([b - a for a, b in rng], dtype=raw)
        for p in self.pieces:
            prng = [tuple(r) for r in p["range"]]
            lo = [max(a, pa) for (a, _), (pa, _) in zip(rng, prng)]
            hi = [min(b, pb) for (_, b), (_, pb) in zip(rng, prng)]
            if any(h <= low for low, h in zip(lo, hi)) and self.shape:
                continue
            data = np.memmap(os.path.join(self.path, p["file"]), dtype=raw, mode="r",
                             shape=tuple(b - a for a, b in prng) or None)
            src = tuple(slice(low - pa, h - pa) for low, h, (pa, _) in zip(lo, hi, prng))
            dst = tuple(slice(low - a, h - a) for low, h, (a, _) in zip(lo, hi, rng))
            out[dst] = np.asarray(data)[src] if self.shape else np.asarray(data).reshape(())
            del data
        return torch.from_numpy(out).view(self.dtype)

    def whole(self):
        """The whole leaf on the host, of the kind it was saved as (a
        bfloat16 array stays torch: numpy has no bfloat16)."""
        t = self.read([(0, n) for n in self.shape])
        if self.kind == "torch" or self.dtype == torch.bfloat16:
            return t
        a = t.numpy()
        return a.item() if self.kind == "python" else a


def restore(path: str, like: Optional[Any] = None, shardings: Optional[Any] = None):
    """Read a checkpoint. With neither ``like`` nor ``shardings``, every
    leaf comes back whole on the host as it was saved (a tensor or a
    sharded tensor as a torch tensor, numpy arrays and Python numbers as
    themselves). ``like`` (a tree of the same structure) gives each leaf's type
    and checks its shape and dtype; ``shardings`` (the same structure, a
    :class:`~.mesh.Sharding` or None a leaf) puts each sharded leaf's
    pieces straight onto their positions as a :class:`~.spmd.ShardedTensor`,
    each position reading only the range it covers. An orbax directory
    raises and names the format."""
    path = os.path.abspath(path)
    ms = _manifests(path)
    tree = ms[0]["tree"]
    saved = [_Leaf(path, [m["leaves"][i] for m in ms]) for i in range(len(ms[0]["leaves"]))]
    likes: Dict[int, Any] = {}
    shards: Dict[int, Any] = {}
    if like is not None:
        likes = dict(enumerate(_collect(like, tree)))
    if shardings is not None:
        shards = dict(enumerate(_collect(shardings, tree)))

    def make(i: int):
        leaf, want, sh = saved[i], likes.get(i), shards.get(i)
        if want is not None:
            if isinstance(want, (torch.Tensor, ShardedTensor)):
                shape, dtype = tuple(want.shape), want.dtype
            else:
                a = np.asarray(want)
                shape, dtype = a.shape, torch.from_numpy(np.zeros((), dtype=a.dtype)).dtype
            if shape != leaf.shape or dtype != leaf.dtype:
                raise ValueError(f"{path}: leaf {i} is {leaf.dtype}{list(leaf.shape)}, "
                                 f"want {dtype}{list(shape)}")
        if isinstance(sh, Sharding):
            return _restore_sharded(leaf, sh)
        if want is None:
            return leaf.whole()
        if isinstance(want, (torch.Tensor, ShardedTensor)):
            return leaf.read([(0, n) for n in leaf.shape])
        return leaf.whole()

    return _unflatten(tree, make)


def _collect(tree, saved_tree) -> list:
    """The leaves of ``tree`` in the saved tree's leaf order (None where it
    has None)."""
    out = []
    for p in _leaf_paths(saved_tree):
        node = tree
        for k in p:
            node = node[k] if not isinstance(node, dict) or k in node else node[int(k)]
        out.append(node)
    return out


def _restore_sharded(leaf: _Leaf, sh: Sharding) -> ShardedTensor:
    mesh = sh.mesh
    pieces = np.empty(mesh.devices.shape, dtype=object)
    read: Dict[tuple, torch.Tensor] = {}
    for idx in np.ndindex(*mesh.devices.shape):
        if not mesh.is_local(idx):
            continue
        key = sh.piece_key(idx)
        if key not in read:
            read[key] = leaf.read(sh.piece_range(idx, leaf.shape))
        pieces[idx] = read[key].to(mesh.devices[idx], copy=True)
    return ShardedTensor(pieces, sh, leaf.shape, leaf.dtype)


def latest_step(root: str) -> Optional[int]:
    """The largest N of the ``root/step_N`` checkpoints, or None."""
    if not os.path.isdir(root):
        return None
    steps = []
    for entry in os.listdir(root):
        if entry.startswith("step_"):
            try:
                steps.append(int(entry[len("step_"):]))
            except ValueError:
                continue
    return max(steps) if steps else None


def step_path(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step}")
