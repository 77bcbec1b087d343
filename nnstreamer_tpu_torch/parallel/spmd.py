"""Training over a mesh: pieces, per-position modules, and what crosses
positions.

The reference trains under one ``jit`` whose shardings GSPMD partitions:
it inserts the collectives, and each device holds its parameter shards.
The port's single controller does that work itself, inside the autograd
graph, so a stage's gradient flows back through the same moves with no
hand-written backward:

- a parameter is a :class:`ShardedTensor`: one piece a position (a
  :class:`~.mesh.Sharding`'s split), each its own leaf, copies of one
  piece at the positions a sharding replicates it over;
- :func:`module_at` builds one position's module around its pieces (no
  weight copied), so the model's own functions run there;
- a ``ppermute`` or re-split is a ``.to(device)``; a ``psum`` is
  :func:`sum_to`, and across processes :func:`all_reduce`
  (``torch.distributed.nn``, whose backward is the all-reduce again);
- after the backward, :func:`sync_grads` makes every copy's gradient the
  sum over the copies: data parallelism's gradient all-reduce. Summing
  is right because each copy's gradient is the part of the loss's
  derivative that flows through that copy's uses.

Across processes, every process computes the same replicated loss;
each scales it by 1/world before the backward, so that the all-reduces'
backward (a sum over processes) adds up to the loss's own derivative.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from nnstreamer_tpu_torch.parallel.mesh import Mesh, Sharding


class ShardedTensor:
    """A global tensor of ``shape`` and ``dtype`` as ``pieces`` (an object
    ndarray of the mesh's shape: each position's piece on its device, None
    where another process holds the position) laid out by ``sharding``."""

    def __init__(self, pieces: np.ndarray, sharding: Sharding, shape: Sequence[int],
                 dtype: torch.dtype) -> None:
        self.pieces = pieces
        self.sharding = sharding
        self.shape = tuple(int(n) for n in shape)
        self.dtype = dtype

    @classmethod
    def place(cls, t: torch.Tensor, sharding: Sharding,
              requires_grad: bool = False) -> "ShardedTensor":
        """``t`` split over ``sharding``, every piece a tensor of its own
        (an ``nn.Parameter`` with ``requires_grad``)."""
        pieces = sharding.split(t.detach())
        for idx in np.ndindex(*pieces.shape):
            if pieces[idx] is not None:
                p = pieces[idx].clone(memory_format=torch.contiguous_format)
                pieces[idx] = nn.Parameter(p) if requires_grad else p
        return cls(pieces, sharding, t.shape, t.dtype)

    def zeros_like(self) -> "ShardedTensor":
        """Zeros on the same layout (no gradients)."""
        pieces = np.empty(self.pieces.shape, dtype=object)
        for idx, p in self.local():
            pieces[idx] = torch.zeros_like(p, requires_grad=False)
        return ShardedTensor(pieces, self.sharding, self.shape, self.dtype)

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    def local(self) -> Iterator[Tuple[Tuple[int, ...], torch.Tensor]]:
        """(position, piece) of every position this process holds."""
        for idx in np.ndindex(*self.pieces.shape):
            if self.pieces[idx] is not None:
                yield idx, self.pieces[idx]

    def piece_shape(self) -> Tuple[int, ...]:
        idx = (0,) * self.pieces.ndim
        return tuple(b - a for a, b in self.sharding.piece_range(idx, self.shape))

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor (every piece must be this process's)."""
        return self.sharding.gather(self.pieces, device).detach()

    def __repr__(self) -> str:
        return f"ShardedTensor({self.shape}, {self.dtype}, {self.sharding})"


def place_state(model: nn.Module, shardings: Dict[str, Sharding]) -> Dict[str, ShardedTensor]:
    """Every state-dict entry of ``model`` (its parameters and persistent
    buffers: the reference's leaves) placed over its sharding, each piece
    a leaf that asks for gradients."""
    return {name: ShardedTensor.place(t, shardings[name], requires_grad=True)
            for name, t in model.state_dict().items()}


def module_at(template: nn.Module, idx: Tuple[int, ...],
              state: Dict[str, ShardedTensor]) -> nn.Module:
    """A copy of ``template`` whose state-dict entries are the pieces of
    position ``idx`` (no weight is copied; buffers that became pieces with
    gradients are registered as parameters, and a batch-norm layer's
    derived vectors are refolded from its pieces)."""
    memo = {id(t): state[name].pieces[idx]
            for name, t in template.state_dict(keep_vars=True).items()}
    m = copy.deepcopy(template, memo)
    for sub in m.modules():
        for k, v in list(sub._buffers.items()):
            if isinstance(v, nn.Parameter):
                del sub._buffers[k]
                sub._parameters[k] = v
        if hasattr(sub, "fold_bn"):
            sub.fold_bn()
    return m


def sum_to(tensors: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of ``tensors`` on ``device``: a ``psum`` of pieces, inside
    the autograd graph."""
    device = torch.device(device)
    out = tensors[0].to(device)
    for t in tensors[1:]:
        out = out + t.to(device)
    return out


def all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed over the processes of ``mesh`` (itself on a
    single-process mesh); differentiable."""
    if mesh.n_processes == 1:
        return t
    import torch.distributed.nn.functional as dfn

    return dfn.all_reduce(t)


def loss_scale(mesh: Mesh) -> float:
    """What each process scales its replicated loss by before the backward
    (see the module docstring)."""
    return 1.0 / mesh.n_processes


def sync_grads(state: Dict[str, ShardedTensor]) -> None:
    """Give every copy of every piece the sum of the copies' gradients
    (None counts as zero; a piece no copy of which has a gradient keeps
    None on a single-process mesh). Across processes the partial sums go
    through one all-reduce a dtype."""
    groups = []  # (members, partial sum or None, piece shape, dtype)
    for name in sorted(state):
        st = state[name]
        members: Dict[Tuple[int, ...], list] = {}
        for idx in np.ndindex(*st.pieces.shape):
            key = st.sharding.piece_key(idx)
            members.setdefault(key, [])
            if st.pieces[idx] is not None:
                members[key].append(st.pieces[idx])
        for key in sorted(members):
            ps = members[key]
            grads = [p.grad for p in ps if p.grad is not None]
            total = sum_to(grads, ps[0].device) if grads else None
            groups.append((ps, total, st.piece_shape(), st.dtype))
    mesh = next(iter(state.values())).mesh
    if mesh.n_processes > 1:
        _all_reduce_partials(groups, mesh)
    for ps, total, _, _ in groups:
        if total is None:
            continue
        for i, p in enumerate(ps):
            p.grad = total.to(p.device) if i == 0 else total.to(p.device).clone()


def _all_reduce_partials(groups: list, mesh: Mesh) -> None:
    """Sum every group's partial over the processes in place (zeros where
    this process holds no copy or no copy has a gradient), one flat
    all-reduce a dtype, in the same order on every process."""
    import torch.distributed as dist

    home = next(d for idx, d in np.ndenumerate(mesh.devices) if mesh.is_local(idx))
    by_dtype: Dict[torch.dtype, list] = {}
    for i, (_, _, _, dtype) in enumerate(groups):
        by_dtype.setdefault(dtype, []).append(i)
    for dtype in sorted(by_dtype, key=str):
        ids = by_dtype[dtype]
        parts = []
        for i in ids:
            _, total, shape, _ = groups[i]
            parts.append(total.to(home).reshape(-1) if total is not None else
                         torch.zeros(int(np.prod(shape)), dtype=dtype, device=home))
        flat = torch.cat(parts)
        dist.all_reduce(flat)
        off = 0
        for i in ids:
            ps, _, shape, _ = groups[i]
            n = int(np.prod(shape))
            total = flat[off:off + n].reshape(shape)
            off += n
            groups[i] = (ps, total.to(ps[0].device) if ps else None, shape, dtype)


def load_state(dst: Dict[str, ShardedTensor], src) -> None:
    """Copy ``src`` into ``dst``'s pieces in place: a tree of
    :class:`ShardedTensor`s on the same layout (say a checkpoint restored
    onto it) or of whole tensors."""
    if set(src) != set(dst):
        raise KeyError(f"state keys differ: {sorted(set(src) ^ set(dst))[:4]}")
    with torch.no_grad():
        for name, st in dst.items():
            other = src[name]
            if tuple(other.shape) != st.shape:
                raise ValueError(f"{name}: shape {tuple(other.shape)} != {st.shape}")
            pieces = other.pieces if isinstance(other, ShardedTensor) else \
                st.sharding.split(torch.as_tensor(other))
            for idx, piece in st.local():
                piece.copy_(pieces[idx])
