"""Device meshes: the substrate of the port's multi-device layer.

The counterpart of ``nnstreamer_tpu/parallel/mesh.py``. The reference's
mesh is single-controller: one process ``jit``s over N devices, and GSPMD
splits, places and gathers. The port's is the same in shape, one process
holding a ``torch.device`` for each mesh position, but the splitting,
placing and gathering are its own: a :class:`Sharding` cuts a tensor into
per-position pieces on their devices and puts them back together.

- On a host with N cards the positions are ``cuda:0 .. cuda:N-1`` and the
  copies between them are peer copies.
- On the CPU, *when the caller asks for it* (``devices="cpu"``), every
  position is the CPU device. There are ``[mesh] cpu_devices`` of them
  (``NNS_TPU_MESH_CPU_DEVICES``, default 1): the analogue of the
  reference's virtual CPU devices, so the sharding arithmetic runs as it
  would across cards. The parity tests set it to 8, as the reference's
  conftest sets its device count.

Nothing gives way to fewer devices: a mesh larger than what is there
raises and names both counts.

Once :func:`.multihost.initialize` has joined a process group, a mesh over
the default devices is *global*, as the reference's ``jax.devices()``
becomes: it lists every process's positions in rank order, and
``Mesh.ranks`` tags each with the rank that holds it. A :class:`Sharding`
then materializes only this process's pieces (None at the others); what
crosses processes goes through ``torch.distributed`` (``parallel/spmd.py``).

The reference's ``shard_map`` has no counterpart: each user of a mesh here
(the torch backend's ``mesh:``, the slot-sharded ``ContinuousBatcher``,
the plane's ``MeshShardedProgram``) runs its per-position work itself.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from nnstreamer_tpu_torch.config import conf
from nnstreamer_tpu_torch.parallel import multihost

DevicesLike = Optional[Union[str, torch.device, Sequence[torch.device]]]


def cpu_positions() -> int:
    """The mesh positions the CPU offers (``[mesh] cpu_devices``)."""
    return max(1, conf().get_int("mesh", "cpu_devices", 1))


def available_devices(kind: Union[str, torch.device, None] = None) -> list:
    """Every position a mesh of ``kind`` may use: ``cuda:0 ..`` for
    ``"cuda"`` (the default), the configured count of CPU positions for
    ``"cpu"``."""
    kind = torch.device(kind).type if kind is not None else "cuda"
    if kind == "cpu":
        return [torch.device("cpu")] * cpu_positions()
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    raise ValueError(f"mesh positions on {kind!r} (want cuda or cpu)")


class Mesh:
    """Named axes over an ndarray of ``torch.device`` (one per position).
    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh``'s.
    ``ranks`` (same shape, or None: every position is this process's)
    names the process that holds each position, and ``rank`` is this
    process's."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 ranks: Optional[np.ndarray] = None, rank: int = 0) -> None:
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} dims with axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.ranks = ranks
        self.rank = rank

    @property
    def n_processes(self) -> int:
        return 1 if self.ranks is None else len(set(self.ranks.flat))

    def is_local(self, idx: Tuple[int, ...]) -> bool:
        """Whether this process holds position ``idx``."""
        return self.ranks is None or int(self.ranks[idx]) == self.rank

    def position(self, **coords: int) -> Tuple[int, ...]:
        """The index of the position at ``coords`` (0 on every axis not
        given; axes the mesh lacks are ignored)."""
        return tuple(coords.get(a, 0) for a in self.axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, axis: str) -> int:
        """The size of ``axis``; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def along(self, axis: str, **fixed: int) -> list:
        """The devices along ``axis`` (one if the mesh lacks it), every
        other axis at its index in ``fixed`` (0 where not given)."""
        out = []
        for i in range(self.axis_size(axis)):
            idx = tuple(i if a == axis else fixed.get(a, 0) for a in self.axis_names)
            out.append(self.devices[idx])
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices.flat[0]})"


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Sequence[str] = ("dp", "tp"),
    shape: Optional[Sequence[int]] = None,
    devices: DevicesLike = None,
) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices``.

    ``devices`` is a list of devices, or a kind (``"cuda"``, the default,
    or ``"cpu"``) whose :func:`available_devices` are taken. The default
    factoring is the reference's: as much as possible (a power of two, at
    most 4) on the *last* axis, the rest on the first; ``("dp", "tp")`` over
    8 devices is (2, 4). Under :func:`.multihost.initialize` the default
    devices (or the group's kind) are every process's, in rank order."""
    ranks = None
    if devices is None or isinstance(devices, (str, torch.device)):
        tagged = multihost.global_positions(devices)
        if tagged is None:
            devs = available_devices(devices)
        else:
            ranks = [r for r, _ in tagged]
            devs = [d for _, d in tagged]
    else:
        devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0:
        raise ValueError("need at least 1 device, have 0")
    if shape is None:
        if len(axes) == 1:
            shape = (n,)
        elif len(axes) == 2:
            tp = 1
            while tp * 2 <= n and n % (tp * 2) == 0 and tp * 2 <= 4:
                tp *= 2
            shape = (n // tp, tp)
        else:
            shape = (n,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    if ranks is None:
        return Mesh(arr.reshape(shape), axes)
    return Mesh(arr.reshape(shape), axes, np.array(ranks[:n]).reshape(shape),
                multihost.process_info()["process_index"])


class Sharding:
    """How a tensor lies over a mesh: ``spec[d]`` names the mesh axis that
    tensor dim ``d`` is split over (None: whole), as a ``PartitionSpec``.
    Dims past the spec are whole, so ``()`` is replicated."""

    def __init__(self, mesh: Mesh, spec: Tuple[Optional[str], ...] = ()) -> None:
        for a in spec:
            if a is not None and a not in mesh.axis_names:
                raise ValueError(f"spec {spec} names {a!r}, not an axis of {mesh.axis_names}")
        self.mesh = mesh
        self.spec = tuple(spec)

    @property
    def is_fully_replicated(self) -> bool:
        return all(a is None or self.mesh.axis_size(a) == 1 for a in self.spec)

    def divides(self, shape: Sequence[int]) -> bool:
        """Whether every split dim of ``shape`` divides over its axis."""
        return len(shape) >= len(self.spec) and all(
            a is None or shape[d] % self.mesh.axis_size(a) == 0
            for d, a in enumerate(self.spec))

    def piece_key(self, idx: Tuple[int, ...]) -> Tuple[int, ...]:
        """Which piece position ``idx`` holds: its index on each split dim's
        axis (positions with equal keys hold copies of one piece)."""
        names = self.mesh.axis_names
        return tuple(idx[names.index(a)] for a in self.spec if a is not None)

    def piece_range(self, idx: Tuple[int, ...],
                    shape: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
        """The [start, stop) of every dim of ``shape`` that position
        ``idx``'s piece covers."""
        names = self.mesh.axis_names
        out = []
        for d, n in enumerate(shape):
            a = self.spec[d] if d < len(self.spec) else None
            if a is None:
                out.append((0, int(n)))
            else:
                k = self.mesh.axis_size(a)
                i = idx[names.index(a)]
                out.append((i * n // k, (i + 1) * n // k))
        return tuple(out)

    def split(self, t: torch.Tensor) -> np.ndarray:
        """The pieces of ``t`` [object ndarray of the mesh's shape]: each
        position's contiguous block of every split dim, on its device
        (None at a position another process holds)."""
        if not self.divides(tuple(t.shape)):
            raise ValueError(f"shape {tuple(t.shape)} does not divide over {self.spec} "
                             f"on mesh {self.mesh.shape}")
        names = self.mesh.axis_names
        out = np.empty(self.mesh.devices.shape, dtype=object)
        for idx in np.ndindex(*self.mesh.devices.shape):
            if not self.mesh.is_local(idx):
                continue
            piece = t
            for d, a in enumerate(self.spec):
                if a is not None:
                    k = self.mesh.axis_size(a)
                    piece = piece.chunk(k, dim=d)[idx[names.index(a)]]
            out[idx] = piece.to(self.mesh.devices[idx])
        return out

    def gather(self, pieces: np.ndarray,
               device: Union[str, torch.device, None] = None) -> torch.Tensor:
        """The whole tensor back from :meth:`split`'s pieces, on ``device``
        (default: the first position's). Every piece must be this
        process's."""
        if any(p is None for p in pieces.flat):
            raise ValueError("gather: pieces held by other processes (a multi-process mesh)")
        dev = torch.device(device) if device is not None else self.mesh.devices.flat[0]
        names = self.mesh.axis_names
        blocks = np.empty(pieces.shape, dtype=object)
        for idx in np.ndindex(*pieces.shape):
            blocks[idx] = pieces[idx].to(dev)
        # fold the mesh axes one by one: concatenate along the tensor dim an
        # axis splits, keep the first position of an axis that splits none
        for ax in reversed(range(len(names))):
            dim = next((d for d, a in enumerate(self.spec) if a == names[ax]), None)
            folded = np.empty(blocks.shape[:ax] + blocks.shape[ax + 1:], dtype=object)
            for idx in np.ndindex(*folded.shape):
                row = [blocks[idx[:ax] + (i,) + idx[ax:]] for i in range(blocks.shape[ax])]
                folded[idx] = row[0] if dim is None else torch.cat(row, dim=dim)
            blocks = folded
        return blocks[()]

    def __repr__(self) -> str:
        return f"Sharding({self.spec})"


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh, axis: str = "dp") -> Sharding:
    """The leading (batch) dim split over ``axis``."""
    return Sharding(mesh, (axis,))


def channel_sharding(mesh: Mesh, ndim: int, axis: str = "tp") -> Sharding:
    """The trailing (channel / feature) dim split over ``axis``."""
    return Sharding(mesh, (None,) * (ndim - 1) + (axis,))
