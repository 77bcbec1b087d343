"""Multi-process runtime: the ``torch.distributed`` bring-up.

The counterpart of ``nnstreamer_tpu/parallel/multihost.py``, which joins
``jax.distributed``: every process runs the same program, a TCP rendezvous
wires them, and a mesh over the default devices becomes *global*
(``parallel/mesh.py make_mesh``): it lists every process's positions in
rank order, each tagged with its rank. A process holds the pieces of its
own positions; a reduction over an axis that crosses processes goes
through ``torch.distributed`` (``parallel/spmd.py``).

    from nnstreamer_tpu_torch.parallel import multihost, mesh
    multihost.initialize("10.0.0.1:29500", num_processes=2, process_id=rank)
    m = mesh.make_mesh(axes=("dp", "tp"))     # spans both processes

The backend is nccl on the cards and gloo when the caller asks for the
CPU (``device="cpu"``), whose positions are ``[mesh] cpu_devices`` a
process, as a single-process CPU mesh's are. With no address, the
torchrun variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``) are read.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from nnstreamer_tpu_torch.log import get_logger

_log = get_logger("parallel.multihost")
#: how long a collective (a barrier included) waits for a missing process
TIMEOUT = datetime.timedelta(seconds=600)


@dataclass
class _Group:
    kind: str  # "cuda" | "cpu"
    rank: int
    world: int
    local: List[torch.device]  # this process's positions
    counts: List[int]  # every process's number of positions, by rank


_group: Optional[_Group] = None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    device: str = "cuda",
) -> None:
    """Join the process group (idempotent): ``coordinator_address`` is
    ``host:port`` of rank 0's rendezvous; ``local_device_ids`` picks this
    process's cards (default: all of them)."""
    global _group
    if _group is not None:
        return
    import torch.distributed as dist

    from nnstreamer_tpu_torch.parallel.mesh import available_devices

    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"multihost on {device!r} (want cuda or cpu)")
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost: no CUDA device (pass device='cpu' for gloo)")
        ids = list(local_device_ids) if local_device_ids is not None else \
            list(range(torch.cuda.device_count()))
        local = [torch.device("cuda", i) for i in ids]
        torch.cuda.set_device(local[0])
    else:
        local = available_devices("cpu")
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(
        backend="nccl" if kind == "cuda" else "gloo", init_method=init,
        world_size=num_processes if num_processes is not None else -1,
        rank=process_id if process_id is not None else -1,
        timeout=TIMEOUT,
    )
    counts: list = [None] * dist.get_world_size()
    dist.all_gather_object(counts, len(local))
    _group = _Group(kind, dist.get_rank(), dist.get_world_size(), local, counts)
    _log.info("multihost up: process %d/%d (%s), %d global / %d local positions",
              _group.rank, _group.world, dist.get_backend(), sum(counts), len(local))


def shutdown() -> None:
    global _group
    if _group is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
        _group = None


def barrier(tag: str = "barrier") -> None:
    """Block until every process reaches this point: the fence that orders
    singleton work (every process has written its checkpoint pieces before
    the primary records the step). A lost process surfaces as this call
    timing out."""
    if _group is None:
        return
    import torch.distributed as dist

    _log.debug("barrier %s", tag)
    if _group.kind == "cuda":
        dist.barrier(device_ids=[_group.local[0].index])
    else:
        dist.barrier()


def is_primary() -> bool:
    """True on the process that does singleton work (logging, checkpoint
    bookkeeping); the only process when none was joined."""
    return _group is None or _group.rank == 0


def process_info() -> dict:
    if _group is None:
        return {"process_index": 0, "process_count": 1, "global_devices": None,
                "local_devices": None}
    return {"process_index": _group.rank, "process_count": _group.world,
            "global_devices": sum(_group.counts), "local_devices": len(_group.local)}


def global_positions(kind=None) -> Optional[list]:
    """Every process's positions in rank order as (rank, device) pairs
    (another process's cards by that process's index), or None when no
    group was joined or ``kind`` is not the group's."""
    if _group is None:
        return None
    if kind is not None and torch.device(kind).type != _group.kind:
        return None
    out = []
    for r, n in enumerate(_group.counts):
        if r == _group.rank:
            out.extend((r, d) for d in _group.local)
        elif _group.kind == "cpu":
            out.extend((r, torch.device("cpu")) for _ in range(n))
        else:
            out.extend((r, torch.device("cuda", i)) for i in range(n))
    return out
