"""Pipeline parallelism: GPipe microbatch rotation over a mesh axis.

The counterpart of ``nnstreamer_tpu/parallel/pipeline_parallel.py``. Each
position of the ``pp`` axis holds a contiguous slice of the layers (an
``nn.ModuleList`` slice on its device, where the reference shards stacked
leaves on their leading dim), and the schedule is the classic
(M + S − 1)-tick loop: at tick t stage s runs microbatch t − s, stage 0
feeding the microbatches in and each stage handing its output to the next
stage's device (the reference's ``ppermute``). The output is the last
stage's stream of microbatches. The single controller issues only the
(stage, microbatch) pairs that hold data; the reference's stages also
compute on the bubble's filler, which never reaches the output.

The layers stay the caller's: :func:`place_stages` moves each slice onto
its stage's device once (in place, as ``nn.Module.to`` does), and the
forward runs those very modules, so a backward through it reaches the
caller's parameters. A slice that is not on its stage's device raises;
nothing is copied behind the caller's back.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch
from torch import nn

from nnstreamer_tpu_torch.parallel.mesh import Mesh, Sharding


def _slices(blocks: Sequence[nn.Module], n_stages: int) -> List[nn.ModuleList]:
    if len(blocks) % n_stages:
        raise ValueError(f"pipeline: {len(blocks)} layers do not divide over {n_stages} stages")
    k = len(blocks) // n_stages
    return [nn.ModuleList(blocks[i * k:(i + 1) * k]) for i in range(n_stages)]


def _layers(blocks) -> List[nn.Module]:
    return list(getattr(blocks, "blocks", blocks))


def place_stages(blocks, mesh: Mesh, axis: str = "pp"):
    """Move each contiguous slice of ``blocks`` (an ``nn.ModuleList`` or a
    module with ``blocks``) onto its position of ``axis``, in place;
    returns ``blocks``. The layer count must divide by the axis size."""
    Sharding(mesh, (axis,))  # names an axis of the mesh, or raises
    devices = mesh.along(axis)
    for stage, dev in zip(_slices(_layers(blocks), len(devices)), devices):
        stage.to(dev)
    return blocks


def stage_slices(blocks: Sequence[nn.Module],
                 devices: Sequence[torch.device]) -> List[nn.ModuleList]:
    """The layers cut into one contiguous slice a stage (the modules
    themselves); the layer count must divide by the stages, and each slice
    must lie on its stage's device (:func:`place_stages`)."""
    stages = _slices(blocks, len(devices))
    for i, (stage, dev) in enumerate(zip(stages, devices)):
        off = {str(t.device) for t in stage.state_dict().values() if t.device != dev}
        if off:
            raise ValueError(f"pipeline: stage {i}'s layers lie on {sorted(off)}, not {dev}; "
                             "place them with place_stages")
    return stages


def pipeline_forward_local(stages: Sequence[nn.Module], x: torch.Tensor,
                           devices: Sequence[torch.device], stage_fn: Callable,
                           n_microbatches: int) -> torch.Tensor:
    """The schedule over ``stages`` (stage s's layer slice on
    ``devices[s]``): x [N, ...] with N = M·mb, ``stage_fn(x_mb, stage)`` →
    y_mb of the same shape. Returns y [N, ...] on x's device."""
    s = len(stages)
    m = n_microbatches
    n = x.shape[0]
    if n % m:
        raise ValueError(f"pipeline: batch {n} not divisible by {m} microbatches")
    x_mbs = x.reshape((m, n // m) + tuple(x.shape[1:]))
    recv = [None] * s  # what each stage received at the last tick
    outs = []
    for t in range(m + s - 1):
        sent = [None] * s
        for st in range(s):
            j = t - st  # the microbatch stage st runs at tick t
            if not 0 <= j < m:
                continue
            inp = x_mbs[j].to(devices[0]) if st == 0 else recv[st]
            out = stage_fn(inp, stages[st])
            if st == s - 1:
                outs.append(out.to(x.device))
            else:
                sent[st + 1] = out.to(devices[st + 1])  # the hand-off
        recv = sent
    y = torch.stack(outs)
    return y.reshape((n,) + tuple(y.shape[2:]))


def make_pipeline_forward(mesh: Mesh, stage_fn: Callable, n_microbatches: int,
                          axis: str = "pp") -> Callable:
    """Whole-array entry: (blocks, x) → y, with ``blocks`` every layer (an
    ``nn.ModuleList`` or a module with ``blocks``), cut into one slice a
    position of ``axis`` and placed there (:func:`place_stages`); the
    layer count must divide by the axis size. x and y are whole."""
    Sharding(mesh, (axis,))  # names an axis of the mesh, or raises
    devices = mesh.along(axis)

    def forward(blocks, x: torch.Tensor) -> torch.Tensor:
        stages = stage_slices(_layers(blocks), devices)
        return pipeline_forward_local(stages, x, devices, stage_fn, n_microbatches)

    return forward
