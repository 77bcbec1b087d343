"""A filter's model run over a device mesh: dp over the batch, tp over
output channels.

The port's counterpart of what GSPMD makes of the reference's ``mesh:``
annotations (``nnstreamer_tpu/backends/jax_backend.py``
``_build_mesh_shardings``): inputs whose dim 0 divides over ``dp`` split
into per-row batches; every layer whose output channels divide over ``tp``
is column-parallel.

- **dp.** Each position of the ``dp`` axis is a row holding its own copy
  of the model on the row's first device. An input whose sharding splits
  dim 0 over ``dp`` is cut into the rows' contiguous batch blocks; any
  other input goes whole to every row. The rows' outputs are concatenated
  on dim 0 in row order. With no input split, one row computes the whole
  batch (the others would compute the same).
- **tp.** In each row, every conv or dense layer (:data:`COLUMN_LAYERS`)
  that the forward calls as a module, and whose output channels divide by
  ``tp``, becomes a :class:`ColumnParallel`: position ``j`` of the row's
  ``tp`` axis holds output channels ``[j·C/tp, (j+1)·C/tp)`` of the weight
  and of every per-channel vector, and computes that channel slice. The
  slices are gathered in channel order before the next layer: the
  column-parallel all-gather. A grouped conv (a depthwise one included)
  splits its groups with its channels, each position taking its groups'
  input channels.

Weights are torch's: dim 0 of ``nn.Linear`` / ``nn.Conv2d`` weights (and
of the zoo's ``ConvBN`` / ``BiasConv``, models/nn.py) is the output
channel, where JAX's HWIO layout puts it last. A layer read by the forward
through its ``.weight`` instead of called (the transformer's functional
matmuls) is never split: it would be read whole.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from nnstreamer_tpu_torch.models.nn import BiasConv, ConvBN
from nnstreamer_tpu_torch.parallel.mesh import (
    Mesh,
    Sharding,
    batch_sharding,
    replicated,
)

#: layer kinds with per-output-channel state on dim 0 → the output's channel dim
COLUMN_LAYERS = {ConvBN: 1, BiasConv: 1, nn.Conv2d: 1, nn.Linear: -1}


def _out_channels(layer: nn.Module) -> int:
    return int(layer.weight.shape[0])


def _splittable(layer: nn.Module, tp: int) -> bool:
    c = _out_channels(layer)
    groups = int(getattr(layer, "groups", 1))
    return c % tp == 0 and c >= tp and (groups == 1 or groups % tp == 0)


class ColumnParallel(nn.Module):
    """One layer split over ``devices`` by output channel (see the module
    docstring). ``weight`` is the first part's: its dtype and device are
    the layer's, for the forwards that read them."""

    def __init__(self, layer: nn.Module, devices: Sequence[torch.device]) -> None:
        super().__init__()
        tp = len(devices)
        cout = _out_channels(layer)
        c = cout // tp
        groups = int(getattr(layer, "groups", 1))
        self.grouped = groups > 1
        self.out_dim = COLUMN_LAYERS[type(layer)]
        self.devices = [torch.device(d) for d in devices]
        parts = []
        for j, dev in enumerate(self.devices):
            part = copy.deepcopy(layer)
            for table in (part._parameters, part._buffers):
                for name, t in table.items():
                    if t is not None and t.dim() >= 1 and t.shape[0] == cout:
                        piece = t.detach()[j * c:(j + 1) * c].clone()
                        table[name] = (nn.Parameter(piece, requires_grad=False)
                                       if isinstance(t, nn.Parameter) else piece)
            if self.grouped:
                part.groups = groups // tp
            if isinstance(part, nn.Linear):
                part.out_features = c
            elif isinstance(part, nn.Conv2d):
                part.out_channels = c
            parts.append(part.to(dev))
        self.parts = nn.ModuleList(parts)

    @property
    def weight(self) -> torch.Tensor:
        return self.parts[0].weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        home = x.device
        xs = x.chunk(len(self.parts), dim=1) if self.grouped else (x,) * len(self.parts)
        outs = [p(xi.to(d, non_blocking=True)).to(home, non_blocking=True)
                for p, d, xi in zip(self.parts, self.devices, xs)]
        return torch.cat(outs, dim=self.out_dim)


def called_layers(module: nn.Module, inputs: Sequence[torch.Tensor]) -> set:
    """The ids of the :data:`COLUMN_LAYERS` submodules that ``module``
    calls on ``inputs`` (one forward, with pre-hooks recording the calls)."""
    seen: set = set()
    hooks = [m.register_forward_pre_hook(lambda mod, _args: seen.add(id(mod)))
             for m in module.modules() if type(m) in COLUMN_LAYERS]
    try:
        with torch.inference_mode():
            module(*inputs)
    finally:
        for h in hooks:
            h.remove()
    return seen


def split_columns(module: nn.Module, devices: Sequence[torch.device], called: set) -> List[str]:
    """Replace, in place, every called and splittable layer of ``module``
    by its :class:`ColumnParallel` over ``devices`` → the replaced layers'
    names."""
    tp = len(devices)
    split = []
    for name, parent in list(module.named_modules()):
        for child_name, child in list(parent.named_children()):
            if (type(child) in COLUMN_LAYERS and id(child) in called
                    and _splittable(child, tp)):
                setattr(parent, child_name, ColumnParallel(child, devices))
                split.append(f"{name}.{child_name}" if name else child_name)
    return split


class MeshModel:
    """``fn`` (the model's callable; ``module`` the ``nn.Module`` behind it,
    or None) run over ``mesh`` with one :class:`Sharding` per input
    (``in_shardings``) and, with ``tp_axis``, its layers column-parallel
    over that axis. ``device`` is where the inputs arrive and the outputs
    are returned; ``probe`` are zeros of the input shapes (one forward
    finds the layers the model calls). Callable as ``fn`` is."""

    def __init__(self, fn: Callable, module: Optional[nn.Module], mesh: Mesh,
                 in_shardings: Sequence[Sharding], tp_axis: Optional[str],
                 device: torch.device, probe: Sequence[torch.Tensor],
                 row_axis: str = "dp") -> None:
        self.mesh = mesh
        self.device = torch.device(device)
        self.in_shardings = tuple(in_shardings)
        self.row_axis = row_axis
        # an input is cut over the rows when its dim 0 is split over the row axis
        self.split_inputs = tuple(bool(s.spec) and s.spec[0] == row_axis
                                  and mesh.axis_size(row_axis) > 1 for s in self.in_shardings)
        tp = mesh.axis_size(tp_axis) if tp_axis else 1
        called = called_layers(module, probe) if tp > 1 and module is not None else set()
        self.rows: List[Callable] = []
        self.row_devices: List[torch.device] = []
        self.split_layers: Dict[int, List[str]] = {}
        for i in range(mesh.axis_size(row_axis)):
            cols = mesh.along(tp_axis or row_axis, **{row_axis: i}) if tp > 1 else \
                mesh.along(row_axis)[i:i + 1]
            home = cols[0]
            self.row_devices.append(home)
            if tp == 1 and home == self.device:
                self.rows.append(fn)
                continue
            if module is None:
                raise ValueError(f"a model with no nn.Module cannot be placed on {home}")
            row = copy.deepcopy(module).to(home)
            if tp > 1:
                # ids of the copy's layers that correspond to the called ones
                row_called = {id(c) for o, c in zip(module.modules(), row.modules())
                              if id(o) in called}
                self.split_layers[i] = split_columns(row, cols, row_called)
            self.rows.append(row)

        # the rows as a 1-D mesh: how each input and the outputs lie over them
        devs = np.empty(len(self.rows), dtype=object)
        devs[:] = self.row_devices
        rows_mesh = Mesh(devs, (row_axis,))
        self._row_in = tuple(batch_sharding(rows_mesh, row_axis) if cut else
                             replicated(rows_mesh) for cut in self.split_inputs)
        self._row_out = batch_sharding(rows_mesh, row_axis)

    @property
    def n_rows(self) -> int:
        return len(self.rows)

    @property
    def splits_inputs(self) -> bool:
        return any(self.split_inputs)

    def __call__(self, *tensors: torch.Tensor):
        if not self.splits_inputs:
            outs = self.rows[0](*(t.to(self.row_devices[0]) for t in tensors))
            if isinstance(outs, torch.Tensor):
                return outs.to(self.device)
            return tuple(o.to(self.device) for o in outs)
        pieces = [sh.split(t) for sh, t in zip(self._row_in, tensors)]
        outs = [row(*(p[i] for p in pieces)) for i, row in enumerate(self.rows)]
        single = isinstance(outs[0], torch.Tensor)
        outs = [(o,) if single else tuple(o) for o in outs]
        gathered = []
        for k in range(len(outs[0])):
            col = np.empty(len(outs), dtype=object)
            for i, o in enumerate(outs):  # one by one: numpy would read a list of tensors
                col[i] = o[k]
            gathered.append(self._row_out.gather(col, self.device))
        return gathered[0] if single else tuple(gathered)

    def column_parts(self) -> Dict[str, List[torch.Tensor]]:
        """Each split layer of row 0 → its parts' weights, one a position."""
        row = self.rows[0]
        if not isinstance(row, nn.Module):
            return {}
        return {name: [p.weight for p in m.parts] for name, m in row.named_modules()
                if isinstance(m, ColumnParallel)}


def parse_mesh_spec(spec: str) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """``"dp2tp4"`` → (("dp", "tp"), (2, 4)); raises ValueError on anything
    else."""
    import re

    pairs = re.findall(r"([a-z]+)(\d+)", spec)
    if not pairs or "".join(a + n for a, n in pairs) != spec:
        raise ValueError(f"bad mesh spec {spec!r} (want e.g. dp2tp4)")
    return tuple(a for a, _ in pairs), tuple(int(n) for _, n in pairs)
