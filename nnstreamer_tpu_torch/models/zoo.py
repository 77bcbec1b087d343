"""Built-in model zoo: named (module, input spec) bundles for the native
backend (``model=zoo:<name>``).

The counterpart of ``nnstreamer_tpu/models/zoo.py`` for ``mobilenet_v2``
and ``add``. Options come from the filter's ``custom=`` string:

- mobilenet_v2: ``size``, ``num_classes``, ``width``, ``batch``,
  ``input_dtype``, ``seed`` (a ``torch.Generator`` seed — these random
  weights are NOT the JAX package's, whose generator differs) and
  ``params:<path.npz>`` (leaves ``p{i}`` in the reference's tree-flatten
  order: the way to run the JAX weights here);
- add: ``const``, ``dims``.

An unknown option raises: quietly ignoring, say, ``quantize:int8`` would
serve a different model than the one asked for.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch
from torch import nn

from nnstreamer_tpu_torch.device import DeviceLike, resolve_device
from nnstreamer_tpu_torch.models.mobilenet_v2 import (  # noqa: F401
    MobileNetV2,
    load_jax_npz,
    mobilenet_v2_from_jax,
)
from nnstreamer_tpu_torch.tensors.spec import DType, TensorSpec, TensorsSpec


@dataclass
class ZooModel:
    name: str
    module: nn.Module  # (*tensors) -> tensor | tuple, on ``device``
    input_spec: TensorsSpec
    device: torch.device


_FACTORIES: Dict[str, Callable[..., ZooModel]] = {}
_OPTIONS: Dict[str, tuple] = {}


def model_factory(name: str, options: tuple):
    def deco(fn):
        _FACTORIES[name] = fn
        _OPTIONS[name] = options
        return fn

    return deco


def get(name: str, device: DeviceLike = None, **options: str) -> ZooModel:
    """Build zoo model ``name`` on ``device`` (default ``cuda``; raises
    without a GPU unless ``device="cpu"``)."""
    if name not in _FACTORIES:
        raise KeyError(f"unknown zoo model {name!r}; known: {sorted(_FACTORIES)}")
    unknown = sorted(set(options) - set(_OPTIONS[name]))
    if unknown:
        raise ValueError(
            f"zoo:{name}: unsupported option(s) {unknown}; "
            f"this port takes {sorted(_OPTIONS[name])}"
        )
    dev = resolve_device(device)
    return _FACTORIES[name](dev, **options)


def available():
    return sorted(_FACTORIES)


class _Add(nn.Module):
    def __init__(self, const: float) -> None:
        super().__init__()
        self.const = const

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + torch.full((), self.const, dtype=x.dtype, device=x.device)


@model_factory("add", ("const", "dims"))
def _add(device: torch.device, **options) -> ZooModel:
    """y = x + const (the reference's add.tflite test model)."""
    const = float(options.get("const", 2.0))
    spec = TensorsSpec.of(
        TensorSpec.from_dim_string(options.get("dims", "1"), "float32")
    )
    return ZooModel("add", _Add(const).to(device), spec, device)


@model_factory(
    "mobilenet_v2",
    ("seed", "num_classes", "width", "batch", "size", "input_dtype", "params"),
)
def _mobilenet_v2(device: torch.device, **options) -> ZooModel:
    gen = torch.Generator().manual_seed(int(options.get("seed", 0)))
    model = MobileNetV2(
        num_classes=int(options.get("num_classes", 1001)),
        width=float(options.get("width", 1.0)),
        generator=gen,
    )
    if options.get("params"):
        load_jax_npz(model, options["params"])
    model = model.eval().to(device=device, memory_format=torch.channels_last)
    batch = int(options.get("batch", 1))
    size = int(options.get("size", 224))
    spec = TensorsSpec.of(TensorSpec(
        (batch, size, size, 3),
        DType.from_any(options.get("input_dtype", "uint8")),
        name="image",
    ))
    return ZooModel("mobilenet_v2", model, spec, device)
