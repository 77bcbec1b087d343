"""Static byte estimates for per-stage placement.

The part of ``nnstreamer_tpu/analysis/costmodel.py`` that the placement
planner (serving_plane/placement.py) imports: :func:`parse_bytes`,
:func:`params_bytes`, :func:`spec_bytes`, :func:`estimate_backend_bytes`,
:func:`estimate_stage_bytes` and :func:`configured_device_bound`. A
stage's resident bytes are its weights (a torch module's parameters and
buffers) plus one in-flight set of input and output activations, by
arithmetic over the negotiated specs: nothing is allocated. The transfer
prediction and ``chain_cost`` come with ROADMAP A.9.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from nnstreamer_tpu_torch.log import get_logger

_log = get_logger("analysis.costmodel")


def parse_bytes(raw: str) -> int:
    """``"256M"`` → 268435456 (K/M/G binary suffixes; plain ints pass
    through)."""
    s = str(raw).strip()
    if not s:
        raise ValueError("empty byte size")
    mult = 1
    suffix = s[-1].upper()
    if suffix in ("K", "M", "G"):
        mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}[suffix]
        s = s[:-1]
    return int(float(s) * mult)


def _leaves(tree: Any):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def params_bytes(tree: Any) -> int:
    """Total bytes of a model's weights: a torch module's parameters and
    buffers, or the tensors and arrays of a nested dict / list."""
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif getattr(leaf, "shape", None) is not None:
            dtype = np.dtype(getattr(leaf, "dtype", np.float32))
            total += int(np.prod(leaf.shape, dtype=np.int64)) * dtype.itemsize
    return total


_VIDEO_CHANNELS = {"RGB": 3, "BGR": 3, "RGBA": 4, "BGRA": 4, "GRAY8": 1}


def spec_bytes(spec: Any) -> int:
    """Activation bytes of a TensorsSpec (0 for flexible/None specs). A
    video MediaSpec (a source feeding tensor_converter) is width x height x
    channels."""
    if spec is None:
        return 0
    if getattr(spec, "media_type", None) == "video":
        w = getattr(spec, "width", None)
        h = getattr(spec, "height", None)
        if not w or not h:
            return 0
        return int(w) * int(h) * _VIDEO_CHANNELS.get(getattr(spec, "format", "RGB"), 3)
    if not getattr(spec, "is_static", False):
        return 0
    return sum(int(np.prod(t.shape, dtype=np.int64)) * np.dtype(t.dtype.np_dtype).itemsize
               for t in spec)


def estimate_backend_bytes(backend: Any) -> int:
    """Resident bytes an opened backend will hold on its device: its
    module's weights plus one in-flight set of input/output activations."""
    total = params_bytes(getattr(backend, "module", None))
    try:
        in_spec, out_spec = backend.get_model_info()
    except Exception:  # noqa: BLE001 — shape-polymorphic: activations unknown
        return total
    return total + spec_bytes(in_spec) + spec_bytes(out_spec)


def estimate_stage_bytes(elem: Any) -> int:
    """Per-stage estimate for a tensor_filter element (opens the backend it
    will serve with anyway: no throwaway copy)."""
    return estimate_backend_bytes(elem._ensure_open())


def configured_device_bound() -> Optional[int]:
    """The per-device memory bound of the placement planner: ``[plane]
    memory_per_device`` (bytes, K/M/G suffixes). None: no bound declared."""
    from nnstreamer_tpu_torch.config import conf

    raw = conf().get("plane", "memory_per_device", "")
    if not raw:
        return None
    try:
        return parse_bytes(raw)
    except ValueError:
        _log.warning("[plane] memory_per_device=%r is not a byte size; no bound", raw)
        return None
