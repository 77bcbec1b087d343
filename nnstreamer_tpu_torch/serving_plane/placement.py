"""Per-stage device placement under a per-device memory bound.

The counterpart of ``nnstreamer_tpu/serving_plane/placement.py`` (the
Hermes-style planner, PAPERS.md): a composite pipeline (detector ! crop !
classifier ...) can exceed one card's memory although every stage fits
alone, so each stage gets a device under the bound while adjacent stages
stay co-resident as long as they fit.

- :func:`plan_placement`: greedy chain packing. A stage stays on the
  current device while the bound holds and spills to the next device with
  room when it does not; explicit ``device=`` pins are hard constraints.
- :func:`place_pipeline`: estimates each ``tensor_filter`` stage
  (analysis/costmodel.py: its module's weights plus one set of
  activations, opening the backend the run will use), plans, and pins
  each stage that lands off device 0 (or is pinned already) through its
  backend's ``pin_device``: the hop into it is then a copy to its card.

The bound defaults to ``[plane] memory_per_device`` (bytes, K/M/G
suffixes). The devices are the pipeline's kind: ``cuda:0 ..``, or on the
CPU the ``[mesh] cpu_devices`` positions, each the one CPU device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from nnstreamer_tpu_torch.analysis.costmodel import (  # noqa: F401 — re-exported
    configured_device_bound,
    estimate_backend_bytes,
    estimate_stage_bytes,
    params_bytes,
    parse_bytes,
    spec_bytes,
)
from nnstreamer_tpu_torch.log import get_logger

_log = get_logger("serving_plane.placement")


class PlacementError(RuntimeError):
    """No placement satisfies the memory bound (a stage exceeds one
    device, or the devices are collectively full)."""


def plan_placement(
    costs: Sequence[int],
    per_device_bytes: int,
    n_devices: int,
    pinned: Optional[Dict[int, int]] = None,
) -> List[int]:
    """Assign each stage (chain order) a device index under the bound:
    stay on the current device while the stage fits, else move to the
    first device with room, scanning forward from the current one and
    wrapping. ``pinned`` maps stage index → device index as hard
    constraints. Raises :class:`PlacementError` when a stage fits
    nowhere."""
    if n_devices < 1:
        raise PlacementError("need at least one device")
    if per_device_bytes <= 0:
        raise PlacementError(
            f"per-device memory bound must be positive, got {per_device_bytes}")
    used = [0] * n_devices
    out: List[int] = []
    d = 0
    for i, cost in enumerate(costs):
        cost = int(cost)
        if cost > per_device_bytes:
            raise PlacementError(
                f"stage {i} needs {cost} bytes, over the per-device bound {per_device_bytes}")
        if pinned and i in pinned:
            d = int(pinned[i])
            if not 0 <= d < n_devices:
                raise PlacementError(f"stage {i} pinned to device {d}, have {n_devices}")
            if used[d] + cost > per_device_bytes:
                raise PlacementError(
                    f"stage {i} pinned to device {d} but only "
                    f"{per_device_bytes - used[d]} bytes remain there")
        elif used[d] + cost > per_device_bytes:
            for step in range(1, n_devices + 1):
                cand = (d + step) % n_devices
                if used[cand] + cost <= per_device_bytes:
                    d = cand
                    break
            else:
                raise PlacementError(
                    f"stage {i} ({cost} bytes) fits on no device "
                    f"(per-device bound {per_device_bytes}, used {used})")
        used[d] += cost
        out.append(d)
    return out


def _configured_bound() -> Optional[int]:
    return configured_device_bound()


def place_pipeline(
    pipeline: Any,
    per_device_bytes: Optional[int] = None,
    n_devices: Optional[int] = None,
) -> Dict[str, int]:
    """Plan and apply placement for a pipeline's tensor_filter stages →
    {element name: device index}. The bound defaults to ``[plane]
    memory_per_device``; ``n_devices`` (default: all of the pipeline's
    kind) is clamped to the devices there, as the reference clamps. A
    stage planned on device 0 and not pinned stays as it was (fusable);
    every other stage is pinned through its backend's ``pin_device``."""
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.parallel.mesh import available_devices

    if per_device_bytes is None:
        per_device_bytes = _configured_bound()
    if per_device_bytes is None:
        raise PlacementError(
            "no memory bound: pass per_device_bytes or set [plane] memory_per_device")
    have = len(available_devices(pipeline.device.type))
    if n_devices is None:
        n_devices = have
    n_devices = max(1, min(int(n_devices), have))
    stages = [e for e in pipeline._toposort() if isinstance(e, TensorFilter)]
    if not stages:
        return {}
    pinned: Dict[int, int] = {}
    for i, e in enumerate(stages):
        raw = e.get_property("device")
        if raw is not None and str(raw).strip() != "":
            pinned[i] = int(raw)
    costs = [estimate_stage_bytes(e) for e in stages]
    plan = plan_placement(costs, per_device_bytes, n_devices, pinned)
    out: Dict[str, int] = {}
    for e, d in zip(stages, plan):
        out[e.name] = d
        if d == 0 and e.get_property("device") is None:
            continue  # the default device, unpinned: the stage stays fusable
        e.set_property("device", d)
        pin = getattr(e.backend, "pin_device", None)
        if callable(pin):
            pin(d)
        else:
            _log.warning("%s: backend %s has no pin_device; placement on device %d is "
                         "advisory only", e.name, type(e.backend).__name__, d)
    _log.info("placement: %s under %d bytes/device over %d device(s)",
              out, per_device_bytes, n_devices)
    return out
