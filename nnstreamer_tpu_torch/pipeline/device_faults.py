"""Device-plane resilience: classify backend faults, degrade, recover.

The counterpart of ``nnstreamer_tpu/pipeline/device_faults.py``:

- :func:`classify_device_fault` buckets an exception into
  ``oom | compile | device_lost | transient``, or None for an ordinary
  element error (those stay with pipeline/faults.py's per-frame policies).
  The typed :class:`DeviceFaultError` family classifies by kind (the chaos
  injectors raise these). Where the reference sniffs XLA's status messages,
  the port reads torch's CUDA errors instead (see the function).
- :class:`BucketGovernor` is the OOM ladder: on OOM the batch bucket drops
  one rung and the segment remembers the safe ceiling; after a cooldown it
  re-probes one rung up. Every ceiling is a rung of the segment's bucket
  ladder, so each is one captured graph.
- :class:`DeviceCircuit` is the breaker around a segment's CUDA graphs: a
  failed build or capture (deterministic: rebuilding per frame would fail
  forever) opens it at once, other device faults after ``after`` in a row.
  While open the segment runs its ops eagerly on the same device
  (``FusedSegment.process_eager``: the same hand-written kernels, launched
  one by one, never their plain versions), counted in ``eager_invokes``,
  and every ``probe_every`` frames one probe builds and replays the graph
  again; a probe that succeeds closes it.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence, Tuple

from nnstreamer_tpu_torch.log import get_logger

_log = get_logger("device_faults")


class DeviceFaultError(RuntimeError):
    """A typed device-plane fault (base). The chaos injectors
    (backends/fakes.py ``faulty``, elements/chaos.py ``tensor_chaos``) raise
    these, so every degradation path is deterministically testable."""

    kind = "transient"


class DeviceOOMError(DeviceFaultError):
    """Device memory exhausted."""

    kind = "oom"


class DeviceCompileError(DeviceFaultError):
    """A program could not be built: its CUDA-graph capture failed."""

    kind = "compile"


class DeviceLostError(DeviceFaultError):
    """The device went away (a reset, a sticky CUDA error)."""

    kind = "device_lost"


class ReplicaExhaustedError(RuntimeError):
    """Every replica of a ReplicaSet is unhealthy (parallel/replicas.py);
    the last underlying device fault is its ``__cause__``."""


# torch's CUDA error texts, checked in order. A capture that fails is a
# program that cannot be built; the sticky errors leave the CUDA context
# unusable, so they are a lost device; any other CUDA runtime error is
# transient. No XLA marker is kept here: "failed to compile" in nvcc's
# output (a kernel that does not build) must stay an ordinary error.
_CAPTURE_MARKERS = (
    "operation not permitted when stream is capturing",
    "cudaerrorstreamcapture",
    "stream capture",
)
_STICKY_MARKERS = (
    "an illegal memory access",
    "unspecified launch failure",
    "device-side assert",
    "ecc",
)
_CUDA_MARKERS = ("CUDA error", "CUDA driver error", "CUBLAS_STATUS", "cuDNN error",
                 "CUDNN_STATUS")


def classify_device_fault(exc: BaseException) -> Optional[str]:
    """``oom | compile | device_lost | transient`` for a device-plane fault,
    None for an ordinary element error.

    - a :class:`DeviceFaultError` → its ``kind``;
    - ``torch.OutOfMemoryError`` (``torch.cuda.OutOfMemoryError``) → oom;
    - a CUDA error raised while a stream captures → compile;
    - ``torch.AcceleratorError``, or a CUDA error naming an illegal memory
      access, an unspecified launch failure, a device-side assert or an ECC
      error → device_lost (sticky: the context is unusable afterwards);
    - any other CUDA runtime error → transient;
    - anything else (bad input, user code, a kernel's nvcc build failure) →
      None."""
    if isinstance(exc, DeviceFaultError):
        return exc.kind
    import torch

    if isinstance(exc, torch.OutOfMemoryError):
        return "oom"
    if not isinstance(exc, RuntimeError):
        return None
    msg = str(exc)
    low = msg.lower()
    accel = isinstance(exc, getattr(torch, "AcceleratorError", ()))
    cuda = accel or any(m in msg for m in _CUDA_MARKERS)
    if not cuda:
        return None
    if any(m in low for m in _CAPTURE_MARKERS):
        return "compile"
    if accel or any(m in low for m in _STICKY_MARKERS):
        return "device_lost"
    return "transient"


def _executor_device_defaults() -> dict:
    """``[executor]`` device-resilience defaults (env ``NNS_TPU_EXECUTOR_*``
    outranks the ini). A malformed value falls back with a warning."""
    from nnstreamer_tpu_torch.config import conf

    c = conf()

    def _num(key: str, cast, fallback):
        raw = c.get("executor", key, str(fallback))
        try:
            return cast(raw)
        except ValueError:
            _log.warning("[executor] %s=%r is not a valid %s; using %s",
                         key, raw, cast.__name__, fallback)
            return fallback

    oom_policy = c.get("executor", "oom_policy", "degrade").strip().lower()
    if oom_policy not in ("degrade", "stop"):
        _log.warning("[executor] oom_policy=%r not one of degrade/stop; using 'degrade'",
                     oom_policy)
        oom_policy = "degrade"
    return {
        "oom-policy": oom_policy,
        "device-fallback": c.get_bool("executor", "device_fallback", True),
        "device-fallback-after": _num("device_fallback_after", int, 3),
        "device-probe-every": _num("device_probe_every", int, 64),
        "oom-reprobe-ms": _num("oom_reprobe_ms", float, 30000.0),
    }


def resolve_device_policy(elements: Sequence[Any]) -> Dict[str, Any]:
    """Element ``oom-policy`` / ``device-fallback`` over the ``[executor]``
    defaults: a chain-order scan, the first element that sets a knob wins."""
    from nnstreamer_tpu_torch.elements.base import parse_bool

    defaults = _executor_device_defaults()
    oom_policy: Optional[str] = None
    fallback: Optional[bool] = None
    for e in elements:
        get = getattr(e, "get_property", None)
        if get is None:
            continue
        if oom_policy is None and get("oom-policy") is not None:
            raw = str(get("oom-policy")).strip().lower()
            if raw not in ("degrade", "stop"):
                raise ValueError(
                    f"{getattr(e, 'name', e)}: oom-policy={raw!r} not one of degrade/stop")
            oom_policy = raw
        if fallback is None and get("device-fallback") is not None:
            fallback = parse_bool(get("device-fallback"))
    return {
        "oom-policy": oom_policy or defaults["oom-policy"],
        "device-fallback": defaults["device-fallback"] if fallback is None else fallback,
        "device-fallback-after": max(1, defaults["device-fallback-after"]),
        "device-probe-every": max(1, defaults["device-probe-every"]),
        "oom-reprobe-ms": max(0.0, defaults["oom-reprobe-ms"]),
    }


class BucketGovernor:
    """A segment's safe batch ceiling under OOM (the node's thread is the
    only writer).

    ``cap()`` is the window limit the collector and the chunking honour. On
    OOM, ``on_oom(attempted)`` drops the ceiling to the rung below the
    attempted bucket (None when already at the smallest: nothing left to
    shrink) and stamps a cooldown; once it elapses ``cap()`` offers ONE rung
    above as a probe, which ``on_ok`` confirms or ``on_oom`` pushes out."""

    __slots__ = ("ladder", "ceiling", "cooldown_s", "ooms", "reprobes", "_probe_at", "_clock")

    def __init__(self, ladder: Sequence[int], cooldown_s: float = 30.0,
                 clock=time.monotonic) -> None:
        self.ladder: Tuple[int, ...] = tuple(sorted(set(int(b) for b in ladder))) or (1,)
        self.ceiling = self.ladder[-1]
        self.cooldown_s = cooldown_s
        self.ooms = 0
        self.reprobes = 0
        self._probe_at: Optional[float] = None
        self._clock = clock

    @property
    def degraded(self) -> bool:
        return self.ceiling < self.ladder[-1]

    def _stamp_cooldown(self) -> Optional[float]:
        """A cooldown <= 0 means never re-probe: offering the probe rung on
        every cap() would livelock a width that always OOMs."""
        if self.cooldown_s <= 0:
            return None
        return self._clock() + self.cooldown_s

    def cap(self) -> int:
        """The ceiling, or one rung above it once the cooldown elapsed."""
        if self.degraded and self._probe_at is not None and self._clock() >= self._probe_at:
            i = self.ladder.index(self.ceiling)
            return self.ladder[min(i + 1, len(self.ladder) - 1)]
        return self.ceiling

    def on_ok(self, bucket: int) -> bool:
        """A dispatch of ``bucket`` rows succeeded; True when it confirmed
        an upward probe. A host path dispatches any width, so the width
        snaps down to its rung: the ceiling always stays a rung."""
        below = [b for b in self.ladder if b <= bucket]
        rung = below[-1] if below else self.ladder[0]
        if rung > self.ceiling:
            self.ceiling = rung
            self.reprobes += 1
            _log.warning("OOM ceiling re-probed up to %d%s", rung,
                         "" if self.degraded else " (fully recovered)")
            self._probe_at = self._stamp_cooldown() if self.degraded else None
            return True
        return False

    def on_oom(self, attempted: int) -> Optional[int]:
        """Shrink below ``attempted``: the new ceiling, or None when it was
        already the smallest bucket (then the OOM is like any other device
        fault)."""
        self.ooms += 1
        below = [b for b in self.ladder if b < max(1, int(attempted))]
        self._probe_at = self._stamp_cooldown()
        if not below:
            return None
        if below[-1] < self.ceiling or attempted > self.ceiling:
            self.ceiling = min(self.ceiling, below[-1])
        return below[-1]

    def snapshot(self) -> dict:
        return {"ceiling": self.ceiling, "max": self.ladder[-1], "ooms": self.ooms,
                "reprobes": self.reprobes}

    def restore(self, snap: dict) -> None:
        """Re-arm a remembered ceiling (and its cooldown), so a restarted
        pipeline does not find the OOM boundary again by OOMing."""
        ceiling = int(snap.get("ceiling", self.ladder[-1]))
        below = [b for b in self.ladder if b <= ceiling]
        self.ceiling = below[-1] if below else self.ladder[0]
        self.ooms = int(snap.get("ooms", 0))
        self.reprobes = int(snap.get("reprobes", 0))
        if self.degraded:
            self._probe_at = self._stamp_cooldown()


class DeviceCircuit:
    """The breaker around one node's CUDA graphs.

    ``record_fault(kind)`` returns True when the caller should serve the
    frame from the eager path: at once for ``compile``, after ``after``
    consecutive device faults otherwise. While open, ``should_probe()`` is
    True every ``probe_every`` eager frames, and a probe that succeeds
    ``close()``s the circuit."""

    __slots__ = ("after", "probe_every", "open", "kinds", "_consec", "_since_probe",
                 "opens", "closes", "eager_invokes", "faults")

    def __init__(self, after: int = 3, probe_every: int = 64) -> None:
        self.after = max(1, int(after))
        self.probe_every = max(1, int(probe_every))
        self.open = False
        self.faults = 0
        self.kinds: Dict[str, int] = {}
        self.opens = 0
        self.closes = 0
        self.eager_invokes = 0  # frames served on the eager path
        self._consec = 0
        self._since_probe = 0

    def record_fault(self, kind: str) -> bool:
        self.faults += 1
        self.kinds[kind] = self.kinds.get(kind, 0) + 1
        self._consec += 1
        if self.open:
            return True
        if kind == "compile" or self._consec >= self.after:
            self.open = True
            self.opens += 1
            self._since_probe = 0
            _log.warning("device circuit OPEN after %d fault(s) (last: %s); running the "
                         "segment's ops eagerly on the device", self._consec, kind)
            return True
        return False

    def record_ok(self) -> None:
        self._consec = 0

    def should_probe(self) -> bool:
        """Called once per eager frame; True on the probe beat."""
        self._since_probe += 1
        if self._since_probe >= self.probe_every:
            self._since_probe = 0
            return True
        return False

    def close(self) -> None:
        if self.open:
            self.open = False
            self.closes += 1
            _log.warning("device circuit closed: the segment's graphs replay again")
        self._consec = 0

    def snapshot(self) -> dict:
        return {"open": self.open, "faults": self.faults, "kinds": dict(self.kinds),
                "opens": self.opens, "closes": self.closes,
                "eager_invokes": self.eager_invokes}

    def restore(self, snap: dict) -> None:
        self.open = bool(snap.get("open", False))
        self.faults = int(snap.get("faults", 0))
        self.kinds = {str(k): int(v) for k, v in (snap.get("kinds") or {}).items()}
        self.opens = int(snap.get("opens", 0))
        self.closes = int(snap.get("closes", 0))
        self.eager_invokes = int(snap.get("eager_invokes", 0))
        self._consec = 0
        self._since_probe = 0
