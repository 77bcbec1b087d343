"""tensor_chaos: fault injection for pipelines under test.

The counterpart of ``nnstreamer_tpu/elements/chaos.py``. A passthrough
that injects RUNTIME faults into a live stream, so the fault layer
(pipeline/faults.py, pipeline/device_faults.py) can be driven end to end:
frame corruption (shape-truncated tensors a strict downstream backend
rejects), latency spikes, one bounded hang (stall-watchdog food), raised
exceptions (which this element's own ``on-error``, or the default stop,
handles) and typed device faults. Deterministic by construction (``seed``
and counters), so chaos runs reproduce.
"""

from __future__ import annotations

import random
import time
from typing import List, Union

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import (
    FAULT_PROPS,
    ElementError,
    HostElement,
    PropSpec,
    Spec,
    install_error_pad,
)
from nnstreamer_tpu_torch.tensors.frame import Frame

_RAISES = {
    "element": ElementError,
    "value": ValueError,
    "runtime": RuntimeError,
}


@registry.element("tensor_chaos")
class TensorChaos(HostElement):
    """Passthrough chaos injector.

    Props: ``fail-rate`` (probability an input raises), ``fail-every-n``
    (every Nth frame raises), ``corrupt-every-n`` (every Nth frame's
    tensors are shape-truncated and tagged ``chaos_corrupted`` meta),
    ``delay-ms``/``delay-every-n`` (latency injection), ``hang-on-frame``/
    ``hang-ms`` (one bounded hang, for stall-watchdog tests),
    ``raise-type`` (element|value|runtime), ``device-fault-kind``/
    ``device-fault-every-n`` (typed device-plane faults for the
    resilience layer), ``seed``. Combine with
    ``on-error`` to exercise this element's own policy, or place it
    upstream of a strict backend (``framework=faulty
    custom=strict_shapes:true``) to drive the downstream policy."""

    FACTORY_NAME = "tensor_chaos"
    PROPERTIES = {
        "fail-rate": PropSpec(
            "float", 0.0, desc="probability an input frame raises"
        ),
        "fail-every-n": PropSpec(
            "int", 0, desc="every Nth frame raises (0 = never)"
        ),
        "corrupt-every-n": PropSpec(
            "int", 0, desc="every Nth frame emits shape-truncated tensors"
        ),
        "delay-ms": PropSpec("float", 0.0, desc="injected per-frame delay"),
        "delay-every-n": PropSpec(
            "int", 1, desc="apply delay-ms every Nth frame"
        ),
        "hang-on-frame": PropSpec(
            "int", 0, desc="frame number that hangs once (0 = never)"
        ),
        "hang-ms": PropSpec(
            "float", 0.0, desc="bounded hang duration for hang-on-frame"
        ),
        "raise-type": PropSpec(
            "enum", "element", ("element", "value", "runtime"),
            desc="exception class injected failures raise",
        ),
        # device-plane chaos (pipeline/device_faults.py): raise a TYPED
        # device fault so the resilience layer — classifier, replica
        # failover, NACK/release accounting — is drivable from any
        # pipeline position without a faulty backend
        "device-fault-kind": PropSpec(
            "enum", "", ("", "oom", "compile", "device_lost", "transient"),
            desc="device fault class device-fault-every-n injects",
        ),
        "device-fault-every-n": PropSpec(
            "int", 0,
            desc="every Nth frame raises the typed device fault (0 = never)",
        ),
        "seed": PropSpec("int", 0, desc="RNG seed (reproducible chaos)"),
        **FAULT_PROPS,
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.fail_rate = float(self.get_property("fail-rate", 0.0))
        self.fail_every_n = int(self.get_property("fail-every-n", 0))
        self.corrupt_every_n = int(self.get_property("corrupt-every-n", 0))
        self.delay_ms = float(self.get_property("delay-ms", 0.0))
        self.delay_every_n = max(1, int(self.get_property("delay-every-n", 1)))
        self.hang_on_frame = int(self.get_property("hang-on-frame", 0))
        self.hang_ms = float(self.get_property("hang-ms", 0.0))
        raise_type = str(self.get_property("raise-type", "element")).lower()
        if raise_type not in _RAISES:
            raise ValueError(
                f"{self.name}: raise-type={raise_type!r} not one of "
                f"{'/'.join(_RAISES)}"
            )
        self._exc = _RAISES[raise_type]
        self.device_fault_kind = str(
            self.get_property("device-fault-kind", "") or ""
        ).lower()
        self.device_fault_every_n = int(
            self.get_property("device-fault-every-n", 0)
        )
        if self.device_fault_every_n and not self.device_fault_kind:
            raise ValueError(
                f"{self.name}: device-fault-every-n needs device-fault-kind"
            )
        self._rng = random.Random(int(self.get_property("seed", 0)))
        self._n = 0
        self._hung = False
        install_error_pad(self)

    def _device_exc(self):
        from nnstreamer_tpu_torch.pipeline import device_faults as df

        return {
            "oom": df.DeviceOOMError,
            "compile": df.DeviceCompileError,
            "device_lost": df.DeviceLostError,
            "transient": df.DeviceFaultError,
        }[self.device_fault_kind]

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        (spec,) = in_specs
        return [spec]

    def process(self, frame: Frame) -> Union[Frame, None]:
        self._n += 1
        n = self._n
        if (
            not self._hung
            and self.hang_on_frame
            and n == self.hang_on_frame
            and self.hang_ms > 0
        ):
            # BOUNDED hang (sliced sleep): long enough for the stall
            # watchdog to fire, short enough that teardown's thread
            # joins still succeed
            self._hung = True
            deadline = time.monotonic() + self.hang_ms / 1000.0
            while time.monotonic() < deadline:
                time.sleep(0.025)
        if self.delay_ms > 0 and n % self.delay_every_n == 0:
            time.sleep(self.delay_ms / 1000.0)
        if self.device_fault_every_n and n % self.device_fault_every_n == 0:
            raise self._device_exc()(
                f"{self.name}: injected {self.device_fault_kind} device "
                f"fault on frame {n}"
            )
        if self.fail_every_n and n % self.fail_every_n == 0:
            raise self._exc(f"{self.name}: injected failure on frame {n}")
        if self.fail_rate and self._rng.random() < self.fail_rate:
            raise self._exc(f"{self.name}: injected random failure (frame {n})")
        if self.corrupt_every_n and n % self.corrupt_every_n == 0:
            # shape truncation: flatten and drop the last element (numpy
            # or torch, where the tensor lies) — a strict consumer (faulty
            # strict_shapes) rejects it, a dead-letter consumer sees what
            # arrived
            corrupted = [t.reshape(-1)[:-1] for t in frame.tensors]
            return frame.with_tensors(corrupted).with_meta(
                chaos_corrupted=True
            )
        return frame
