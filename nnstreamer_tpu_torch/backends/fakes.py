"""Deterministic fake backends for tests and examples.

The counterpart of ``nnstreamer_tpu/backends/fakes.py`` (the reference's
custom_example_{passthrough,scaler,average,framecounter} stand-ins, used
where a real model is not the point). ``passthrough``, ``scaler`` and
``average`` are torch functions over device tensors, so they fuse into a
segment; ``hostscaler`` and ``framecounter`` run on the host, a fusion
barrier each. ``faulty`` is the chaos injector that drives the fault
machinery (pipeline/faults.py, pipeline/device_faults.py) end to end.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.backends.base import Backend, BackendError, FilterProps, host_invoke
from nnstreamer_tpu_torch.tensors.spec import DType, TensorSpec, TensorsSpec


class _SameSpec(Backend):
    """A fake whose output spec is its input spec, known once set."""

    def open(self, props: FilterProps) -> None:
        self.props = props
        self._spec = props.input_spec

    def get_model_info(self) -> Tuple[TensorsSpec, TensorsSpec]:
        if self._spec is None:
            raise BackendError(f"{self.name}: input spec unknown until set")
        return self._spec, self._spec

    def set_input_info(self, in_spec: TensorsSpec) -> TensorsSpec:
        self._spec = in_spec
        return in_spec

    def invoke(self, tensors):
        return self.traceable_fn()(tensors)


@registry.filter_backend("passthrough")
class PassthroughBackend(_SameSpec):
    """Identity filter (custom_example_passthrough)."""

    name = "passthrough"
    IS_IDENTITY = True

    def traceable_fn(self) -> Callable:
        return lambda tensors: tuple(tensors)


@registry.filter_backend("scaler")
class ScalerBackend(_SameSpec):
    """Multiply by a constant (custom_example_scaler), custom="factor:2.0".
    The factor is cast to each tensor's dtype first, as the reference
    does: factor 0.5 on uint8 multiplies by 0."""

    name = "scaler"

    def open(self, props: FilterProps) -> None:
        super().open(props)
        self._factor = float(props.custom_dict().get("factor", "2.0"))

    def traceable_fn(self) -> Callable:
        f = self._factor
        return lambda tensors: tuple(
            t * torch.full((), f, dtype=t.dtype, device=t.device) for t in tensors
        )


@registry.filter_backend("average")
class AverageBackend(Backend):
    """Spatial average per tensor (custom_example_average): NHWC → N11C,
    the mean taken in float32 and cast back to the tensor's dtype."""

    name = "average"

    def open(self, props: FilterProps) -> None:
        self.props = props
        self._in_spec = props.input_spec
        self._out_spec = self._derive_out(self._in_spec) if self._in_spec else None

    @staticmethod
    def _derive_out(in_spec: TensorsSpec) -> TensorsSpec:
        outs = []
        for t in in_spec:
            if t.rank < 3:
                raise BackendError(f"average: rank>=3 required, got {t}")
            shape = list(t.shape)
            shape[-3] = 1
            shape[-2] = 1
            outs.append(TensorSpec(tuple(shape), t.dtype))
        return TensorsSpec(tuple(outs), in_spec.format, in_spec.rate)

    def get_model_info(self) -> Tuple[TensorsSpec, TensorsSpec]:
        if self._in_spec is None:
            raise BackendError("average: input spec unknown until set")
        return self._in_spec, self._out_spec

    def set_input_info(self, in_spec: TensorsSpec) -> TensorsSpec:
        self._in_spec = in_spec
        self._out_spec = self._derive_out(in_spec)
        return self._out_spec

    def invoke(self, tensors):
        return self.traceable_fn()(tensors)

    def traceable_fn(self) -> Callable:
        return lambda tensors: tuple(
            t.to(torch.float32).mean(dim=(-3, -2), keepdim=True).to(t.dtype) for t in tensors
        )


def _scale_host(a: np.ndarray, factor: float) -> np.ndarray:
    return (a * factor).astype(a.dtype)


@registry.filter_backend("hostscaler")
class HostScalerBackend(_SameSpec):
    """Host-bound scaler (numpy, a fusion barrier) with a batched entry:
    :meth:`invoke_batched` stacks a window of frames and multiplies once
    (the stand-in for an engine with a real batched entry point)."""

    name = "hostscaler"
    batchable = True

    def open(self, props: FilterProps) -> None:
        super().open(props)
        self._factor = float(props.custom_dict().get("factor", "2.0"))
        self.batched_calls = 0

    def invoke(self, tensors):
        f = self._factor
        return host_invoke(lambda ts: [_scale_host(t, f) for t in ts], tensors,
                           self.props.device)

    def invoke_batched(self, batch: Sequence[Tuple[Any, ...]]) -> List[Tuple[Any, ...]]:
        self.batched_calls += 1
        f = self._factor
        stacked = tuple(torch.stack([ts[i] for ts in batch]) for i in range(len(batch[0])))
        cols = host_invoke(lambda cs: [_scale_host(c, f) for c in cs], stacked, self.props.device)
        return [tuple(col[j] for col in cols) for j in range(len(batch))]


@registry.filter_backend("framecounter")
class FrameCounterBackend(Backend):
    """Emits a running uint32 frame count (custom_example_framecounter):
    stateful, so host-bound."""

    name = "framecounter"

    def open(self, props: FilterProps) -> None:
        self.props = props
        self._count = 0
        self._in_spec = props.input_spec

    def get_model_info(self) -> Tuple[TensorsSpec, TensorsSpec]:
        out = TensorsSpec.of(TensorSpec((1,), DType.UINT32))
        return (self._in_spec or TensorsSpec()), out

    def set_input_info(self, in_spec: TensorsSpec) -> TensorsSpec:
        self._in_spec = in_spec
        return self.get_model_info()[1]

    def invoke(self, tensors):
        out = np.array([self._count], dtype=np.uint32)
        self._count += 1
        return (out,)

    def state_snapshot(self) -> dict:
        return {"count": self._count}

    def state_restore(self, snap: dict) -> None:
        self._count = int(snap.get("count", 0))


@registry.filter_backend("faulty")
class FaultyBackend(_SameSpec):
    """A deterministic flaky engine: a passthrough that fails on cue, to
    drive the executor's error policies and device resilience. Options
    (``custom=``):

    - ``fail_rate:0.2`` (seeded), ``fail_every_n:5``, ``fail_first_n:3``:
      an invoke raises ``raise_type`` (``backend`` | ``value`` | ``runtime``);
    - ``latency_spike_ms:50`` with ``spike_every_n:10``: periodic stalls;
    - ``strict_shapes:true``: an invoke checks its tensors against the
      opened spec (so ``tensor_chaos``-corrupted frames raise here);
    - ``batchable:true``: declares micro-batching; ``invoke_batched`` chains
      ``invoke``, so one poisoned frame fails its whole window;
    - ``seed:7``: the RNG seed (default 0);
    - ``oom_every_n:5``: every Nth invoke raises DeviceOOMError;
    - ``oom_above_rows:2``: a dispatch wider than N rows raises
      DeviceOOMError, in ``invoke_batched`` by window length and through
      :meth:`device_probe`, which ``FusedSegment.process_batch`` calls with
      the padded bucket before its program runs;
    - ``compile_fail:true`` (with ``traceable:true``): the fn raises
      DeviceCompileError inside a program build (pipeline/programs.py
      ``current_build``: a CUDA graph's warm-up and capture on the card, a
      program call where programs are the fn itself, on the CPU) and passes
      tensors through on the eager path. ``compile_fail_first_n:K`` bounds
      the outage to the first K builds, counted one a build (the reference
      counts jax traces);
    - ``device_lost_at:7``: invoke N and every later one raise
      DeviceLostError; ``device_lost_for:M`` bounds the outage to M invokes;
      ``only_replica:<i>`` keeps the device modes to the replica opened with
      ``_replica:<i>`` (the filter's and the plane's replicas append it);
    - ``traceable:true``: expose the fn over device tensors, so the filter
      fuses.
    """

    name = "faulty"

    _RAISES = {"backend": BackendError, "value": ValueError, "runtime": RuntimeError}

    def open(self, props: FilterProps) -> None:
        import random

        from nnstreamer_tpu_torch.elements.base import parse_bool

        super().open(props)
        opts = props.custom_dict()
        self._fail_rate = float(opts.get("fail_rate", "0"))
        self._fail_every_n = int(opts.get("fail_every_n", "0"))
        self._fail_first_n = int(opts.get("fail_first_n", "0"))
        self._spike_ms = float(opts.get("latency_spike_ms", "0"))
        self._spike_every_n = int(opts.get("spike_every_n", "0"))
        self._strict = parse_bool(opts.get("strict_shapes", "false"))
        self.batchable = parse_bool(opts.get("batchable", "false"))
        self._exc = self._RAISES.get(opts.get("raise_type", "backend").lower(), BackendError)
        self._rng = random.Random(int(opts.get("seed", "0")))
        self._oom_every_n = int(opts.get("oom_every_n", "0"))
        self._oom_above_rows = int(opts.get("oom_above_rows", "0"))
        self._compile_fail = parse_bool(opts.get("compile_fail", "false"))
        self._compile_fail_first_n = int(opts.get("compile_fail_first_n", "0"))
        self._device_lost_at = int(opts.get("device_lost_at", "0"))
        self._device_lost_for = int(opts.get("device_lost_for", "0"))
        self._traceable = parse_bool(opts.get("traceable", "false"))
        self._replica_idx = opts.get("_replica")
        only = opts.get("only_replica")
        self._inject = only is None or (
            self._replica_idx is not None and int(only) == int(self._replica_idx))
        self.invokes = 0
        self.traces = 0  # program builds the fn was part of
        self._build_seen = None

    def _maybe_fail(self) -> None:
        n = self.invokes
        if ((self._fail_first_n and n <= self._fail_first_n)
                or (self._fail_every_n and n % self._fail_every_n == 0)
                or (self._fail_rate and self._rng.random() < self._fail_rate)):
            raise self._exc(f"faulty: injected failure on invoke {n}")

    def _maybe_device_fail(self) -> None:
        if not self._inject:
            return
        from nnstreamer_tpu_torch.pipeline.device_faults import DeviceLostError, DeviceOOMError

        n = self.invokes
        if self._device_lost_at and n >= self._device_lost_at and (
                not self._device_lost_for or n < self._device_lost_at + self._device_lost_for):
            raise DeviceLostError(f"faulty: device lost at invoke {n}")
        if self._oom_every_n and n % self._oom_every_n == 0:
            raise DeviceOOMError(f"faulty: out of memory on invoke {n}")

    def device_probe(self, rows: int) -> None:
        """The device's capacity boundary for a batched dispatch: a bucket
        wider than ``oom_above_rows`` OOMs before its program runs, as a real
        allocation of the stacked window would."""
        from nnstreamer_tpu_torch.pipeline.device_faults import DeviceOOMError

        if self._inject and self._oom_above_rows and rows > self._oom_above_rows:
            raise DeviceOOMError(f"faulty: out of memory allocating {rows} rows "
                                 f"(fits {self._oom_above_rows})")

    def invoke(self, tensors):
        self.invokes += 1
        if self._spike_every_n and self.invokes % self._spike_every_n == 0:
            time.sleep(self._spike_ms / 1000.0)
        if self._strict and self._spec is not None:
            for t, ts in zip(tensors, self._spec):
                if tuple(t.shape) != tuple(ts.shape):
                    raise self._exc(f"faulty: corrupted frame — tensor shape "
                                    f"{tuple(t.shape)} != spec {ts.shape}")
        self._maybe_device_fail()
        self._maybe_fail()
        return tuple(tensors)

    def invoke_batched(self, batch):
        self.device_probe(len(batch))
        return super().invoke_batched(batch)

    def traceable_fn(self):
        """The identity over device tensors when ``traceable:true``; with
        ``compile_fail`` it raises DeviceCompileError inside a program build
        and passes tensors through on the eager path, the device circuit's
        scenario."""
        if not self._traceable:
            return None
        from nnstreamer_tpu_torch.pipeline.programs import current_build

        def fn(tensors):
            build = current_build()
            if build is not None and build != self._build_seen:
                self._build_seen = build
                self.traces += 1
                if self._inject and self._compile_fail and (
                        not self._compile_fail_first_n
                        or self.traces <= self._compile_fail_first_n):
                    from nnstreamer_tpu_torch.pipeline.device_faults import DeviceCompileError

                    raise DeviceCompileError(
                        f"faulty: injected build failure (build {self.traces})")
            return tuple(tensors)

        return fn
