"""Deterministic fake backends for tests and examples.

The counterpart of ``nnstreamer_tpu/backends/fakes.py`` (the reference's
custom_example_{passthrough,scaler,average,framecounter} stand-ins, used
where a real model is not the point). ``passthrough``, ``scaler`` and
``average`` are torch functions over device tensors, so they fuse into a
segment; ``hostscaler`` and ``framecounter`` run on the host, a fusion
barrier each. The reference's ``faulty`` fake belongs with the fault
machinery and is not ported yet.
"""

from __future__ import annotations

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

    def traceable_fn(self):
        return None


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
