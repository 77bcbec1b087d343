"""The native backend: models as ``nn.Module``s on the pipeline's device.

The counterpart of ``nnstreamer_tpu/backends/jax_backend.py``: registered
as ``torch``, and also as ``jax`` so the reference's pipeline strings (its
golden pipelines included) run unchanged. Model sources (``model=``):
``zoo:<name>`` from the port's zoo (models/zoo.py), options in the
``custom=`` string (``custom="size:224,num_classes:1001,params:w.npz"``).

The module's function is handed to the fused segment whole
(:meth:`traceable_fn`); convolutions run in cuDNN.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.backends.base import Backend, BackendError, FilterProps
from nnstreamer_tpu_torch.tensors.spec import DType, TensorSpec, TensorsSpec


def _as_tuple(x) -> Tuple[Any, ...]:
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return (x,)


@registry.filter_backend("torch", "jax")
class TorchBackend(Backend):
    """framework=torch (alias jax): ``zoo:`` models on the given device."""

    name = "torch"

    def __init__(self) -> None:
        super().__init__()
        self.module: Optional[torch.nn.Module] = None
        self._in_spec: Optional[TensorsSpec] = None
        self._out_spec: Optional[TensorsSpec] = None

    def open(self, props: FilterProps) -> None:
        self.props = props
        path = props.model_path
        if not path.startswith("zoo:"):
            raise BackendError(
                f"torch: unsupported model source {path!r} (the port loads "
                "zoo:<name> models)"
            )
        from nnstreamer_tpu_torch.models import zoo

        try:
            m = zoo.get(path[len("zoo:"):], device=props.device, **props.custom_dict())
        except (KeyError, ValueError) as exc:
            raise BackendError(f"torch: {exc}") from exc
        self.module = m.module
        self._in_spec = props.input_spec or m.input_spec
        self._out_spec = None

    def close(self) -> None:
        self.module = None

    def _infer_out_spec(self) -> TensorsSpec:
        """Output spec by running the module once on zeros of the input
        spec (which also warms the device: cuDNN picks its algorithms
        here, not on the first frame)."""
        zeros = tuple(
            torch.zeros(t.shape, dtype=t.dtype.torch_dtype, device=self.props.device)
            for t in self._in_spec
        )
        with torch.inference_mode():
            outs = _as_tuple(self.module(*zeros))
        return TensorsSpec(tuple(
            TensorSpec(tuple(int(d) for d in o.shape), DType.from_any(o.dtype))
            for o in outs
        ))

    def get_model_info(self) -> Tuple[TensorsSpec, TensorsSpec]:
        if self._in_spec is None:
            raise BackendError("torch: input spec unknown")
        if self._out_spec is None:
            if not self._in_spec.is_static:
                raise BackendError(f"torch: input spec not static: {self._in_spec}")
            self._out_spec = self._infer_out_spec()
        return self._in_spec, self._out_spec

    def set_input_info(self, in_spec: TensorsSpec) -> TensorsSpec:
        if not in_spec.is_static:
            raise BackendError(f"torch: spec must be static, got {in_spec}")
        cur_in = self._in_spec
        if cur_in is not None and (
            cur_in.num_tensors != in_spec.num_tensors
            or any(a.dtype != b.dtype for a, b in zip(cur_in, in_spec))
        ):
            raise BackendError(f"torch: cannot renegotiate input {cur_in} -> {in_spec}")
        self._in_spec = in_spec
        self._out_spec = self._infer_out_spec()
        return self._out_spec

    def invoke(self, tensors: Tuple[Any, ...]) -> Tuple[Any, ...]:
        if self.module is None:
            raise BackendError("torch: backend not open")
        in_spec, _ = self.get_model_info()
        if len(tensors) != in_spec.num_tensors:
            raise BackendError(
                f"torch: expected {in_spec.num_tensors} tensors, got {len(tensors)}"
            )
        for t, s in zip(tensors, in_spec):
            if tuple(t.shape) != s.shape:
                raise BackendError(
                    f"torch: input shape {tuple(t.shape)} != negotiated {s.shape}"
                )
        with torch.inference_mode():
            return _as_tuple(self.module(*tensors))

    def traceable_fn(self) -> Optional[Callable]:
        module = self.module
        if module is None:
            return None
        return lambda tensors: _as_tuple(module(*tensors))
