"""TFLite backend: ``.tflite`` models through a host TFLite interpreter.

The counterpart of ``nnstreamer_tpu/backends/tflite_backend.py`` (the
reference's tensor_filter_tensorflow_lite.cc, its default engine). The
interpreter (``tflite_runtime``, ``ai_edge_litert`` or ``tensorflow``) is
imported inside :meth:`TFLiteBackend.open`, never when the package is
imported; where none imports, ``open`` raises :class:`BackendError` saying
so. The backend is a host node: ``invoke`` takes the frame's tensors to
the host, runs the interpreter on numpy, and hands its outputs back to the
filter's device. ``framework=torch`` runs the same file as the port's own
program on the device instead (tools/tflite_exec.py).
"""

from __future__ import annotations

import os
from typing import Any, Tuple

import numpy as np

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.backends.base import Backend, BackendError, FilterProps, host_invoke
from nnstreamer_tpu_torch.tensors.spec import DType, TensorSpec, TensorsSpec


def _load_interpreter():
    """The first TFLite Interpreter class that imports; BackendError when
    none does."""
    try:
        from tflite_runtime.interpreter import Interpreter  # type: ignore

        return Interpreter
    except ImportError:
        pass
    try:
        from ai_edge_litert.interpreter import Interpreter  # type: ignore

        return Interpreter
    except ImportError:
        pass
    try:
        import tensorflow as tf  # type: ignore
    except ImportError as exc:
        raise BackendError(
            "tflite: no TFLite interpreter imports here (tflite_runtime, ai_edge_litert "
            "or tensorflow); framework=torch runs a .tflite as the port's own program"
        ) from exc
    return tf.lite.Interpreter


def _spec_from_details(details) -> TensorsSpec:
    return TensorsSpec(tuple(
        TensorSpec(tuple(int(x) for x in d["shape"]), DType.from_any(np.dtype(d["dtype"]).name),
                   d.get("name"))
        for d in details
    ))


@registry.filter_backend("tflite")
class TFLiteBackend(Backend):
    """framework=tflite model=m.tflite: the host CPU interpreter."""

    name = "tflite"

    def open(self, props: FilterProps) -> None:
        self.props = props
        path = props.model_path
        if not os.path.isfile(path):
            raise BackendError(f"tflite: model not found: {path}")
        threads = int(props.custom_dict().get("num_threads", "0")) or None
        interpreter = _load_interpreter()
        self._interp = interpreter(model_path=path, num_threads=threads)
        self._interp.allocate_tensors()

    def close(self) -> None:
        self._interp = None

    def get_model_info(self) -> Tuple[TensorsSpec, TensorsSpec]:
        return (_spec_from_details(self._interp.get_input_details()),
                _spec_from_details(self._interp.get_output_details()))

    def set_input_info(self, in_spec: TensorsSpec) -> TensorsSpec:
        details = self._interp.get_input_details()
        if len(details) != in_spec.num_tensors:
            raise BackendError("tflite: tensor count mismatch")
        for d, t in zip(details, in_spec):
            self._interp.resize_tensor_input(d["index"], list(t.shape))
        self._interp.allocate_tensors()
        return self.get_model_info()[1]

    def _run(self, tensors: Tuple[Any, ...]) -> Tuple[np.ndarray, ...]:
        details = self._interp.get_input_details()
        if len(tensors) != len(details):
            raise BackendError(
                f"tflite: expected {len(details)} input tensors, got {len(tensors)}"
            )
        for d, t in zip(details, tensors):
            self._interp.set_tensor(d["index"], np.asarray(t, dtype=d["dtype"]))
        self._interp.invoke()
        return tuple(self._interp.get_tensor(d["index"])
                     for d in self._interp.get_output_details())

    def invoke(self, tensors: Tuple[Any, ...]) -> Tuple[Any, ...]:
        return host_invoke(self._run, tensors, self.props.device)
