"""Custom filter backends: in-process callables and user python scripts.

The counterpart of ``nnstreamer_tpu/backends/custom.py``:

- ``custom-easy``: a function and its specs registered in-process, no file
  (the reference's NNS_custom_easy_register; :func:`register_custom_easy`).
- ``custom``: a script file with a filter class, the python3-subplugin
  protocol (``invoke``, and ``setInputDim`` or ``getInputDim`` +
  ``getOutputDim``; tensor_filter_python3.cc:286-291).

Where the code runs: a callable or script that is not traceable is a host
function. It gets numpy arrays, and its outputs go back to the filter's
device: one device-to-host and one host-to-device copy a tensor a frame.
A traceable one (``traceable=True`` at registration, ``TRACEABLE = True``
on the script class) gets torch tensors on the device and fuses into the
segment. That departs from the reference, whose traceable callables are
written in ``jnp``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.backends.base import Backend, BackendError, FilterProps, host_invoke
from nnstreamer_tpu_torch.script import load_script_module
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec

_custom_easy_lock = threading.Lock()
_custom_easy_table: Dict[
    str, Tuple[Callable, Optional[TensorsSpec], Optional[TensorsSpec], bool]
] = {}


def register_custom_easy(
    name: str,
    fn: Callable[[Tuple[Any, ...]], Tuple[Any, ...]],
    in_spec: Optional[TensorsSpec] = None,
    out_spec: Optional[TensorsSpec] = None,
    *,
    traceable: bool = False,
) -> None:
    """Model name → in-process function (NNS_custom_easy_register)."""
    with _custom_easy_lock:
        _custom_easy_table[name] = (fn, in_spec, out_spec, traceable)


def unregister_custom_easy(name: str) -> bool:
    """NNS_custom_easy_unregister: True if ``name`` was registered."""
    with _custom_easy_lock:
        return _custom_easy_table.pop(name, None) is not None


@registry.filter_backend("custom-easy")
class CustomEasyBackend(Backend):
    """framework=custom-easy model=<registered name>."""

    name = "custom-easy"

    def open(self, props: FilterProps) -> None:
        self.props = props
        key = props.model_path
        with _custom_easy_lock:
            if key not in _custom_easy_table:
                raise BackendError(f"custom-easy model {key!r} not registered")
            self._fn, self._in, self._out, self._traceable = _custom_easy_table[key]
        if self._in is None:
            self._in = props.input_spec
        if self._out is None:
            self._out = props.output_spec or self._in

    def get_model_info(self):
        if self._in is None or self._out is None:
            raise BackendError("custom-easy: specs unknown; register with specs "
                               "or set input/output on the filter")
        return self._in, self._out

    def set_input_info(self, in_spec: TensorsSpec) -> TensorsSpec:
        if self._in is None or self._in.is_compatible(in_spec):
            self._in = in_spec
            if self._out is None:
                self._out = in_spec
            return self._out
        raise BackendError(f"custom-easy: fixed input {self._in} != {in_spec}")

    def invoke(self, tensors):
        if self._traceable:
            return tuple(self._fn(tensors))
        return host_invoke(self._fn, tensors, self.props.device)

    def traceable_fn(self):
        return self._fn if self._traceable else None


class CustomScriptProtocolError(BackendError):
    pass


@registry.filter_backend("custom")
class CustomScriptBackend(Backend):
    """framework=custom model=/path/to/script.py

    The script defines ``CustomFilter`` (or a module-level
    ``filter_class``)::

        class CustomFilter:
            def getInputDim(self) -> TensorsSpec: ...   # or setInputDim
            def getOutputDim(self) -> TensorsSpec: ...
            def setInputDim(self, in_spec) -> TensorsSpec: ...  # returns out
            def invoke(self, tensors) -> tuple: ...
            TRACEABLE = False  # optional

    Shape-fixed filters implement the two getters, shape-polymorphic ones
    ``setInputDim`` (tensor_filter_python3.cc:402-583).
    """

    name = "custom"

    def open(self, props: FilterProps) -> None:
        self.props = props
        path = props.model_path
        try:
            module = load_script_module(path, "nns_tpu_torch_custom")
        except FileNotFoundError as exc:
            raise BackendError(f"custom: script not found: {path}") from exc
        cls = getattr(module, "CustomFilter", None) or getattr(module, "filter_class", None)
        if cls is None:
            raise CustomScriptProtocolError(f"custom: {path} defines no CustomFilter class")
        self._obj = cls() if isinstance(cls, type) else cls
        if not hasattr(self._obj, "invoke"):
            raise CustomScriptProtocolError(f"custom: {path} has no invoke()")
        has_set = hasattr(self._obj, "setInputDim")
        has_get = hasattr(self._obj, "getInputDim") and hasattr(self._obj, "getOutputDim")
        if not (has_set or has_get):
            raise CustomScriptProtocolError(
                f"custom: {path} must define setInputDim or getInputDim+getOutputDim"
            )
        self._traceable = bool(getattr(self._obj, "TRACEABLE", False))
        self._in: Optional[TensorsSpec] = None
        self._out: Optional[TensorsSpec] = None
        if has_get:
            self._in = self._obj.getInputDim()
            self._out = self._obj.getOutputDim()
        elif props.input_spec is not None:
            self._in = props.input_spec
            self._out = self._obj.setInputDim(props.input_spec)

    def get_model_info(self):
        if self._in is None or self._out is None:
            raise BackendError("custom: input spec not negotiated yet")
        return self._in, self._out

    def set_input_info(self, in_spec: TensorsSpec) -> TensorsSpec:
        if hasattr(self._obj, "setInputDim"):
            self._in = in_spec
            self._out = self._obj.setInputDim(in_spec)
            return self._out
        return super().set_input_info(in_spec)

    def invoke(self, tensors):
        if self._traceable:
            return tuple(self._obj.invoke(tensors))
        return host_invoke(self._obj.invoke, tensors, self.props.device)

    def traceable_fn(self):
        if self._traceable:
            return lambda tensors: tuple(self._obj.invoke(tensors))
        return None
