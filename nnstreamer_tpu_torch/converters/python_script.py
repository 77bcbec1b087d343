"""python3 converter subplugin: a user script converts media → tensors.

The counterpart of ``nnstreamer_tpu/converters/python_script.py``
(reference tensor_converter_python3.cc): the script defines
``CustomConverter`` with ``convert(tensors) -> tensors`` (numpy arrays in)
and optionally ``negotiate(in_spec) -> TensorsSpec``. The script path is
the element's ``script`` (or ``option1``) property.
"""

from __future__ import annotations

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.script import load_script_object
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorFormat, TensorsSpec


@registry.converter_plugin("python3")
class PythonScriptConverter:
    def __init__(self) -> None:
        self._obj = None

    def _load(self, props: dict):
        if self._obj is None:
            path = props.get("script") or props.get("option1")
            if not path:
                raise ValueError("python3 converter: script=/path/to.py required")
            self._obj = load_script_object(path, ("CustomConverter", "converter_class"))
            if not hasattr(self._obj, "convert"):
                raise ValueError("python3 converter: script has no convert()")
        return self._obj

    def negotiate(self, in_spec, props: dict) -> TensorsSpec:
        obj = self._load(props)
        if hasattr(obj, "negotiate"):
            return obj.negotiate(in_spec)
        return TensorsSpec(format=TensorFormat.FLEXIBLE)

    def convert(self, frame: Frame, props: dict) -> Frame:
        out = self._load(props).convert(frame.to_host().tensors)
        return frame.with_tensors(tuple(out))
