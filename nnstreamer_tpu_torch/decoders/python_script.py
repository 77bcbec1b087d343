"""python3 decoder subplugin: a user script decodes tensors → media/tensors.

The counterpart of ``nnstreamer_tpu/decoders/python_script.py`` (reference
tensordec-python3.cc): the script defines ``CustomDecoder`` with
``decode(tensors) -> tensors`` and optionally ``negotiate(in_spec,
options) -> MediaSpec | TensorsSpec``; the script path is ``option1``.
The script gets numpy arrays: the frame crosses to the host once.
"""

from __future__ import annotations

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import MediaSpec
from nnstreamer_tpu_torch.script import load_script_object
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec


@registry.decoder_plugin("python3")
class PythonScriptDecoder:
    def __init__(self) -> None:
        self._obj = None

    def _load(self, options: dict):
        if self._obj is None:
            path = options.get("script") or options.get("option1")
            if not path:
                raise ValueError("python3 decoder: option1=/path/to.py required")
            self._obj = load_script_object(path, ("CustomDecoder", "decoder_class"))
            if not hasattr(self._obj, "decode"):
                raise ValueError("python3 decoder: script has no decode()")
        return self._obj

    def negotiate(self, in_spec: TensorsSpec, options: dict):
        obj = self._load(options)
        if hasattr(obj, "negotiate"):
            return obj.negotiate(in_spec, options)
        return MediaSpec("octet")

    def decode(self, frame: Frame, options: dict) -> Frame:
        out = self._load(options).decode(frame.to_host().tensors)
        return frame.with_tensors(tuple(out))
