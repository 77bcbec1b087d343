"""Converter subplugins (the reference's ext/nnstreamer/tensor_converter/).

The counterpart of ``nnstreamer_tpu/converters/``. Protocol:
``negotiate(in_spec, props) -> TensorsSpec``; ``convert(frame, props) ->
Frame``. Registered under registry kind ``converter`` and used by
``tensor_converter mode=NAME``. A subplugin reads its input's bytes on the
host and returns host tensors; the element places them on its device.
"""

from nnstreamer_tpu_torch.converters import flatbuf  # noqa: F401
from nnstreamer_tpu_torch.converters import flexbuf  # noqa: F401
from nnstreamer_tpu_torch.converters import protobuf  # noqa: F401
from nnstreamer_tpu_torch.converters import python_script  # noqa: F401
