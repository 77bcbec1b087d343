"""Custom-plugin scaffold generator.

The counterpart of ``nnstreamer_tpu/tools/codegen.py`` (the reference's
tools/development/nnstreamerCodeGenCustomFilter.py). The port's plugin ABI
is Python (backends/custom.py, the decoder and converter registries), so
a scaffold is a ready-to-run ``.py`` in torch and numpy:

- ``filter``: ``<name>.py``, a python3-subplugin filter for
  ``tensor_filter framework=custom model=<name>.py``, traceable (its
  invoke gets torch tensors on the device and fuses into the segment);
- ``decoder`` / ``converter``: ``nns_decoder_<name>.py`` /
  ``nns_converter_<name>.py``, the names the registry looks for on the
  ``[decoder]`` / ``[converter]`` ``plugin_paths`` (so ``tensor_decoder
  mode=<name>`` loads it by name), registering on import.

Usage: python -m nnstreamer_tpu_torch.tools.codegen filter my_op [-o DIR]
"""

from __future__ import annotations

import argparse
import os
import sys

_FILTER_TEMPLATE = '''"""Custom tensor_filter: {name}.

Load with: tensor_filter framework=custom model={name}.py
(python3-subplugin protocol, nnstreamer_tpu_torch/backends/custom.py).
"""

import torch


class CustomFilter:
    TRACEABLE = True  # invoke gets torch tensors on the device and may fuse

    def setInputDim(self, in_spec):
        """Shape-polymorphic: accept the upstream spec, return the output
        spec (here passthrough). Shape-fixed filters implement
        getInputDim()/getOutputDim() instead."""
        self.in_spec = in_spec
        return in_spec

    def invoke(self, tensors):
        return tuple(torch.as_tensor(t) for t in tensors)
'''

_DECODER_TEMPLATE = '''"""Custom tensor_decoder subplugin: {name}.

Put this file on a [decoder] plugin_paths directory (or import it), then:
tensor_decoder mode={name}.
"""

import numpy as np

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import MediaSpec
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec


@registry.decoder_plugin("{name}")
class {cls}Decoder:
    def negotiate(self, in_spec: TensorsSpec, options: dict) -> MediaSpec:
        return MediaSpec("octet")

    def decode(self, frame: Frame, options: dict) -> Frame:
        frame = frame.to_host()
        data = np.ascontiguousarray(frame.tensors[0])
        return frame.with_tensors((np.frombuffer(data.tobytes(), np.uint8),)).with_meta(
            media_type="octet")
'''

_CONVERTER_TEMPLATE = '''"""Custom tensor_converter subplugin: {name}.

Put this file on a [converter] plugin_paths directory (or import it), then:
tensor_converter mode={name}.
"""

import numpy as np

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import DType, TensorSpec, TensorsSpec


@registry.converter_plugin("{name}")
class {cls}Converter:
    def negotiate(self, in_spec, props: dict) -> TensorsSpec:
        return TensorsSpec.of(TensorSpec((1,), DType.UINT8))

    def convert(self, frame: Frame, props: dict) -> Frame:
        data = np.asarray(frame.to_host().tensors[0], dtype=np.uint8)
        return frame.with_tensors((data.reshape(1, -1),))
'''

_TEMPLATES = {
    "filter": ("{name}.py", _FILTER_TEMPLATE),
    "decoder": ("nns_decoder_{name}.py", _DECODER_TEMPLATE),
    "converter": ("nns_converter_{name}.py", _CONVERTER_TEMPLATE),
}


def generate(kind: str, name: str, out_dir: str = ".") -> str:
    if kind not in _TEMPLATES:
        raise ValueError(f"unknown kind {kind!r}; one of {sorted(_TEMPLATES)}")
    if not name.isidentifier():
        raise ValueError(f"name must be a python identifier, got {name!r}")
    fname, template = _TEMPLATES[kind]
    cls = "".join(part.capitalize() for part in name.split("_"))
    path = os.path.join(out_dir, fname.format(name=name))
    if os.path.exists(path):
        raise FileExistsError(path)
    with open(path, "w") as f:
        f.write(template.format(name=name, cls=cls))
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nns-codegen", description=__doc__)
    ap.add_argument("kind", choices=sorted(_TEMPLATES))
    ap.add_argument("name", help="plugin name (python identifier)")
    ap.add_argument("-o", "--out-dir", default=".")
    args = ap.parse_args(argv)
    path = generate(args.kind, args.name, args.out_dir)
    print(f"generated {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
