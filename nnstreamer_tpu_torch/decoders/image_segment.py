"""image_segment decoder: per-pixel class maps → an RGBA overlay.

The counterpart of ``nnstreamer_tpu/decoders/image_segment.py`` (reference
tensordec-imagesegment.c). Modes (option1): ``tflite-deeplab`` ([1, H, W,
C] scores → argmax), ``snpe-deeplab`` ([H, W] labels already) and
``snpe-depth`` ([H, W] float depth → grey). The argmax or normalization
runs where the tensors are (ops/heatmap.py). With ``postproc=device`` it
fuses and emits the [H, W] uint8 label (or grey) map; the host decode
copies that map to the host, paints it with the VOC palette there and
keeps it in ``frame.meta["label_map"]``.
"""

from __future__ import annotations

import numpy as np
import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.decoders import render
from nnstreamer_tpu_torch.elements.base import MediaSpec, NegotiationError
from nnstreamer_tpu_torch.ops import heatmap as hm
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import DType, TensorSpec, TensorsSpec

_MODES = ("tflite-deeplab", "snpe-deeplab", "snpe-depth")
_DEFAULT_LABELS = 21  # Pascal-VOC classes of deeplab-v3 (reference :95)


@registry.decoder_plugin("image_segment")
class ImageSegmentDecoder:
    @classmethod
    def device_capable(cls, options: dict) -> bool:
        """Static capability read for nns-lint NNS-W116: every segment
        mode decodes on the device."""
        return True

    def __init__(self) -> None:
        self._mode = "tflite-deeplab"
        self._num_labels = _DEFAULT_LABELS
        self._wh = None

    def negotiate(self, in_spec: TensorsSpec, options: dict) -> MediaSpec:
        mode = options.get("option1", self._mode) or "tflite-deeplab"
        if mode not in _MODES:
            raise NegotiationError(f"image_segment: unknown mode {mode!r}")
        self._mode = mode
        if options.get("option2"):
            self._num_labels = int(options["option2"])
        if in_spec.num_tensors != 1:
            raise NegotiationError("image_segment: exactly one tensor expected")
        shape = [d for d in in_spec[0].shape if d != 1]
        if mode == "tflite-deeplab":
            if len(shape) != 3:
                raise NegotiationError(
                    f"image_segment[tflite-deeplab]: need [H,W,C], got {in_spec[0]}"
                )
            h, w, self._num_labels = shape
        else:
            if len(shape) != 2:
                raise NegotiationError(f"image_segment[{mode}]: need [H,W], got {in_spec[0]}")
            h, w = shape
        self._wh = (w, h)
        return MediaSpec("video", width=w, height=h, format="RGBA", rate=in_spec.rate)

    def _map(self, t: torch.Tensor, shape=None) -> torch.Tensor:
        arr = t.reshape(shape) if shape is not None else t.squeeze()
        if self._mode == "snpe-depth":
            return hm.depth_normalize(arr)
        return hm.segment_argmax(arr)

    # -- device post-processing (tensor_decoder postproc=device) ----------
    def device_decode(self, in_spec: TensorsSpec, options: dict):
        """The argmax (or depth normalization) as a fused op: the [H, W]
        uint8 map, ``meta["label_map"]`` of the host decode; no palette."""
        self.negotiate(in_spec, options)
        w, h = self._wh
        shape = tuple(d for d in in_spec[0].shape if d != 1)
        out = TensorsSpec.of(TensorSpec((h, w), DType.UINT8, name="label_map"), rate=in_spec.rate)
        return out, lambda tensors: (self._map(tensors[0], shape),)

    def decode(self, frame: Frame, options: dict) -> Frame:
        labels = self._map(render.as_tensor(frame.tensors[0])).cpu().numpy()
        if self._mode == "snpe-depth":
            rgba = np.stack([labels, labels, labels, np.full_like(labels, 255)], axis=-1)
        else:
            rgba = render.render_segmentation(labels, self._num_labels)
        return frame.with_tensors((rgba,)).with_meta(media_type="video", label_map=labels)
