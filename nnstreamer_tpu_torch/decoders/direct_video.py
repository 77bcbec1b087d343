"""direct_video decoder: a uint8 NHWC tensor → raw video frames.

The counterpart of ``nnstreamer_tpu/decoders/direct_video.py`` (reference
tensordec-directvideo.c): one media frame per batch element, read to the
host once; a batched tensor (frames-per-tensor) splits its duration
evenly over its frames.
"""

from __future__ import annotations

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import MediaSpec, NegotiationError
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import DType, TensorsSpec


@registry.decoder_plugin("direct_video")
class DirectVideoDecoder:
    def negotiate(self, in_spec: TensorsSpec, options: dict) -> MediaSpec:
        if in_spec.num_tensors != 1:
            raise NegotiationError("direct_video: exactly one tensor expected")
        t = in_spec[0]
        if t.dtype is not DType.UINT8 or t.rank != 4:
            raise NegotiationError(f"direct_video: need uint8 NHWC, got {t}")
        _, h, w, c = t.shape
        fmt = {1: "GRAY8", 3: "RGB", 4: "RGBA"}.get(c)
        if fmt is None:
            raise NegotiationError(f"direct_video: {c} channels unsupported")
        return MediaSpec("video", width=w, height=h, format=fmt, rate=in_spec.rate)

    def decode(self, frame: Frame, options: dict):
        batch = frame.to_host().tensors[0]
        n = batch.shape[0]
        out = []
        for i in range(n):
            f = frame.with_tensors((batch[i],)).with_meta(media_type="video")
            if frame.pts is not None and frame.duration is not None and n > 1:
                per = frame.duration // n
                f = f.with_pts(frame.pts + i * per, per)
            out.append(f)
        return out if len(out) > 1 else out[0]
