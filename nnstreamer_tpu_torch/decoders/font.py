"""font decoder: render a text tensor as a video frame.

The counterpart of ``nnstreamer_tpu/decoders/font.py`` (reference
tensordec-font.c): a uint8 text tensor (read to the host once) drawn on a
transparent RGBA canvas, line by line from the top left. option1 =
WIDTH:HEIGHT of the output video (default 640:480).
"""

from __future__ import annotations

import numpy as np

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.decoders import render
from nnstreamer_tpu_torch.elements.base import MediaSpec, NegotiationError
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec

LINE_HEIGHT = 14


@registry.decoder_plugin("font")
class FontDecoder:
    def __init__(self) -> None:
        self._out_wh = (640, 480)

    def negotiate(self, in_spec: TensorsSpec, options: dict) -> MediaSpec:
        if options.get("option1"):
            self._out_wh = render.parse_wh(options["option1"], "font option1")
        if in_spec.num_tensors != 1:
            raise NegotiationError(f"font: expected 1 text tensor, got {in_spec.num_tensors}")
        w, h = self._out_wh
        return MediaSpec("video", width=w, height=h, format="RGBA", rate=in_spec.rate)

    def decode(self, frame: Frame, options: dict) -> Frame:
        raw = np.asarray(frame.to_host().tensors[0]).reshape(-1).astype(np.uint8)
        text = raw.tobytes().split(b"\0", 1)[0].decode("utf-8", "replace")
        w, h = self._out_wh
        canvas = render.new_canvas(w, h)
        for i, line in enumerate(text.splitlines() or [""]):
            y = 2 + i * LINE_HEIGHT
            if y + LINE_HEIGHT > h:
                break
            render.draw_text(canvas, line, 2, y)
        return frame.with_tensors((canvas,)).with_meta(text=text)
