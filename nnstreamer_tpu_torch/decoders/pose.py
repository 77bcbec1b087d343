"""pose_estimation decoder: heatmaps → keypoints and an RGBA skeleton overlay.

The counterpart of ``nnstreamer_tpu/decoders/pose.py`` (reference
tensordec-pose.c). Options:

- option1 = WIDTH:HEIGHT of the output video (default 640:480);
- option2 = WIDTH:HEIGHT of the model input (default 257:257);
- option3 = labels file (``<name> <connected-id>...`` a keypoint line);
- option4 = ``heatmap-only`` (default; one [1, H, W, K] tensor) or
  ``heatmap-offset`` (adds the [1, H, W, 2K] offsets, posenet convention).

The grid argmax and the offset gather run where the tensors are
(ops/heatmap.py). With ``postproc=device`` the decode fuses and emits the
[K, 3] (x, y, score) keypoints in output pixels (:meth:`PoseDecoder.device_decode`);
the host decode copies those [K, 3] rows to the host, draws the skeleton
there and keeps them in ``frame.meta["keypoints"]``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.decoders import render
from nnstreamer_tpu_torch.elements.base import MediaSpec, NegotiationError
from nnstreamer_tpu_torch.ops import heatmap as hm
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import DType, TensorSpec, TensorsSpec


def load_pose_labels(path: str) -> Tuple[List[str], List[List[int]]]:
    """``<label> <id> <id>...`` a line → (names, connection lists)
    (tensordec-pose.c:31-56 syntax)."""
    names, conns = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            names.append(parts[0])
            conns.append([int(p) for p in parts[1:]])
    return names, conns


@registry.decoder_plugin("pose_estimation")
class PoseDecoder:
    @classmethod
    def device_capable(cls, options: dict) -> bool:
        """Static capability read for nns-lint NNS-W116: both heatmap
        modes decode on the device."""
        return True

    def __init__(self) -> None:
        self._out_wh = (640, 480)
        self._in_wh = (257, 257)
        self._names: Optional[List[str]] = None
        self._conns: Optional[List[List[int]]] = None
        self._offset_mode = False
        self._score_threshold = 0.3

    def negotiate(self, in_spec: TensorsSpec, options: dict) -> MediaSpec:
        if options.get("option1"):
            self._out_wh = render.parse_wh(options["option1"], "pose option1")
        if options.get("option2"):
            self._in_wh = render.parse_wh(options["option2"], "pose option2")
        if options.get("option3"):
            self._names, self._conns = load_pose_labels(options["option3"])
        mode = options.get("option4", "heatmap-only") or "heatmap-only"
        if mode not in ("heatmap-only", "heatmap-offset"):
            raise NegotiationError(f"pose_estimation: unknown option4 {mode!r}")
        self._offset_mode = mode == "heatmap-offset"
        need = 2 if self._offset_mode else 1
        if in_spec.num_tensors != need:
            raise NegotiationError(
                f"pose_estimation[{mode}]: expected {need} tensors, got {in_spec.num_tensors}"
            )
        w, h = self._out_wh
        return MediaSpec("video", width=w, height=h, format="RGBA", rate=in_spec.rate)

    def _keypoints_fn(self, grid_shape: Optional[Tuple[int, int, int]] = None):
        """tensors → [K, 3] (x, y, score) in output pixels. ``grid_shape``
        (H, W, K) fixes the heatmap's shape from the negotiated spec; None
        takes the last three dims of each frame's tensor."""
        ow, oh = self._out_wh
        iw, ih = self._in_wh
        offset_mode = self._offset_mode

        def fn(tensors):
            heat = tensors[0]
            gh, gw, k = grid_shape or tuple(heat.shape[-3:])
            grid = heat.reshape(gh, gw, k)
            if offset_mode:
                raw = hm.pose_keypoints_with_offsets(grid, tensors[1].reshape(gh, gw, 2 * k))
                # posenet: pos = grid_idx / (grid - 1) · (input - 1) + offset
                # (model-input pixels), then scaled to the output size
                x_in = raw[:, 0] / max(gw - 1, 1) * (iw - 1) + raw[:, 3]
                y_in = raw[:, 1] / max(gh - 1, 1) * (ih - 1) + raw[:, 4]
                xs, ys = x_in / iw * ow, y_in / ih * oh
            else:
                raw = hm.pose_keypoints_from_heatmap(grid)
                xs = raw[:, 0] / max(gw - 1, 1) * ow
                ys = raw[:, 1] / max(gh - 1, 1) * oh
            return torch.stack([xs, ys, raw[:, 2]], dim=-1).to(torch.float32)

        return fn

    # -- device post-processing (tensor_decoder postproc=device) ----------
    def device_decode(self, in_spec: TensorsSpec, options: dict):
        """The keypoint decode as a fused op: the [K, 3] (x, y, score)
        keypoints tensor in output pixels, the values the host decode
        keeps in ``meta["keypoints"]``; no skeleton is drawn."""
        self.negotiate(in_spec, options)
        grid_shape = tuple(d for d in in_spec[0].shape if d != 1)
        if len(grid_shape) != 3:
            return None
        fn = self._keypoints_fn(grid_shape)
        out = TensorsSpec.of(
            TensorSpec((grid_shape[2], 3), DType.FLOAT32, name="keypoints"), rate=in_spec.rate,
        )
        return out, lambda tensors: (fn(tensors),)

    def decode(self, frame: Frame, options: dict) -> Frame:
        kpts = self._keypoints_fn()(
            [render.as_tensor(t) for t in frame.tensors]).cpu().numpy()
        xs, ys, score = kpts[:, 0], kpts[:, 1], kpts[:, 2]
        k = kpts.shape[0]
        ow, oh = self._out_wh
        canvas = render.new_canvas(ow, oh)
        ok = score >= self._score_threshold
        for i in range(k):
            if not ok[i]:
                continue
            render.draw_point(canvas, xs[i], ys[i])
            if self._names and i < len(self._names):
                render.draw_text(canvas, self._names[i], xs[i] + 3, ys[i] + 3)
            for j in (self._conns[i] if self._conns and i < len(self._conns) else ()):
                if 0 <= j < k and ok[j]:
                    render.draw_line(canvas, xs[i], ys[i], xs[j], ys[j])
        return frame.with_tensors((canvas,)).with_meta(media_type="video", keypoints=kpts)
