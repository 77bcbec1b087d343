"""bounding_boxes decoder: detection tensors → detections, or an RGBA overlay.

The counterpart of ``nnstreamer_tpu/decoders/bounding_box.py`` (reference
ext/nnstreamer/tensor_decoder/tensordec-boundingbox.c). Modes (option1,
tensordec-boundingbox.c:143-186):

- ``mobilenet-ssd`` (priors file + scales, score threshold),
- ``mobilenet-ssd-postprocess`` (model-side NMS, 4 tensors + tensor map),
- ``ov-person-detection`` / ``ov-face-detection`` ([N, 7] descriptors),
- ``yolov5`` ([N, 5+C], normalized or pixel coordinates),
- ``mp-palm-detection`` (anchors generated from the option3 scheme),

plus the aliases ``tflite-ssd`` and ``tf-ssd``. Options: option1 = mode,
option2 = labels file, option3 = mode-specific, option4 = WIDTH:HEIGHT of
the output video, option5 = WIDTH:HEIGHT of the model input.

The decode math (ops/detection.py) runs on the device the frame's tensors
are on, and so reaches the K2 NMS kernel on the card. With
``postproc=device`` it fuses into the upstream segment
(:meth:`BoundingBoxDecoder.device_decode`) and only the fixed [max_out, 6]
detections tensor leaves the card. The host decode runs the same math on
the device, copies the [max_out, 6] result to the host and draws the RGBA
overlay there; the valid rows ride in ``frame.meta["detections"]``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.decoders import render
from nnstreamer_tpu_torch.elements.base import MediaSpec, NegotiationError
from nnstreamer_tpu_torch.ops import detection as det
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import DType, TensorSpec, TensorsSpec

_MODES = (
    "mobilenet-ssd",
    "mobilenet-ssd-postprocess",
    "ov-person-detection",
    "ov-face-detection",
    "yolov5",
    "mp-palm-detection",
    # backward-compat aliases (reference OLDNAME_/deprecated modes :150-155)
    "tflite-ssd",
    "tf-ssd",
)
_ALIASES = {"tflite-ssd": "mobilenet-ssd", "tf-ssd": "mobilenet-ssd-postprocess"}
_NUM_TENSORS = {
    "mobilenet-ssd": 2, "mobilenet-ssd-postprocess": 4,
    "ov-person-detection": 1, "ov-face-detection": 1,
    "yolov5": 1, "mp-palm-detection": 2,
}


def load_box_priors(path: str) -> np.ndarray:
    """Reference box-priors.txt: 4 lines (ycenter, xcenter, h, w) × N
    values (tensordec-boundingbox.c box_priors load)."""
    rows = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.replace(",", " ").split()]
            if vals:
                rows.append(vals)
    if len(rows) < 4:
        raise ValueError(f"box priors file needs 4 rows, got {len(rows)}: {path}")
    n = min(len(r) for r in rows[:4])
    return np.asarray([r[:n] for r in rows[:4]], np.float32)


class _OnDevice:
    """A host array's copy on each device it is asked for, made once (no
    host-to-device copy per frame)."""

    def __init__(self, array: np.ndarray) -> None:
        self._host = torch.from_numpy(np.ascontiguousarray(array))
        self._copies: Dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        t = self._copies.get(device)
        if t is None:
            t = self._copies[device] = self._host.to(device)
        return t


def _as_tensor(t) -> torch.Tensor:
    return t if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))


@registry.decoder_plugin("bounding_boxes")
class BoundingBoxDecoder:
    def __init__(self) -> None:
        self._mode = "mobilenet-ssd"
        self._labels: Optional[List[str]] = None
        self._priors: Optional[_OnDevice] = None
        self._anchors: Optional[_OnDevice] = None
        self._params: dict = {}
        self._out_wh = (640, 480)
        self._in_wh = (300, 300)
        self._tensor_map = (0, 1, 2, 3)
        self._pp_threshold = det.SSD_THRESHOLD

    # -- option parsing (reference scheme, option3 per mode :39-80) -------
    def _parse_options(self, options: dict) -> None:
        mode = options.get("option1", self._mode) or "mobilenet-ssd"
        mode = _ALIASES.get(mode, mode)
        if mode not in _MODES:
            raise NegotiationError(f"bounding_box: unknown mode {mode!r}")
        self._mode = mode
        labels_path = options.get("option2", "")
        if labels_path:
            self._labels = render.load_labels(labels_path)
        if options.get("option4"):
            self._out_wh = render.parse_wh(options["option4"], "bounding_box option4")
        if options.get("option5"):
            self._in_wh = render.parse_wh(options["option5"], "bounding_box option5")
        opt3 = options.get("option3", "")
        if mode == "mobilenet-ssd":
            parts = (opt3 or "").split(":")
            if not parts or not parts[0]:
                raise NegotiationError(
                    "bounding_box: mobilenet-ssd needs option3=box-priors-file[:...]"
                )
            self._priors = _OnDevice(load_box_priors(parts[0]))
            defaults = [det.SSD_THRESHOLD, det.SSD_Y_SCALE, det.SSD_X_SCALE,
                        det.SSD_H_SCALE, det.SSD_W_SCALE, det.SSD_IOU_THRESHOLD]
            vals = []
            for i, d in enumerate(defaults):
                p = parts[i + 1] if i + 1 < len(parts) else ""
                vals.append(float(p) if p else d)
            self._params = dict(
                threshold=vals[0], y_scale=vals[1], x_scale=vals[2],
                h_scale=vals[3], w_scale=vals[4], iou_threshold=vals[5],
            )
        elif mode == "mobilenet-ssd-postprocess":
            # "%i:%i:%i:%i,%i" — tensor index map + threshold percent (:60-67)
            if opt3:
                head, _, thr = opt3.partition(",")
                idx = [int(v) for v in head.split(":") if v != ""]
                if len(idx) == 4:
                    self._tensor_map = tuple(idx)
                if thr:
                    self._pp_threshold = int(thr) / 100.0
        elif mode == "mp-palm-detection":
            parts = (opt3 or "").split(":")
            score = float(parts[0]) if parts and parts[0] else 0.5
            num_layers = int(parts[1]) if len(parts) > 1 and parts[1] else 4
            min_scale = float(parts[2]) if len(parts) > 2 and parts[2] else 1.0
            max_scale = float(parts[3]) if len(parts) > 3 and parts[3] else 1.0
            x_off = float(parts[4]) if len(parts) > 4 and parts[4] else 0.5
            y_off = float(parts[5]) if len(parts) > 5 and parts[5] else 0.5
            strides = [int(v) for v in parts[6:] if v] or [8, 16, 16, 16]
            self._params = dict(score_threshold=score)
            try:
                self._anchors = _OnDevice(det.generate_mp_palm_anchors(
                    num_layers, min_scale, max_scale, x_off, y_off,
                    tuple(strides), input_size=self._in_wh[0],
                ))
            except ValueError as exc:
                raise NegotiationError(f"bounding_box: {exc}") from exc
        elif mode == "yolov5":
            # Reference yolov5 has no option3 and expects normalized [0,1]
            # coords (tensordec-boundingbox.c:1675 multiplies by i_width).
            # Extension: option3=CONF[:IOU[:pixel]] — "pixel" marks models
            # emitting pixel-unit coords (normalized by option5 size here).
            parts = (opt3 or "").split(":")
            self._params = dict(
                conf_threshold=float(parts[0]) if parts and parts[0]
                else det.YOLOV5_CONF_THRESHOLD,
                iou_threshold=float(parts[1]) if len(parts) > 1 and parts[1]
                else det.YOLOV5_IOU_THRESHOLD,
                pixel_coords=len(parts) > 2 and parts[2] == "pixel",
            )

    def negotiate(self, in_spec: TensorsSpec, options: dict) -> MediaSpec:
        self._parse_options(options)
        need = _NUM_TENSORS[self._mode]
        if in_spec.num_tensors != need:
            raise NegotiationError(
                f"bounding_box[{self._mode}]: expected {need} tensors, "
                f"got {in_spec.num_tensors}"
            )
        w, h = self._out_wh
        return MediaSpec("video", width=w, height=h, format="RGBA", rate=in_spec.rate)

    # -- the decode math, on the tensors' device ---------------------------
    def _decode_fn(self, loc_idx: Optional[int] = None, cols: Optional[int] = None):
        """tensors → [max_out, 6] detections for the negotiated mode.
        ``loc_idx``/``cols`` fix the SSD tensor order and the row width
        from the negotiated shapes; None resolves them per frame from the
        squeezed tensors, as the reference's host path does."""
        mode = self._mode
        p = dict(self._params)
        if mode == "mobilenet-ssd":
            priors = self._priors

            def fn(ts):
                li = loc_idx
                if li is None:
                    li = 0 if (ts[0].dim() == 2 and ts[0].shape[-1] == 4) else 1
                loc = ts[li].reshape(-1, 4)
                scores = ts[1 - li].reshape(loc.shape[0], -1)
                return det.ssd_postprocess(
                    loc, scores, priors.on(loc.device),
                    threshold=p["threshold"], iou_threshold=p["iou_threshold"],
                    y_scale=p["y_scale"], x_scale=p["x_scale"],
                    h_scale=p["h_scale"], w_scale=p["w_scale"],
                )

        elif mode == "mobilenet-ssd-postprocess":
            m, thr = self._tensor_map, self._pp_threshold

            def fn(ts):
                return det.ssd_pp_postprocess(
                    ts[m[0]].reshape(-1, 4).to(torch.float32),
                    ts[m[1]].reshape(-1).to(torch.float32),
                    ts[m[2]].reshape(-1).to(torch.float32),
                    ts[m[3]].reshape(-1).to(torch.float32)[0],
                    threshold=thr,
                )

        elif mode in ("ov-person-detection", "ov-face-detection"):
            def fn(ts):
                return det.ov_detection_postprocess(ts[0].reshape(-1, 7))

        elif mode == "yolov5":
            iw, ih = self._in_wh
            norm = _OnDevice(np.asarray([iw, ih, iw, ih], np.float32))

            def fn(ts):
                pred = ts[0].reshape(-1, cols or ts[0].shape[-1]).to(torch.float32)
                if p["pixel_coords"]:  # normalize pixel-unit outputs first
                    pred = torch.cat(
                        [pred[:, :4] / norm.on(pred.device), pred[:, 4:]], dim=-1
                    )
                return det.yolov5_postprocess(
                    pred, conf_threshold=p["conf_threshold"],
                    iou_threshold=p["iou_threshold"], scaled=True,
                )

        elif mode == "mp-palm-detection":
            anchors = self._anchors
            in_size = self._in_wh[0]

            def fn(ts):
                boxes = ts[0].reshape(-1, cols or ts[0].shape[-1])
                return det.mp_palm_postprocess(
                    boxes, ts[1].reshape(-1), anchors.on(boxes.device),
                    score_threshold=p["score_threshold"], input_size=in_size,
                )

        else:  # pragma: no cover - _MODES is closed above
            raise NegotiationError(f"bounding_box: unhandled mode {mode}")
        return fn

    # -- device post-processing (tensor_decoder postproc=device) ----------
    def device_decode(self, in_spec: TensorsSpec, options: dict):
        """The decode of :meth:`_detections` as a fused op: ONE float32
        [max_out, 6] detections tensor (x1, y1, x2, y2, class, score; rows
        with score 0 empty). The RGBA host tail is dropped — a downstream
        consumer reads structured rows, not pixels."""
        self.negotiate(in_spec, options)  # validates count + options
        max_out = 20 if self._mode == "mp-palm-detection" else 100
        shapes = [tuple(d for d in t.shape if d != 1) for t in in_spec]
        loc_idx = cols = None
        if self._mode == "mobilenet-ssd":
            # resolve the loc/scores order statically from the negotiated
            # shapes (the host path probes per frame)
            loc_idx = 0 if (len(shapes[0]) == 2 and shapes[0][-1] == 4) else 1
        elif self._mode in ("yolov5", "mp-palm-detection"):
            cols = shapes[0][-1]
        decode = self._decode_fn(loc_idx, cols)
        out = TensorsSpec.of(
            TensorSpec((max_out, 6), DType.FLOAT32, name="detections"),
            rate=in_spec.rate,
        )
        return out, lambda tensors: (decode(tensors),)

    # -- per-frame decode --------------------------------------------------
    def _detections(self, frame: Frame) -> torch.Tensor:
        """[max_out, 6] detections of one frame, computed on the device its
        tensors are on (a host frame decodes on the CPU)."""
        ts = [_as_tensor(t).squeeze() for t in frame.tensors]
        return self._decode_fn()(ts)

    def decode(self, frame: Frame, options: dict) -> Frame:
        d = self._detections(frame).cpu().numpy()
        w, h = self._out_wh
        canvas = render.render_detections(d, w, h, self._labels)
        valid = d[d[:, 5] > 0]
        return frame.with_tensors((canvas,)).with_meta(
            media_type="video", detections=valid
        )


# The reference registers this decoder as "bounding_boxes"; keep a
# hyphenated alias for pipeline-string convenience.
registry.register(registry.KIND_DECODER, "bounding-boxes", BoundingBoxDecoder)
