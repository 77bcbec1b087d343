"""Control-flow elements: tensor_if (data-dependent branch), tensor_crop
(crop by a region stream), tensor_repo{sink,src} (feedback loops).

The counterpart of ``nnstreamer_tpu/elements/control.py``. Reference:
gsttensor_if.c (compared-value/operator/actions, gsttensor_if.h:79-90 +
custom cb include/tensor_if.h), gsttensor_crop.c (crop a raw stream by
another stream's region tensors, flexible output), gsttensor_repo{,sink,
src}.c (slot-indexed global repository enabling RNN/LSTM cycles outside
the pad graph).

tensor_if reads one small value a frame to the host (the compared scalar);
the payload stays where it is. tensor_crop's ``out-size=`` mode reads
nothing: it crops on the device through K1's crop entry.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import (
    HostElement,
    NegotiationError,
    PropSpec,
    Routing,
    Sink,
    Source,
    Spec,
)
from nnstreamer_tpu_torch.ops.image import crop_regions
from nnstreamer_tpu_torch.tensors import data as tdata
from nnstreamer_tpu_torch.tensors.frame import EOS_FRAME, Frame
from nnstreamer_tpu_torch.tensors.spec import TensorFormat, TensorSpec, TensorsSpec

# ---------------------------------------------------------------------------
# tensor_if

_if_custom_lock = threading.Lock()
_if_custom: Dict[str, Callable] = {}


def register_if_condition(name: str, fn: Callable[[Frame], bool]) -> None:
    """nnstreamer_if_custom_register analogue (include/tensor_if.h:30-37)."""
    with _if_custom_lock:
        _if_custom[name] = fn


def unregister_if_condition(name: str) -> bool:
    with _if_custom_lock:
        return _if_custom.pop(name, None) is not None


_OPERATORS = (
    "EQ", "NE", "GT", "GE", "LT", "LE",
    "RANGE_INCLUSIVE", "RANGE_EXCLUSIVE",
    "NOT_IN_RANGE_INCLUSIVE", "NOT_IN_RANGE_EXCLUSIVE",
)
_ACTIONS = (
    "PASSTHROUGH", "SKIP", "FILL_ZERO", "FILL_VALUES",
    "FILL_WITH_FILE", "FILL_WITH_FILE_RPT",
    "REPEAT_PREVIOUS_FRAME", "TENSORPICK",
)


@registry.element("tensor_if")
class TensorIf(HostElement):
    """Per-frame predicate with then/else actions (single src pad; build
    exclusive branches with two complementary tensor_if + join, as the
    reference does).

    Props: compared-value {A_VALUE, TENSOR_AVERAGE_VALUE, CUSTOM},
    compared-value-option (A_VALUE: 'D1:D2:D3:D4,N' innermost-first coords
    + tensor index; TENSOR_AVERAGE_VALUE: tensor index; CUSTOM: registered
    name), operator (10 ops), supplied-value 'V' or 'V1:V2' (ranges),
    then / then-option, else / else-option.
    """

    FACTORY_NAME = "tensor_if"

    PROPERTIES = {
        "compared-value": PropSpec(
            "enum", "A_VALUE",
            ("A_VALUE", "TENSOR_AVERAGE_VALUE", "CUSTOM"),
        ),
        "compared-value-option": PropSpec("str", "0,0"),
        "operator": PropSpec("str", "GT", desc="EQ/NE/GT/GE/LT/LE/..."),
        "supplied-value": PropSpec("str", "0", desc="'V' or 'V1:V2' range"),
        "then": PropSpec("str", "PASSTHROUGH"),
        "then-option": PropSpec("str", ""),
        "else": PropSpec("str", "SKIP"),
        "else-option": PropSpec("str", ""),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.cv = str(self.get_property("compared-value", "A_VALUE")).upper()
        self.cv_option = str(self.get_property("compared-value-option", "0,0"))
        self.operator = str(self.get_property("operator", "GT")).upper()
        sv = str(self.get_property("supplied-value", "0"))
        self.supplied = [float(x) for x in sv.split(":") if x != ""]
        self.then_action = str(self.get_property("then", "PASSTHROUGH")).upper()
        self.then_option = str(self.get_property("then-option", ""))
        self.else_action = str(self.get_property("else", "SKIP")).upper()
        self.else_option = str(self.get_property("else-option", ""))
        if self.operator not in _OPERATORS:
            raise ValueError(f"{self.name}: unknown operator {self.operator}")
        for a in (self.then_action, self.else_action):
            if a not in _ACTIONS:
                raise ValueError(f"{self.name}: unknown action {a}")
        self._prev: Optional[Frame] = None
        self._skipped = 0
        self._file_cache: dict = {}

    def _file_blob(self, path: str) -> bytes:
        if not path:
            raise RuntimeError(
                f"{self.name}: FILL_WITH_FILE needs then/else-option=<path>"
            )
        blob = self._file_cache.get(path)
        if blob is None:
            try:
                with open(path, "rb") as f:
                    blob = f.read()
            except OSError as exc:
                raise RuntimeError(
                    f"{self.name}: cannot read fill file {path}: {exc}"
                ) from exc
            self._file_cache[path] = blob
        return blob

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        (spec,) = in_specs
        if not isinstance(spec, TensorsSpec):
            raise NegotiationError(f"{self.name}: needs tensor input")
        # TENSORPICK changes the output tensor list; both branches must
        # agree on the spec, so TENSORPICK output spec = picked subset and
        # the other branch must be SKIP (reference restriction)
        then_a, else_a = self.then_action, self.else_action
        if "TENSORPICK" in (then_a, else_a):
            if then_a == "TENSORPICK" and else_a == "TENSORPICK":
                if self.then_option != self.else_option:
                    raise NegotiationError(
                        f"{self.name}: then/else TENSORPICK options must match "
                        "(both branches share one output spec)"
                    )
            else:
                other = else_a if then_a == "TENSORPICK" else then_a
                if other != "SKIP":
                    raise NegotiationError(
                        f"{self.name}: TENSORPICK pairs only with SKIP or an "
                        "identical TENSORPICK"
                    )
            option = self.then_option if then_a == "TENSORPICK" else self.else_option
            picks = [int(x) for x in option.split(",") if x != ""]
            return [
                TensorsSpec(tuple(spec[i] for i in picks), spec.format, spec.rate)
            ]
        return [spec]

    # -- predicate ---------------------------------------------------------
    def _compared_value(self, frame: Frame) -> float:
        # one scalar crosses to the host; the payload stays on the device
        if self.cv == "A_VALUE":
            bits = self.cv_option.split(",")
            coords_ref = [int(x) for x in bits[0].split(":")] if bits[0] else [0]
            nth = int(bits[1]) if len(bits) > 1 else 0
            a = frame.tensors[nth]
            coords = tuple(reversed(coords_ref))  # innermost-first → canonical
            # pad missing leading coords with 0
            while len(coords) < a.ndim:
                coords = (0,) + coords
            if len(coords) > a.ndim:
                # reference pipelines always pass 4 coords (fixed uint32[4]
                # dims); excess *leading* (outermost) coords address the
                # padded 1-sized dims — valid only when 0
                extra, coords = coords[: len(coords) - a.ndim], coords[-a.ndim:]
                if any(c != 0 for c in extra):
                    raise RuntimeError(
                        f"{self.name}: compared-value-option coords "
                        f"{coords_ref} out of range for rank-{a.ndim} tensor"
                    )
            return float(a[coords])
        if self.cv == "TENSOR_AVERAGE_VALUE":
            # option = tensor index; tolerate the A_VALUE-style default
            # ("coords,N") an unset option falls back to
            nth = int((self.cv_option or "0").split(",")[-1])
            t = frame.tensors[nth]
            if isinstance(t, torch.Tensor):
                # reduce where the tensor is, accumulating in float64 as
                # the host path does (gst_tensor_data_raw_average)
                return float(t.to(torch.float64).mean())
            return tdata.tensor_average(t)
        if self.cv == "CUSTOM":
            with _if_custom_lock:
                fn = _if_custom.get(self.cv_option)
            if fn is None:
                raise RuntimeError(
                    f"{self.name}: custom condition {self.cv_option!r} not registered"
                )
            return fn(frame)
        raise RuntimeError(f"{self.name}: unknown compared-value {self.cv}")

    def _test(self, v: float) -> bool:
        op = self.operator
        s = self.supplied
        if op in ("EQ", "NE", "GT", "GE", "LT", "LE"):
            return tdata.compare(v, op, s[0])
        if len(s) < 2:
            raise RuntimeError(f"{self.name}: range operator needs 'V1:V2'")
        lo, hi = min(s[0], s[1]), max(s[0], s[1])
        if op == "RANGE_INCLUSIVE":
            return lo <= v <= hi
        if op == "RANGE_EXCLUSIVE":
            return lo < v < hi
        if op == "NOT_IN_RANGE_INCLUSIVE":
            return not (lo <= v <= hi)
        if op == "NOT_IN_RANGE_EXCLUSIVE":
            return not (lo < v < hi)
        raise AssertionError(op)

    # -- actions -----------------------------------------------------------
    def _apply(self, frame: Frame, action: str, option: str) -> Optional[Frame]:
        if action == "PASSTHROUGH":
            return frame
        if action == "SKIP":
            return None
        if action == "TENSORPICK":
            picks = [int(x) for x in option.split(",") if x != ""]
            return frame.with_tensors([frame.tensors[i] for i in picks])
        if action == "REPEAT_PREVIOUS_FRAME" and self._prev is not None:
            return self._prev.with_pts(frame.pts, frame.duration)
        # the fills make new tensors of the input's shape and dtype, on
        # the pipeline's device
        src = frame.to_device(self.device).tensors
        if action in ("FILL_ZERO", "REPEAT_PREVIOUS_FRAME"):
            return frame.with_tensors([torch.zeros_like(t) for t in src])
        if action == "FILL_VALUES":
            val = float(option or 0)
            return frame.with_tensors([torch.full_like(t, val) for t in src])
        if action in ("FILL_WITH_FILE", "FILL_WITH_FILE_RPT"):
            # reference gsttensor_if.h: replace payload with file content;
            # plain variant zero-pads a short file, _RPT repeats it
            blob = self._file_blob(option)
            outs = []
            for t in src:
                n = t.numel() * t.element_size()
                if action.endswith("_RPT") and blob:
                    raw = (blob * (-(-n // len(blob))))[:n]
                else:
                    raw = blob[:n].ljust(n, b"\0")
                filled = torch.frombuffer(bytearray(raw), dtype=t.dtype) if n else t.new_empty(0)
                outs.append(filled.reshape(t.shape).to(t.device))
            return frame.with_tensors(outs)
        raise AssertionError(action)

    def process(self, frame: Frame) -> Optional[Frame]:
        cond = self._test(self._compared_value(frame)) if self.cv != "CUSTOM" else bool(
            self._compared_value(frame)
        )
        action, option = (
            (self.then_action, self.then_option)
            if cond
            else (self.else_action, self.else_option)
        )
        out = self._apply(frame, action, option)
        # Reference semantics (gsttensor_if.h): REPEAT_PREVIOUS_FRAME resends
        # the previous *output* frame, so remember what was emitted, not what
        # arrived.
        if out is not None:
            self._prev = out
        else:
            self._skipped += 1
        return out

    def drop_stats(self) -> dict:
        """Frame-accounting surface (Executor.totals)."""
        return {"if-skip": self._skipped}


# ---------------------------------------------------------------------------
# tensor_crop

@registry.element("tensor_crop")
class TensorCrop(Routing):
    """Crop a raw tensor stream by a region stream.

    sink 0 = raw (N,H,W,C); sink 1 = regions, flexible or static tensor of
    shape (num_objects, 4) with [x, y, w, h] per object (reference
    gsttensor_crop.c info format). Frames pair by arrival order (the
    reference pairs corresponding buffers the same way). Two modes:

    - default: variable-size exact-pixel crops, one tensor per region
      (views of the raw tensor, where it is), format=flexible output.
      The regions are read to the host to slice.
    - ``out-size=W:H`` (+ ``max-crops=K``, default 16): crops on the
      device through K1's crop entry (ops/image.crop_regions), every
      region mapped to a [K, H, W, C] batch. The output spec is static;
      regions are padded or cut to K, zero-size regions give zero rows,
      and the regions ride on in ``meta["crop_regions"]`` as an int32
      device tensor. Nothing is read to the host: padding and the valid
      mask are tensor ops, so the crop is no sync point.
    """

    FACTORY_NAME = "tensor_crop"
    N_SINKS = 2
    N_SRCS = 1

    PROPERTIES = {
        "out-size": PropSpec(
            "str", "", desc="'W:H' enables device-resident crop batch"
        ),
        "max-crops": PropSpec("int", 16),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._raw: deque = deque()
        self._info: deque = deque()
        out_size = str(self.get_property("out-size", "") or "")
        self.out_size: Optional[Tuple[int, int]] = None
        if out_size:
            w, _, h = out_size.partition(":")
            self.out_size = (int(w), int(h or w))  # (W, H)
        self.max_crops = int(self.get_property("max-crops", 16))

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        raw, info = in_specs
        if not isinstance(raw, TensorsSpec) or raw.num_tensors != 1:
            raise NegotiationError(f"{self.name}: raw input must be one tensor")
        if raw[0].rank != 4:
            raise NegotiationError(f"{self.name}: raw must be NHWC, got {raw[0]}")
        if self.out_size is None:
            return [TensorsSpec(format=TensorFormat.FLEXIBLE, rate=raw.rate)]
        # device mode: static [K, outH, outW, C] spec — downstream
        # negotiates (and compiles) once
        if raw[0].shape[0] not in (1, None):
            raise NegotiationError(
                f"{self.name}: out-size mode crops one image per frame "
                f"(raw batch {raw[0].shape[0]})"
            )
        ow, oh = self.out_size
        out = TensorSpec((self.max_crops, oh, ow, raw[0].shape[3]), raw[0].dtype)
        return [TensorsSpec.of(out, rate=raw.rate)]

    def receive(self, pad: int, frame: Frame) -> List[Tuple[int, Frame]]:
        (self._raw if pad == 0 else self._info).append(frame)
        out = []
        while self._raw and self._info:
            rf = self._raw.popleft()
            inf = self._info.popleft()
            crop = self._crop_device if self.out_size else self._crop_host
            out.append((0, crop(rf, inf)))
        return out

    def _device_boxes(self, boxes) -> torch.Tensor:
        """Regions as float32 [N, 4] on the device. Host regions (an
        appsrc) are cast on the host and copied up once; device regions
        (a detector's output) stay there."""
        if isinstance(boxes, torch.Tensor):
            return boxes.to(self.device).reshape(-1, 4).to(torch.float32)
        b = torch.from_numpy(np.array(boxes, np.float32).reshape(-1, 4))
        if self.device.type == "cuda":
            return b.pin_memory().to(self.device, non_blocking=True)
        return b

    def _crop_device(self, raw: Frame, info: Frame) -> Frame:
        with torch.inference_mode():
            img = raw.to_device(self.device).tensors[0][0]  # [H, W, C]
            b = self._device_boxes(info.tensors[0])
            k, n = self.max_crops, b.shape[0]
            b = b[:k] if n >= k else F.pad(b, (0, 0, 0, k - n))
            xyxy = torch.cat([b[:, :2], b[:, :2] + b[:, 2:4]], dim=-1)
            ow, oh = self.out_size
            # zero-size regions → zeroed rows, integer round+clip: the
            # tensor_crop conventions of ops/image.crop_regions
            crops = crop_regions(
                img, xyxy, oh, ow, valid=(b[:, 2] > 0) & (b[:, 3] > 0)
            )
        meta = dict(raw.meta)
        meta["crop_regions"] = b.to(torch.int32)  # stays on the device
        return Frame((crops,), pts=raw.pts, duration=raw.duration, meta=meta)

    def _crop_host(self, raw: Frame, info: Frame) -> Frame:
        img = raw.tensors[0]  # NHWC, where it is
        boxes = info.tensors[0]
        if isinstance(boxes, torch.Tensor):
            boxes = boxes.cpu().numpy()
        boxes = np.asarray(boxes).reshape(-1, 4).astype(np.int64)
        _, h, w, _ = img.shape
        crops = []
        for x, y, bw, bh in boxes[:16]:  # max 16 tensors per frame
            x0, y0 = max(0, int(x)), max(0, int(y))
            x1, y1 = min(w, int(x) + int(bw)), min(h, int(y) + int(bh))
            if x1 <= x0 or y1 <= y0:
                continue
            crops.append(img[:, y0:y1, x0:x1, :])
        return Frame(
            tuple(crops), pts=raw.pts, duration=raw.duration, meta=dict(raw.meta)
        )


# ---------------------------------------------------------------------------
# tensor_repo: feedback loops

class _RepoSlot:
    def __init__(self) -> None:
        self.cond = threading.Condition()
        self.frame: Optional[Frame] = None
        self.eos = False


class _TensorRepo:
    """Global slot-indexed frame repository (gsttensor_repo.c)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._slots: Dict[int, _RepoSlot] = {}

    def slot(self, index: int) -> _RepoSlot:
        with self._lock:
            if index not in self._slots:
                self._slots[index] = _RepoSlot()
            return self._slots[index]

    def set(self, index: int, frame: Optional[Frame], eos: bool = False) -> None:
        s = self.slot(index)
        with s.cond:
            if frame is not None:
                s.frame = frame
            if eos:
                s.eos = True
            s.cond.notify_all()

    def get(self, index: int, timeout: float) -> Tuple[Optional[Frame], bool]:
        s = self.slot(index)
        with s.cond:
            if s.frame is None and not s.eos:
                s.cond.wait(timeout)
            f, s.frame = s.frame, None
            return f, s.eos

    def reset(self, index: int) -> None:
        with self._lock:
            self._slots.pop(index, None)


REPO = _TensorRepo()


@registry.element("tensor_reposink")
class TensorRepoSink(Sink):
    """Write frames into a repo slot (slot-index=N)."""

    FACTORY_NAME = "tensor_reposink"
    # the repo keeps frames where they are: a reposrc loop stays on the device
    READS_HOST = False

    PROPERTIES = {
        "slot-index": PropSpec("int", 0),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.slot_index = int(self.get_property("slot-index", 0))

    def render(self, frame: Frame) -> None:
        REPO.set(self.slot_index, frame)

    def on_eos(self) -> None:
        REPO.set(self.slot_index, None, eos=True)


@registry.element("tensor_reposrc")
class TensorRepoSrc(Source):
    """Read frames from a repo slot. Emits one zero frame first when the
    slot is empty (bootstrap for RNN-style cycles, reference reposrc dummy
    buffer). Props: slot-index, dimensions, types."""

    FACTORY_NAME = "tensor_reposrc"

    PROPERTIES = {
        "slot-index": PropSpec("int", 0),
        "dimensions": PropSpec("str", "1"),
        "types": PropSpec("str", "float32"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.slot_index = int(self.get_property("slot-index", 0))
        self.spec = TensorsSpec.from_strings(
            str(self.get_property("dimensions", "1")),
            str(self.get_property("types", "float32")),
        )
        self._bootstrapped = False

    def output_spec(self) -> Spec:
        return self.spec

    def start(self) -> None:
        self._bootstrapped = False

    def generate(self):
        if not self._bootstrapped:
            self._bootstrapped = True
            return Frame(
                tuple(np.zeros(t.shape, t.dtype.np_dtype) for t in self.spec)
            )
        frame, eos = REPO.get(self.slot_index, timeout=0.1)
        if frame is not None:
            return frame
        if eos:
            return EOS_FRAME
        return None  # poll again (keeps stop event responsive)
