"""tensor_converter: media → other/tensors ingress.

The counterpart of ``nnstreamer_tpu/elements/converter.py``:

- video, one frame a tensor: HWC uint8 → (1, H, W, C), optionally
  normalized with ``input-norm=MEAN:STD`` into float32. A TensorOp, so it
  fuses into the downstream segment: the frame crosses to the device once,
  at the segment's entry, and the reshape and normalization run there;
- video with ``frames-per-tensor=N`` > 1: N frames stacked on the device
  into (N, H, W, C) (GstAdapter batching; a partial batch at EOS is
  dropped like leftover adapter bytes);
- audio: the (samples, channels) chunk as it is, or N chunks concatenated
  along the samples;
- octet/text: the bytes framed into the ``input-dim``/``input-type``
  tensors;
- flexible → static: each tensor reshaped to the declared ``input-dim``;
- a static tensor stream passes through unchanged;
- ``mode=NAME``: a converter subplugin (converters/: flexbuf, protobuf,
  flatbuf, python3), ``mode=custom-script:<path.py>`` (python3 on that
  script) or ``mode=custom-code:<name>`` (an in-process callable
  registered with :func:`register_custom_converter`). The subplugin reads
  the input's bytes on the host, where they arrive, and its tensors cross
  to the element's device once each. The output is flexible.

All but the first and the last run per frame on the host path (a fusion
barrier), with torch ops on the pipeline's device.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Union

import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import (
    FAULT_PROPS,
    MediaSpec,
    NegotiationError,
    PropSpec,
    Spec,
    TensorOp,
    install_error_pad,
)
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import DType, TensorFormat, TensorSpec, TensorsSpec

_AUDIO_DTYPES = {"S16LE": DType.INT16, "U8": DType.UINT8, "F32LE": DType.FLOAT32}

_custom_lock = threading.Lock()
_custom_converters: Dict[str, Callable] = {}


def register_custom_converter(name: str, fn: Callable[[Frame, dict], Frame]) -> None:
    """An in-process callable ``fn(frame, props) -> Frame`` for
    ``mode=custom-code:<name>`` (the reference's
    nnstreamer_converter_custom_register); its frames are flexible
    downstream."""
    with _custom_lock:
        _custom_converters[name] = fn


def unregister_custom_converter(name: str) -> bool:
    with _custom_lock:
        return _custom_converters.pop(name, None) is not None


@registry.element("tensor_converter")
class TensorConverter(TensorOp):
    FACTORY_NAME = "tensor_converter"

    PROPERTIES = {
        "frames-per-tensor": PropSpec("int", 1, desc="batch N frames"),
        "mode": PropSpec(
            "str", None,
            desc="converter subplugin, custom-code:<name>, or custom-script:<path.py>",
        ),
        "script": PropSpec("str", None, desc="python3 subplugin script path"),
        "input-dim": PropSpec("str", None, desc="octet/text framing dims"),
        "input-type": PropSpec("str", "uint8"),
        "input-norm": PropSpec(
            "str", None,
            desc="MEAN:STD — fuse (x - MEAN)/STD uint8→float32 "
            "normalization into the ingress (video input)",
        ),
        # per-frame error policy (pipeline/faults.py)
        **FAULT_PROPS,
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.frames_per_tensor = int(self.get_property("frames-per-tensor", 1))
        if self.frames_per_tensor < 1:
            raise ValueError(
                f"{self.name}: frames-per-tensor={self.frames_per_tensor} (want >= 1)"
            )
        self.mode = self.get_property("mode")
        self.input_dims = self.get_property("input-dim")
        self.input_types = str(self.get_property("input-type", "uint8"))
        raw_norm = self.get_property("input-norm")
        self.input_norm = None
        if raw_norm:
            mean, sep, std = str(raw_norm).partition(":")
            try:
                self.input_norm = (float(mean), float(std)) if sep else None
            except ValueError:
                self.input_norm = None
            if self.input_norm is None:
                raise ValueError(
                    f"{self.name}: input-norm={raw_norm!r} (want MEAN:STD)"
                )
            if self.input_norm[1] == 0.0:
                raise ValueError(f"{self.name}: input-norm STD must be nonzero")
        self._fn = None
        self._subplugin = None
        self._custom_fn = None
        self._batch: List[torch.Tensor] = []
        self._batch_pts = None
        install_error_pad(self)

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        (spec,) = in_specs
        self._fn = None
        if self.input_norm is not None and (
            self.mode or not (isinstance(spec, MediaSpec) and spec.media_type == "video")
        ):
            # a normalization that silently did not apply would feed a model
            # unnormalized pixels; subplugin modes convert on their own terms
            raise NegotiationError(
                f"{self.name}: input-norm applies to direct video conversion "
                f"only, got mode={self.mode!r} over {spec}"
            )
        if self.mode:
            return [self._negotiate_mode(spec)]
        if isinstance(spec, MediaSpec):
            if spec.media_type == "video":
                return [self._negotiate_video(spec)]
            if spec.media_type == "audio":
                if spec.channels is None:
                    raise NegotiationError(f"{self.name}: audio channels unknown")
                # the samples a buffer are the source's to choose: a wildcard
                dt = _AUDIO_DTYPES[spec.sample_format]
                return [TensorsSpec.of(TensorSpec((None, spec.channels), dt))]
            if spec.media_type in ("octet", "text"):
                if not self.input_dims:
                    raise NegotiationError(
                        f"{self.name}: {spec.media_type} input needs input-dim="
                    )
                return [TensorsSpec.from_strings(self.input_dims, self.input_types)]
            raise NegotiationError(f"{self.name}: unsupported media {spec.media_type}")
        if isinstance(spec, TensorsSpec):
            if spec.format is TensorFormat.FLEXIBLE:
                if not self.input_dims:
                    raise NegotiationError(
                        f"{self.name}: flexible→static needs input-dim="
                    )
                return [TensorsSpec.from_strings(self.input_dims, self.input_types)]
            if spec.format is TensorFormat.STATIC:
                self._fn = lambda tensors: tuple(tensors)
                return [spec]
        raise NegotiationError(f"{self.name}: cannot convert {spec!r}")

    def _negotiate_mode(self, spec: Spec) -> TensorsSpec:
        # the subplugin reads the bytes on the host: its node takes each
        # frame where it arrives instead of moving it to the device first
        self.DEVICE_PASSTHROUGH = True
        kind, _, arg = str(self.mode).partition(":")
        if kind == "custom-code":
            with _custom_lock:
                self._custom_fn = _custom_converters.get(arg)
            if self._custom_fn is None:
                raise NegotiationError(f"{self.name}: custom converter {arg!r} not registered")
            # a callback declares no static shape: its frames describe themselves
            return TensorsSpec(format=TensorFormat.FLEXIBLE, rate=getattr(spec, "rate", None))
        if kind == "custom-script":
            # the reference's spelling of the python3 subplugin on a script
            if arg:
                self.props.setdefault("script", arg)
            self.mode = "python3"
        sub = registry.get(registry.KIND_CONVERTER, self.mode)
        self._subplugin = sub() if isinstance(sub, type) else sub
        return self._subplugin.negotiate(spec, dict(self.props))

    def _negotiate_video(self, spec: MediaSpec) -> TensorsSpec:
        if spec.width is None or spec.height is None:
            raise NegotiationError(f"{self.name}: video size unknown")
        n = self.frames_per_tensor
        dtype = DType.FLOAT32 if self.input_norm else DType.UINT8
        out = TensorSpec((n, spec.height, spec.width, spec.channels_per_pixel), dtype)
        if n == 1:  # HWC → NHWC (and the normalization) fuse downstream
            self._fn = lambda tensors: (self._norm(tensors[0][None, ...]),)
        return TensorsSpec.of(out, rate=spec.rate / n if spec.rate else None)

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        if self.input_norm is None:
            return x
        mean, std = self.input_norm
        return (x.to(torch.float32) - mean) / std

    def is_traceable(self) -> bool:
        return self._fn is not None

    def is_layout_only(self) -> bool:
        # one video frame as NHWC without normalization, or a static stream
        # passed on: a view of the input
        return self._fn is not None and self.input_norm is None

    def make_fn(self):
        return self._fn

    # -- host path: batching, audio, byte framing, flexible → static ----------
    def host_process(self, frame: Frame) -> Union[Frame, List[Frame], None]:
        if self._custom_fn is not None:
            return self._custom_fn(frame, dict(self.props)).to_device(self.device)
        if self._subplugin is not None:
            return self._subplugin.convert(frame, dict(self.props)).to_device(self.device)
        in_spec = self.in_specs[0]
        if isinstance(in_spec, MediaSpec):
            if in_spec.media_type in ("octet", "text"):
                return self._convert_octet(frame)
            # video frames stack on a new leading axis, audio chunks
            # concatenate along the samples
            video = in_spec.media_type == "video"
            (t,) = frame.tensors
            if self.frames_per_tensor == 1:
                return frame.with_tensors((t,))
            self._batch.append(t)
            if len(self._batch) == 1:
                self._batch_pts = frame.pts
            if len(self._batch) < self.frames_per_tensor:
                return None
            batch = torch.stack(self._batch) if video else torch.cat(self._batch)
            self._batch.clear()
            dur = (
                frame.duration * self.frames_per_tensor
                if frame.duration is not None else None
            )
            return Frame(
                (self._norm(batch) if video else batch,),
                pts=self._batch_pts, duration=dur, meta=dict(frame.meta),
            )
        # flexible → static: per-frame sizes checked against the declared spec
        tensors = []
        for t, s in zip(frame.tensors, self.out_specs[0]):
            if t.numel() != s.element_count:
                raise ValueError(
                    f"{self.name}: flexible frame size {t.numel()} != {s.element_count}"
                )
            tensors.append(t.reshape(s.shape).to(s.dtype.torch_dtype))
        return frame.with_tensors(tensors)

    def _convert_octet(self, frame: Frame) -> Frame:
        data = frame.tensors[0].reshape(-1)  # uint8 bytes on the device
        tensors = []
        offset = 0
        for s in self.out_specs[0]:
            n = s.byte_size
            if data.numel() - offset < n:
                raise ValueError(
                    f"{self.name}: octet frame too small ({data.numel()} bytes, "
                    f"need {offset + n})"
                )
            # a fresh copy, so the view to the wider type starts aligned
            raw = data[offset:offset + n].clone()
            tensors.append(raw.view(s.dtype.torch_dtype).reshape(s.shape))
            offset += n
        return frame.with_tensors(tensors)

    def stop(self) -> None:
        self._batch.clear()
