"""tensor_decoder: tensor → result egress.

The counterpart of ``nnstreamer_tpu/elements/decoder.py``: dispatches to
decoder subplugins by ``mode=`` with ``option1..option9`` strings.
Subplugins are objects with ``negotiate(in_spec, options) -> Spec`` and
``decode(frame, options) -> Frame``. Where the decode math runs is the
``postproc`` property:

- ``auto`` (default): a subplugin that exposes ``make_fn(in_spec,
  options)`` returning a function over device tensors fuses into the
  upstream segment (image_labeling's argmax without a labels file: the
  egress payload shrinks to [N] indices on the device); any other decode
  runs as a host node;
- ``device``: the subplugin's ``device_decode(in_spec, options)`` gives
  the negotiated result tensor spec and its function, which fuses (a
  bounding-box decode emits the [max_out, 6] detections tensor instead of
  an RGBA overlay); a mode without one fails negotiation;
- ``host``: never fuses.

``mode=custom-code option1=<name>`` calls an in-process callback
registered with :func:`register_custom_decoder` (the reference's
tensor_decoder_custom.h): a host callback, given the frame with numpy
tensors and returning the output frame; it declares no static output spec,
and ``postproc=device`` is refused at negotiation. The decoder takes the
per-frame error policy (``on-error``, pipeline/faults.py).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import (
    FAULT_PROPS,
    NegotiationError,
    PropSpec,
    Spec,
    TensorOp,
    install_error_pad,
)
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec

_custom_lock = threading.Lock()
_custom_decoders: Dict[str, Callable] = {}


def register_custom_decoder(name: str, fn: Callable[[Frame, dict], Frame]) -> None:
    """Register ``fn(frame, options) -> frame`` under ``name`` for
    ``mode=custom-code option1=<name>``."""
    with _custom_lock:
        _custom_decoders[name] = fn


def unregister_custom_decoder(name: str) -> bool:
    with _custom_lock:
        return _custom_decoders.pop(name, None) is not None


@registry.element("tensor_decoder")
class TensorDecoder(TensorOp):
    FACTORY_NAME = "tensor_decoder"

    PROPERTIES = dict(
        {"mode": PropSpec("str", None, desc="decoder subplugin name"),
         "postproc": PropSpec(
             "enum", "auto", ("auto", "device", "host"),
             desc="where the decode math runs: device = fuse the "
             "subplugin's tensor math into the adjacent segment and emit "
             "the structured result tensor (no host rasterization); host = "
             "force the host node; auto = fuse only decodes whose "
             "negotiated output is already a tensor (e.g. image_labeling)",
         ),
         **FAULT_PROPS},
        **{
            f"option{i}": PropSpec("str", "", desc="mode-specific option")
            for i in range(1, 10)
        },
    )

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.mode = str(self.get_property("mode", ""))
        self.postproc = str(self.get_property("postproc", "auto")).lower()
        if self.postproc not in ("auto", "device", "host"):
            raise ValueError(
                f"{self.name}: postproc={self.postproc!r} not auto/device/host"
            )
        if not self.mode:
            raise ValueError(f"{self.name}: tensor_decoder needs mode=")
        self.options = {
            f"option{i}": str(self.get_property(f"option{i}", "")) for i in range(1, 10)
        }
        self._sub = None
        self._fn = None
        self._custom_fn = None
        install_error_pad(self)

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        (spec,) = in_specs
        if not isinstance(spec, TensorsSpec):
            raise NegotiationError(f"{self.name}: needs tensor input, got {spec}")
        self._fn = None
        if self.mode == "custom-code":
            if self.postproc == "device":
                raise NegotiationError(
                    f"{self.name}: custom-code decoders are host callbacks; "
                    "postproc=device cannot run them on the device")
            name = self.options["option1"]
            with _custom_lock:
                fn = _custom_decoders.get(name)
            if fn is None:
                raise NegotiationError(f"{self.name}: custom decoder {name!r} not registered")
            self._custom_fn = fn
            return [spec]  # a custom decoder declares no static output spec
        sub = registry.get(registry.KIND_DECODER, self.mode)
        self._sub = sub() if isinstance(sub, type) else sub
        if self.postproc == "device":
            dd = getattr(self._sub, "device_decode", None)
            got = dd(spec, self.options) if dd is not None else None
            if got is None:
                raise NegotiationError(
                    f"{self.name}: mode {self.mode!r} (with these options) has "
                    "no device decode path; use postproc=host"
                )
            out_spec, self._fn = got
            return [out_spec]
        out = [self._sub.negotiate(spec, self.options)]
        mk = getattr(self._sub, "make_fn", None)
        if self.postproc != "host" and mk is not None:
            self._fn = mk(spec, self.options)
        return out

    def is_traceable(self) -> bool:
        return self._fn is not None

    def make_fn(self):
        return self._fn

    def host_process(self, frame: Frame) -> Frame:
        if self._custom_fn is not None:
            return self._custom_fn(frame.to_host(), self.options)
        if self.postproc == "device":
            # a device decode that lands on the host loop serves the same
            # math per frame, so the negotiated result spec holds
            return frame.with_tensors(tuple(self._fn(frame.tensors)))
        return self._sub.decode(frame, self.options)
