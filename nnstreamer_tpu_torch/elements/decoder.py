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

The reference's ``custom-code`` decoders (in-process callbacks) are not
ported yet.
"""

from __future__ import annotations

from typing import List

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import (
    NegotiationError,
    PropSpec,
    Spec,
    TensorOp,
)
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec


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
         )},
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

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        (spec,) = in_specs
        if not isinstance(spec, TensorsSpec):
            raise NegotiationError(f"{self.name}: needs tensor input, got {spec}")
        self._fn = None
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
        if self.postproc == "device":
            # a device decode that lands on the host loop serves the same
            # math per frame, so the negotiated result spec holds
            return frame.with_tensors(tuple(self._fn(frame.tensors)))
        return self._sub.decode(frame, self.options)
