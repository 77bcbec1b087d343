"""Frame: the unit of data flowing through a pipeline.

The counterpart of ``nnstreamer_tpu/tensors/frame.py``. A Frame holds
``torch.Tensor``s on the pipeline's device between elements, or numpy
arrays at host edges (sources emit numpy, sinks read numpy). The move to
the device happens once per frame, at the entry of a fused segment
(:meth:`Frame.to_device`), and the move back once, at a sink
(:meth:`Frame.to_host`).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch.tensors.spec import DType, TensorsSpec

_frame_seq = itertools.count()

# Timestamps are integer nanoseconds (GStreamer GstClockTime convention).
SECOND = 1_000_000_000


def _to_numpy(t: Any, dtype: Optional[DType]) -> np.ndarray:
    """One tensor to host numpy, cast to the negotiated ``dtype``.

    Some dtypes live on the device in a wider torch type (the argmax of
    image_labeling stays int64 where the spec says uint32; torch's unsigned
    32-bit support on CUDA is thin), so the cast to the spec's type happens
    here, at the host edge. bfloat16 has no numpy type: its bits are handed
    out as uint16, which keeps the raw bytes identical."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype is torch.bfloat16:
            return t.cpu().view(torch.uint16).numpy()
        a = t.cpu().numpy()
    else:
        a = np.asarray(t)
    if dtype is not None and dtype is not DType.BFLOAT16 and a.dtype != dtype.np_dtype:
        a = a.astype(dtype.np_dtype)
    return a


@dataclass
class Frame:
    """One multi-tensor frame with stream timing and per-frame metadata.

    - ``tensors``: tuple of ``torch.Tensor`` (on the device inside the
      pipeline) or numpy arrays (at host edges). Max 16.
    - ``pts``/``duration``: presentation time in ns (None = unknown).
    - ``meta``: free-form per-frame metadata (decoders add labels here).
    """

    tensors: Tuple[Any, ...]
    pts: Optional[int] = None
    duration: Optional[int] = None
    meta: Dict[str, Any] = field(default_factory=dict)
    seq: int = field(default_factory=lambda: next(_frame_seq))

    def __post_init__(self):
        self.tensors = tuple(self.tensors)

    @property
    def num_tensors(self) -> int:
        return len(self.tensors)

    def spec(self, **kw) -> TensorsSpec:
        return TensorsSpec.from_arrays(self.tensors, **kw)

    def with_tensors(self, tensors: Sequence[Any]) -> "Frame":
        """Same timing and (shared) meta, new payload, fresh seq."""
        return replace(self, tensors=tuple(tensors), seq=next(_frame_seq))

    def with_meta(self, **kw) -> "Frame":
        m = dict(self.meta)
        m.update(kw)
        return replace(self, meta=m)

    def to_host(self, spec: Optional[TensorsSpec] = None) -> "Frame":
        """Materialize every tensor as numpy (egress boundary only), cast
        to the dtypes of ``spec`` when given."""
        dtypes = (
            [t.dtype for t in spec] if spec is not None and spec.num_tensors
            else [None] * len(self.tensors)
        )
        return self.with_tensors(
            [_to_numpy(t, d) for t, d in zip(self.tensors, dtypes)]
        )

    def to_device(self, device: torch.device) -> "Frame":
        """Place every tensor on ``device`` (ingress boundary). Host arrays
        bound for a GPU go through pinned memory with ``non_blocking=True``,
        so the copy runs on the current stream without stalling the
        host; PyTorch's pinned-memory allocator keeps the staging buffer
        alive until the copy has finished."""
        out = []
        for t in self.tensors:
            if not isinstance(t, torch.Tensor):
                t = torch.from_numpy(np.ascontiguousarray(t))
            if t.device != device:
                if device.type == "cuda" and t.device.type == "cpu":
                    t = t.pin_memory().to(device, non_blocking=True)
                else:
                    t = t.to(device)
            out.append(t)
        return self.with_tensors(out)

    def __getitem__(self, i):
        return self.tensors[i]

    def __len__(self):
        return len(self.tensors)

    def __repr__(self):
        shapes = ",".join(f"{tuple(t.shape)}:{t.dtype}" for t in self.tensors)
        return f"Frame(seq={self.seq}, pts={self.pts}, [{shapes}])"


class EOS:
    """End-of-stream sentinel pushed through queues (GStreamer EOS event)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "EOS"


EOS_FRAME = EOS()
