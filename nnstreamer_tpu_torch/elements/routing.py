"""Routing elements: tensor_mux, tensor_demux, tensor_merge, tensor_split,
join — N↔M stream combination with timestamp sync policies.

The counterpart of ``nnstreamer_tpu/elements/routing.py``, with the same
sync rules; merge and split compute with torch on the pipeline's device.
Reference: gsttensor_mux.c / gsttensor_demux.c / gsttensor_merge.c /
gsttensor_split.c / gst/join/gstjoin.c; sync policy semantics from
Documentation/synchronization-policies-at-mux-merge.md and the shared impl
gst_tensor_time_sync_* (nnstreamer_plugin_api_impl.c:20-198).

Sync policies (sync-mode property):
- nosync  — combine in arrival order.
- slowest — output at the slowest pad's cadence: wait for every pad, take
  the largest head timestamp as base, drop older frames on faster pads.
- basepad — like slowest but one designated pad (sync-option=PAD:DURATION)
  is the base.
- refresh — emit on every new frame on any pad, reusing the last frame of
  the others.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional, Tuple

import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.elements.base import NegotiationError, PropSpec, Routing, Spec
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.spec import (
    NNS_TENSOR_SIZE_LIMIT,
    TensorSpec,
    TensorsSpec,
    parse_dimension,
)

_POLICIES = ("nosync", "slowest", "basepad", "refresh")


class SyncCombiner:
    """Shared timestamp-sync machinery for mux/merge."""

    def __init__(self, mode: str, option: str, n_pads: int) -> None:
        if mode not in _POLICIES:
            raise NegotiationError(f"unknown sync-mode {mode!r}")
        self.mode = mode
        self.n = n_pads
        self.queues: List[Deque[Frame]] = [deque() for _ in range(n_pads)]
        self.last: List[Optional[Frame]] = [None] * n_pads
        self.eos: List[bool] = [False] * n_pads
        self.base_pad = 0
        self.base_slack = 0
        if mode == "basepad" and option:
            bits = option.split(":")
            self.base_pad = int(bits[0])
            if len(bits) > 1:
                self.base_slack = int(bits[1])
        if not (0 <= self.base_pad < n_pads):
            raise NegotiationError(
                f"basepad index {self.base_pad} out of range for {n_pads} pads"
            )

    def push(self, pad: int, frame: Frame) -> List[List[Frame]]:
        """Feed one frame; return list of combined frame-groups ready."""
        if self.mode == "refresh":
            return self._refresh_push(pad, frame)
        self.queues[pad].append(frame)
        self.last[pad] = frame
        out = []
        while True:
            group = self._try_combine(pad)
            if group is None:
                break
            out.append(group)
        return out

    def mark_eos(self, pad: int) -> List[List[Frame]]:
        """A pad reached EOS; release any groups it was gating."""
        self.eos[pad] = True
        if self.mode == "refresh":
            return self._refresh_drain()
        out = []
        while True:
            group = self._try_combine(pad)
            if group is None:
                return out
            out.append(group)

    def _refresh_primed(self) -> bool:
        return all(l is not None for l in self.last)

    def _refresh_push(self, pad: int, frame: Frame) -> List[List[Frame]]:
        """SYNC_REFRESH: once every pad has delivered ("primed"), a new
        frame on ANY pad emits a group immediately, the other pads
        contributing their last (possibly stale) frame — the reference
        marks refresh collect-pads non-waiting
        (nnstreamer_plugin_api_impl.c SYNC_REFRESH pop/reuse path), so a
        fast pad is never gated on a slow one and nothing queues after
        priming (a live mixed-rate mux stays bounded at one frame per
        pad). Priming itself is PTS-merged lock-step (below) — the one
        deliberate divergence (docs/PARITY.md): the reference's pre-roll
        also waits on every pad, but in arrival order; merging by PTS
        keeps the executor's racing source threads out of golden
        outputs."""
        if self._refresh_primed():
            self.last[pad] = frame
            return [list(self.last)]
        self.queues[pad].append(frame)
        return self._refresh_drain()

    def _refresh_drain(self) -> List[List[Frame]]:
        """PTS-merged drain of queued (pre-priming) frames: pads'
        timelines merge in pts order, one group per distinct instant,
        each pad contributing its newest frame at-or-before that
        instant. Instants before every pad has delivered produce no
        output (priming); once primed, remaining queued frames emit
        per-instant without any gate."""
        out: List[List[Frame]] = []
        while True:
            if not self._refresh_primed() and any(
                not self.queues[i] and not self.eos[i] for i in range(self.n)
            ):
                return out  # still priming and a pad may yet deliver
            heads = [
                (-1 if q[0].pts is None else q[0].pts, i)
                for i, q in enumerate(self.queues)
                if q
            ]
            if not heads:
                return out
            t = min(h[0] for h in heads)
            for pts, i in heads:
                if pts == t:
                    self.last[i] = self.queues[i].popleft()
            if self._refresh_primed():
                out.append(list(self.last))

    def _try_combine(self, trigger_pad: int) -> Optional[List[Frame]]:
        if any(not q for q in self.queues):
            return None
        if self.mode == "nosync":
            return [q.popleft() for q in self.queues]
        # slowest / basepad: pick base timestamp, drop stale frames
        if self.mode == "slowest":
            base_ts = max(
                (q[0].pts for q in self.queues if q[0].pts is not None),
                default=None,
            )
        else:
            base_ts = self.queues[self.base_pad][0].pts
        if base_ts is None:
            return [q.popleft() for q in self.queues]  # untimed: arrival order
        # phase 1: drop stale frames and check viability WITHOUT popping
        # heads — an abort must leave every queue intact
        for q in self.queues:
            # drop frames that are definitely older than base (their
            # successor is still ≤ base): keeps the closest-not-newer frame
            while len(q) > 1 and q[1].pts is not None and q[1].pts <= base_ts:
                q.popleft()
            head = q[0]
            # basepad's DURATION option widens the match window: a head
            # within [base_ts - slack, base_ts] pairs immediately instead of
            # waiting for a closer frame (reference
            # gst_tensor_time_sync_buffer duration-window matching).
            if (
                head.pts is not None
                and head.pts < base_ts - self.base_slack
                and len(q) <= 1
            ):
                # not enough data to know if a closer frame is coming
                return None
        # phase 2: all pads viable — pop the group atomically
        return [q.popleft() for q in self.queues]


def _combined_pts(group: List[Frame]) -> Tuple[Optional[int], Optional[int]]:
    pts = max((f.pts for f in group if f.pts is not None), default=None)
    dur = group[0].duration
    return pts, dur


def _combined_rate(mode: str, base_pad: int, in_specs):
    """Output cadence by sync policy: slowest → min pad rate, basepad → the
    base pad's rate, refresh → max (emits per any new frame), nosync →
    first known."""
    rates = [s.rate for s in in_specs if getattr(s, "rate", None) is not None]
    if not rates:
        return None
    if mode == "slowest":
        return min(rates)
    if mode == "basepad":
        return getattr(in_specs[base_pad], "rate", None) or rates[0]
    if mode == "refresh":
        return max(rates)
    return rates[0]


@registry.element("tensor_mux")
class TensorMux(Routing):
    """N × other/tensors → 1 frame with the tensor lists concatenated
    (num_tensors grows; reference gsttensor_mux.c)."""

    FACTORY_NAME = "tensor_mux"
    N_SINKS = None
    N_SRCS = 1

    PROPERTIES = {
        "sync-mode": PropSpec(
            "enum", "slowest", ("nosync", "slowest", "basepad", "refresh")
        ),
        "sync-option": PropSpec(
            "str", "", desc="basepad: 'PAD' or 'PAD:DURATION' slack"
        ),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.sync_mode = str(self.get_property("sync-mode", "slowest"))
        self.sync_option = str(self.get_property("sync-option", ""))
        self._comb: Optional[SyncCombiner] = None

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        tensors: List[TensorSpec] = []
        for s in in_specs:
            if not isinstance(s, TensorsSpec):
                raise NegotiationError(f"{self.name}: non-tensor input {s}")
            tensors.extend(s.tensors)
        if len(tensors) > NNS_TENSOR_SIZE_LIMIT:
            raise NegotiationError(
                f"{self.name}: combined {len(tensors)} tensors exceeds limit"
            )
        self._comb = SyncCombiner(self.sync_mode, self.sync_option, self._n_sinks)
        rate = _combined_rate(self.sync_mode, self._comb.base_pad, in_specs)
        return [TensorsSpec(tuple(tensors), rate=rate)]

    def _frames(self, groups) -> List[Tuple[int, Frame]]:
        out = []
        for group in groups:
            tensors = tuple(t for f in group for t in f.tensors)
            pts, dur = _combined_pts(group)
            meta = {}
            for f in group:
                meta.update(f.meta)
            out.append((0, Frame(tensors, pts=pts, duration=dur, meta=meta)))
        return out

    def receive(self, pad: int, frame: Frame) -> List[Tuple[int, Frame]]:
        return self._frames(self._comb.push(pad, frame))

    def eos(self, pad: int) -> List[Tuple[int, Frame]]:
        # refresh groups gated on this pad having data release at its EOS
        return self._frames(self._comb.mark_eos(pad))


@registry.element("tensor_merge")
class TensorMerge(Routing):
    """N single-tensor streams → 1 tensor concatenated along a dimension
    (mode=linear option=<ref dim index>; reference gsttensor_merge.c)."""

    FACTORY_NAME = "tensor_merge"
    N_SINKS = None
    N_SRCS = 1

    PROPERTIES = {
        "mode": PropSpec("enum", "linear", ("linear",)),
        "option": PropSpec("int", 0, desc="reference dim index to merge on"),
        "sync-mode": PropSpec(
            "enum", "slowest", ("nosync", "slowest", "basepad", "refresh")
        ),
        "sync-option": PropSpec(
            "str", "", desc="basepad: 'PAD' or 'PAD:DURATION' slack"
        ),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        mode = str(self.get_property("mode", "linear"))
        if mode != "linear":
            raise ValueError(f"{self.name}: only mode=linear supported, got {mode}")
        self.ref_dim = int(self.get_property("option", 0))
        self.sync_mode = str(self.get_property("sync-mode", "slowest"))
        self.sync_option = str(self.get_property("sync-option", ""))
        self._comb: Optional[SyncCombiner] = None
        self._axis: int = 0

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        specs: List[TensorSpec] = []
        for s in in_specs:
            if not isinstance(s, TensorsSpec) or s.num_tensors != 1:
                raise NegotiationError(
                    f"{self.name}: each input must be a single tensor, got {s}"
                )
            specs.append(s[0])
        rank = specs[0].rank
        self._axis = rank - 1 - self.ref_dim
        if not (0 <= self._axis < rank):
            raise NegotiationError(f"{self.name}: merge dim {self.ref_dim} out of range")
        base = list(specs[0].shape)
        total = 0
        for t in specs:
            if t.rank != rank or t.dtype != specs[0].dtype:
                raise NegotiationError(f"{self.name}: incompatible inputs")
            for ax in range(rank):
                if ax != self._axis and t.shape[ax] != base[ax]:
                    raise NegotiationError(
                        f"{self.name}: shape mismatch on non-merge axis {ax}"
                    )
            total += t.shape[self._axis]
        base[self._axis] = total
        self._comb = SyncCombiner(self.sync_mode, self.sync_option, self._n_sinks)
        rate = _combined_rate(self.sync_mode, self._comb.base_pad, in_specs)
        return [TensorsSpec.of(TensorSpec(tuple(base), specs[0].dtype), rate=rate)]

    def _frames(self, groups) -> List[Tuple[int, Frame]]:
        out = []
        for group in groups:
            merged = torch.cat(
                [f.to_device(self.device).tensors[0] for f in group], dim=self._axis
            )
            pts, dur = _combined_pts(group)
            out.append((0, Frame((merged,), pts=pts, duration=dur)))
        return out

    def receive(self, pad: int, frame: Frame) -> List[Tuple[int, Frame]]:
        return self._frames(self._comb.push(pad, frame))

    def eos(self, pad: int) -> List[Tuple[int, Frame]]:
        return self._frames(self._comb.mark_eos(pad))


@registry.element("tensor_demux")
class TensorDemux(Routing):
    """1 multi-tensor stream → N streams. tensorpick selects/reorders:
    'tensorpick=0,2' or grouped 'tensorpick=0:1,2' (reference
    gsttensor_demux.c)."""

    FACTORY_NAME = "tensor_demux"
    N_SINKS = 1
    N_SRCS = None

    PROPERTIES = {
        "tensorpick": PropSpec(
            "str", "", desc="select/reorder: '0,2' or grouped '0:1,2'"
        ),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        pick = str(self.get_property("tensorpick", ""))
        self.picks: Optional[List[List[int]]] = None
        if pick:
            self.picks = [
                [int(x) for x in grp.split(":")] for grp in pick.split(",") if grp
            ]

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        (spec,) = in_specs
        if not isinstance(spec, TensorsSpec):
            raise NegotiationError(f"{self.name}: needs tensor input")
        picks = self.picks or [[i] for i in range(spec.num_tensors)]
        if len(picks) != self._n_srcs:
            raise NegotiationError(
                f"{self.name}: {len(picks)} pick groups vs {self._n_srcs} linked pads"
            )
        outs = []
        for grp in picks:
            for i in grp:
                if i >= spec.num_tensors:
                    raise NegotiationError(f"{self.name}: pick {i} out of range")
            outs.append(
                TensorsSpec(tuple(spec[i] for i in grp), spec.format, spec.rate)
            )
        self._resolved_picks = picks
        return outs

    def receive(self, pad: int, frame: Frame) -> List[Tuple[int, Frame]]:
        return [
            (p, frame.with_tensors([frame.tensors[i] for i in grp]))
            for p, grp in enumerate(self._resolved_picks)
        ]


@registry.element("tensor_split")
class TensorSplit(Routing):
    """1 tensor → N tensors split along a dim. tensorseg gives per-output
    sizes along the split axis: 'tensorseg=2:4:4:1,1:4:4:1' (reference
    gsttensor_split.c)."""

    FACTORY_NAME = "tensor_split"
    N_SINKS = 1
    N_SRCS = None

    PROPERTIES = {
        "tensorseg": PropSpec(
            "str", None, desc="per-output dims along the split axis"
        ),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        seg = str(self.get_property("tensorseg", ""))
        if not seg:
            raise ValueError(f"{self.name}: tensor_split needs tensorseg=")
        self.segs = [parse_dimension(s) for s in seg.split(",") if s]

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        (spec,) = in_specs
        if not isinstance(spec, TensorsSpec) or spec.num_tensors != 1:
            raise NegotiationError(f"{self.name}: needs a single-tensor input")
        t = spec[0]
        if len(self.segs) != self._n_srcs:
            raise NegotiationError(
                f"{self.name}: {len(self.segs)} segments vs {self._n_srcs} pads"
            )
        # find the split axis: the one where segment sizes sum to the input
        rank = t.rank
        axis = None
        for ax in range(rank):
            if all(len(s) == rank for s in self.segs) and sum(
                s[ax] for s in self.segs
            ) == t.shape[ax] and all(
                s[a2] == t.shape[a2] for s in self.segs for a2 in range(rank) if a2 != ax
            ):
                axis = ax
                break
        if axis is None:
            raise NegotiationError(
                f"{self.name}: tensorseg {self.segs} does not tile input {t.shape}"
            )
        self._axis = axis
        self._sizes = [s[axis] for s in self.segs]
        return [
            TensorsSpec.of(TensorSpec(tuple(s), t.dtype), rate=spec.rate)
            for s in self.segs
        ]

    def receive(self, pad: int, frame: Frame) -> List[Tuple[int, Frame]]:
        x = frame.to_device(self.device).tensors[0]
        parts = torch.split(x, self._sizes, dim=self._axis)  # views, no copy
        return [(p, frame.with_tensors((t,))) for p, t in enumerate(parts)]


@registry.element("join")
class Join(Routing):
    """N→1 first-come-forward (no sync): whichever pad delivers, forwards.
    For exclusive branches after tensor_if (reference gst/join/gstjoin.c —
    unlike funnel, only the active branch forwards; here branches are
    exclusive by construction when upstream used SKIP actions)."""

    FACTORY_NAME = "join"
    N_SINKS = None
    N_SRCS = 1

    def negotiate(self, in_specs: List[Spec]) -> List[Spec]:
        first = in_specs[0]
        for s in in_specs[1:]:
            if isinstance(first, TensorsSpec) and isinstance(s, TensorsSpec):
                if not first.is_compatible(s):
                    raise NegotiationError(
                        f"{self.name}: branch specs differ: {first} vs {s}"
                    )
        return [first]

    def receive(self, pad: int, frame: Frame) -> List[Tuple[int, Frame]]:
        return [(0, frame)]
