"""Streaming executor: one thread per node, bounded per-pad queues.

The counterpart of ``nnstreamer_tpu/pipeline/executor.py`` with five node
kinds: sources, segments (a fused chain of TensorOps, or one TensorOp on
the host path), host elements, routing elements and sinks (GStreamer's
streaming-thread model: pipeline parallelism across nodes, backpressure
through the bounded queues). A source thread generates host frames, a
segment thread moves each frame to the device and queues its work there,
and a sink thread waits for the results and renders them, so the host work
of frame N+1 overlaps the device work of frame N.

Every node has one inbox per sink pad. A node's src pad fans out to every
link of that pad (``outs[pad] → [(node, dst_pad)]``); a frame sent down
two links is the same object on both, so no element writes its input in
place. A routing node drains all of its pads in turn and sleeps until a
producer notifies it, so a fan-in (tee → two queues → mux) never waits on
one pad while the other's inbox is full. EOS leaves a node on every src
pad, and a routing node sends it only after every sink pad saw it.

A segment node with micro-batching active (pipeline/batching.py) collects
a window of queued frames and runs it as one program. Every fused
segment's negotiated program is built in :meth:`Executor.start`, before
any node thread starts (on CUDA: captured as a CUDA graph).

Streaming (pipeline/transfer.py). A device node keeps its output frames in
an in-flight ring (:class:`_FrameRing`, depth ``ring-depth`` /
``[executor] ring_depth``, 2 by default on a fused segment): it submits
frame N and delivers the oldest only once the ring is full, an idle inbox
or EOS flushes it, so the host work of frame N+1 overlaps the device work
of N. Delivery is strictly FIFO. When every consumer of a node reads
bytes on the host (``WANTS_HOST``), entering the ring starts one coalesced
asynchronous D2H for the frame; an adjacent segment gets device tensors
untouched. A sink fetches its frame (or with ``sync-window`` N, a window
of N frames) in one coalesced copy. :meth:`Executor.totals` carries the
run's bytes by direction.

Chains (pipeline/chain_program.py). Fused segments joined only by queue /
capsfilter form a chain; an eligible one under ``chain_mode=auto`` runs
on ONE node (:class:`_ChainNode`) as one CUDA graph a window of
``chain_unroll`` frames, the plumbing between its segments absorbed. A
device fault latches the per-node path: each member segment's own graph
in order, on the same card, counted (``chain_fallback``).

A ``tensor_filter plane=`` node collects windows the same way and sends
each one to its serving plane (serving_plane/plane.py) on a ticket. With
a ticket depth above 1 (``ring-depth``) window N+1 is submitted while the
plane computes N; at depth 1 each window is redeemed as soon as it is
submitted. Delivery is strictly FIFO at every depth.

Faults (pipeline/faults.py, pipeline/device_faults.py). A node whose
element declares ``on-error`` applies a :class:`FaultGate` around its frame
work (segments and host elements, as in the reference): a failed frame is
dropped, retried or routed to the element's error pad instead of stopping
the run, and a failed window splits per frame through the gate. A fused
segment's window goes through the degradation ladder: chunked to the OOM
governor's ceiling, an OOM shrinks the ceiling and retries the chunk, other
device faults feed the device circuit, which once open serves the segment
eagerly on the same device (``FusedSegment.process_eager``) and probes its
graphs every ``device_probe_every`` frames. A frame whose ``deadline_ms``
passed is shed at dequeue. Without a policy the first error in any node
stops every node; :meth:`Executor.wait` returns and :attr:`Executor.errors`
holds it.

The control surface: :meth:`Executor.drain` parks the sources and waits
for quiescence, :meth:`Executor.snapshot` / :meth:`save_snapshot` /
:meth:`read_snapshot` / :meth:`restore` / :meth:`resume` carry per-node
counters, OOM ceilings, circuit state and element state across a restart,
:meth:`Executor.totals` balances the frames, and a stall watchdog
(``[executor] watchdog_timeout_ms``, off by default) turns a hang into a
:class:`PipelineStallError`.

Observability (obs/, trace.py, pipeline/sanitize.py): with a metrics
registry on (``obs.enable()``, ``NNS_TPU_METRICS``, ``[executor] metrics``)
every node records ``nns_element_latency_us``, frames, queue waits and
depths, and the fault layer its ``nns_*`` counters; :meth:`Executor.stats`
rows then carry p50/p95/p99. With a tracer on, one span a frame a node
and one a batch, plus the fault and stall events. With both off (the
default) the hot path pays one ``None`` check a frame. ``NNS_TPU_SANITIZE``
swaps the inboxes for instrumented ones (spec conformance, frame
accounting at EOS, lock order, thread leaks).
"""

from __future__ import annotations

import json
import math
import os
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from nnstreamer_tpu_torch import trace
from nnstreamer_tpu_torch.elements.base import Element, HostElement, Routing, Sink, Source
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.obs import metrics as obs_metrics
from nnstreamer_tpu_torch.pipeline import transfer
from nnstreamer_tpu_torch.pipeline.batching import BatchCollector, BatchConfig, default_buckets
from nnstreamer_tpu_torch.pipeline.chain_program import (
    ChainHazardError,
    ChainProgram,
    decide_chain,
)
from nnstreamer_tpu_torch.pipeline.device_faults import (
    BucketGovernor,
    DeviceCircuit,
    classify_device_fault,
    resolve_device_policy,
)
from nnstreamer_tpu_torch.pipeline.faults import (
    FaultGate,
    PipelineStallError,
    frame_deadline_expired,
    notify_shed,
    resolve_fault_policy,
    watchdog_timeout_ms,
)
from nnstreamer_tpu_torch.pipeline.graph import ExecPlan, FusedSegment, is_plumbing
from nnstreamer_tpu_torch.pipeline.sanitize import SanQueue, Sanitizer, sanitize_enabled
from nnstreamer_tpu_torch.tensors.frame import EOS_FRAME
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec

_log = get_logger("executor")

_POLL_S = 0.05  # bounded waits keep every thread responsive to stop()


class _Stop(Exception):
    """Raised through a retry's backoff sleep when the executor stops."""


class _MeteredQueue(queue.Queue):
    """An inbox that feeds ``nns_queue_wait_us`` (metrics on only): each
    put stamps a parallel deque BEFORE the item goes in, and each get pairs
    the oldest stamp off, so the stamps always run ahead of the items and
    the pairing stays exact. A put that fails (full, stopping) takes its
    own stamp back."""

    def __init__(self, maxsize: int, wait_hist) -> None:
        super().__init__(maxsize=maxsize)
        self._tq: deque = deque()
        self.wait_hist = wait_hist

    def put(self, item, block: bool = True, timeout=None) -> None:
        self._tq.append(time.perf_counter())
        try:
            super().put(item, block, timeout)
        except BaseException:
            try:
                self._tq.pop()
            except IndexError:
                pass
            raise

    def get(self, block: bool = True, timeout=None):
        item = super().get(block, timeout)
        try:
            dt = time.perf_counter() - self._tq.popleft()
        except IndexError:
            return item
        if dt >= 0.0:
            self.wait_hist.observe(dt * 1e6)
        return item


class _FrameRing:
    """A device node's in-flight frames (the reference's ``_FrameRing``).

    The node SUBMITS frame N (its work queued on the stream) and only once
    ``depth`` frames are in flight does the oldest DELIVER downstream, so
    the H2D of N+1, the compute of N and the D2H of N-1 overlap. Delivery
    is strictly FIFO at every depth. ``to_host`` (every consumer reads host
    bytes) starts one coalesced asynchronous D2H a frame as it enters the
    ring, and delivery materialises it; a fault surfacing there goes to the
    node's fault machinery (:meth:`_Node.dispose_fault`). ``put`` and
    ``flush`` return False once the executor is stopping."""

    __slots__ = ("node", "depth", "to_host", "_q")

    def __init__(self, node: "_Node", depth: int, to_host: bool) -> None:
        self.node = node
        self.depth = max(1, int(depth))
        self.to_host = to_host
        self._q: deque = deque()

    def __len__(self) -> int:
        return len(self._q)

    def put(self, frame, t0: Optional[float] = None) -> bool:
        """Submit one output frame; deliver the oldest once the ring is
        full. ``t0`` defers the node's stat() to delivery, so its frame
        count is frames that left the node."""
        fetch = None
        if self.to_host and any(transfer.is_device_array(t) for t in frame.tensors):
            fetch = transfer.fetch_frame(frame)
        self._q.append((frame, fetch, t0))
        while len(self._q) >= self.depth:
            if not self._deliver_one():
                return False
        return True

    def flush(self) -> bool:
        """Deliver everything in flight, oldest first (EOS, idle input)."""
        while self._q:
            if not self._deliver_one():
                return False
        return True

    def _deliver_one(self) -> bool:
        frame, fetch, t0 = self._q.popleft()
        node = self.node
        if fetch is not None:
            try:
                frame = frame.with_tensors(fetch.finish())
            except _Stop:
                raise
            except Exception as exc:  # noqa: BLE001 — the fault machinery decides
                if node.dispose_fault(frame, exc):
                    return True
                raise
        if t0 is not None:
            node.stat(t0)
        return node.push_out(0, frame)


class _Node:
    def __init__(self, ex: "Executor", name: str, n_inboxes: int, depth: int) -> None:
        self.ex = ex
        self.name = name
        self.inboxes = [ex.make_inbox(max(1, depth), self, i) for i in range(n_inboxes)]
        # src pad → [(downstream node, its sink pad)]
        self.outs: Dict[int, List[Tuple["_Node", int]]] = {}
        self.thread = threading.Thread(target=self._main, name=f"nns-{name}", daemon=True)
        # the node's thread is the only writer of these counters
        self.frames_processed = 0
        self.proc_time_ema_ms = 0.0
        self.max_invoke_ms = 0.0  # the slowest invoke seen (drain's settle window)
        self.deadline_shed = 0
        self.fault_gate: Optional[FaultGate] = None
        self.device_circuit: Optional[DeviceCircuit] = None
        self.bucket_governor: Optional[BucketGovernor] = None
        # a warm-restart snapshot restored before the loop built what it
        # restores (Executor.restore on a fresh executor)
        self._pending_restore: Optional[Dict[str, Any]] = None
        # the in-flight frame ring of a device node (None: delivers at once)
        self._ring: Optional[_FrameRing] = None
        # metrics handles, wired by the Executor when a registry is on
        # (None / empty otherwise: one None check a frame)
        self._lat_hist = None
        self._frames_ctr = None
        self._depth_hists: List = []
        self._batch_hist = None
        self._shed_ctr = None
        self._device_ctrs: Dict[str, Any] = {}
        self._deg_gauge = None
        self._postproc_ctr = None  # a segment with fused pre/post-processing

    @property
    def fault_stats(self):
        return self.fault_gate.stats if self.fault_gate is not None else None

    def _main(self) -> None:
        try:
            self.run()
        except _Stop:
            pass
        except BaseException as exc:  # noqa: BLE001 — reported, never lost
            self.ex._fail(self.name, exc)

    def notify(self) -> None:
        """A producer put a frame into one of this node's inboxes."""

    def inflight(self) -> int:
        """Frames taken from the inbox but not yet delivered (the node's
        ring): drain and the watchdog must see them."""
        ring = self._ring
        return len(ring) if ring is not None else 0

    def get(self, pad: int = 0):
        while not self.ex._stop.is_set():
            try:
                return self.inboxes[pad].get(timeout=_POLL_S)
            except queue.Empty:
                continue
        return None

    def push_out(self, pad: int, item) -> bool:
        """Send ``item`` down every link of src ``pad``; False once the
        executor is stopping."""
        san = self.ex.sanitizer
        if san is not None and item is not EOS_FRAME:
            san.count_push(self.name, pad)
        for node, dst_pad in self.outs.get(pad, ()):
            box = node.inboxes[dst_pad]
            while True:
                if self.ex._stop.is_set():
                    return False
                try:
                    box.put(item, timeout=_POLL_S)
                    break
                except queue.Full:
                    continue
            node.notify()
        return True

    def push_all(self, items) -> bool:
        """Send an element's output (a frame, a list, or None) on pad 0."""
        if items is None:
            return True
        for f in items if isinstance(items, list) else [items]:
            if not self.push_out(0, f):
                return False
        return True

    def broadcast_eos(self) -> None:
        for pad in self.outs:
            self.push_out(pad, EOS_FRAME)

    def _out_wants_host(self) -> bool:
        """Link-level placement for pad 0: True when EVERY consumer reads
        tensor bytes on the host (an element declaring ``WANTS_HOST``, or a
        host-path op that places its frames itself and is no plumbing: a
        converter subplugin), so this node fetches one coalesced D2H a
        frame, overlapped with the next frame's work. Any device-capable
        consumer (a segment, plumbing, a sink, which fetches for itself)
        keeps the frames on the device."""
        consumers = self.outs.get(0)
        if not consumers:
            return False
        for dst, _pad in consumers:
            elem = getattr(dst, "elem", None)
            seg = getattr(dst, "seg", None)
            if elem is None and seg is not None:
                elem = seg.first
            if elem is not None and getattr(type(elem), "WANTS_HOST", False):
                continue
            if (seg is not None and not seg.fused and getattr(elem, "DEVICE_PASSTHROUGH", False)
                    and not is_plumbing(elem)):
                continue
            return False
        return True

    def run(self) -> None:
        raise NotImplementedError

    # -- accounting --------------------------------------------------------
    def _advance(self, n: int) -> None:
        """The ONE place ``frames_processed`` changes: the node's own thread
        is its only writer (observers read it whole under the GIL), and one
        method for the read-modify-write makes that structural for the
        nns-san race lint."""
        self.frames_processed += n

    def stat(self, t0: float) -> None:
        """A frame left this node; ``t0`` is when its work began. With a
        tracer or a registry on, every frame records (a span, a latency
        observation); without, one EMA update in 8."""
        self._advance(1)
        tracer = trace.get()
        lat = self._lat_hist
        if tracer is None and lat is None and (self.frames_processed & 7):
            return
        now = time.perf_counter()
        dt = (now - t0) * 1000.0
        self.proc_time_ema_ms = 0.8 * self.proc_time_ema_ms + 0.2 * dt
        if dt > self.max_invoke_ms:
            self.max_invoke_ms = dt
        if lat is not None:
            lat.observe(dt * 1000.0)
            self._frames_ctr.inc()
            if self._postproc_ctr is not None:
                self._postproc_ctr.inc()
            if not (self.frames_processed & 15):
                # queue depth every 16th frame: one qsize() a pad
                for h, q in zip(self._depth_hists, self.inboxes):
                    h.observe(q.qsize())
        if tracer is not None:
            tracer.complete(self.name, type(self).__name__.lstrip("_"), t0, now - t0,
                            {"frame": self.frames_processed})

    def stat_batch(self, t0: float, n: int, bucket: int, wait_s: float) -> None:
        """One window of ``n`` frames left this node (``bucket`` rows run):
        one latency observation a window, ``n`` frames counted, and with a
        tracer on one batch span (size, bucket, straggler wait)."""
        self._advance(n)
        now = time.perf_counter()
        dt = (now - t0) * 1000.0
        self.proc_time_ema_ms = 0.8 * self.proc_time_ema_ms + 0.2 * dt
        if dt > self.max_invoke_ms:
            self.max_invoke_ms = dt
        lat = self._lat_hist
        if lat is not None:
            lat.observe(dt * 1000.0)
            self._frames_ctr.inc(n)
            if self._postproc_ctr is not None:
                self._postproc_ctr.inc(n)
            if self._batch_hist is None:
                self._batch_hist = self.ex.metrics.histogram(
                    "nns_batch_size", lo=1.0, growth=2.0 ** 0.5, nbuckets=16, element=self.name)
            self._batch_hist.observe(n)
            for h, q in zip(self._depth_hists, self.inboxes):
                h.observe(q.qsize())
        tracer = trace.get()
        if tracer is not None:
            tracer.batch(self.name, t0, now - t0, batch=n, bucket=bucket, wait_s=wait_s,
                         frame=self.frames_processed)

    def shed_if_expired(self, item) -> bool:
        """Shed a frame whose client deadline (``deadline_ms`` since
        ``admit_t``) passed before this node spent time on it; counted."""
        meta = getattr(item, "meta", None)
        if not meta or "deadline_ms" not in meta or not frame_deadline_expired(meta):
            return False
        self.deadline_shed += 1
        if self._shed_ctr is None and self.ex.metrics is not None:
            self._shed_ctr = self.ex.metrics.counter("nns_deadline_shed_total", element=self.name)
        if self._shed_ctr is not None:
            self._shed_ctr.inc()
        notify_shed(item, self.name)
        return True

    def make_fault_gate(self, policy, elem: Element) -> Optional[FaultGate]:
        """This node's error-policy gate, or None for ``stop``. Only an
        element that DECLARES ``on-error`` takes part, so the ``[executor]``
        default never applies to one that did not opt in. Made in run(),
        after the links are wired, so the route closure sees whether the
        error pad has a consumer."""
        if "on-error" not in type(elem).property_schema():
            return None
        if policy is None:
            policy = resolve_fault_policy([elem])
        if not policy.active:
            return None
        route = None
        err_pad = elem.error_pad
        if err_pad is not None and err_pad in self.outs:
            def route(err_frame, _pad=err_pad):
                if not self.push_out(_pad, err_frame):
                    raise _Stop()
        self.fault_gate = FaultGate(policy, self.name, stop_event=self.ex._stop, route=route,
                                    raise_through=(_Stop,), stop_exc=_Stop)
        return self.fault_gate

    # -- device resilience ---------------------------------------------------
    def _device_fault(self, exc: BaseException) -> Optional[str]:
        """Classify ``exc``; a device fault is counted in
        ``nns_device_faults_total`` and traced (one event a fault, never a
        frame) and its kind returned, anything else gives None."""
        kind = classify_device_fault(exc)
        if kind is None:
            return None
        if self.ex.metrics is not None:
            ctr = self._device_ctrs.get(kind)
            if ctr is None:
                ctr = self._device_ctrs[kind] = self.ex.metrics.counter(
                    "nns_device_faults_total", element=self.name, kind=kind)
            ctr.inc()
        tracer = trace.get()
        if tracer is not None:
            tracer.fault(self.name, f"device-{kind}", exc)
        return kind

    def _update_degraded_gauge(self) -> None:
        """``nns_degraded_segments`` for this node (0/1): the circuit is
        open or the OOM governor holds the ceiling below the ladder's top.
        Called on transitions only, never a frame."""
        if self.ex.metrics is None:
            return
        if self._deg_gauge is None:
            self._deg_gauge = self.ex.metrics.gauge("nns_degraded_segments", element=self.name)
        self._deg_gauge.set(1 if self.degraded() else 0)

    def degraded(self) -> bool:
        circ, gov = self.device_circuit, self.bucket_governor
        return bool((circ is not None and circ.open) or (gov is not None and gov.degraded))

    def dispose_fault(self, frame, exc: Exception) -> bool:
        """A fault outside a gated invoke (a frame whose coalesced fetch
        failed at delivery, a plane window's frame that failed to reach the
        device): classify and count it (the circuit included), then dispose
        of the frame through the error policy. False under ``stop``: the
        caller re-raises. ``retry`` degrades to route-or-drop, as an
        exhausted budget does."""
        kind = self._device_fault(exc)
        circ = self.device_circuit
        if kind is not None and circ is not None and circ.record_fault(kind):
            self._update_degraded_gauge()
        gate = self.fault_gate
        if gate is None or gate.policy.on_error == "stop":
            return False
        gate.stats.errors += 1
        gate.dispose(frame, exc, 0)
        return True

    def device_snapshot(self) -> Dict[str, Any]:
        """This node's warm-restart payload (Executor.snapshot)."""
        d: Dict[str, Any] = {"frames": self.frames_processed,
                             "deadline_shed": self.deadline_shed}
        if self.bucket_governor is not None:
            d["governor"] = self.bucket_governor.snapshot()
        if self.device_circuit is not None:
            d["circuit"] = self.device_circuit.snapshot()
        if self.fault_stats is not None:
            d["faults"] = self.fault_stats.state()
        return d

    def restore_state(self, d: Dict[str, Any]) -> None:
        """Counters land now; the governor, circuit and fault sections are
        stashed until the node has built what they restore."""
        self.frames_processed = int(d.get("frames", self.frames_processed))
        self.deadline_shed = int(d.get("deadline_shed", self.deadline_shed))
        self._pending_restore = dict(d)

    def _apply_pending_restore(self) -> None:
        """Re-arm the stashed sections whose target exists; the rest stay
        stashed for the node's own later call (a restore that races the
        loop's setup must not lose a remembered OOM ceiling)."""
        d = self._pending_restore
        if not d:
            return
        pending: Dict[str, Any] = {}
        for key, target in (("governor", self.bucket_governor),
                            ("circuit", self.device_circuit),
                            ("faults", self.fault_stats)):
            if key not in d:
                continue
            if target is not None:
                target.restore(d[key])
            else:
                pending[key] = d[key]
        self._pending_restore = pending or None
        self._update_degraded_gauge()


def _qos_skip(elem: Element, frame) -> bool:
    """True (and counted) when a downstream rate limiter will drop the
    frame anyway."""
    if elem.qos_would_drop(frame):
        for q in elem.qos_sources:
            q.skipped_upstream += 1
        return True
    return False


class _SourceNode(_Node):
    def __init__(self, ex, elem: Source) -> None:
        super().__init__(ex, elem.name, 0, 1)
        self.elem = elem

    def run(self) -> None:
        pause = self.ex._pause
        while not self.ex._stop.is_set():
            if pause.is_set():
                # Executor.drain(): park at a frame boundary until resume()
                time.sleep(0.005)
                continue
            t0 = time.perf_counter()
            frame = self.elem.generate()
            if frame is None:  # nothing ready yet (appsrc, an LLM server): poll again
                continue
            if frame is EOS_FRAME:
                self.broadcast_eos()
                return
            self.stat(t0)
            if not self.push_out(0, frame):
                return


class _SegmentNode(_Node):
    """A fused segment, or one TensorOp on the host path (``fused`` False:
    the reference's TensorOpHostNode)."""

    def __init__(self, ex, seg: FusedSegment, depth: int) -> None:
        super().__init__(ex, seg.name, 1, depth)
        self.seg = seg
        # a device fault of the per-frame program's build at start, reported
        # at the first frame, where the reference builds that program
        self._pending_fault: Optional[BaseException] = None
        self._plane_ring: deque = deque()  # (frames, ticket, collector wait)
        self._collector: Optional[BatchCollector] = None

    def batched(self) -> bool:
        """Whether this node collects windows: batching active, and a fused
        segment or an op whose backend declared ``batchable``."""
        cfg = self.seg.batch_config
        return bool(cfg is not None and cfg.active
                    and (self.seg.fused or self.seg.first.is_batch_capable()))

    def inflight(self) -> int:
        """The plane's parked windows, a frame the collector holds in its
        straggler wait and the frame ring (neither queued nor delivered)."""
        held = self._collector.held if self._collector is not None else 0
        return held + sum(len(e[0]) for e in self._plane_ring) + super().inflight()

    # -- build (Executor.start, before any node thread) --------------------
    def build(self) -> None:
        """Make the circuit and the OOM governor from the plan-time device
        policy, then build the negotiated programs. A device fault of the
        per-frame build is reported at the first frame; a failed build of
        the max-batch bucket opens the circuit now (compile), or is left to
        the ladder (OOM and the rest); an ordinary error raises."""
        seg, pol, cfg = self.seg, self.seg.device_policy, self.seg.batch_config
        if pol is not None:
            if seg.fused and pol["device-fallback"]:
                self.device_circuit = DeviceCircuit(
                    after=pol["device-fallback-after"], probe_every=pol["device-probe-every"])
            if self.batched() and pol["oom-policy"] == "degrade":
                self.bucket_governor = BucketGovernor(
                    cfg.buckets, cooldown_s=pol["oom-reprobe-ms"] / 1000.0)
        if self._runs_on_host():
            return  # no program: run() applies the ops to the host frame
        try:
            seg.build_frame()
        except Exception as exc:
            if classify_device_fault(exc) is None:
                raise
            self._pending_fault = exc
        try:
            seg.build_batched()
        except Exception as exc:
            kind = self._device_fault(exc)
            circ = self.device_circuit
            if kind == "compile":
                if circ is None or not circ.record_fault(kind):
                    raise
                self._update_degraded_gauge()
                self._pending_fault = None
            elif kind is None:
                raise
            else:
                _log.warning("%s: building the max-batch program failed: %s", self.name, exc)

    def _runs_on_host(self) -> bool:
        """A segment that only re-views its tensors (an identity one too),
        feeding consumers that read host bytes (a query client after a
        converter), runs on the host frame: staging it up to fetch it back
        would move it twice. Every other fused segment is staged."""
        return not self.batched() and self.seg.is_layout_only() and self._out_wants_host()

    # -- loops ---------------------------------------------------------------
    def _make_ring(self) -> _FrameRing:
        """The node's in-flight ring: a fused segment's depth from its plan
        (``ring-depth`` / ``[executor] ring_depth``), fetching to the host
        when every consumer reads host bytes. A host-path op delivers at
        once unless it set ``ring-depth``; plumbing whose consumers read
        the host arms the fetch with depth 2, so a handoff across a queue
        still lands as one overlapped D2H."""
        seg = self.seg
        depth = seg.ring_depth or 1
        to_host = self._out_wants_host()
        if not seg.fused:
            to_host = to_host and is_plumbing(seg.first)
            if to_host and depth < 2:
                depth = 2
        self._ring = _FrameRing(self, depth, to_host)
        return self._ring

    def run(self) -> None:
        seg = self.seg
        gate = self.make_fault_gate(seg.fault_policy, seg.first)
        self._apply_pending_restore()
        if self.batched():
            if not seg.fused and getattr(seg.first, "plane", ""):
                self._run_plane(seg.batch_config, seg.first.plane_inflight, gate)
            else:
                self._run_batched(seg.batch_config, gate)
            return
        ring = self._make_ring()
        inbox = self.inboxes[0]
        on_host = self._runs_on_host()
        process = seg.process_host if on_host else self._process_frame
        # H2D staging (pipeline/transfer.py): a fused segment on a GPU moves
        # each host frame up through pinned memory before its program runs
        stage_to = seg.device if (seg.fused and not on_host
                                  and seg.device.type == "cuda") else None
        while True:
            try:
                frame = inbox.get_nowait()
            except queue.Empty:
                # idle input: deliver what is in flight, then block
                if not ring.flush():
                    return
                frame = self.get()
            if frame is None:
                return
            if frame is EOS_FRAME:
                if not ring.flush():
                    return
                if self.push_all(seg.first.flush() if not seg.fused else None):
                    self.broadcast_eos()
                return
            if self.shed_if_expired(frame) or _qos_skip(seg.first, frame):
                continue
            t0 = time.perf_counter()
            if stage_to is not None:
                try:
                    frame = transfer.stage_frame(frame, stage_to)
                except _Stop:
                    raise
                except Exception as exc:  # noqa: BLE001 — the policy decides
                    if self.dispose_fault(frame, exc):
                        continue
                    raise
            if gate is None:
                out = process(frame)
            else:
                delivered, out = gate.process(frame, process)
                if not delivered:
                    continue
            if seg.fused:
                if not ring.put(out, t0):
                    return
                continue
            self.stat(t0)
            if out is None:  # absorbed (a converter mid-batch)
                continue
            for f in out if isinstance(out, list) else [out]:
                if not ring.put(f):
                    return

    def _run_batched(self, cfg, gate) -> None:
        """Micro-batched loop: collect up to max-batch frames (the OOM
        governor's ceiling when degraded), ONE program a chunk through the
        degradation ladder (:meth:`_invoke_window`), its frames on in order
        through the node's ring; a partial window flushes at EOS."""
        seg = self.seg
        gov = self.bucket_governor
        collector = self._collector = BatchCollector(
            self.inboxes[0], self.ex._stop, cfg, drop=lambda f: _qos_skip(seg.first, f),
            cap=gov.cap if gov is not None else None)
        ring = self._make_ring()
        while True:
            if self.inboxes[0].empty() and not ring.flush():
                return
            frames, eos, wait_s = collector.collect()
            frames = [f for f in frames if not self.shed_if_expired(f)]
            if frames:
                t0 = time.perf_counter()
                outs, rows = self._invoke_window(frames, cfg, gate)
                seg.batch_stats.record(len(frames), rows, wait_s)
                self.stat_batch(t0, len(frames), rows, wait_s)
                for f in outs:
                    if not ring.put(f):
                        return
            if eos:
                break
        if collector.stopped or not ring.flush():
            return
        if self.push_all(seg.first.flush() if not seg.fused else None):
            self.broadcast_eos()

    def _run_plane(self, cfg, depth: int, gate) -> None:
        """Plane submits: each collected window is submitted as a ticket,
        and the oldest ticket is redeemed (its frames delivered) once
        ``depth`` tickets are in flight, the inbox idles, or EOS flushes
        them; depth 1 redeems each window at once. Delivery is strictly
        FIFO. A window whose ticket fails goes through the host ladder of
        :meth:`_recover_window`: per stream, through this node's policy."""
        seg = self.seg
        elem = seg.first
        gov = self.bucket_governor
        collector = self._collector = BatchCollector(
            self.inboxes[0], self.ex._stop, cfg, drop=lambda f: _qos_skip(elem, f),
            cap=gov.cap if gov is not None else None)
        ring = self._plane_ring
        inbox = self.inboxes[0]

        def deliver_one() -> bool:
            frames, ticket, wait_s = ring[0]
            t0 = time.perf_counter()
            if isinstance(ticket, BaseException):
                outs = self._recover_window(frames, ticket, cfg, gate)
            else:
                try:
                    outs = elem.host_collect_window(ticket)
                except _Stop:
                    raise
                except Exception as exc:  # noqa: BLE001 — the ladder decides
                    outs = self._recover_window(frames, exc, cfg, gate)
                else:
                    if gov is not None:
                        gov.on_ok(len(frames))
            ring.popleft()
            seg.batch_stats.record(len(frames), len(frames), wait_s)
            self.stat_batch(t0, len(frames), len(frames), wait_s)
            return self.push_all(outs)

        while True:
            while ring and inbox.empty():
                # idle input: deliver in order so latency stays bounded
                if not deliver_one():
                    return
            frames, eos, wait_s = collector.collect()
            frames = self._stage([f for f in frames if not self.shed_if_expired(f)])
            if frames:
                try:
                    ticket = elem.host_submit_window_async(frames)
                except _Stop:
                    raise
                except Exception as exc:  # noqa: BLE001 — recovered at delivery
                    ticket = exc
                ring.append((frames, ticket, wait_s))
                while len(ring) >= depth:
                    if not deliver_one():
                        return
            if eos:
                while ring:
                    if not deliver_one():
                        return
                break
        if collector.stopped:
            return
        if self.push_all(elem.flush()):
            self.broadcast_eos()

    def _stage(self, frames) -> List:
        """A plane window's frames moved to the device ahead of the submit,
        outside any invoke: a frame that fails to stage is disposed of by
        the error policy (:meth:`_Node.dispose_fault`), or stops the run."""
        if self.seg.first.DEVICE_PASSTHROUGH:
            return frames
        staged = []
        for f in frames:
            try:
                staged.append(f.to_device(self.seg.device))
            except _Stop:
                raise
            except Exception as exc:  # noqa: BLE001 — the policy decides
                if not self.dispose_fault(f, exc):
                    raise
        return staged

    # -- the degradation ladder ---------------------------------------------
    def _frame_program(self, item):
        """One frame through the segment's per-frame program; a device
        fault of its build at start surfaces here, at the first frame."""
        exc, self._pending_fault = self._pending_fault, None
        if exc is not None:
            raise exc
        return self.seg.process(item)

    def _process_frame(self, item):
        """The per-frame program with the device circuit around it:
        repeated device faults (or one failed build) open the circuit, and
        this frame and the stream after it run eagerly; below the threshold
        the exception goes to the node's error policy."""
        circ = self.device_circuit
        if circ is None:
            return self._frame_program(item)
        if circ.open:
            return self._degraded_process(item)
        try:
            out = self._frame_program(item)
        except _Stop:
            raise
        except Exception as exc:
            kind = self._device_fault(exc)
            if kind is None or not circ.record_fault(kind):
                raise
            self._update_degraded_gauge()
            circ.eager_invokes += 1
            return self.seg.process_eager(item)
        circ.record_ok()
        return out

    def _degraded_process(self, item):
        """One frame while the circuit is open: eager, with the per-frame
        program probed every ``probe_every`` frames; a probe that succeeds
        closes the circuit and serves its frame."""
        circ = self.device_circuit
        if circ.should_probe():
            try:
                out = self._frame_program(item)
            except _Stop:
                raise
            except Exception as exc:
                kind = self._device_fault(exc)
                if kind is None:
                    raise
                circ.record_fault(kind)  # stays open; the kind is counted
            else:
                circ.close()
                self._update_degraded_gauge()
                return out
        circ.eager_invokes += 1
        return self.seg.process_eager(item)

    def _serve_degraded(self, chunk, gate) -> List:
        outs = []
        for f in chunk:
            if gate is None:
                outs.append(self._degraded_process(f))
            else:
                delivered, out = gate.process(f, self._degraded_process)
                if delivered:
                    outs.append(out)
        return outs

    def _split(self, chunk, gate, fn) -> List:
        """A failed chunk per frame through the gate: one bad frame never
        discards its batchmates."""
        outs: List = []
        for f in chunk:
            delivered, out = gate.process(f, fn)
            if delivered and out is not None:
                outs.extend(out if isinstance(out, list) else [out])
        return outs

    def _invoke_window(self, frames, cfg, gate) -> Tuple[List, int]:
        """One collected window through the ladder → (outs, rows run):

        1. chunked to the OOM governor's live ceiling;
        2. a chunk that OOMs shrinks the ceiling one rung and is retried,
           never dropped; at the smallest bucket the OOM is like any other
           device fault;
        3. other device faults feed the circuit (fused segments); once
           open, the chunk and the stream run eagerly;
        4. anything else splits per frame through the error-policy gate."""
        seg = self.seg
        gov, circ = self.bucket_governor, self.device_circuit
        outs: List = []
        rows = 0
        pending = deque([frames])
        while pending:
            chunk = pending.popleft()
            cap = gov.cap() if gov is not None else None
            if cap is not None and len(chunk) > cap:
                pending.appendleft(chunk[cap:])  # the rest keeps its order
                chunk = chunk[:cap]
            if circ is not None and circ.open:
                outs.extend(self._serve_degraded(chunk, gate))
                rows += len(chunk)
                continue
            try:
                got, bucket = seg.process_batch(chunk, cfg)
            except _Stop:
                raise
            except Exception as exc:
                kind = self._device_fault(exc)
                # a fused window OOMs at its padded bucket; a host window at
                # its width, and a lone host frame has nothing to shrink
                if kind == "oom" and gov is not None and (seg.fused or len(chunk) > 1):
                    attempted = (cfg.bucket_for(len(chunk)) if seg.fused and len(chunk) > 1
                                 else len(chunk))
                    if gov.on_oom(attempted) is not None:
                        self._update_degraded_gauge()
                        pending.appendleft(chunk)  # retried, shrunk
                        continue
                if kind is not None and circ is not None and circ.record_fault(kind):
                    self._update_degraded_gauge()
                    outs.extend(self._serve_degraded(chunk, gate))
                    rows += len(chunk)
                    continue
                if gate is None:
                    raise
                outs.extend(self._split(chunk, gate,
                                        self._process_frame if seg.fused else seg.process))
                rows += len(chunk)
                continue
            if circ is not None:
                circ.record_ok()
            if gov is not None and gov.on_ok(bucket):
                self._update_degraded_gauge()
            outs.extend(got)
            rows += bucket
        return outs, rows

    def _recover_window(self, frames, exc: BaseException, cfg, gate) -> List:
        """A plane window whose ticket failed, through the host ladder: an
        OOM shrinks the governor's ceiling and re-runs the window chunked;
        anything else splits per frame through the gate (each frame its
        own blocking plane round trip), or raises whole without one."""
        gov = self.bucket_governor
        if (self._device_fault(exc) == "oom" and gov is not None and len(frames) > 1
                and gov.on_oom(len(frames)) is not None):
            self._update_degraded_gauge()
            return self._invoke_window(frames, cfg, gate)[0]
        if gate is None:
            raise exc
        return self._split(frames, gate, self.seg.process)


class _HostNode(_Node):
    def __init__(self, ex, elem: HostElement, depth: int) -> None:
        super().__init__(ex, elem.name, 1, depth)
        self.elem = elem

    def run(self) -> None:
        gate = self.make_fault_gate(None, self.elem)
        self._apply_pending_restore()
        while True:
            frame = self.get()
            if frame is None:
                return
            if frame is EOS_FRAME:
                if self.push_all(self.elem.flush()):
                    self.broadcast_eos()
                return
            if self.shed_if_expired(frame) or _qos_skip(self.elem, frame):
                continue
            t0 = time.perf_counter()
            if gate is None:
                out = self.elem.process(frame)
            else:
                delivered, out = gate.process(frame, self.elem.process)
                if not delivered:
                    continue
            self.stat(t0)
            if not self.push_all(out):
                return


class _RoutingNode(_Node):
    def __init__(self, ex, elem: Routing, n_sinks: int, depth: int) -> None:
        super().__init__(ex, elem.name, n_sinks, depth)
        self.elem = elem
        # producers notify() on push, so an idle node sleeps until there
        # is data instead of polling every pad
        self._wake = threading.Event()

    def notify(self) -> None:
        self._wake.set()

    def _emit(self, pairs) -> bool:
        return all(self.push_out(pad, f) for pad, f in pairs)

    def run(self) -> None:
        eos_seen = [False] * len(self.inboxes)
        while not all(eos_seen):
            self._wake.clear()
            progressed = False
            for pad, box in enumerate(self.inboxes):
                while not eos_seen[pad]:  # drain the pad without waiting
                    try:
                        item = box.get_nowait()
                    except queue.Empty:
                        break
                    progressed = True
                    if item is EOS_FRAME:
                        eos_seen[pad] = True
                        pairs = self.elem.eos(pad)
                    else:
                        t0 = time.perf_counter()
                        pairs = self.elem.receive(pad, item)
                        self.stat(t0)
                    if not self._emit(pairs):
                        return
            if self.ex._stop.is_set():
                return
            if not progressed and not all(eos_seen):
                # bounded, so a lost notify costs one period and stop()
                # is still honoured
                self._wake.wait(timeout=0.1)
        self.broadcast_eos()


class _SinkNode(_Node):
    def __init__(self, ex, elem: Sink, depth: int) -> None:
        super().__init__(ex, elem.name, 1, depth)
        self.elem = elem
        self.done = threading.Event()

    def run(self) -> None:
        """Render each frame as one coalesced D2H of its tensors lands, or
        with ``sync-window`` N, N frames through ONE fetch of the whole
        window (pipeline/transfer.py); a sink that never reads bytes
        (``READS_HOST = False``) gets its frames untouched."""
        elem = self.elem
        window = getattr(elem, "sync_window", 1)
        reads_host = getattr(type(elem), "READS_HOST", True)
        pending: List = []

        def flush() -> None:
            if not pending:
                return
            ready = transfer.fetch_window(pending) if reads_host else pending
            for f in ready:
                elem.render(f)
            pending.clear()

        while True:
            frame = self.get()
            if frame is None:
                return
            if frame is EOS_FRAME:
                flush()
                elem.on_eos()
                self.done.set()
                self.ex._sink_done()
                return
            t0 = time.perf_counter()
            if window > 1:
                pending.append(frame)
                if len(pending) >= window:
                    flush()
            else:
                if reads_host and any(transfer.is_device_array(t) for t in frame.tensors):
                    frame = frame.with_tensors(transfer.fetch_frame(frame).finish())
                elem.render(frame)
            self.stat(t0)


class _ChainNode(_Node):
    """ONE node, and in steady state ONE graph replay a window, for a whole
    compiled chain (pipeline/chain_program.py). It takes the place of the
    member segments' nodes and of the plumbing between them, so no frame
    crosses a queue inside the chain and the interior host bytes are zero
    by construction. A device fault latches the STICKY per-node path when
    the device policy allows it (raises otherwise): every later frame runs
    through the member segments' own graphs, on the same card, counted in
    ``chain_fallback``; an OOM shrinks the window one rung through the
    bucket governor and retries it, never drops it."""

    def __init__(self, ex, chain, program: ChainProgram, depth: int) -> None:
        super().__init__(ex, chain.name, 1, depth)
        self.chain = chain
        self.program = program
        # the sticky latch and its counters; single writer (this thread)
        self.fallback_latched = False
        self.fallback_windows = 0
        self.fallback_frames = 0
        self.hazard: Optional[str] = None
        self._fallback_allowed = True
        self._collector: Optional[BatchCollector] = None
        self._chain_launch_ctr = None
        self._chain_fallback_ctr = None

    def inflight(self) -> int:
        held = self._collector.held if self._collector is not None else 0
        return held + super().inflight()

    def degraded(self) -> bool:
        gov = self.bucket_governor
        return self.fallback_latched or bool(gov is not None and gov.degraded)

    def _latch_fallback(self, why: str = "") -> None:
        """Engage the per-node path for the rest of the run: latched, not
        probed (the fault proved the window program wrong for this run)."""
        if not self.fallback_latched:
            self.fallback_latched = True
            _log.warning("chain %s: falling back to the per-node path%s", self.name,
                         f" ({why})" if why else "")
            self._update_degraded_gauge()

    # -- build (Executor.start, before any node thread) --------------------
    def build(self) -> None:
        """The OOM governor over the window ladder, then the full window's
        program. A device fault of the build latches the per-node path when
        ``device-fallback`` allows it; the members' own graphs are built at
        their first use, never here."""
        pol = resolve_device_policy(self.chain.ops)
        self._fallback_allowed = bool(pol.get("device-fallback"))
        if pol.get("oom-policy") == "degrade" and self.program.unroll > 1:
            self.bucket_governor = BucketGovernor(
                self.program.buckets, cooldown_s=pol["oom-reprobe-ms"] / 1000.0)
        try:
            self.program.build()
        except Exception as exc:
            kind = self._device_fault(exc)
            if kind is None or not self._fallback_allowed:
                raise
            self._latch_fallback(f"build: {type(exc).__name__}")

    def run(self) -> None:
        self._apply_pending_restore()
        gov = self.bucket_governor
        u = self.program.unroll
        # drain up to a window of queued frames and never wait for one to
        # fill: a trickle keeps its latency, a full inbox fills windows
        cfg = BatchConfig(enabled=True, max_batch=u, timeout_ms=0.0, buckets=default_buckets(u))
        collector = self._collector = BatchCollector(
            self.inboxes[0], self.ex._stop, cfg, cap=gov.cap if gov is not None else None)
        ring = self._ring = _FrameRing(self, transfer.resolve_ring_depth(self.chain.ops),
                                       self._out_wants_host())
        while True:
            if self.inboxes[0].empty() and not ring.flush():
                return
            frames, eos, wait_s = collector.collect()
            frames = [f for f in frames if not self.shed_if_expired(f)]
            if frames:
                t0 = time.perf_counter()
                outs, rows = self._invoke_chain_window(frames)
                self.stat_batch(t0, len(frames), rows, wait_s)
                for f in outs:
                    if not ring.put(f):
                        return
            if eos:
                break
        if collector.stopped or not ring.flush():
            return
        self.broadcast_eos()

    def _stage(self, frames) -> List:
        """H2D staging on a GPU (pipeline/transfer.py, counted in the
        tally), as a segment node stages; a frame that fails to move is
        disposed of by the error policy or stops the run."""
        device = self.program.device
        if device.type != "cuda" or self.program.is_identity():
            return frames
        staged = []
        for f in frames:
            try:
                staged.append(transfer.stage_frame(f, device))
            except _Stop:
                raise
            except Exception as exc:  # noqa: BLE001 — the policy decides
                if not self.dispose_fault(f, exc):
                    raise
        return staged

    def _serve_fallback(self, chunk) -> List:
        """Per frame through the member segments' own graphs; a device
        fault there drops that frame one more rung, to the members' eager
        paths (their kernels one by one, on the same card)."""
        outs = []
        for f in chunk:
            try:
                outs.append(self.program.process_frame_fallback(f))
            except _Stop:
                raise
            except Exception as exc:
                if self._device_fault(exc) is None:
                    raise
                outs.append(self.program.process_frame_eager(f))
        self.fallback_windows += 1
        self.fallback_frames += len(chunk)
        if self._chain_fallback_ctr is not None:
            self._chain_fallback_ctr.inc()
        return outs

    def _invoke_chain_window(self, frames) -> Tuple[List, int]:
        """One collected window through the chain's ladder → (outs, rows):

        1. chunked to the OOM governor's live ceiling;
        2. a chunk that OOMs shrinks the ceiling one rung and is retried;
           an OOM with nothing left to shrink falls to (3);
        3. any other device fault latches the per-node path (policy
           permitting; raises otherwise) and the chunk, and the stream
           after it, runs there. A hazard found at the first window (the
           W122 dtype check) latches it too."""
        gov = self.bucket_governor
        outs: List = []
        rows = 0
        frames = self._stage(frames)
        pending = deque([frames] if frames else [])
        while pending:
            chunk = pending.popleft()
            cap = gov.cap() if gov is not None else None
            if cap is not None and len(chunk) > cap:
                pending.appendleft(chunk[cap:])  # the rest keeps its order
                chunk = chunk[:cap]
            if self.fallback_latched:
                outs.extend(self._serve_fallback(chunk))
                rows += len(chunk)
                continue
            try:
                got, width, launched = self.program.process_window(chunk)
            except _Stop:
                raise
            except ChainHazardError as exc:
                self.hazard = str(exc)
                self._latch_fallback(self.hazard)
                pending.appendleft(chunk)
                continue
            except Exception as exc:
                kind = self._device_fault(exc)
                if kind == "oom" and gov is not None:
                    if gov.on_oom(self.program.bucket_for(len(chunk))) is not None:
                        self._update_degraded_gauge()
                        pending.appendleft(chunk)  # retried, shrunk
                        continue
                if kind is None or not self._fallback_allowed:
                    raise
                self._latch_fallback(f"{kind}: {exc}")
                pending.appendleft(chunk)  # served by the per-node path
                continue
            if gov is not None and gov.on_ok(width):
                self._update_degraded_gauge()
            if launched and self._chain_launch_ctr is not None:
                self._chain_launch_ctr.inc()
            outs.extend(got)
            rows += width
        return outs, rows


class Executor:
    def __init__(self, plan: ExecPlan) -> None:
        self.plan = plan
        self.pipeline = p = plan.pipeline
        self.errors: List[BaseException] = []
        self._stop = threading.Event()
        # drain() sets it to park the sources at a frame boundary; resume()
        # clears it
        self._pause = threading.Event()
        self._finished = threading.Event()
        self.nodes: List[_Node] = []
        self.sinks: List[_SinkNode] = []
        self._started = False
        # the stall watchdog ([executor] watchdog_timeout_ms; 0 = off),
        # read here so a caller may set the attribute before start()
        self.watchdog_timeout_ms = watchdog_timeout_ms()
        self._watchdog: Optional[threading.Thread] = None
        self.stalled = False
        # the sanitizer and the metrics registry, resolved once, before
        # the nodes (their inboxes) are made; None keeps the hot path at
        # one attribute check a frame
        self.sanitizer: Optional[Sanitizer] = Sanitizer() if sanitize_enabled() else None
        self.leaked_threads: List[str] = []
        self._threads_at_start: Optional[set] = None
        self._lock = (self.sanitizer.lock("executor._lock") if self.sanitizer is not None
                      else threading.Lock())
        self.metrics = obs_metrics.get()
        self._metrics_server = None
        self._t_run0: Optional[float] = None
        self._t_run_end: Optional[float] = None
        self._transfer_t0: Dict[str, int] = transfer.tally.snapshot()
        # the transfer cross-check at stop() (NNS_XRAY_CROSSCHECK /
        # [executor] xray_crosscheck), read here like the watchdog's bound
        self.xray_crosscheck = transfer.xray_crosscheck_enabled()
        self.last_crosscheck: Optional[Dict[str, Any]] = None
        # whole-chain programs: one verdict a chain (pipeline/chain_program.py);
        # a compiled chain's ops and the plumbing between its segments map
        # to ONE node
        self.chain_decisions: Dict[str, Any] = {}
        chain_of: Dict[Element, Tuple[Any, ChainProgram]] = {}
        for chain in plan.chains():
            decision = decide_chain(plan, chain)
            self.chain_decisions[chain.name] = decision
            if not decision.compiles:
                continue
            program = ChainProgram(chain, decision.unroll)
            for e in list(chain.ops) + self._interior_plumbing(chain):
                chain_of[e] = (chain, program)
        # the node that owns each element (a fused segment's ops share one)
        node_of: Dict[Element, _Node] = {}
        for e in p._toposort():
            cp = chain_of.get(e)
            if cp is not None:
                chain, program = cp
                if e is chain.first:
                    node = _ChainNode(self, chain, program, e.queue_size)
                    node_of[e] = node
                    self.nodes.append(node)
                else:
                    node_of[e] = node_of[chain.first]
                continue
            seg = plan.seg_of.get(e)
            if seg is not None and e is not seg.first:
                node_of[e] = node_of[seg.first]
                continue
            if isinstance(e, Source):
                node = _SourceNode(self, e)
            elif seg is not None:
                node = _SegmentNode(self, seg, e.queue_size)
            elif isinstance(e, Routing):
                node = _RoutingNode(self, e, p.n_sinks(e), e.queue_size)
            elif isinstance(e, HostElement):
                node = _HostNode(self, e, e.queue_size)
            elif isinstance(e, Sink):
                node = _SinkNode(self, e, e.queue_size)
                self.sinks.append(node)
            else:  # pragma: no cover - every ported element is one of the above
                raise TypeError(f"{e.name}: no executor node for {type(e).__name__}")
            node_of[e] = node
            self.nodes.append(node)
        self._node_of = node_of
        # wire each link from the node that emits its src pad (a segment
        # emits what its last op emits) to the node that owns its sink pad
        for l in p.links:
            dst = node_of[l.dst]
            if dst is node_of[l.src]:
                continue  # a link inside a fused segment or a chain
            node_of[l.src].outs.setdefault(l.src_pad, []).append((dst, l.dst_pad))
            san = self.sanitizer
            if san is not None:
                # the consumer pad's negotiated spec checks every put
                # (static tensor specs only: flexible and media links
                # negotiate a frame at a time)
                spec = l.dst.in_specs[l.dst_pad] if l.dst_pad < len(l.dst.in_specs) else None
                box = dst.inboxes[l.dst_pad] if l.dst_pad < len(dst.inboxes) else None
                if isinstance(spec, TensorsSpec) and spec.is_static and isinstance(box, SanQueue):
                    box.expected_spec = spec
        if self.sanitizer is not None:
            for n in self.nodes:
                for pad in n.outs:
                    self.sanitizer.register_pad(n.name, pad)
            for seg in plan.segments:
                seg.sanitize_poison = True
            for n in self.nodes:
                if isinstance(n, _ChainNode):
                    n.program.sanitize_poison = True
        if self.metrics is not None:
            # the per-node handles, made once here so a frame reads
            # attributes, never the registry
            for n in self.nodes:
                n._lat_hist = self.metrics.histogram("nns_element_latency_us", element=n.name)
                n._frames_ctr = self.metrics.counter("nns_element_frames_total", element=n.name)
                n._depth_hists = [
                    self.metrics.histogram("nns_queue_depth", lo=1.0, growth=2.0, nbuckets=16,
                                           element=n.name, pad=str(i))
                    for i in range(len(n.inboxes))]
                if getattr(getattr(n, "seg", None), "postproc_ops", 0):
                    n._postproc_ctr = self.metrics.counter(
                        "nns_fused_postproc_total", element=n.name)
                if isinstance(n, _ChainNode):
                    n._chain_launch_ctr = self.metrics.counter(
                        "nns_chain_launches_total", element=n.name)
                    n._chain_fallback_ctr = self.metrics.counter(
                        "nns_chain_fallback_total", element=n.name)
        if not self.sinks:
            self._finished.set()

    def _interior_plumbing(self, chain) -> List[Element]:
        """The queue / capsfilter elements between a chain's segments (the
        chain's node absorbs them)."""
        out: List[Element] = []
        members = {id(op) for op in chain.ops}
        for seg in chain.segments[:-1]:
            frontier = [l.dst for l in self.pipeline.out_links(seg.last)]
            while frontier:
                e = frontier.pop()
                if id(e) in members or e in out:
                    continue
                if is_plumbing(e) and self.plan.fused_seg(e) is None:
                    out.append(e)
                    frontier.extend(l.dst for l in self.pipeline.out_links(e))
        return out

    def make_inbox(self, size: int, node: "_Node", pad: int) -> "queue.Queue":
        """An inbox: the sanitizer's instrumented one, the metered one
        under a metrics registry, a plain bounded queue otherwise (the
        sanitizer wins when both are on)."""
        if self.sanitizer is not None:
            return SanQueue(size, self.sanitizer, node.name, pad)
        if self.metrics is not None:
            return _MeteredQueue(size, self.metrics.histogram(
                "nns_queue_wait_us", element=node.name, pad=str(pad)))
        return queue.Queue(maxsize=size)

    @property
    def stop_event(self) -> threading.Event:
        return self._stop

    @property
    def finished(self) -> bool:
        return self._finished.is_set()

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._t_run0 = time.perf_counter()
        # the run's transfer bytes are the process tally's delta from here
        # (totals()["transfer"], mirrored into nns_transfer_bytes_total)
        self._transfer_t0 = transfer.tally.snapshot()
        if self.metrics is not None:
            port = obs_metrics.resolve_port()
            if port is not None:
                from nnstreamer_tpu_torch.config import conf
                from nnstreamer_tpu_torch.obs.expo import MetricsServer

                # loopback unless widened on purpose: the endpoint has no auth
                host = conf().get("executor", "metrics_host", "127.0.0.1")
                try:
                    self._metrics_server = MetricsServer(
                        self.metrics, stats_fn=self.stats, totals_fn=self.totals,
                        host=host, port=port).start()
                except OSError as exc:
                    # a scrape endpoint never keeps a pipeline from starting
                    _log.error("metrics endpoint failed to bind: %s", exc)
        if self.sanitizer is not None:
            # threads that appear during the run and outlive stop() are
            # reported as leaks
            self._threads_at_start = set(threading.enumerate())
        for e in self.pipeline.elements:
            e.start()
        # every negotiated program exists before the first frame: on CUDA
        # each is captured here, before any node thread launches. A build
        # that fails with an ordinary error raises, after the elements are
        # stopped again; a device fault goes to the node's circuit (a
        # chain's: its per-node latch).
        try:
            for n in self.nodes:
                if isinstance(n, (_SegmentNode, _ChainNode)):
                    n.build()
        except BaseException:
            for e in self.pipeline.elements:
                e.stop()
            raise
        for n in self.nodes:
            n.thread.start()
        if self.watchdog_timeout_ms and self.watchdog_timeout_ms > 0:
            self._watchdog = threading.Thread(target=self._watchdog_loop,
                                              name="nns-watchdog", daemon=True)
            self._watchdog.start()

    # -- stall watchdog ----------------------------------------------------
    def progress_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Per node: frames processed and the depth of each inbox (the
        payload of PipelineStallError)."""
        return {n.name: {"frames": n.frames_processed,
                         "queued": [q.qsize() for q in n.inboxes]}
                for n in self.nodes}

    def _queued(self) -> bool:
        return any(q.qsize() for n in self.nodes for q in n.inboxes) or any(
            n.inflight() for n in self.nodes)

    def _watchdog_loop(self) -> None:
        """A hang is data queued somewhere and NO node progressing for
        longer than the timeout. An idle pipeline with empty queues (a live
        source waiting) is not one, nor is a node parked in a retry
        backoff. The detector cannot see inside one invoke, so the timeout
        must exceed the slowest legitimate one (a first build, a cold model
        load); it is off by default."""
        timeout_s = self.watchdog_timeout_ms / 1000.0
        beat = max(0.01, min(timeout_s / 4.0, 0.25))

        def counts():
            # a node working through its error policy is progressing
            return tuple((n.frames_processed,
                          (n.fault_stats.errors, n.fault_stats.retries)
                          if n.fault_stats is not None else (0, 0))
                         for n in self.nodes)

        last = counts()
        t_last = time.monotonic()
        while not self._stop.wait(beat):
            if self.finished or self.errors:
                return
            cur = counts()
            now = time.monotonic()
            if cur != last:
                last, t_last = cur, now
                continue
            if now - t_last <= timeout_s:
                continue
            if not self._queued() or any(
                    n.fault_gate is not None and n.fault_gate.backoff_deadline >= now
                    for n in self.nodes):
                t_last = now
                continue
            snapshot = self.progress_snapshot()
            self.stalled = True
            tracer = trace.get()
            if tracer is not None:
                tracer.fault("executor", "stall", None, timeout_ms=self.watchdog_timeout_ms)
            self._fail("watchdog", PipelineStallError(self.watchdog_timeout_ms, snapshot))
            return

    # -- warm restart: drain / snapshot / restore / resume ------------------
    def drain(self, timeout: float = 30.0, settle_s: Optional[float] = None) -> bool:
        """Quiesce at a frame boundary: park the sources, then wait until
        every inbox is empty, nothing is in flight and no node progressed
        across a settle window. True once quiescent; False on timeout or
        error (the pipeline keeps running either way; resume() continues).
        The settle window defaults to twice the slowest invoke seen (at
        least 60 ms, at most half the timeout), since the check cannot see
        inside an invoke; pass ``settle_s`` when the slowest has not been
        seen yet."""
        self._pause.set()
        if settle_s is None:
            worst_ms = max((n.max_invoke_ms for n in self.nodes), default=0.0)
            settle_s = min(max(0.06, 2.0 * worst_ms / 1000.0), max(0.06, timeout / 2.0))
        polls_needed = max(3, int(math.ceil(settle_s / 0.02)))
        deadline = time.monotonic() + timeout
        last = None
        settled = 0
        while time.monotonic() < deadline:
            if self.errors:
                return False
            counts = tuple(n.frames_processed for n in self.nodes)
            if not self._queued() and counts == last:
                settled += 1
                if settled >= polls_needed:
                    return True
            else:
                settled = 0
            last = counts
            time.sleep(0.02)
        return False

    def snapshot(self) -> Dict[str, Any]:
        """The warm-restart snapshot: per node its counters, OOM ceiling,
        circuit state and fault counters, and per element the state of a
        ``state_snapshot()`` hook (its own or its backend's). Take it after
        drain() for a frame-boundary-consistent capture; JSON by
        construction."""
        snap: Dict[str, Any] = {"version": 1, "nodes": {}, "elements": {}}
        for n in self.nodes:
            snap["nodes"][n.name] = n.device_snapshot()
        for e in self.pipeline.elements:
            hook = getattr(e, "state_snapshot", None)
            if hook is None:
                hook = getattr(getattr(e, "backend", None), "state_snapshot", None)
            if callable(hook):
                snap["elements"][e.name] = hook()
        return snap

    def save_snapshot(self, path: str) -> Dict[str, Any]:
        """snapshot() to a JSON file: written beside it, then atomically
        replaced, so a crashed writer never leaves half a snapshot."""
        snap = self.snapshot()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(snap, f)
        os.replace(tmp, path)
        return snap

    @staticmethod
    def read_snapshot(path: str) -> Dict[str, Any]:
        with open(path, encoding="utf-8") as f:
            return json.load(f)

    def restore(self, snap: Dict[str, Any]) -> None:
        """Apply a snapshot(): node counters now, the governor, circuit and
        fault sections once each node has built them (at once on a running
        executor), element state through ``state_restore()``. Unknown
        names are skipped with a warning."""
        by_name = {n.name: n for n in self.nodes}
        for name, d in (snap.get("nodes") or {}).items():
            node = by_name.get(name)
            if node is None:
                _log.warning("restore: no node %r in this pipeline", name)
                continue
            node.restore_state(d)
            if self._started:
                node._apply_pending_restore()
        elems = {e.name: e for e in self.pipeline.elements}
        for name, d in (snap.get("elements") or {}).items():
            e = elems.get(name)
            if e is None:
                _log.warning("restore: no element %r in this pipeline", name)
                continue
            hook = getattr(e, "state_restore", None)
            if hook is None:
                hook = getattr(getattr(e, "backend", None), "state_restore", None)
            if callable(hook):
                hook(d)

    def resume(self, snap: Optional[Dict[str, Any]] = None) -> None:
        """Un-park the sources after drain(), restoring ``snap`` first."""
        if snap is not None:
            self.restore(snap)
        self._pause.clear()

    def inflight(self) -> int:
        """Frames queued or in flight between the nodes."""
        return (sum(q.qsize() for n in self.nodes for q in n.inboxes)
                + sum(n.inflight() for n in self.nodes))

    # -- accounting ----------------------------------------------------------
    def stats(self) -> Dict[str, dict]:
        """Per node: ``frames`` and its inbox depths; for a fused segment its
        programs (``n_traces``, whether they are CUDA graphs, the ops that
        kept them eager); the batch snapshot of a node that collects
        windows; the fault counters once a policy saw an error; deadline
        sheds; the device circuit's and the OOM governor's counters once
        they saw a fault; a filter's replica (``rep_*``) and fallback
        (``cb_*``) counters; a plane filter's ``plane_*`` rows; an LLM
        serversrc's batcher counters and SLO request rows (``serving_*``,
        ``serving_requests`` the rows nns-top --requests renders). Every
        row has ``proc_ms_ema`` and ``fps``; with metrics on, the latency
        percentiles of each invoke (``latency_p50/p95/p99_ms``) and of the
        inbox waits (``queue_wait_p50/p99_ms``); a compiled chain its
        segments, window, launches and ``chain_fallback`` (frames the
        per-node path served); under the sanitizer the ``san_*`` counts.
        Reads what the nodes recorded; opens no backend."""
        out: Dict[str, dict] = {}
        t_end = self._t_run_end or time.perf_counter()
        elapsed = t_end - self._t_run0 if self._t_run0 is not None else 0.0
        for n in self.nodes:
            row: dict = {"frames": n.frames_processed,
                         "proc_ms_ema": round(n.proc_time_ema_ms, 3)}
            if elapsed > 0:
                row["fps"] = round(n.frames_processed / elapsed, 2)
            if n.inboxes:
                row["queue_depth"] = [q.qsize() for q in n.inboxes]
            lat = n._lat_hist
            if lat is not None and lat.count:
                p50, p95, p99 = lat.percentiles()
                row.update(latency_p50_ms=round(p50 / 1000.0, 3),
                           latency_p95_ms=round(p95 / 1000.0, 3),
                           latency_p99_ms=round(p99 / 1000.0, 3))
            whs = [q.wait_hist for q in n.inboxes
                   if isinstance(q, _MeteredQueue) and q.wait_hist.count]
            wh = whs[0] if len(whs) == 1 else None
            if len(whs) > 1:
                # a join's pads merged (one ladder), so a backpressured pad
                # cannot hide behind a trickle-fed one
                wh = obs_metrics.Histogram(whs[0].name, {}, lo=whs[0].lo, growth=whs[0].growth,
                                           nbuckets=len(whs[0].counts))
                for h in whs:
                    wh.merge(h)
            if wh is not None:
                row["queue_wait_p50_ms"] = round(wh.quantile(0.50) / 1000.0, 3)
                row["queue_wait_p99_ms"] = round(wh.quantile(0.99) / 1000.0, 3)
            seg = getattr(n, "seg", None)
            elem = seg.first if seg is not None else getattr(n, "elem", None)
            if isinstance(n, _ChainNode):
                elem = n.chain.first
                prog = n.program
                row.update(chain_segments=len(n.chain.segments), chain_unroll=prog.unroll,
                           chain_launches=prog.launches, chain_replays=prog.replays,
                           chain_fallback=n.fallback_frames, n_traces=prog.n_traces,
                           captured=prog.captured, uncapturable=list(prog.programs.uncapturable))
                if n.fallback_windows:
                    row["chain_fallback_windows"] = n.fallback_windows
                if n.hazard:
                    row["chain_hazard"] = n.hazard
                if n.fallback_latched:
                    row["device_degraded"] = 1
            if seg is not None:
                if seg.fused:
                    row.update(n_traces=seg.n_traces, captured=seg.captured,
                               uncapturable=list(seg.uncapturable))
                if n.batched():
                    row.update(seg.batch_stats.snapshot())
            fs = n.fault_stats
            if fs is not None and (fs.errors or fs.retries):
                row.update(fs.snapshot())
            if n.deadline_shed:
                row["deadline_shed"] = n.deadline_shed
            circ = n.device_circuit
            if circ is not None and (circ.faults or circ.opens):
                row.update(device_degraded=1 if circ.open else 0, device_faults=circ.faults,
                           device_fault_kinds=dict(circ.kinds),
                           device_eager_invokes=circ.eager_invokes,
                           device_circuit_opens=circ.opens, device_circuit_closes=circ.closes)
            gov = n.bucket_governor
            if gov is not None and gov.ooms:
                row.update(oom_events=gov.ooms, batch_ceiling=gov.ceiling,
                           oom_reprobes=gov.reprobes)
                if gov.degraded:
                    row["device_degraded"] = 1
                else:
                    row.setdefault("device_degraded", 0)
            for hook, prefix in (("admission_stats", "adm_"), ("fleet_stats", "fleet_"),
                                 ("circuit_stats", "cb_"), ("replica_stats", "rep_"),
                                 ("plane_stats", "plane_"), ("serving_stats", "serving_")):
                fn = getattr(elem, hook, None)
                got = fn() if callable(fn) else None
                if got:
                    row.update({f"{prefix}{k}": v for k, v in got.items()})
            if self.sanitizer is not None:
                row.update(self.sanitizer.node_snapshot(n))
            out[n.name] = row
        return out

    def totals(self) -> Dict[str, Any]:
        """Pipeline-wide frame accounting: what the sources produced is
        rendered at a sink, dropped with a reason, or (mid-run) in flight.
        For 1:1 chains, ``produced + created == rendered + dropped`` after
        EOS (``balance`` 0); a routed frame is rendered at its dead-letter
        sink."""
        produced = rendered = 0
        dropped: Dict[str, int] = {}
        created: Dict[str, int] = {}
        for n in self.nodes:
            if isinstance(n, _SourceNode):
                produced += n.frames_processed
            elif isinstance(n, _SinkNode):
                rendered += n.frames_processed
            elem = getattr(n, "elem", None)
            for attr, bucket in (("drop_stats", dropped), ("create_stats", created)):
                fn = getattr(elem, attr, None)
                if callable(fn):
                    for reason, count in fn().items():
                        bucket[reason] = bucket.get(reason, 0) + count
            fs = n.fault_stats
            if fs is not None:
                for reason, count in (("on-error-drop", fs.dropped - fs.routed_unlinked),
                                      ("on-error-route-unlinked", fs.routed_unlinked)):
                    if count:
                        dropped[reason] = dropped.get(reason, 0) + count
            if n.deadline_shed:
                dropped["deadline-shed"] = dropped.get("deadline-shed", 0) + n.deadline_shed
        return {
            "produced": produced,
            "rendered": rendered,
            "dropped": dropped,
            "created": created,
            "balance": produced + sum(created.values()) - rendered - sum(dropped.values()),
            "transfer": self.transfer_totals(),
        }

    def transfer_totals(self) -> Dict[str, int]:
        """This run's host↔device bytes through the transfer engine
        (pipeline/transfer.py), by direction: the process tally minus the
        baseline start() took. ``d2h`` 0 across a chain of segments is the
        zero-host-bytes handoff. The tally is process-wide, so executors
        running AT ONCE in one process see each other's bytes here."""
        now = transfer.tally.snapshot()
        base = self._transfer_t0
        return {"h2d": now["h2d_bytes"] - base["h2d_bytes"],
                "d2h": now["d2h_bytes"] - base["d2h_bytes"]}

    def transfer_crosscheck(self) -> Dict[str, Any]:
        """The static transfer model (analysis/costmodel.py
        ``plan_transfer_boundaries``, over the plan this executor runs)
        against this run's tally: each boundary's bytes a frame times the
        frames of the node that moves them (rate limiters and windows
        change cardinality), against :meth:`transfer_totals`. Returns
        ``{"predicted", "measured", "delta", "chains"}``; a zero delta on a
        run alone in its process is the model's proof. ``chains``: for
        each compiled chain, the interior bytes predicted (0: its members
        are one node, so no interior link exists to cross)."""
        from nnstreamer_tpu_torch.analysis.costmodel import plan_transfer_boundaries

        elems = {e.name: e for e in self.pipeline.elements}
        boundaries = plan_transfer_boundaries(self.plan)

        def frames(name: str) -> int:
            node = self._node_of.get(elems.get(name))
            return node.frames_processed if node is not None else 0

        predicted = {"h2d": 0, "d2h": 0}
        for b in boundaries:
            predicted[b.direction] += b.bytes_per_frame * frames(b.node)
        measured = self.transfer_totals()
        chains = []
        for n in self.nodes:
            if not isinstance(n, _ChainNode):
                continue
            member = {op.name for op in n.chain.ops}
            interior = sum(b.bytes_per_frame * frames(b.node) for b in boundaries
                           if b.producer in member and b.consumer in member)
            chains.append({"chain": n.name, "unroll": n.program.unroll,
                           "launches": n.program.launches,
                           "predicted_interior": interior, "measured_interior": 0})
        return {
            "predicted": predicted,
            "measured": measured,
            "delta": {k: measured[k] - predicted[k] for k in ("h2d", "d2h")},
            "chains": chains,
        }

    # -- lifecycle -----------------------------------------------------------
    def _fail(self, where: str, exc: BaseException) -> None:
        _log.error("%s: %s", where, exc)
        with self._lock:
            self.errors.append(exc)
        self._stop.set()
        self._finished.set()

    def _sink_done(self) -> None:
        if all(s.done.is_set() for s in self.sinks):
            self._finished.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every sink saw EOS or a node failed; False on
        timeout."""
        return self._finished.wait(timeout)

    def stop(self) -> None:
        """Stop every node thread (and the watchdog), join them, release
        element resources. The metrics endpoint closes first; the run's
        transfer bytes are mirrored into the registry after the join. Under
        the sanitizer, threads that outlive the stop are reported, and each
        1:1 node's frame accounting is latched at a clean EOS."""
        first = not self._stop.is_set() or self._t_run_end is None
        self._stop.set()
        if self._t_run_end is None:
            self._t_run_end = time.perf_counter()
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None
        deadline = time.monotonic() + 10.0
        threads = [n.thread for n in self.nodes]
        if self._watchdog is not None:
            threads.append(self._watchdog)
        for t in threads:
            if t.is_alive():
                t.join(max(0.0, deadline - time.monotonic()))
        if self.metrics is not None:
            transfer.mirror_into(self.metrics)
        if self.xray_crosscheck and first:
            # after the join: the tally holds every fetch of the run
            try:
                cc = self.last_crosscheck = self.transfer_crosscheck()
                level = _log.warning if any(cc["delta"].values()) else _log.info
                level("xray cross-check: predicted=%s measured=%s delta=%s",
                      cc["predicted"], cc["measured"], cc["delta"])
            except Exception as exc:  # noqa: BLE001 — advisory, never fatal
                _log.warning("xray cross-check failed: %s", exc)
        for e in self.pipeline.elements:
            e.stop()
        if not first:
            return
        leaked = [t.name for t in threads if t.is_alive() and t.ident is not None]
        san = self.sanitizer
        if san is not None and self._threads_at_start is not None:
            ours, me = set(threads), threading.current_thread()
            leaked += [t.name for t in threading.enumerate()
                       if t.is_alive() and t is not me and t not in ours
                       and t not in self._threads_at_start]
        self.leaked_threads = leaked
        if leaked:
            _log.warning("threads alive after shutdown: %s", leaked)
            if san is not None:
                san.thread_leak(leaked)
        if san is not None and all(sk.done.is_set() for sk in self.sinks) and not self.errors:
            for n in self.nodes:
                if self._accounting_eligible(n):
                    san.check_accounting(n)

    def _accounting_eligible(self, n: "_Node") -> bool:
        """Nodes whose offered == delivered + dropped + routed is defined:
        fused segments and compiled chains (1:1 TensorOps) and elements
        declaring ``SAN_ONE_TO_ONE``, minus any with upstream QoS wired and
        any whose thread still runs."""
        if isinstance(n, _ChainNode):
            elem = n.chain.first
        elif isinstance(n, _SegmentNode) and n.seg.fused:
            elem = n.seg.first
        else:
            elem = getattr(n, "elem", None)
            if elem is None or not getattr(type(elem), "SAN_ONE_TO_ONE", False):
                return False
        if elem.qos_sources:
            return False
        return not n.thread.is_alive()
