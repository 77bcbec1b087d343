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
:class:`PipelineStallError`. The reference's ``nns_*`` metrics and trace
events come with the port's observability layer; until then the counters
live in :meth:`Executor.stats`.
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

from nnstreamer_tpu_torch.elements.base import Element, HostElement, Routing, Sink, Source
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.pipeline.batching import BatchCollector
from nnstreamer_tpu_torch.pipeline.device_faults import (
    BucketGovernor,
    DeviceCircuit,
    classify_device_fault,
)
from nnstreamer_tpu_torch.pipeline.faults import (
    FaultGate,
    PipelineStallError,
    frame_deadline_expired,
    notify_shed,
    resolve_fault_policy,
    watchdog_timeout_ms,
)
from nnstreamer_tpu_torch.pipeline.graph import ExecPlan, FusedSegment
from nnstreamer_tpu_torch.tensors.frame import EOS_FRAME

_log = get_logger("executor")

_POLL_S = 0.05  # bounded waits keep every thread responsive to stop()


class _Stop(Exception):
    """Raised through a retry's backoff sleep when the executor stops."""


class _Node:
    def __init__(self, ex: "Executor", name: str, n_inboxes: int, depth: int) -> None:
        self.ex = ex
        self.name = name
        self.inboxes = [queue.Queue(maxsize=max(1, depth)) for _ in range(n_inboxes)]
        # src pad → [(downstream node, its sink pad)]
        self.outs: Dict[int, List[Tuple["_Node", int]]] = {}
        self.thread = threading.Thread(target=self._main, name=f"nns-{name}", daemon=True)
        # the node's thread is the only writer of these counters
        self.frames_processed = 0
        self.max_invoke_ms = 0.0  # the slowest invoke seen (drain's settle window)
        self.deadline_shed = 0
        self.fault_gate: Optional[FaultGate] = None
        self.device_circuit: Optional[DeviceCircuit] = None
        self.bucket_governor: Optional[BucketGovernor] = None
        # a warm-restart snapshot restored before the loop built what it
        # restores (Executor.restore on a fresh executor)
        self._pending_restore: Optional[Dict[str, Any]] = None

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
        """Frames taken from the inbox but not yet delivered (a plane
        node's parked windows): drain and the watchdog must see them."""
        return 0

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

    def run(self) -> None:
        raise NotImplementedError

    # -- accounting --------------------------------------------------------
    def stat(self, t0: float, n: int = 1) -> None:
        """``n`` frames left this node; ``t0`` is when their work began."""
        self.frames_processed += n
        dt = (time.perf_counter() - t0) * 1000.0
        if dt > self.max_invoke_ms:
            self.max_invoke_ms = dt

    def shed_if_expired(self, item) -> bool:
        """Shed a frame whose client deadline (``deadline_ms`` since
        ``admit_t``) passed before this node spent time on it; counted."""
        meta = getattr(item, "meta", None)
        if not meta or "deadline_ms" not in meta or not frame_deadline_expired(meta):
            return False
        self.deadline_shed += 1
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
    def dispose_fault(self, frame, exc: Exception) -> bool:
        """A fault outside a gated invoke (a plane window's frame that failed
        to reach the device): classify and count it (the circuit included),
        then dispose of the frame through the error policy. False under
        ``stop``: the caller re-raises. ``retry`` degrades to route-or-drop,
        as an exhausted budget does."""
        kind = classify_device_fault(exc)
        circ = self.device_circuit
        if kind is not None and circ is not None:
            circ.record_fault(kind)
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
        """The plane's parked windows and a frame the collector holds in
        its straggler wait (neither queued nor delivered)."""
        held = self._collector.held if self._collector is not None else 0
        return held + sum(len(e[0]) for e in self._plane_ring)

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
        try:
            seg.build_frame()
        except Exception as exc:
            if classify_device_fault(exc) is None:
                raise
            self._pending_fault = exc
        try:
            seg.build_batched()
        except Exception as exc:
            kind = classify_device_fault(exc)
            circ = self.device_circuit
            if kind == "compile":
                if circ is None or not circ.record_fault(kind):
                    raise
                self._pending_fault = None
            elif kind is None:
                raise
            else:
                _log.warning("%s: building the max-batch program failed: %s", self.name, exc)

    # -- loops ---------------------------------------------------------------
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
        while True:
            frame = self.get()
            if frame is None:
                return
            if frame is EOS_FRAME:
                if self.push_all(seg.first.flush() if not seg.fused else None):
                    self.broadcast_eos()
                return
            if self.shed_if_expired(frame) or _qos_skip(seg.first, frame):
                continue
            t0 = time.perf_counter()
            if gate is None:
                out = self._process_frame(frame)
            else:
                delivered, out = gate.process(frame, self._process_frame)
                if not delivered:
                    continue
            self.stat(t0)
            if not self.push_all(out):
                return

    def _run_batched(self, cfg, gate) -> None:
        """Micro-batched loop: collect up to max-batch frames (the OOM
        governor's ceiling when degraded), ONE program a chunk through the
        degradation ladder (:meth:`_invoke_window`), its frames on in order;
        a partial window flushes at EOS."""
        seg = self.seg
        gov = self.bucket_governor
        collector = self._collector = BatchCollector(
            self.inboxes[0], self.ex._stop, cfg, drop=lambda f: _qos_skip(seg.first, f),
            cap=gov.cap if gov is not None else None)
        while True:
            frames, eos, wait_s = collector.collect()
            frames = [f for f in frames if not self.shed_if_expired(f)]
            if frames:
                t0 = time.perf_counter()
                outs, rows = self._invoke_window(frames, cfg, gate)
                seg.batch_stats.record(len(frames), rows, wait_s)
                self.stat(t0, len(frames))
                if not self.push_all(outs):
                    return
            if eos:
                break
        if collector.stopped:
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
            self.stat(t0, len(frames))
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
            kind = classify_device_fault(exc)
            if kind is None or not circ.record_fault(kind):
                raise
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
                kind = classify_device_fault(exc)
                if kind is None:
                    raise
                circ.record_fault(kind)  # stays open; the kind is counted
            else:
                circ.close()
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
                kind = classify_device_fault(exc)
                # a fused window OOMs at its padded bucket; a host window at
                # its width, and a lone host frame has nothing to shrink
                if kind == "oom" and gov is not None and (seg.fused or len(chunk) > 1):
                    attempted = (cfg.bucket_for(len(chunk)) if seg.fused and len(chunk) > 1
                                 else len(chunk))
                    if gov.on_oom(attempted) is not None:
                        pending.appendleft(chunk)  # retried, shrunk
                        continue
                if kind is not None and circ is not None and circ.record_fault(kind):
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
            if gov is not None:
                gov.on_ok(bucket)
            outs.extend(got)
            rows += bucket
        return outs, rows

    def _recover_window(self, frames, exc: BaseException, cfg, gate) -> List:
        """A plane window whose ticket failed, through the host ladder: an
        OOM shrinks the governor's ceiling and re-runs the window chunked;
        anything else splits per frame through the gate (each frame its
        own blocking plane round trip), or raises whole without one."""
        gov = self.bucket_governor
        if (classify_device_fault(exc) == "oom" and gov is not None and len(frames) > 1
                and gov.on_oom(len(frames)) is not None):
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
        while True:
            frame = self.get()
            if frame is None:
                return
            if frame is EOS_FRAME:
                self.elem.on_eos()
                self.done.set()
                self.ex._sink_done()
                return
            t0 = time.perf_counter()
            self.elem.render(frame)
            self.stat(t0)


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
        self._lock = threading.Lock()
        self.nodes: List[_Node] = []
        self.sinks: List[_SinkNode] = []
        self._started = False
        # the stall watchdog ([executor] watchdog_timeout_ms; 0 = off),
        # read here so a caller may set the attribute before start()
        self.watchdog_timeout_ms = watchdog_timeout_ms()
        self._watchdog: Optional[threading.Thread] = None
        self.stalled = False
        # the node that owns each element (a fused segment's ops share one)
        node_of: Dict[Element, _Node] = {}
        for e in p._toposort():
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
        # wire each link from the node that emits its src pad (a segment
        # emits what its last op emits) to the node that owns its sink pad
        for l in p.links:
            dst = node_of[l.dst]
            if dst is node_of[l.src]:
                continue  # a link inside a fused segment
            node_of[l.src].outs.setdefault(l.src_pad, []).append((dst, l.dst_pad))
        if not self.sinks:
            self._finished.set()

    @property
    def finished(self) -> bool:
        return self._finished.is_set()

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for e in self.pipeline.elements:
            e.start()
        # every negotiated program exists before the first frame: on CUDA
        # each is captured here, before any node thread launches. A build
        # that fails with an ordinary error raises, after the elements are
        # stopped again; a device fault goes to the node's circuit.
        try:
            for n in self.nodes:
                if isinstance(n, _SegmentNode):
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
        (``cb_*``) counters; and a plane filter's ``plane_*`` rows. Reads
        what the nodes recorded; opens no backend."""
        out: Dict[str, dict] = {}
        for n in self.nodes:
            row: dict = {"frames": n.frames_processed}
            if n.inboxes:
                row["queue_depth"] = [q.qsize() for q in n.inboxes]
            seg = getattr(n, "seg", None)
            elem = seg.first if seg is not None else getattr(n, "elem", None)
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
            for hook, prefix in (("circuit_stats", "cb_"), ("replica_stats", "rep_"),
                                 ("plane_stats", "plane_")):
                fn = getattr(elem, hook, None)
                if callable(fn):
                    row.update({f"{prefix}{k}": v for k, v in fn().items()})
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
        element resources."""
        self._stop.set()
        deadline = time.monotonic() + 10.0
        threads = [n.thread for n in self.nodes]
        if self._watchdog is not None:
            threads.append(self._watchdog)
        for t in threads:
            if t.is_alive():
                t.join(max(0.0, deadline - time.monotonic()))
        for e in self.pipeline.elements:
            e.stop()
