"""Streaming executor: one thread per node, bounded per-pad queues.

The counterpart of ``nnstreamer_tpu/pipeline/executor.py`` with five node
kinds: sources, fused segments, host elements, routing elements and sinks
(GStreamer's streaming-thread model: pipeline parallelism across nodes,
backpressure through the bounded queues). A source thread generates host
frames, a segment thread moves each frame to the device and queues its
work there, and a sink thread waits for the results and renders them, so
the host work of frame N+1 overlaps the device work of frame N.

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
submitted. Delivery is strictly FIFO at every depth, and a failed window
raises its error whole, as a failed window of a fused segment does (the
port has no per-frame fault gate yet).

The first error in any node stops every node; :meth:`Executor.wait`
returns and :attr:`Executor.errors` holds it.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.elements.base import Element, HostElement, Routing, Sink, Source
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.pipeline.batching import BatchCollector
from nnstreamer_tpu_torch.pipeline.graph import ExecPlan, FusedSegment
from nnstreamer_tpu_torch.tensors.frame import EOS_FRAME

_log = get_logger("executor")

_POLL_S = 0.05  # bounded waits keep every thread responsive to stop()


class _Node:
    def __init__(self, ex: "Executor", name: str, n_inboxes: int, depth: int) -> None:
        self.ex = ex
        self.name = name
        self.inboxes = [queue.Queue(maxsize=max(1, depth)) for _ in range(n_inboxes)]
        # src pad → [(downstream node, its sink pad)]
        self.outs: Dict[int, List[Tuple["_Node", int]]] = {}
        self.thread = threading.Thread(target=self._main, name=f"nns-{name}", daemon=True)

    def _main(self) -> None:
        try:
            self.run()
        except BaseException as exc:  # noqa: BLE001 — reported, never lost
            self.ex._fail(self.name, exc)

    def notify(self) -> None:
        """A producer put a frame into one of this node's inboxes."""

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
        while not self.ex._stop.is_set():
            frame = self.elem.generate()
            if frame is None:  # nothing ready yet (appsrc, an LLM server): poll again
                continue
            if frame is EOS_FRAME:
                self.broadcast_eos()
                return
            if not self.push_out(0, frame):
                return


class _SegmentNode(_Node):
    def __init__(self, ex, seg: FusedSegment, depth: int) -> None:
        super().__init__(ex, seg.name, 1, depth)
        self.seg = seg

    def batched(self) -> bool:
        """Whether this node collects windows: batching active, and a fused
        segment or an op whose backend declared ``batchable``."""
        cfg = self.seg.batch_config
        return bool(cfg is not None and cfg.active
                    and (self.seg.fused or self.seg.first.is_batch_capable()))

    def run(self) -> None:
        if self.batched():
            if not self.seg.fused and getattr(self.seg.first, "plane", ""):
                self._run_plane(self.seg.batch_config, self.seg.first.plane_inflight)
            else:
                self._run_batched(self.seg.batch_config)
            return
        while True:
            frame = self.get()
            if frame is None:
                return
            if frame is EOS_FRAME:
                if self.push_all(self.seg.first.flush() if not self.seg.fused else None):
                    self.broadcast_eos()
                return
            if _qos_skip(self.seg.first, frame):
                continue
            if not self.push_all(self.seg.process(frame)):
                return

    def _run_batched(self, cfg) -> None:
        """Micro-batched loop: collect up to max-batch frames, ONE program
        for the window (:meth:`FusedSegment.process_batch`), its frames on
        in order; a partial window flushes at EOS. A failed window raises,
        as a failed frame does."""
        seg = self.seg
        collector = BatchCollector(self.inboxes[0], self.ex._stop, cfg,
                                   drop=lambda f: _qos_skip(seg.first, f))
        while True:
            frames, eos, wait_s = collector.collect()
            if frames:
                outs, rows = seg.process_batch(frames, cfg)
                seg.batch_stats.record(len(frames), rows, wait_s)
                if not self.push_all(outs):
                    return
            if eos:
                break
        if collector.stopped:
            return
        if self.push_all(seg.first.flush() if not seg.fused else None):
            self.broadcast_eos()

    def _run_plane(self, cfg, depth: int) -> None:
        """Plane submits: each collected window is submitted as a ticket,
        and the oldest ticket is redeemed (its frames delivered) once
        ``depth`` tickets are in flight, the inbox idles, or EOS flushes
        them; depth 1 redeems each window at once. Delivery is strictly
        FIFO. A failed window raises its error whole: no frame of it is
        delivered, and every earlier window was."""
        seg = self.seg
        elem = seg.first
        collector = BatchCollector(self.inboxes[0], self.ex._stop, cfg,
                                   drop=lambda f: _qos_skip(elem, f))
        ring: deque = deque()  # (frames, ticket, collector wait)
        inbox = self.inboxes[0]

        def deliver_one() -> bool:
            frames, ticket, wait_s = ring.popleft()
            outs = elem.host_collect_window(ticket)
            seg.batch_stats.record(len(frames), len(frames), wait_s)
            return self.push_all(outs)

        while True:
            while ring and inbox.empty():
                # idle input: deliver in order so latency stays bounded
                if not deliver_one():
                    return
            frames, eos, wait_s = collector.collect()
            if frames:
                if not elem.DEVICE_PASSTHROUGH:
                    frames = [f.to_device(seg.device) for f in frames]
                ring.append((frames, elem.host_submit_window_async(frames), wait_s))
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


class _HostNode(_Node):
    def __init__(self, ex, elem: HostElement, depth: int) -> None:
        super().__init__(ex, elem.name, 1, depth)
        self.elem = elem

    def run(self) -> None:
        while True:
            frame = self.get()
            if frame is None:
                return
            if frame is EOS_FRAME:
                if self.push_all(self.elem.flush()):
                    self.broadcast_eos()
                return
            if _qos_skip(self.elem, frame):
                continue
            if not self.push_all(self.elem.process(frame)):
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
                        pairs = self.elem.receive(pad, item)
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
            self.elem.render(frame)


class Executor:
    def __init__(self, plan: ExecPlan) -> None:
        self.plan = plan
        self.pipeline = p = plan.pipeline
        self.errors: List[BaseException] = []
        self._stop = threading.Event()
        self._finished = threading.Event()
        self._lock = threading.Lock()
        self.nodes: List[_Node] = []
        self.sinks: List[_SinkNode] = []
        self._started = False
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
        # that fails raises, after the elements are stopped again.
        try:
            for seg in self.plan.segments:
                seg.build()
        except BaseException:
            for e in self.pipeline.elements:
                e.stop()
            raise
        for n in self.nodes:
            n.thread.start()

    def stats(self) -> Dict[str, dict]:
        """Per node: its programs (``n_traces``, whether they are CUDA
        graphs, the ops that kept them eager) for a fused segment, the
        batch snapshot of a node that collects windows, and a plane
        filter's ``plane_*`` rows (the plane's counters and this stream's).
        Reads what the fills recorded; opens no backend."""
        out: Dict[str, dict] = {}
        for n in self.nodes:
            seg = getattr(n, "seg", None)
            if seg is None:
                continue
            row: dict = {}
            if seg.fused:
                row.update(n_traces=seg.n_traces, captured=seg.captured,
                           uncapturable=list(seg.uncapturable))
            if n.batched():
                row.update(seg.batch_stats.snapshot())
            plane_stats = getattr(seg.first, "plane_stats", None)
            if callable(plane_stats):
                row.update({f"plane_{k}": v for k, v in plane_stats().items()})
            out[n.name] = row
        return out

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
        """Stop every node thread, join them, release element resources."""
        self._stop.set()
        deadline = time.monotonic() + 10.0
        for n in self.nodes:
            if n.thread.is_alive():
                n.thread.join(max(0.0, deadline - time.monotonic()))
        for e in self.pipeline.elements:
            e.stop()
