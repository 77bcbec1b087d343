"""Streaming executor: one thread per node, bounded queues between them.

The counterpart of ``nnstreamer_tpu/pipeline/executor.py``, with three
node kinds only: sources, fused segments and sinks (GStreamer's
streaming-thread model: pipeline parallelism across nodes, backpressure
through the bounded queues). A source thread generates host frames, a
segment thread moves each frame to the device and queues its work there,
and a sink thread waits for the results and renders them, so the host
work of frame N+1 overlaps the device work of frame N.

The first error in any node stops every node; :meth:`Executor.wait`
returns and :attr:`Executor.errors` holds it.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional

from nnstreamer_tpu_torch.elements.base import Element, Sink, Source
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.pipeline.graph import ExecPlan, FusedSegment
from nnstreamer_tpu_torch.tensors.frame import EOS_FRAME

_log = get_logger("executor")

_POLL_S = 0.05  # bounded waits keep every thread responsive to stop()


class _Node:
    def __init__(self, ex: "Executor", name: str, inbox: Optional[queue.Queue]) -> None:
        self.ex = ex
        self.name = name
        self.inbox = inbox
        self.outbox: Optional[queue.Queue] = None
        self.thread = threading.Thread(target=self._main, name=f"nns-{name}", daemon=True)

    def _main(self) -> None:
        try:
            self.run()
        except BaseException as exc:  # noqa: BLE001 — reported, never lost
            self.ex._fail(self.name, exc)

    def get(self):
        while not self.ex._stop.is_set():
            try:
                return self.inbox.get(timeout=_POLL_S)
            except queue.Empty:
                continue
        return None

    def put(self, item) -> bool:
        while not self.ex._stop.is_set():
            try:
                self.outbox.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def run(self) -> None:
        raise NotImplementedError


class _SourceNode(_Node):
    def __init__(self, ex, elem: Source) -> None:
        super().__init__(ex, elem.name, None)
        self.elem = elem

    def run(self) -> None:
        while not self.ex._stop.is_set():
            frame = self.elem.generate()
            if frame is None:  # nothing ready yet (appsrc, an LLM server): poll again
                continue
            if not self.put(frame) or frame is EOS_FRAME:
                return


class _SegmentNode(_Node):
    def __init__(self, ex, seg: FusedSegment, inbox: queue.Queue) -> None:
        super().__init__(ex, seg.name, inbox)
        self.seg = seg

    def run(self) -> None:
        while True:
            frame = self.get()
            if frame is None:
                return
            if frame is EOS_FRAME:
                self.put(frame)
                return
            if not self.put(self.seg.process(frame)):
                return


class _SinkNode(_Node):
    def __init__(self, ex, elem: Sink, inbox: queue.Queue) -> None:
        super().__init__(ex, elem.name, inbox)
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
        self.pipeline = plan.pipeline
        self.errors: List[BaseException] = []
        self._stop = threading.Event()
        self._finished = threading.Event()
        self._lock = threading.Lock()
        self.nodes: List[_Node] = []
        self.sinks: List[_SinkNode] = []
        self._started = False
        # the node that owns each element, and the queue in front of it
        node_of: Dict[Element, _Node] = {}
        for e in self.pipeline._toposort():
            ups = self.pipeline.in_links(e)
            inbox = queue.Queue(maxsize=max(1, e.queue_size)) if ups else None
            seg = plan.seg_of.get(e)
            if seg is not None and e is not seg.first:
                node_of[e] = node_of[seg.first]
                continue
            if isinstance(e, Source):
                node = _SourceNode(self, e)
            elif seg is not None:
                node = _SegmentNode(self, seg, inbox)
            elif isinstance(e, Sink):
                node = _SinkNode(self, e, inbox)
                self.sinks.append(node)
            else:  # pragma: no cover - every ported element is one of the above
                raise TypeError(f"{e.name}: no executor node for {type(e).__name__}")
            for l in ups:
                node_of[l.src].outbox = inbox
            node_of[e] = node
            self.nodes.append(node)
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
        for n in self.nodes:
            n.thread.start()

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
