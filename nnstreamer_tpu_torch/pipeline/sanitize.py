"""nns-san runtime side: the pipeline sanitizer.

The counterpart of ``nnstreamer_tpu/pipeline/sanitize.py``. Enabled with
``NNS_TPU_SANITIZE=1`` (or ``[executor] sanitize = true``; env wins, the
standard layering). When on, the executor swaps every
inter-node inbox for an instrumented :class:`SanQueue` and checks the
invariants the streaming machinery is supposed to preserve but nothing
verified until now:

- **spec conformance (NNS-S001)** — every frame put onto a negotiated
  STATIC link must match the consumer pad's ``TensorsSpec`` (tensor
  count, shapes modulo wildcards, dtypes). A violation raises a typed
  :class:`SpecViolationError` through the producing node, so the stream
  fails AT the corruption point instead of wherever the drifted shape
  finally crashes (or silently retraces) downstream.
- **frame accounting (NNS-S002)** — at clean EOS, for every node whose
  element declares 1:1 cardinality (``SAN_ONE_TO_ONE``) or is a fused
  segment of pure TensorOps: ``offered == delivered + dropped + routed``.
  Catches frames silently vanishing (an element returning None without
  accounting) and duplication.
- **lock order (NNS-S003)** — :class:`TrackedLock` records per-thread
  acquisition order into a :class:`LockOrderGraph`; a cyclic edge set is
  a latent deadlock, reported with the cycle. The executor wraps its own
  locks; user/test code can watch more via :meth:`Sanitizer.lock`.
- **thread leaks (NNS-S004)** — ``Executor.stop()`` joins every thread it
  started with a bounded budget and reports stragglers; under the
  sanitizer, threads that appeared during the run (element/edge service
  threads) and outlive shutdown are reported too.
- **pad-row poison** — micro-batch padding rows are filled with poison
  (NaN / integer max) instead of replicas of the last frame, so an
  off-by-one in batch splitting surfaces as an obviously-wrong value
  instead of a plausibly-stale one (``graph.py process_batch`` and the
  chain program's trailing window).

Findings are the analyzers' ``Diagnostic`` records (analysis/diagnostics.py:
codes ``NNS-S0xx`` of the shared catalog, in one ``LintReport``), surfaced
through ``Executor.sanitizer.report``, ``Executor.stats()`` per-node
counters, and ``trace.py`` instant events.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import queue

import numpy as np
import torch

from nnstreamer_tpu_torch.analysis.diagnostics import LintReport
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.tensors.frame import EOS_FRAME, Frame
from nnstreamer_tpu_torch.tensors.spec import TensorsSpec

_log = get_logger("sanitize")

_TRUTHY = ("1", "true", "yes", "on")


def sanitize_enabled() -> bool:
    """``NNS_TPU_SANITIZE`` env first (the documented one-knob opt-in),
    then ``[executor] sanitize`` through the layered config."""
    raw = os.environ.get("NNS_TPU_SANITIZE")
    if raw is not None:
        return raw.strip().lower() in _TRUTHY
    from nnstreamer_tpu_torch.config import conf

    return conf().get_bool("executor", "sanitize", False)


class SpecViolationError(TypeError):
    """A frame failed the negotiated-spec check on a link (NNS-S001)."""

    def __init__(self, node: str, pad: int, detail: str) -> None:
        self.node = node
        self.pad = pad
        super().__init__(
            f"sanitizer: frame into {node!r} sink pad {pad} violates the "
            f"negotiated spec: {detail}"
        )


def frame_conforms(frame: Any, spec: TensorsSpec) -> Optional[str]:
    """None when `frame` matches `spec`, else a mismatch description.
    Only STATIC specs constrain; wildcard dims unify with anything."""
    if not isinstance(frame, Frame):
        return f"not a Frame: {type(frame).__name__}"
    if len(frame.tensors) != spec.num_tensors:
        return (
            f"{len(frame.tensors)} tensors, spec says {spec.num_tensors}"
        )
    for i, (t, ts) in enumerate(zip(frame.tensors, spec.tensors)):
        shape = tuple(int(d) for d in t.shape)
        if len(shape) != len(ts.shape) or any(
            want is not None and got != want
            for got, want in zip(shape, ts.shape)
        ):
            return f"tensor {i} shape {shape}, spec {ts.shape}"
        if not _dtype_conforms(t, ts.dtype):
            return f"tensor {i} dtype {_dtype_name(t)}, spec {ts.dtype.value}"
    return None


# integer specs the device keeps in a wider torch type until the host edge
# casts them (tensors/frame.py: an image_labeling argmax stays int64)
_WIDE_INT = (torch.int64,)


def _dtype_name(t: Any) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).replace("torch.", "")
    return np.dtype(t.dtype).name


def _dtype_conforms(t: Any, dtype) -> bool:
    """A torch tensor of the spec's torch type (or, for an integer spec,
    the device's wide int64 form); a numpy array of the spec's numpy type
    (bfloat16 also as its raw uint16 bits, as the host edge hands it)."""
    if isinstance(t, torch.Tensor):
        if t.dtype == dtype.torch_dtype:
            return True
        return dtype.is_integer and t.dtype in _WIDE_INT
    got = np.dtype(t.dtype)
    if got == dtype.np_dtype:
        return True
    return dtype.value == "bfloat16" and got == np.uint16


def poison_like(t: Any) -> Any:
    """A same-shape/dtype array of obviously-wrong values (NaN for floats,
    the dtype max for ints): pad rows filled with this make a batch
    split/index bug show up as garbage instead of a plausible replica.
    An exotic dtype the poison recipe can't handle returns `t` itself —
    the padding then stays a replica rather than failing the batch. A
    torch tensor gets a torch tensor on its own device."""
    if isinstance(t, torch.Tensor):
        try:
            if t.dtype.is_floating_point:
                return torch.full_like(t, float("nan"))
            if t.dtype is torch.bool:
                return torch.ones_like(t)
            return torch.full_like(t, torch.iinfo(t.dtype).max)
        except Exception:  # noqa: BLE001 — keep the replica
            return t
    try:
        dt = np.dtype(t.dtype)
        if np.issubdtype(dt, np.floating) or dt.name == "bfloat16":
            val: Any = np.nan
        elif dt == np.bool_:
            val = True
        else:
            val = np.iinfo(dt).max
        return np.full(tuple(int(d) for d in t.shape), val, dtype=dt)
    except Exception:
        return t


# -- lock-order watching -----------------------------------------------------

class LockOrderGraph:
    """Directed held→acquired edges across all threads; a cycle means two
    code paths take the watched locks in opposite orders."""

    def __init__(self, on_cycle=None) -> None:
        self._edges: Dict[str, set] = {}
        self._tls = threading.local()
        self._mu = threading.Lock()
        self._reported: set = set()
        self._on_cycle = on_cycle

    def _held(self) -> List[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def acquired(self, name: str) -> None:
        held = self._held()
        for h in held:
            if h != name:
                self._add_edge(h, name)
        held.append(name)

    def released(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                break

    def _add_edge(self, a: str, b: str) -> None:
        with self._mu:
            peers = self._edges.setdefault(a, set())
            if b in peers:
                return
            peers.add(b)
            cycle = self._find_path(b, a)
        if cycle is not None:
            key = frozenset(cycle)
            if key in self._reported:
                return
            self._reported.add(key)
            chain = " -> ".join(cycle + [cycle[0]])
            if self._on_cycle is not None:
                self._on_cycle(chain)

    def _find_path(self, src: str, dst: str) -> Optional[List[str]]:
        """Path src..dst over the edge set (call with self._mu held)."""
        stack: List[Tuple[str, List[str]]] = [(src, [src])]
        seen = set()
        while stack:
            cur, path = stack.pop()
            if cur == dst:
                return path
            if cur in seen:
                continue
            seen.add(cur)
            for nxt in self._edges.get(cur, ()):
                stack.append((nxt, path + [nxt]))
        return None


class TrackedLock:
    """threading.Lock proxy that feeds a LockOrderGraph. Usable directly
    (`with lock:`) and as the lock behind a threading.Condition."""

    def __init__(self, name: str, graph: LockOrderGraph,
                 lock: Optional[threading.Lock] = None) -> None:
        self.name = name
        self._graph = graph
        self._lock = lock if lock is not None else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._graph.acquired(self.name)
        return got

    def release(self) -> None:
        self._graph.released(self.name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


# -- instrumented inbox ------------------------------------------------------

class SanQueue(queue.Queue):
    """A node inbox with put/get counters and a per-put spec check. The
    executor's bounded waits and wakes are untouched: the instrumentation
    wraps ``put`` / ``get`` (``put_nowait`` / ``get_nowait`` go through
    them)."""

    def __init__(self, maxsize: int, san: "Sanitizer", node_name: str, pad: int) -> None:
        super().__init__(maxsize=maxsize)
        self.san = san
        self.node_name = node_name
        self.pad = pad
        self.expected_spec: Optional[TensorsSpec] = None
        self.n_put = 0
        self.n_got = 0

    def put(self, item, block: bool = True, timeout=None) -> None:
        if item is not EOS_FRAME:
            spec = self.expected_spec
            if spec is not None:
                detail = frame_conforms(item, spec)
                if detail is not None:
                    self.san.spec_violation(self.node_name, self.pad, detail)
        super().put(item, block, timeout)
        if item is not EOS_FRAME:
            self.n_put += 1

    def get(self, block: bool = True, timeout=None):
        item = super().get(block, timeout)
        if item is not EOS_FRAME:
            self.n_got += 1
        return item


# -- the sanitizer -----------------------------------------------------------

class Sanitizer:
    """One per Executor. Collects NNS-S findings (thread-safe), owns the
    lock-order graph, and counts node-level pushes for the EOS frame-
    accounting check."""

    def __init__(self) -> None:
        self.report = LintReport()
        self._mu = threading.Lock()
        self.lock_graph = LockOrderGraph(on_cycle=self._cycle)
        # (node name, out pad) -> frames pushed (producer-thread writes;
        # GIL-atomic int adds under the per-key single-writer contract)
        self._pushes: Dict[Tuple[str, int], int] = {}

    # -- recording ---------------------------------------------------------
    def record(self, code: str, where: Optional[str], message: str,
               hint: str = "") -> None:
        with self._mu:
            self.report.add(code, where, message, hint)
        _log.warning("sanitizer %s [%s]: %s", code, where, message)
        from nnstreamer_tpu_torch import trace

        tracer = trace.get()
        if tracer is not None:
            tracer.san(where or "pipeline", code, message=message)

    @property
    def codes(self) -> List[str]:
        with self._mu:
            return self.report.codes

    def findings(self) -> List[Any]:
        with self._mu:
            return list(self.report.diagnostics)

    # -- spec conformance --------------------------------------------------
    def spec_violation(self, node: str, pad: int, detail: str) -> None:
        self.record(
            "NNS-S001", node, f"sink pad {pad}: {detail}",
            "an element emitted tensors that do not match what it "
            "negotiated",
        )
        raise SpecViolationError(node, pad, detail)

    # -- lock order --------------------------------------------------------
    def lock(self, name: str) -> TrackedLock:
        return TrackedLock(name, self.lock_graph)

    def _cycle(self, chain: str) -> None:
        self.record(
            "NNS-S003", None,
            f"lock acquisition order cycle: {chain}",
            "impose one global order on these locks",
        )

    # -- frame accounting --------------------------------------------------
    def register_pad(self, node_name: str, pad: int) -> None:
        """Pre-create the (node, pad) counter at build time: with every
        key present before streaming, the per-frame count_push fast path
        never resizes the dict (single-writer value updates are
        GIL-atomic and safe against concurrent snapshot reads)."""
        with self._mu:
            self._pushes.setdefault((node_name, pad), 0)

    def count_push(self, node_name: str, pad: int) -> None:
        key = (node_name, pad)
        cur = self._pushes.get(key)
        if cur is None:  # unregistered (hand-built plan): insert locked
            with self._mu:
                self._pushes.setdefault(key, 0)
            cur = self._pushes[key]
        self._pushes[key] = cur + 1

    def pushes(self, node_name: str, pad: int) -> int:
        return self._pushes.get((node_name, pad), 0)

    def node_snapshot(self, node) -> Dict[str, int]:
        offered = sum(
            q.n_got for q in node.inboxes if hasattr(q, "n_got")
        )
        err_pad = self._error_pad(node)
        delivered = routed = 0
        with self._mu:  # excludes key inserts, not value updates
            items = list(self._pushes.items())
        for (name, pad), n in items:
            if name != node.name:
                continue
            if err_pad is not None and pad == err_pad:
                routed += n
            else:
                delivered += n
        return {
            "san_offered": offered,
            "san_delivered": delivered,
            "san_routed": routed,
        }

    @staticmethod
    def _error_pad(node) -> Optional[int]:
        elem = getattr(node, "elem", None)
        if elem is None:
            elem = getattr(getattr(node, "seg", None), "first", None)
        return getattr(elem, "error_pad", None) if elem is not None else None

    def check_accounting(self, node) -> None:
        """Latch offered == delivered + dropped + routed for one node at
        clean EOS (the caller filters to eligible 1:1 nodes)."""
        snap = self.node_snapshot(node)
        # deadline sheds are counted drops: the frame was popped
        # (offered) and disposed of with a reason before processing
        dropped = getattr(node, "deadline_shed", 0)
        fs = getattr(node, "fault_stats", None)
        if fs is not None:
            dropped += fs.dropped
        balance = (
            snap["san_offered"]
            - snap["san_delivered"] - snap["san_routed"] - dropped
        )
        if balance != 0:
            what = "leaked" if balance > 0 else "duplicated"
            self.record(
                "NNS-S002", node.name,
                f"{abs(balance)} frame(s) {what} at EOS: offered="
                f"{snap['san_offered']}, delivered="
                f"{snap['san_delivered']}, dropped={dropped}, "
                f"routed={snap['san_routed']}",
                "the element consumed or emitted frames outside its "
                "declared 1:1 + error-policy accounting",
            )

    # -- thread leaks ------------------------------------------------------
    def thread_leak(self, names: List[str]) -> None:
        self.record(
            "NNS-S004", None,
            f"{len(names)} thread(s) survived executor shutdown: "
            f"{', '.join(sorted(names))}",
            "join service threads in stop() or mark them daemon with a "
            "bounded loop",
        )
