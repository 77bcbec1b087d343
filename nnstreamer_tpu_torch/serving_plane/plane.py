"""ModelPlane: a process-wide shared device batcher per model.

The counterpart of ``nnstreamer_tpu/serving_plane/plane.py``. A fused
segment batches frames *within* one stream; a plane batches *across*
executors: every ``tensor_filter plane=<name>`` in the process attaches as
one stream, and one service thread collects a weighted-fair cross-stream
batch (:mod:`~nnstreamer_tpu_torch.serving_plane.scheduler`) and runs ONE
device program for all of them (on CUDA one graph replay a dispatch,
:mod:`~nnstreamer_tpu_torch.serving_plane.sharding`). What each stream
keeps:

- **FIFO order**: requests complete in per-stream submission order (the
  scheduler pops each stream's queue left to right, and a stream's
  executor thread submits, and under async tickets collects, in order).
- **Fault accounting**: a failed batch splits per window, so only the
  failing window's stream sees the error; it surfaces in THAT stream's
  executor, where the stream's own ``on-error`` disposes of it per frame.

Memory: all sharers ride ONE opened backend (``plane-mode=replicas``: one
a replica, ``plane-devices`` of them, behind failover).

Lifecycle: the registry refcounts by attached filter; the first
:func:`acquire` opens the backend and starts the service thread, the last
:func:`release` drains, closes and joins it. Planes are created at
negotiation time, before the executors start.

The reference's plane metrics (``nns_plane_*``) come with the port's
observability layer; until then the plane runs as the reference does with
no metrics registry, and :meth:`ModelPlane.stats` carries its counters.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.pipeline.batching import BatchStats
from nnstreamer_tpu_torch.serving_plane.scheduler import PlaneStream, StreamScheduler

_log = get_logger("serving_plane")

PLANE_MODES = ("single", "shard", "replicas")


class PlaneClosedError(RuntimeError):
    """Submit/attach on a closed (or closing) plane."""


class PlaneConfigError(ValueError):
    """Plane name already bound to a different model/config signature."""


@dataclass(frozen=True)
class PlaneConfig:
    """Resolved knobs for one plane (first-attacher wins; the
    config signature guards against sharers disagreeing)."""

    max_batch: int = 8
    timeout_ms: float = 1.0
    mode: str = "single"
    devices: int = 1
    unhealthy_after: int = 3
    probe_every: int = 64
    submit_timeout_s: float = 30.0
    # default per-stream in-flight ring depth for ASYNC submits
    # (the executor's plane window ring): 1 keeps blocking submits;
    # an element-level ring-depth= outranks it per stream, so it stays
    # out of signature() — sharers may legitimately differ
    inflight: int = 1

    def signature(self) -> tuple:
        return (self.max_batch, self.timeout_ms, self.mode, self.devices,
                self.unhealthy_after, self.probe_every)


def _plane_defaults() -> Dict[str, Any]:
    """``[plane]`` config-section defaults (env ``NNS_TPU_PLANE_*``
    outranks ini, the standard layering). Malformed values fall back
    with a warning — a typo'd ini line must not fail every plane."""
    from nnstreamer_tpu_torch.config import conf

    c = conf()

    def _num(key: str, cast, fallback):
        raw = c.get("plane", key, str(fallback))
        try:
            return cast(raw)
        except ValueError:
            _log.warning("[plane] %s=%r is not a valid %s; using %s",
                         key, raw, cast.__name__, fallback)
            return fallback

    mode = c.get("plane", "mode", "single").strip().lower()
    if mode not in PLANE_MODES:
        _log.warning("[plane] mode=%r unknown; using single", mode)
        mode = "single"
    return {
        "max_batch": _num("max_batch", int, 8),
        "timeout_ms": _num("timeout_ms", float, 1.0),
        "mode": mode,
        "devices": _num("devices", int, 1),
        "unhealthy_after": _num("unhealthy_after", int, 3),
        "probe_every": _num("probe_every", int, 64),
        "submit_timeout_s": _num("submit_timeout_s", float, 30.0),
        "inflight": _num("inflight", int, 1),
    }


def resolve_plane_config(elements) -> PlaneConfig:
    """Merge element-level ``plane-*`` properties over the ``[plane]``
    section defaults (the resolve_batch_config discipline: first
    element that sets a knob explicitly wins; bad values raise with the
    element named)."""
    d = _plane_defaults()

    def _coerce(elem, prop, fn, raw):
        try:
            return fn(raw)
        except (TypeError, ValueError) as exc:
            raise ValueError(
                f"{getattr(elem, 'name', elem)}: bad {prop}={raw!r}: {exc}"
            ) from exc

    for e in elements:
        get = getattr(e, "get_property", None)
        if get is None:
            continue
        raw = get("plane-max-batch")
        if raw is not None:
            d["max_batch"] = _coerce(e, "plane-max-batch", int, raw)
        raw = get("plane-timeout-ms")
        if raw is not None:
            d["timeout_ms"] = _coerce(e, "plane-timeout-ms", float, raw)
        raw = get("plane-mode")
        if raw is not None:
            mode = str(raw).strip().lower()
            if mode not in PLANE_MODES:
                raise ValueError(
                    f"{getattr(e, 'name', e)}: plane-mode={raw!r} not one "
                    f"of {'/'.join(PLANE_MODES)}"
                )
            d["mode"] = mode
        raw = get("plane-devices")
        if raw is not None:
            d["devices"] = _coerce(e, "plane-devices", int, raw)
    return PlaneConfig(
        max_batch=max(1, int(d["max_batch"])),
        timeout_ms=max(0.0, float(d["timeout_ms"])),
        mode=d["mode"],
        devices=max(1, int(d["devices"])),
        unhealthy_after=max(1, int(d["unhealthy_after"])),
        probe_every=max(1, int(d["probe_every"])),
        submit_timeout_s=max(0.1, float(d["submit_timeout_s"])),
        inflight=max(1, min(32, int(d["inflight"]))),
    )


class _Req:
    """One in-flight request: a WINDOW of 1..k same-stream frames plus
    its completion latch. Windows are the submitting executor's local
    micro-batch (its segment node's collector), so one round-trip
    through the plane amortizes over the whole window — per-frame
    blocking submits would gate every stream on two thread wakes per
    frame."""

    __slots__ = ("frames", "out", "exc", "done", "abandoned", "ahead")

    def __init__(self, frames) -> None:
        self.frames = frames
        self.out: Optional[List[Tuple[Any, ...]]] = None
        self.exc: Optional[BaseException] = None
        self.done = threading.Event()
        # set by a timed-out submitter that gave up on an IN-FLIGHT
        # window: a recovering service thread must not credit `served`
        # for frames nobody waits on
        self.abandoned = False
        # windows of the SAME stream already in flight when this one was
        # submitted: the wait-side stall grant scales by it (a deep ring
        # legitimately waits several dispatches, but only while the
        # plane keeps making progress)
        self.ahead = 0


class ModelPlane:
    """The shared batcher (module docstring has the contract).

    Counter discipline: ``dispatches``/``frames``/``split_dispatches``
    and the BatchStats mutate only on the service thread; stream
    ``admitted`` mutates under the plane lock in :meth:`submit`.
    Readers snapshot GIL-atomically (the executor stats convention).
    """

    def __init__(
        self,
        name: str,
        cfg: PlaneConfig,
        backends: List[Any],
        program: Optional[Any] = None,
    ) -> None:
        self.name = name
        self.cfg = cfg
        self.backends = backends
        self._sched = StreamScheduler()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        self._stop_ev = threading.Event()
        # an explicit program (a test's marker program) bypasses
        # build_plane_program's backend-derived choice
        self._program = program
        self.batch_stats = BatchStats()
        self.dispatches = 0
        self.frames = 0
        self.split_dispatches = 0
        # total windows submitted-but-not-yet-collected across streams
        # (inc under the plane lock at submit, dec at wait-side
        # resolution — the async ring's live depth)
        self._inflight_total = 0
        # the plane's metrics (obs/metrics.py), made once when a registry
        # is on: batch occupancy and backlog a dispatch, the in-flight
        # windows, a ticket's redeem wait
        from nnstreamer_tpu_torch.obs import metrics as obs_metrics

        reg = self._metrics = obs_metrics.get()
        self._occ_hist = self._depth_gauge = self._inflight_gauge = self._wait_hist = None
        if reg is not None:
            self._occ_hist = reg.histogram("nns_plane_batch_occupancy", lo=1.0,
                                           growth=2.0 ** 0.5, nbuckets=16, plane=name)
            self._depth_gauge = reg.gauge("nns_plane_queue_depth", plane=name)
            self._inflight_gauge = reg.gauge("nns_plane_inflight_windows", plane=name)
            self._wait_hist = reg.histogram("nns_plane_submit_wait_ms", plane=name)
        self._thread = threading.Thread(
            target=self._serve, name=f"nns-plane-{name}", daemon=True
        )
        self._thread.start()

    @property
    def backend(self):
        """Primary backend (negotiation/model-info surface for sharers;
        replica 0 under mode=replicas)."""
        return self.backends[0]

    # -- streams -----------------------------------------------------------
    def attach(self, sid: str, weight: float = 1.0) -> PlaneStream:
        with self._cond:
            if self._closed:
                raise PlaneClosedError(f"plane {self.name!r} is closed")
            s = PlaneStream(sid, weight)
            if self._metrics is not None:
                s._admit_ctr = self._metrics.counter(
                    "nns_plane_stream_admitted_total", plane=self.name, stream=sid)
                s._serve_ctr = self._metrics.counter(
                    "nns_plane_stream_served_total", plane=self.name, stream=sid)
            self._sched.add(s)
            return s

    def detach(self, stream: PlaneStream) -> None:
        with self._cond:
            pending = self._sched.remove(stream)
            # tickets the stream never redeemed (executor torn down
            # with windows parked in its ring) would inflate the
            # plane-wide in-flight counter forever — reconcile them
            # out with the leaving stream
            if stream.inflight > 0:
                self._inflight_total = max(
                    0, self._inflight_total - stream.inflight
                )
                stream.inflight = 0
                if self._inflight_gauge is not None:
                    self._inflight_gauge.set(self._inflight_total)
        for req in pending:
            # a detaching stream's queued frames get a terminal outcome,
            # never a silent hang
            req.exc = PlaneClosedError(
                f"stream {stream.sid!r} detached from plane "
                f"{self.name!r} with requests queued"
            )
            req.done.set()

    # -- submission (executor node threads) --------------------------------
    def submit_window_async(
        self, stream: PlaneStream, windows: List[Tuple[Any, ...]]
    ) -> _Req:
        """Enqueue one window of tensor tuples WITHOUT waiting: returns
        a ticket the submitter redeems with :meth:`wait_window` —
        strictly in submission order, which keeps per-stream FIFO
        structural exactly like the blocking path (the stream's
        executor thread is the only submitter AND the only collector).
        The stream's in-flight ring (the executor's plane loop) is the
        caller's: it holds up to ``ring-depth``/``[plane] inflight``
        tickets so window N+1 submits while N computes and N−1
        delivers."""
        req = _Req(windows)
        with self._cond:
            if self._closed:
                raise PlaneClosedError(f"plane {self.name!r} is closed")
            req.ahead = stream.inflight
            stream.q.append(req)
            stream.admitted += len(windows)
            if stream._admit_ctr is not None:
                stream._admit_ctr.inc(len(windows))
            stream.inflight += 1
            self._inflight_total += 1
            if self._inflight_gauge is not None:
                self._inflight_gauge.set(self._inflight_total)
            self._cond.notify_all()
        return req

    def wait_window(
        self, stream: PlaneStream, req: _Req
    ) -> List[Tuple[Any, ...]]:
        """Redeem a ticket: block until the plane serves (or fails) the
        window. Returns per-frame output tuples; raises the underlying
        invoke error for THIS window only — batchmates from other
        streams are unaffected.

        Stall discipline: while the window is still QUEUED the wait is
        one ``submit_timeout_s`` (then the request retracts, so a
        timed-out-and-retried window is never ALSO served later by a
        recovering service thread). Once IN FLIGHT the grant scales
        with the windows ahead of it at submit time — a depth-k ring
        legitimately waits k dispatches — but every grant past the
        first requires the plane to have DISPATCHED something since the
        last check: a wedged service thread surfaces after at most
        2×``submit_timeout_s`` regardless of ring depth, instead of the
        depth masking it."""
        t_wait0 = time.perf_counter()
        try:
            deadline = time.monotonic() + self.cfg.submit_timeout_s
            max_ext = 1 + max(0, req.ahead)
            extensions = 0
            last_dispatches = self.dispatches
            while not req.done.wait(0.05):
                if time.monotonic() < deadline:
                    continue
                with self._cond:
                    try:
                        stream.q.remove(req)
                        retracted = True
                    except ValueError:
                        retracted = False  # already collected: in flight
                if retracted:
                    raise PlaneClosedError(
                        f"plane {self.name!r}: no service within "
                        f"{self.cfg.submit_timeout_s}s (service thread "
                        "dead or program wedged)"
                    )
                progressed = self.dispatches != last_dispatches
                last_dispatches = self.dispatches
                if extensions == 0 or (
                    progressed and extensions < max_ext
                ):
                    # in flight: the dispatch may legitimately be slow
                    # (a cold compile, or windows ahead in the ring) —
                    # grant another full window, but past the first
                    # only while dispatches keep landing
                    extensions += 1
                    deadline = time.monotonic() + self.cfg.submit_timeout_s
                    continue
                req.abandoned = True
                raise PlaneClosedError(
                    f"plane {self.name!r}: in-flight window unserved "
                    f"after {(1 + extensions) * self.cfg.submit_timeout_s}"
                    "s without dispatch progress (program wedged)"
                )
        finally:
            with self._lock:
                # conditional: detach() may have already reconciled
                # this stream's tickets out of the totals — a late
                # waiter must not debit another stream's contribution
                if stream.inflight > 0:
                    stream.inflight -= 1
                    self._inflight_total = max(
                        0, self._inflight_total - 1
                    )
                    if self._inflight_gauge is not None:
                        self._inflight_gauge.set(self._inflight_total)
            if self._wait_hist is not None:
                self._wait_hist.observe((time.perf_counter() - t_wait0) * 1000.0)
        if req.exc is not None:
            raise req.exc
        return req.out

    def submit_window(
        self, stream: PlaneStream, windows: List[Tuple[Any, ...]]
    ) -> List[Tuple[Any, ...]]:
        """Blocking submit: one async ticket redeemed immediately (the
        ``inflight=1`` discipline; also the error-policy split's
        re-invoke unit)."""
        return self.wait_window(
            stream, self.submit_window_async(stream, windows)
        )

    def submit(self, stream: PlaneStream, frame):
        """Single-frame convenience over :meth:`submit_window` (the
        per-frame host path; also the error-policy split's re-invoke
        unit)."""
        (out,) = self.submit_window(stream, [frame.tensors])
        return frame.with_tensors(out)

    # -- service thread ----------------------------------------------------
    def _ensure_program(self):
        if self._program is None:
            from nnstreamer_tpu_torch.serving_plane.sharding import (
                build_plane_program,
            )

            self._program = build_plane_program(self.backends, self.cfg)
        return self._program

    def _serve(self) -> None:
        cfg = self.cfg
        cond = self._cond
        while not self._stop_ev.is_set():
            t_wait0 = time.perf_counter()
            with cond:
                batch = self._sched.collect(cfg.max_batch)
                if not batch:
                    cond.wait(0.05)
                    continue
                got = sum(len(req.frames) for _s, req in batch)
                if got < cfg.max_batch and cfg.timeout_ms > 0.0:
                    # trickle-fed: ONE bounded straggler wait, then take
                    # what arrived (the BatchCollector discipline — a
                    # rolling wait would stretch worst-case latency).
                    # Under blocking-submit traffic the other streams'
                    # resubmissions land inside this window, so steady
                    # state dispatches full cross-stream batches.
                    cond.wait(cfg.timeout_ms / 1000.0)
                    # a window that would push the dispatch past max_batch
                    # waits for the next one (the reference's top-up takes
                    # it and then runs the batch as two bucket programs)
                    batch += self._sched.collect(cfg.max_batch - got, at_least_one=False)
                depth = self._sched.backlog
            wait_s = time.perf_counter() - t_wait0
            self._dispatch(batch, depth, wait_s)

    def _dispatch(self, batch, depth: int, wait_s: float) -> None:
        # flatten the collected windows into ONE device batch; split
        # results back per request (per-stream order intact: requests
        # complete whole, and each stream's requests were popped FIFO)
        flat: List[Tuple[Any, ...]] = []
        for _s, req in batch:
            flat.extend(req.frames)
        try:
            program = self._ensure_program()
        except Exception as exc:  # noqa: BLE001 — no program at all:
            # the BUILD error is the real verdict for every window (a
            # split would just dereference the still-None program)
            for s, req in batch:
                req.exc = exc
                s.errors += len(req.frames)
                req.done.set()
            return
        try:
            outs = program.invoke(flat)
        except Exception as exc:  # noqa: BLE001 — split below, per window
            self._dispatch_split(batch, exc)
            return
        i = 0
        for s, req in batch:
            k = len(req.frames)
            self._complete(s, req, outs[i:i + k])
            i += k
        n = len(flat)
        self._account_dispatch(n)
        self.batch_stats.record(n, n, wait_s)
        if self._occ_hist is not None:
            self._occ_hist.observe(n)
        if self._depth_gauge is not None:
            self._depth_gauge.set(depth)

    def _account_dispatch(self, n: int) -> None:
        """The ONE place the dispatch counters mutate — the service
        thread is the only caller (single-writer contract; readers
        snapshot GIL-atomically)."""
        self.dispatches += 1
        self.frames += n

    def _dispatch_split(self, batch, batch_exc: BaseException) -> None:
        """A failed batch re-runs per request (window) so only the
        failing window's stream sees an error — one bad frame must not
        discard (or fail) batchmates from other streams. The failing
        window's error reaches its stream, whose executor node disposes
        of it per frame through the stream's own ``on-error``."""
        _log.warning(
            "plane %s: batched dispatch of %d window(s) failed (%s); "
            "splitting per window", self.name, len(batch), batch_exc,
        )
        self.split_dispatches += 1
        program = self._program
        n = 0
        for s, req in batch:
            n += len(req.frames)
            try:
                outs = program.invoke(list(req.frames))
            except Exception as exc:  # noqa: BLE001 — per-stream verdict
                req.exc = exc
                s.errors += len(req.frames)
                req.done.set()
                continue
            self._complete(s, req, outs)
        self._account_dispatch(n)

    def _complete(self, s: PlaneStream, req: _Req, outs) -> None:
        if req.abandoned:
            # the submitter timed out and (possibly) re-submitted these
            # frames: completing the ghost would double-credit `served`
            req.done.set()
            return
        req.out = [tuple(o) for o in outs]
        s.served += len(req.frames)
        if s._serve_ctr is not None:
            s._serve_ctr.inc(len(req.frames))
        req.done.set()

    # -- observability -----------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return self._stats_locked()

    def _stats_locked(self) -> Dict[str, Any]:
        # under the plane lock: backlog/snapshot ITERATE the stream
        # deques, and an unlocked iteration racing the service thread's
        # popleft raises "deque mutated during iteration" — scalar
        # counters are GIL-atomic, deque walks are not
        bs = self.batch_stats
        avg = bs.avg_batch_size
        d: Dict[str, Any] = {
            "name": self.name,
            "mode": self.cfg.mode,
            "devices": self.cfg.devices,
            "max_batch": self.cfg.max_batch,
            "streams": len(self._sched),
            "queue_depth": self._sched.backlog,
            "inflight": self._inflight_total,
            "dispatches": self.dispatches,
            "frames": self.frames,
            "split_dispatches": self.split_dispatches,
            "avg_batch": round(avg, 3),
            "occupancy_pct": round(
                100.0 * avg / self.cfg.max_batch, 1
            ) if self.cfg.max_batch else 0.0,
            "per_stream": {
                s.sid: s.snapshot() for s in self._sched.streams()
            },
        }
        prog = self._program
        if prog is not None:
            d["n_traces"] = getattr(prog, "n_traces", 0)
            d["program"] = getattr(prog, "mode", "")
            mesh = getattr(prog, "mesh", None)
            if mesh is not None:
                d["mesh_devices"] = mesh.size
            rstats = getattr(prog, "replica_stats", None)
            if callable(rstats):
                d["replicas"] = rstats()
        return d

    # -- lifecycle ---------------------------------------------------------
    def close(self, join_timeout: float = 5.0) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._stop_ev.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=join_timeout)
            if t.is_alive():  # pragma: no cover - wedged program
                _log.warning("plane %s service thread did not stop",
                             self.name)
        with self._cond:
            leftovers: List[_Req] = []
            for s in self._sched.streams():
                leftovers.extend(self._sched.remove(s))
        for req in leftovers:
            req.exc = PlaneClosedError(f"plane {self.name!r} closed")
            req.done.set()
        prog, self._program = self._program, None
        if prog is not None:
            close = getattr(prog, "close", None)
            if callable(close):
                close()
        for b in self.backends:
            try:
                b.close()
            except Exception as exc:  # noqa: BLE001 — teardown best-effort
                _log.warning("plane %s: backend close failed: %s",
                             self.name, exc)
        self.backends = []


# -- process-wide plane registry (the shared-backend table's sibling) -------

_registry_lock = threading.Lock()
# name -> {"plane", "sig", "refs", "open_lock"}
_planes: Dict[str, Dict[str, Any]] = {}


def acquire(
    name: str,
    sig: tuple,
    cfg: PlaneConfig,
    opener: Callable[[int, bool], Any],
    cfg_explicit: bool = True,
) -> ModelPlane:
    """Get-or-create the named plane; refcounted like the shared-key
    backend table. The MODEL signature ``sig`` must agree across
    sharers always; the plane config binds with the first attacher —
    a later attacher that set no ``plane-*`` properties
    (``cfg_explicit=False``) INHERITS the bound config, while
    explicitly conflicting knobs fail. ``opener(i, replicated)`` opens
    backend ``i`` (one for single/shard, ``cfg.devices`` for replicas;
    ``replicated`` follows the BINDING config's mode; a ``shard`` plane
    opens one backend, which its mesh program spreads)."""
    with _registry_lock:
        entry = _planes.get(name)
        if entry is None:
            entry = {"plane": None, "sig": sig, "cfg": cfg, "refs": 0,
                     "open_lock": threading.Lock()}
            _planes[name] = entry
        else:
            if entry["sig"] != sig:
                raise PlaneConfigError(
                    f"plane {name!r} already bound to {entry['sig']}, "
                    f"cannot rebind to {sig}"
                )
            if cfg_explicit and cfg.signature() != \
                    entry["cfg"].signature():
                raise PlaneConfigError(
                    f"plane {name!r} config already bound to "
                    f"{entry['cfg'].signature()}, cannot rebind to "
                    f"{cfg.signature()} (drop the plane-* properties "
                    "to inherit)"
                )
        cfg = entry["cfg"]  # the binding config governs the open below
        entry["refs"] += 1
    try:
        # per-plane open lock: model opens for DIFFERENT planes must not
        # serialize behind one global lock (the shared-key discipline)
        with entry["open_lock"]:
            if entry["plane"] is None:
                replicated = cfg.mode == "replicas"
                backends: List[Any] = []
                try:
                    for i in range(cfg.devices if replicated else 1):
                        backends.append(opener(i, replicated))
                except Exception:
                    for b in backends:
                        try:
                            b.close()
                        except Exception as exc:  # noqa: BLE001
                            _log.warning("plane %s: backend close failed during an "
                                         "aborted open: %s", name, exc)
                    raise
                entry["plane"] = ModelPlane(name, cfg, backends)
        return entry["plane"]
    except Exception:
        with _registry_lock:
            entry["refs"] -= 1
            if entry["refs"] <= 0 and entry["plane"] is None:
                _planes.pop(name, None)
        raise


def release(name: str, plane: ModelPlane) -> bool:
    """Drop one ref; closes (and unregisters) the plane when the last
    sharer leaves. True when this call actually closed it."""
    with _registry_lock:
        entry = _planes.get(name)
        if entry is None or entry["plane"] is not plane:
            plane.close()
            return True
        entry["refs"] -= 1
        if entry["refs"] > 0:
            return False
        del _planes[name]
    plane.close()
    return True


def get(name: str) -> Optional[ModelPlane]:
    """The live plane registered under ``name`` (introspection), or
    None."""
    entry = _planes.get(name)
    return entry["plane"] if entry else None
