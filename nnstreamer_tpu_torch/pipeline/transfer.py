"""The transfer engine: staged H2D, coalesced D2H, transfer accounting.

The counterpart of ``nnstreamer_tpu/pipeline/transfer.py``, for the frame
ring of the executor (pipeline/executor.py):

- **Staged H2D** (:func:`stage_frame`, :func:`stage_iter`): host tensors
  (numpy arrays, CPU tensors) bound for a GPU go through pinned host
  memory with ``non_blocking=True``, so frame N+1's copy overlaps frame
  N's compute on the stream. On the CPU staging passes the frame through
  unless ``force`` asks for a private copy.
- **Coalesced D2H** (:class:`FrameFetch`): a frame's (or a whole sink
  window's) tensors are packed on the device into ONE byte buffer (each
  tensor's bytes, concatenated), copied into a pinned host buffer with
  ``non_blocking=True`` behind a CUDA event, and split back into numpy
  arrays by dtype and shape at :meth:`FrameFetch.finish`. A lone tensor
  skips the packer (it is one copy already). Each fetch owns its pinned
  buffer until it is finished, so the next frame's fetch never writes
  into a frame still in flight; finish copies the arrays out and hands
  the buffer back to PyTorch's pinned-memory cache. The packer is plain torch
  (a ``view(torch.uint8)`` of each tensor and one ``torch.cat``).
- **Accounting** (:data:`tally`, ``nns_transfer_bytes_total``): every byte
  that crosses the host↔device boundary through this module is counted by
  direction. A torch tensor counts as the device side on both devices (as
  a jax array does on the reference's CPU backend), so a sink that
  materialises a frame as numpy counts its bytes as D2H on the CPU too,
  and "adjacent fused segments hand off with zero host bytes" is a number.

Donation: the reference donates node-owned buffers to its jitted programs.
A CUDA graph copies its inputs into its own static buffers, so the port
has nothing to donate; ``[executor] donate`` is read
(:func:`donation_enabled`) and has no effect.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from nnstreamer_tpu_torch.log import get_logger

_log = get_logger("transfer")


# -- transfer accounting ----------------------------------------------------

class TransferTally:
    """Process-wide transfer byte/event counters (always on; the metrics
    registry mirrors them into ``nns_transfer_bytes_total``). One short
    lock per event (a frame's worth of tensors), never per tensor."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.h2d_events = 0
        self.d2h_events = 0

    def count(self, direction: str, nbytes: int) -> None:
        with self._lock:
            if direction == "h2d":
                self.h2d_bytes += nbytes
                self.h2d_events += 1
            else:
                self.d2h_bytes += nbytes
                self.d2h_events += 1

    def reset(self) -> None:
        with self._lock:
            self.h2d_bytes = self.d2h_bytes = 0
            self.h2d_events = self.d2h_events = 0

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "h2d_bytes": self.h2d_bytes,
                "d2h_bytes": self.d2h_bytes,
                "h2d_events": self.h2d_events,
                "d2h_events": self.d2h_events,
            }


#: the process's tally; Executor.totals()["transfer"] is a run's delta
tally = TransferTally()

_mirror_lock = threading.Lock()
_mirrored = {"h2d": 0, "d2h": 0}


def mirror_into(metrics) -> None:
    """Advance the ``nns_transfer_bytes_total`` counters to the process
    tally. Watermark-based: executors stopping in one process each publish
    only the delta not yet mirrored, so nothing is counted twice."""
    snap = tally.snapshot()
    with _mirror_lock:
        for direction, key in (("h2d", "h2d_bytes"), ("d2h", "d2h_bytes")):
            delta = snap[key] - _mirrored[direction]
            if delta > 0:
                _mirrored[direction] += delta
                metrics.counter("nns_transfer_bytes_total", direction=direction).inc(delta)


def nbytes(tensors: Iterable[Any]) -> int:
    total = 0
    for t in tensors:
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        else:
            total += int(np.asarray(t).nbytes)
    return total


# -- placement probes -------------------------------------------------------

def is_device_array(t: Any) -> bool:
    """True for a torch tensor (the pipeline's device side on either
    device); numpy arrays and scalars are host by definition."""
    return isinstance(t, torch.Tensor)


# -- staged H2D -------------------------------------------------------------

def _host_tensor(t: Any) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t
    a = np.ascontiguousarray(t)
    # a read-only array (np.frombuffer of bytes) is copied: the tensor
    # would share memory it must not write
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def stage_frame(frame, device: Optional[torch.device] = None, force: bool = False):
    """Move a frame's host tensors to ``device`` (pinned memory,
    ``non_blocking=True`` on a GPU); tensors already there pass through
    untouched, and the SAME frame object comes back when nothing moved.
    On the CPU staging is a pass-through unless ``force``, which makes a
    private copy of every host tensor (the caller may write it)."""
    device = torch.device("cpu") if device is None else torch.device(device)
    if device.type == "cpu" and not force:
        return frame
    idx = [i for i, t in enumerate(frame.tensors)
           if not isinstance(t, torch.Tensor) or t.device != device
           or (force and device.type == "cpu")]
    if not idx:
        return frame
    tensors = list(frame.tensors)
    tally.count("h2d", nbytes(tensors[i] for i in idx))
    for i in idx:
        t = _host_tensor(tensors[i])
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        elif device.type == "cpu":
            t = t.clone()
        else:
            t = t.to(device)
        tensors[i] = t
    return frame.with_tensors(tensors)


def stage_iter(arrays: Iterable[Any], device: Optional[torch.device] = None,
               depth: int = 3) -> Iterator[Any]:
    """Upload ``arrays`` on a feeder thread, yielding device tensors in
    order with up to ``depth`` uploads in flight (a streaming-ingest
    harness). On the CPU the arrays are yielded as they are."""
    device = torch.device("cpu") if device is None else torch.device(device)
    if device.type == "cpu":
        yield from arrays
        return
    import queue as queue_mod

    q: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, depth))
    end = object()
    stop = threading.Event()
    err: List[BaseException] = []

    def put(item) -> bool:
        # bounded, so a consumer that abandoned the generator frees us
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def feed() -> None:
        try:
            for a in arrays:
                if stop.is_set():
                    return
                tally.count("h2d", nbytes((a,)))
                t = _host_tensor(a).pin_memory().to(device, non_blocking=True)
                if not put(t):
                    return
        except Exception as exc:  # noqa: BLE001 — re-raised by the consumer
            err.append(exc)
        finally:
            put(end)

    th = threading.Thread(target=feed, name="nns-h2d-stager", daemon=True)
    th.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            yield item
        if err:
            # a failed upload is an error, never a silently short stream
            raise err[0]
    finally:
        stop.set()
        try:
            while True:  # unblock a feeder parked on a full queue
                q.get_nowait()
        except queue_mod.Empty:
            pass
        th.join(timeout=5.0)


# -- coalesced D2H ----------------------------------------------------------

def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy type a tensor's bytes are read as on the host (bfloat16
    as its raw uint16 bits, as ``Frame.to_host`` hands it out)."""
    if dtype is torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty((), dtype=dtype).numpy().dtype


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype is torch.bfloat16:
        t = t.view(torch.uint16) if t.is_contiguous() else t.contiguous().view(torch.uint16)
    return t.numpy()


def pack_tensors(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The packer: every tensor's bytes, in order, as ONE flat uint8
    tensor on their device (a ``view(torch.uint8)`` of each, one cat)."""
    parts = [t.detach().contiguous().view(torch.uint8).reshape(-1) for t in tensors]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def split_packed(buf: np.ndarray, sig: List[tuple]) -> List[np.ndarray]:
    """Numpy views of a packed buffer, one per ``(shape, torch dtype)`` of
    ``sig`` (bool as a copy: numpy reads its bytes as uint8)."""
    out: List[np.ndarray] = []
    offset = 0
    for shape, dtype in sig:
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        view = buf[offset:offset + n]
        arr = view.astype(np.bool_) if dtype is torch.bool else view.view(_np_dtype(dtype))
        out.append(arr.reshape(shape))
        offset += n
    return out


class FrameFetch:
    """One in-flight coalesced D2H for an ordered set of tensors (a
    frame's worth, or a whole sink window's).

    :meth:`start` packs the CUDA tensors into one byte buffer on the
    device and begins ONE asynchronous copy into a pinned host buffer of
    this fetch's own, behind a CUDA event; :meth:`finish` waits on the
    event and splits the buffer into numpy views. A lone CUDA tensor is
    copied without the packer; tensors on the CPU, or on several devices,
    are read one by one. Host arrays pass through untouched."""

    __slots__ = ("_tensors", "_sig", "_host", "_dev_idx", "_event", "_singles")

    def __init__(self, tensors: List[Any]) -> None:
        self._tensors = list(tensors)
        self._sig: Optional[list] = None
        self._host: Optional[torch.Tensor] = None
        self._dev_idx: List[int] = []
        self._event = None
        self._singles: Dict[int, torch.Tensor] = {}

    def start(self) -> "FrameFetch":
        ts = self._tensors
        dev_idx = [i for i, t in enumerate(ts) if is_device_array(t)]
        if not dev_idx:
            return self
        dev_ts = [ts[i] for i in dev_idx]
        tally.count("d2h", nbytes(dev_ts))
        cuda = [i for i in dev_idx if ts[i].device.type == "cuda"]
        if not cuda:
            return self  # host memory: finish() reads views
        if len(cuda) < 2 or len({ts[i].device for i in cuda}) > 1:
            # one transfer already, or tensors on several devices: one
            # pinned copy each, behind one event
            for i in cuda:
                t = ts[i]
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                self._singles[i] = host
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(ts[cuda[-1]].device))
            return self
        packed = pack_tensors([ts[i] for i in cuda])
        host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(packed.device))
        self._sig = [(tuple(ts[i].shape), ts[i].dtype) for i in cuda]
        self._host = host
        self._dev_idx = cuda
        return self

    def finish(self) -> List[Any]:
        """Host (numpy) tensors, in order. Blocks only on what of the
        copy has not landed yet. The arrays are copied out of the pinned
        buffers, which go back to PyTorch's pinned-memory cache here: a
        sink that keeps its frames holds ordinary memory, and pinned
        memory stays bounded by the fetches in flight."""
        if self._event is not None:
            self._event.synchronize()
        out = list(self._tensors)
        if self._host is not None:
            for i, arr in zip(self._dev_idx, split_packed(self._host.numpy(), self._sig)):
                out[i] = arr.copy()
            self._host = None
        for i, host in self._singles.items():
            out[i] = _as_numpy(host).copy()
        self._singles = {}
        return [_as_numpy(t) if is_device_array(t) else t for t in out]


def fetch_frame(frame) -> FrameFetch:
    """Start a coalesced asynchronous D2H of one frame's tensors."""
    return FrameFetch(list(frame.tensors)).start()


def fetch_window(frames: List[Any]) -> List[Any]:
    """A window of frames as host frames through ONE coalesced fetch across
    every tensor of every frame (the sink's ``sync-window`` path), in
    order. An all-host window comes back as it is."""
    flat: List[Any] = []
    counts: List[int] = []
    for f in frames:
        counts.append(len(f.tensors))
        flat.extend(f.tensors)
    if not any(is_device_array(t) for t in flat):
        return frames
    fetched = FrameFetch(flat).start().finish()
    out = []
    i = 0
    for f, n in zip(frames, counts):
        out.append(f.with_tensors(fetched[i:i + n]))
        i += n
    return out


# -- stream (ring) configuration -------------------------------------------

def resolve_ring_depth(elems) -> int:
    """The in-flight frame ring's depth for a node: the first member's
    ``ring-depth`` property outranks ``[executor] ring_depth`` (env over
    ini, the standard layering). Clamped to [1, 32]; 1 delivers each frame
    as it is made."""
    from nnstreamer_tpu_torch.config import conf

    raw = None
    for e in elems:
        raw = e.get_property("ring-depth")
        if raw is not None:
            break
    if raw is None:
        raw = conf().get("executor", "ring_depth", "2")
    try:
        depth = int(raw)
    except (TypeError, ValueError):
        _log.warning("ring-depth=%r is not an int; using 2", raw)
        depth = 2
    return max(1, min(32, depth))


def resolve_chain_mode(elems) -> str:
    """Whole-chain compilation for one chain (pipeline/chain_program.py):
    ``off`` on ANY member's ``chain-mode`` outranks ``[executor]
    chain_mode``, so one member opting out keeps the chain on the per-node
    path. Unknown values read as ``auto`` with a warning."""
    from nnstreamer_tpu_torch.config import conf

    raw = None
    for e in elems:
        get = getattr(e, "get_property", None)
        got = get("chain-mode") if get is not None else None
        if got is not None:
            raw = str(got).strip().lower()
            if raw == "off":
                return "off"
    if raw is None:
        raw = str(conf().get("executor", "chain_mode", "auto")).strip().lower()
    if raw not in ("auto", "off"):
        _log.warning("chain-mode=%r not one of auto/off; using auto", raw)
        return "auto"
    return raw


def resolve_chain_unroll(elems) -> int:
    """Frames per compiled-chain window (``[executor] chain_unroll``,
    default 4, clamped to [1, 32]): the static ceiling, which
    pipeline/chain_program.py clamps by the device bound and the OOM
    governor by its rung."""
    from nnstreamer_tpu_torch.config import conf

    raw = conf().get("executor", "chain_unroll", "4")
    try:
        unroll = int(raw)
    except (TypeError, ValueError):
        _log.warning("[executor] chain_unroll=%r is not an int; using 4", raw)
        unroll = 4
    return max(1, min(32, unroll))


def xray_crosscheck_enabled() -> bool:
    """``NNS_XRAY_CROSSCHECK`` env first, then ``[executor]
    xray_crosscheck`` (default off): the executor then holds the static
    transfer prediction (analysis/costmodel.py) to this tally at stop()
    and logs the verdict."""
    raw = os.environ.get("NNS_XRAY_CROSSCHECK")
    if raw is not None:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    from nnstreamer_tpu_torch.config import conf

    return conf().get_bool("executor", "xray_crosscheck", False)


def donation_enabled() -> bool:
    """``[executor] donate`` (default on), read as the reference reads it.
    It has no effect in the port: a CUDA graph replay copies its inputs
    into the graph's static buffers, so no buffer of a frame is ever
    handed to a program to reuse."""
    from nnstreamer_tpu_torch.config import conf

    return conf().get_bool("executor", "donate", True)
