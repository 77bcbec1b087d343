"""Edge transport: length-prefixed blob streams over TCP.

The counterpart of ``nnstreamer_tpu/edge/transport.py``, on the same
native source (native/nns_edge.cpp, built by the port's own loader into
build/torch_native/) and the same framing, so a port endpoint talks to a
reference endpoint.

API mirror of the external nnstreamer-edge library the reference's query/
edge elements use (nns_edge_create_handle/start/connect/send + event
callbacks, tensor_query_client.c:524-549,663-697). Two interchangeable
implementations behind one interface:

- :class:`NativeTransport` — ctypes binding to the in-tree C++ library
  (native/nns_edge.cpp, built on demand by _build.py). The product path.
- :class:`PyTransport` — pure-python sockets with identical framing, the
  fallback when no toolchain is available (and a cross-check in tests).

Framing on the wire: ``uint64_le length | payload``. A server tags each
message with the originating client id; ``send(0, ...)`` from a server
broadcasts (the pub/sub path of edgesink).
"""

from __future__ import annotations

import ctypes
import socket
import struct
import threading
import time
from collections import deque
from typing import Optional, Tuple

from nnstreamer_tpu_torch.edge._build import native_lib_path

RecvResult = Optional[Tuple[int, bytes]]  # (client_id, payload); b"" = closed


class TransportError(RuntimeError):
    pass


class UnresolvableError(TransportError):
    """The target hostname no longer resolves (NXDOMAIN/EAI_*): a
    DISTINCT failure class — reconnect-with-backoff against a gone name
    burns the whole retry budget for nothing, so callers fail fast (or,
    in a fleet, eject the endpoint immediately) instead of retrying."""


def resolve_target(host: str, port: int) -> Tuple[str, int]:
    """Resolve ``host`` freshly (EVERY reconnect attempt must re-resolve
    — a failed-over DNS record points somewhere new, and the old A
    record may be the dead box). Returns the first (address, port);
    raises :class:`UnresolvableError` when the name does not resolve."""
    try:
        infos = socket.getaddrinfo(
            host, port, type=socket.SOCK_STREAM
        )
    except socket.gaierror as exc:
        raise UnresolvableError(
            f"cannot resolve {host!r}: {exc}"
        ) from exc
    if not infos:
        raise UnresolvableError(f"cannot resolve {host!r}: empty answer")
    addr = infos[0][4]
    return str(addr[0]), int(addr[1])


# --------------------------------------------------------------------- native
class _NativeLib:
    _instance = None
    _lock = threading.Lock()

    def __init__(self, path: str):
        lib = ctypes.CDLL(path)
        lib.nns_edge_create.restype = ctypes.c_void_p
        lib.nns_edge_listen.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.nns_edge_connect.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.nns_edge_get_port.argtypes = [ctypes.c_void_p]
        lib.nns_edge_peer_count.argtypes = [ctypes.c_void_p]
        lib.nns_edge_send.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
        ]
        lib.nns_edge_recv.restype = ctypes.c_int64
        lib.nns_edge_recv.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.c_int,
        ]
        lib.nns_edge_free_buf.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.nns_edge_close.argtypes = [ctypes.c_void_p]
        self.lib = lib

    @classmethod
    def get(cls) -> Optional["_NativeLib"]:
        with cls._lock:
            if cls._instance is None:
                path = native_lib_path()
                if path is None:
                    return None
                cls._instance = cls(path)
            return cls._instance


class NativeTransport:
    """ctypes wrapper over the C++ handle (server or client role)."""

    def __init__(self) -> None:
        nl = _NativeLib.get()
        if nl is None:
            raise TransportError("native edge library unavailable")
        self._lib = nl.lib
        self._h = ctypes.c_void_p(self._lib.nns_edge_create())
        self._closed = False

    def listen(self, host: str = "127.0.0.1", port: int = 0) -> int:
        rc = self._lib.nns_edge_listen(self._h, host.encode(), port)
        if rc != 0:
            raise TransportError(f"listen({host}:{port}) failed rc={rc}")
        return self._lib.nns_edge_get_port(self._h)

    def connect(self, host: str, port: int) -> None:
        rc = self._lib.nns_edge_connect(self._h, host.encode(), port)
        if rc != 0:
            raise TransportError(f"connect({host}:{port}) failed rc={rc}")

    def send(self, client_id: int, data: bytes) -> None:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        rc = self._lib.nns_edge_send(self._h, client_id, buf, len(data))
        if rc != 0:
            raise TransportError(f"send failed rc={rc}")

    def recv(self, timeout: Optional[float] = None) -> RecvResult:
        cid = ctypes.c_uint64()
        out = ctypes.POINTER(ctypes.c_uint8)()
        tmo = -1 if timeout is None else max(0, int(timeout * 1000))
        n = self._lib.nns_edge_recv(
            self._h, ctypes.byref(cid), ctypes.byref(out), tmo
        )
        if n < 0:
            return None
        if n == 0 and not out:
            return (cid.value, b"")  # connection-closed event
        data = ctypes.string_at(out, n)
        self._lib.nns_edge_free_buf(out)
        return (cid.value, data)

    def peer_count(self) -> int:
        return self._lib.nns_edge_peer_count(self._h)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._lib.nns_edge_close(self._h)


# --------------------------------------------------------------------- python
_LEN = struct.Struct("<Q")


class PyTransport:
    """Pure-python fallback; same wire framing and semantics.

    Connection admission (docs/edge-serving.md): a server with
    ``max_conns`` > 0 rejects accepts beyond the cap — the over-cap
    socket is sent ``reject_payload`` (one framed message, typically an
    admission NACK from edge/serialize.py) and closed, instead of
    silently holding a reader thread forever. ``rejected_conns`` counts
    them (acceptor-thread single-writer)."""

    max_conns = 0            # 0 = unbounded (instance attr overrides)
    reject_payload: Optional[bytes] = None
    connect_timeout = 10.0   # fleet clients shrink this: a blackholed
    #                          endpoint must not stall a whole request
    #                          deadline inside one connect()

    def __init__(self) -> None:
        self._is_server = False
        self._listen_sock: Optional[socket.socket] = None
        self._conns = {}
        self._next_id = 1
        self._conn_lock = threading.Lock()
        self._send_lock = threading.Lock()
        self._queue: deque = deque()
        self._q_cv = threading.Condition()
        self._threads = []
        self._running = False
        self.rejected_conns = 0

    # -- shared plumbing ---------------------------------------------------
    def _enqueue(self, cid: int, data: bytes) -> None:
        with self._q_cv:
            if len(self._queue) >= 4096:
                self._queue.popleft()
            self._queue.append((cid, data))
            self._q_cv.notify()

    def _reader(self, cid: int, sock: socket.socket) -> None:
        try:
            while True:
                hdr = self._read_exact(sock, _LEN.size)
                if hdr is None:
                    break
                (length,) = _LEN.unpack(hdr)
                payload = self._read_exact(sock, length) if length else b""
                if payload is None:
                    break
                self._enqueue(cid, payload)
        finally:
            with self._conn_lock:
                self._conns.pop(cid, None)
            try:
                sock.close()
            except OSError:
                pass
            if self._running:
                self._enqueue(cid, b"")  # closed event

    @staticmethod
    def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
        chunks = []
        while n > 0:
            try:
                c = sock.recv(n)
            except OSError:
                return None
            if not c:
                return None
            chunks.append(c)
            n -= len(c)
        return b"".join(chunks)

    def _acceptor(self) -> None:
        while self._running:
            try:
                sock, _ = self._listen_sock.accept()
            except OSError:
                break
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            over_cap = False
            with self._conn_lock:
                # reap finished readers so client churn can't grow the list
                self._threads = [t for t in self._threads if t.is_alive()]
                if self.max_conns and len(self._conns) >= self.max_conns:
                    over_cap = True
                else:
                    cid = self._next_id
                    self._next_id += 1
                    self._conns[cid] = sock
                    t = threading.Thread(
                        target=self._reader, args=(cid, sock), daemon=True
                    )
                    self._threads.append(t)
                    t.start()
            if over_cap:
                # reject on a short-lived thread: the NACK send can block
                # up to its 1 s timeout on a hostile/slow peer, and a
                # stream of over-cap connections must not serialize the
                # accept loop behind it (counter bumped HERE — acceptor
                # thread stays the single writer)
                self.rejected_conns += 1
                t = threading.Thread(
                    target=self._reject_conn, args=(sock,), daemon=True
                )
                with self._conn_lock:
                    self._threads.append(t)
                t.start()

    def _reject_conn(self, sock: socket.socket) -> None:
        try:
            payload = self.reject_payload
            if payload:
                sock.settimeout(1.0)
                sock.sendall(_LEN.pack(len(payload)) + payload)
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    # -- public API --------------------------------------------------------
    def listen(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._listen_sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen_sock.bind((host, port))
        self._listen_sock.listen(64)
        self._is_server = True
        self._running = True
        t = threading.Thread(target=self._acceptor, daemon=True)
        self._threads.append(t)
        t.start()
        return self._listen_sock.getsockname()[1]

    def connect(self, host: str, port: int) -> None:
        # create_connection re-resolves `host` on every call by design:
        # a reconnect after failover must chase the CURRENT record
        try:
            sock = socket.create_connection(
                (host, port), timeout=self.connect_timeout
            )
        except socket.gaierror as exc:
            raise UnresolvableError(
                f"cannot resolve {host!r}: {exc}"
            ) from exc
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)
        self._running = True
        with self._conn_lock:
            self._conns[0] = sock
            t = threading.Thread(target=self._reader, args=(0, sock), daemon=True)
            self._threads.append(t)
            t.start()

    def send(self, client_id: int, data: bytes) -> None:
        broadcast = self._is_server and client_id == 0
        with self._conn_lock:
            if broadcast:
                socks = list(self._conns.values())
            else:
                key = client_id if self._is_server else 0
                if key not in self._conns:
                    raise TransportError(f"no connection {key}")
                socks = [self._conns[key]]
        msg = _LEN.pack(len(data)) + data
        with self._send_lock:
            for s in socks:
                try:
                    s.sendall(msg)
                except OSError as exc:
                    # broadcast is best-effort: a dead subscriber is skipped
                    # (its reader thread prunes the connection); a directed
                    # send failure is the caller's error
                    if not broadcast:
                        raise TransportError(f"send failed: {exc}") from exc

    def recv(self, timeout: Optional[float] = None) -> RecvResult:
        with self._q_cv:
            if not self._q_cv.wait_for(
                lambda: self._queue or not self._running, timeout=timeout
            ):
                return None
            if not self._queue:
                return None
            return self._queue.popleft()

    def peer_count(self) -> int:
        with self._conn_lock:
            return len(self._conns)

    def close(self) -> None:
        self._running = False
        if self._listen_sock is not None:
            try:
                # shutdown BEFORE close: closing a listening socket does
                # not reliably wake a thread blocked in accept() (the fd
                # stays referenced); shutdown forces accept to return
                self._listen_sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listen_sock.close()
            except OSError:
                pass
        with self._conn_lock:
            for s in self._conns.values():
                try:
                    s.shutdown(socket.SHUT_RDWR)
                    s.close()
                except OSError:
                    pass
            self._conns.clear()
            threads = list(self._threads)
        with self._q_cv:
            self._q_cv.notify_all()
        # join the acceptor/readers under one bounded budget: their
        # sockets just closed, so they exit promptly — and a server
        # torn down by Executor.stop() must not read as a thread leak
        # merely because the sweep ran before the daemons noticed
        me = threading.current_thread()
        deadline = time.monotonic() + 2.0
        for t in threads:
            if t is me:
                continue
            t.join(timeout=max(0.05, deadline - time.monotonic()))


class ChaosCounter:
    """Mutable send counter shared across reconnects, so the injection
    schedule stays deterministic when the wrapped transport is rebuilt
    (the client reconnect path replaces its transport object)."""

    __slots__ = ("n",)

    def __init__(self) -> None:
        self.n = 0


class ChaosTransport:
    """Deterministic network-fault injector wrapping a query transport
    (docs/fault-tolerance.md, docs/edge-serving.md): the chaos harness's
    answer to "does the NACK/reconnect machinery actually work" without
    waiting for real packet loss.

    - ``drop_every_n``: every Nth send severs the connection mid-stream
      (the inner transport is closed, the send raises TransportError) —
      exercising the client's reconnect-with-backoff and the server's
      disconnect bookkeeping.
    - ``truncate_every_n``: every Nth send transmits a truncated edge
      header instead of the payload (framing intact, message garbage) —
      the server answers with a structured ``malformed`` NACK and the
      client retries.

    Counting is shared via :class:`ChaosCounter` so schedules survive
    the reconnects they themselves cause."""

    def __init__(self, inner, counter: Optional[ChaosCounter] = None,
                 drop_every_n: int = 0, truncate_every_n: int = 0) -> None:
        self.inner = inner
        self.counter = counter if counter is not None else ChaosCounter()
        self.drop_every_n = max(0, int(drop_every_n))
        self.truncate_every_n = max(0, int(truncate_every_n))

    # -- fault injection on the send path ----------------------------------
    def send(self, client_id: int, data: bytes) -> None:
        self.counter.n += 1
        n = self.counter.n
        if self.drop_every_n and n % self.drop_every_n == 0:
            self.inner.close()
            raise TransportError(
                f"chaos: connection dropped mid-stream (send {n})"
            )
        if self.truncate_every_n and n % self.truncate_every_n == 0:
            # a well-framed message whose edge header is cut short: the
            # peer's decode_message raises, never mis-parses
            self.inner.send(client_id, data[: min(len(data), 6)])
            return
        self.inner.send(client_id, data)

    # -- passthrough -------------------------------------------------------
    def listen(self, host: str = "127.0.0.1", port: int = 0) -> int:
        return self.inner.listen(host, port)

    def connect(self, host: str, port: int) -> None:
        self.inner.connect(host, port)

    def recv(self, timeout: Optional[float] = None) -> RecvResult:
        return self.inner.recv(timeout=timeout)

    def peer_count(self) -> int:
        return self.inner.peer_count()

    def close(self) -> None:
        self.inner.close()


def transport_kind(t) -> str:
    """Which byte path a transport runs: ``native`` (the C++ library),
    ``python`` (the socket fallback), ``shm`` or ``mqtt``; wrappers (the
    chaos injector, HYBRID's discovery shell) report their data plane.
    ``none`` before a transport exists."""
    if t is None:
        return "none"
    inner = getattr(t, "inner", None) or getattr(t, "_tcp", None)
    if inner is not None:
        return transport_kind(inner)
    if isinstance(t, NativeTransport):
        return "native"
    if isinstance(t, PyTransport):
        return "python"
    name = type(t).__name__.lower()
    return "shm" if "shm" in name else "mqtt" if "mqtt" in name else name


def make_transport(prefer_native: bool = True):
    """Factory: native C++ transport when buildable, else python sockets."""
    if prefer_native:
        try:
            return NativeTransport()
        except TransportError:
            pass
    return PyTransport()
