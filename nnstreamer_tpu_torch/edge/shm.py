"""Shared-memory ring transport: the same-host zero-socket fast path.

Reference context: co-located pipeline shards in the reference still talk
through loopback TCP via nnstreamer-edge (gst/edge/edge_common.h default
port 3000). ``connect-type=SHM`` on edgesink/edgesrc replaces that hop
with the native SPSC ring in native/nns_shm.cpp (POSIX shm + process-
shared condvars): one memcpy in, one memcpy out, no syscall per frame on
the hot path.

Exposes the same transport surface as the TCP layer (listen/connect/
send/recv/peer_count/close) keyed by the element's ``port`` (segment name
``/nns-shm-<port>``). Single consumer by design — fan-out stays the TCP
transport's job.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

from nnstreamer_tpu_torch.edge._build import build_native
from nnstreamer_tpu_torch.edge.transport import TransportError

DEFAULT_CAPACITY = 32 * 1024 * 1024  # 32 MB ring
MIN_CAPACITY = 4096  # native layer clamps to this (nns_shm.cpp)
_MAX_MSG = 512 * 1024 * 1024


class MessageTooLarge(TransportError):
    """Permanent per-configuration failure: the message can NEVER fit the
    ring — callers should fail loudly, not retry/drop."""


def _load() -> ctypes.CDLL:
    path = build_native("nns_shm.cpp")
    if path is None:
        raise TransportError(
            "native shm transport unavailable (g++ build failed)"
        )
    try:
        lib = ctypes.CDLL(path)
    except OSError as exc:
        # e.g. a sanitizer build: libtsan needs LD_PRELOAD to dlopen into
        # an uninstrumented interpreter (static TLS)
        raise TransportError(
            f"native shm transport failed to load: {exc} "
            "(sanitizer builds need LD_PRELOAD of the sanitizer runtime)"
        )
    lib.nns_shm_create.restype = ctypes.c_void_p
    lib.nns_shm_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.nns_shm_open.restype = ctypes.c_void_p
    lib.nns_shm_open.argtypes = [ctypes.c_char_p]
    lib.nns_shm_write.restype = ctypes.c_int
    lib.nns_shm_write.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
    ]
    lib.nns_shm_read.restype = ctypes.c_int64
    lib.nns_shm_read.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
    ]
    lib.nns_shm_reader_count.restype = ctypes.c_uint32
    lib.nns_shm_reader_count.argtypes = [ctypes.c_void_p]
    lib.nns_shm_mark_closed.restype = None
    lib.nns_shm_mark_closed.argtypes = [ctypes.c_void_p]
    lib.nns_shm_close.restype = None
    lib.nns_shm_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


_lib: Optional[ctypes.CDLL] = None


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


def segment_name(port: int) -> str:
    return f"/nns-shm-{port}"


class ShmTransport:
    """Producer (listen) or consumer (connect) end of one shm ring."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self.capacity = max(int(capacity), MIN_CAPACITY)  # mirror native clamp
        self._h: Optional[int] = None
        self._producer = False
        self._buf = ctypes.create_string_buffer(4 * 1024 * 1024)

    # -- transport surface -------------------------------------------------
    def listen(self, host: str, port: int) -> int:
        lib = _get_lib()
        port = port or os.getpid() % 50000 + 10000
        h = lib.nns_shm_create(segment_name(port).encode(), self.capacity)
        if not h:
            raise TransportError(
                f"cannot create shm segment {segment_name(port)!r}: a live "
                "producer owns it (TCP-listen EADDRINUSE analogue), or shm "
                f"is unavailable; stale file: /dev/shm{segment_name(port)}"
            )
        self._h = h
        self._producer = True
        return port

    def connect(self, host: str, port: int) -> None:
        lib = _get_lib()
        h = lib.nns_shm_open(segment_name(port).encode())
        if not h:
            raise TransportError(
                f"no shm segment {segment_name(port)!r} (is the producer up?)"
            )
        self._h = h
        self._producer = False

    def send(self, cid, payload: bytes, timeout: float = 10.0) -> None:
        if self._h is None:
            raise TransportError("shm transport not started")
        if len(payload) + 8 > self.capacity // 2:
            # the ring guarantees progress only for messages ≤ capacity/2
            raise MessageTooLarge(
                f"shm message ({len(payload)} B) exceeds ring capacity/2 "
                f"({self.capacity // 2} B); raise the transport capacity "
                "(edgesink shm-capacity property)"
            )
        rc = _get_lib().nns_shm_write(
            self._h, payload, len(payload), int(timeout * 1000)
        )
        if rc == 0:
            raise TransportError("shm ring full (consumer stalled)")
        if rc < 0:
            raise TransportError("shm ring closed")

    def recv(self, timeout: Optional[float] = None) -> Optional[Tuple[int, bytes]]:
        if self._h is None:
            raise TransportError("shm transport not started")
        lib = _get_lib()
        ms = int((timeout if timeout is not None else 0.1) * 1000) or 1
        while True:
            n = lib.nns_shm_read(self._h, self._buf, len(self._buf), ms)
            if n == 0:
                return None  # timeout
            if n == -1:
                return (0, b"")  # closed + drained (EOS analogue)
            if n == -2:
                if len(self._buf) * 2 > _MAX_MSG:
                    raise TransportError("shm message exceeds max size")
                self._buf = ctypes.create_string_buffer(len(self._buf) * 2)
                continue
            # string_at copies exactly n bytes; .raw would materialize the
            # whole (possibly hundreds-of-MB) reader buffer per message
            return (0, ctypes.string_at(self._buf, n))

    def peer_count(self) -> int:
        if self._h is None:
            return 0
        return int(_get_lib().nns_shm_reader_count(self._h))

    def close(self) -> None:
        if self._h is None:
            return
        lib = _get_lib()
        if self._producer:
            lib.nns_shm_mark_closed(self._h)
        lib.nns_shm_close(self._h, 1 if self._producer else 0)
        self._h = None
