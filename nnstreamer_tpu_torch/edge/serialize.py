"""Frame ↔ wire-message codec for the edge layer.

The counterpart of ``nnstreamer_tpu/edge/serialize.py``: the same frame
gives the same bytes in both packages, in both directions.

The payload the transports carry: a small frame header followed by the
flexible-tensor encoding (tensors/meta.py — the same self-describing header
the reference uses for format=flexible streams and its edge serialization,
SURVEY.md §5.8).

Layout (little-endian):

    uint8  version (2; v1 — no meta blob, flags always 0 — still decodes)
    uint8  kind    (0 = DATA, 1 = EOS, 2 = NACK, 3 = CTRL)
    int64  pts     (ns; -1 = unknown)
    int64  duration(ns; -1 = unknown)
    uint32 flags   (bit 0: a meta blob follows the header)
    [uint32 meta_len + UTF-8 JSON meta blob, when flags bit 0]
    [flex tensors...]

The meta blob is the distributed-correlation channel (docs/
observability.md): JSON-scalar frame meta — notably the ``frame_id``
tensor_query_client stamps — crosses tensor_query/edgesrc hops, so the
client's trace span and the server-side spans for the same frame share
an identity and ``trace.merge()`` can line them up on one timeline.
Per-hop-local keys (``client_id``, the transport pairing tag;
``wall_t0``, a perf_counter reading meaningless in another process;
``admit_t``, the server's local admission stamp; ``_nns_srv``, the
serversrc pairing key) never ride the wire.

``KIND_NACK`` (docs/edge-serving.md) is the admission layer's explicit
rejection: no tensors, just a meta blob carrying ``nack_reason``
(max-clients / overload / client-backpressure / rate / malformed /
deadline / failed), a ``retry_after_ms`` hint, and — when known — the
``frame_id`` of the rejected request. ``decode_message`` returns it as
a :class:`Nack` so clients can back off instead of timing out.
"""

from __future__ import annotations

import json
import struct

from nnstreamer_tpu_torch.tensors.frame import EOS, EOS_FRAME, Frame
from nnstreamer_tpu_torch.tensors.meta import decode_frame_tensors, encode_frame_tensors

_HDR = struct.Struct("<BBqqI")
_META_LEN = struct.Struct("<I")
# v2 added the flagged meta blob; v1 messages (reserved field always 0)
# decode through the same path, and a v1 peer receiving v2 fails with a
# clean unsupported-version error instead of mis-parsing the blob as
# tensor data
VERSION = 2
_DECODABLE_VERSIONS = (1, 2)
KIND_DATA = 0
KIND_EOS = 1
KIND_NACK = 2
# control channel (docs/edge-serving.md "Running a fleet"): an operator
# message to the serving plane rather than a request — ``drain``
# (graceful drain for rolling restarts) and the ``migrate_*`` live-
# migration handshake. Same framing as a NACK: the meta blob
# (``ctrl_op``) instead of tensors, plus optional opaque payload bytes
# after it (the KV span). Both ends of this protocol live in-tree, so
# no version bump is needed.
KIND_CTRL = 3
FLAG_META = 1

# meta keys that must NOT cross a hop: local to the process that set them
_WIRE_META_SKIP = frozenset({
    "client_id", "wall_t0", "admit_t", "_nns_srv", "_nns_budget_released",
})

#: request-meta key carrying the prompt's rolling-CRC prefix keys as one
#: dot-joined hex string (``_wire_meta`` keeps scalars only, so the list
#: rides flattened). Stamped by the fleet client, echoed back in the
#: reply meta like any propagatable key — the PrefixRouter learns which
#: endpoint answered which prefix from the echo (docs/edge-serving.md
#: "Prefix-aware routing").
ROUTE_META_KEY = "_nns_pfx"


class Nack:
    """A structured rejection from the serving plane (docs/
    edge-serving.md): the request was NOT processed; ``retry_after_ms``
    hints when a retry might be admitted (reason ``deadline`` is the one
    terminal NACK — the request was admitted but shed)."""

    __slots__ = ("reason", "retry_after_ms", "frame_id")

    def __init__(self, reason: str, retry_after_ms: float = 0.0,
                 frame_id=None) -> None:
        self.reason = reason
        self.retry_after_ms = float(retry_after_ms)
        self.frame_id = frame_id

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"Nack(reason={self.reason!r}, "
            f"retry_after_ms={self.retry_after_ms})"
        )


class Ctrl:
    """A control message to the serving plane (``KIND_CTRL``):
    ``op == "drain"`` (stop accepting new work, NACK new submits
    ``draining``, finish the admitted in-flight, then quiesce) and the
    live-migration handshake (docs/llm-serving.md "Migration &
    recovery"): ``migrate_probe`` / ``migrate_probe_ack`` (prefix
    coverage query before shipping), ``migrate_span`` /
    ``migrate_span_ack`` (the KV span itself riding ``payload``), and
    the disaggregated-serving poll (docs/llm-serving.md "Disaggregated
    serving"): ``disagg_fetch`` / ``disagg_fetch_ack`` — the prefill
    server collecting a handed-off generation's finished tokens from
    its decode peer. ``payload`` is opaque trailing bytes after the
    meta blob — v1/v2 decoders ignored trailing CTRL bytes, so no
    version bump."""

    __slots__ = ("op", "meta", "payload")

    def __init__(self, op: str, meta=None, payload: bytes = b"") -> None:
        self.op = op
        self.meta = meta or {}
        self.payload = payload

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Ctrl(op={self.op!r})"


def encode_ctrl(op: str, payload: bytes = b"", **extra) -> bytes:
    meta = {"ctrl_op": str(op)}
    meta.update(extra)
    enc = json.dumps(meta, separators=(",", ":")).encode()
    return (
        _HDR.pack(VERSION, KIND_CTRL, -1, -1, FLAG_META)
        + _META_LEN.pack(len(enc)) + enc + payload
    )


def encode_nack(reason: str, retry_after_ms: float = 0.0,
                frame_id=None) -> bytes:
    meta = {"nack_reason": reason, "retry_after_ms": float(retry_after_ms)}
    if frame_id is not None:
        meta["frame_id"] = frame_id
    enc = json.dumps(meta, separators=(",", ":")).encode()
    return (
        _HDR.pack(VERSION, KIND_NACK, -1, -1, FLAG_META)
        + _META_LEN.pack(len(enc)) + enc
    )


def _wire_meta(frame) -> dict:
    """The JSON-safe, propagatable subset of a frame's meta."""
    out = {}
    for k, v in frame.meta.items():
        if k in _WIRE_META_SKIP:
            continue
        if v is None or isinstance(v, (str, int, float, bool)):
            out[k] = v
    return out


def encode_message(frame) -> bytes:
    if isinstance(frame, EOS):
        return _HDR.pack(VERSION, KIND_EOS, -1, -1, 0)
    pts = -1 if frame.pts is None else frame.pts
    dur = -1 if frame.duration is None else frame.duration
    # torch tensors (any device) and numpy arrays encode alike; a sink
    # hands over host tensors, fetched in one copy before this runs
    meta = _wire_meta(frame)
    flags = FLAG_META if meta else 0
    blob = b""
    if meta:
        enc = json.dumps(meta, separators=(",", ":")).encode()
        blob = _META_LEN.pack(len(enc)) + enc
    return (
        _HDR.pack(VERSION, KIND_DATA, pts, dur, flags)
        + blob
        + encode_frame_tensors(frame.tensors)
    )


def decode_message(data: bytes):
    """→ Frame, EOS_FRAME, :class:`Nack`, or :class:`Ctrl`. Raises
    ValueError on malformed input."""
    if len(data) < _HDR.size:
        raise ValueError(f"edge message too short: {len(data)}")
    version, kind, pts, dur, flags = _HDR.unpack_from(data)
    if version not in _DECODABLE_VERSIONS:
        raise ValueError(f"unsupported edge message version {version}")
    if kind == KIND_EOS:
        return EOS_FRAME
    off = _HDR.size
    meta = {}
    if flags & FLAG_META:
        if len(data) < off + _META_LEN.size:
            raise ValueError("edge message meta length truncated")
        (meta_len,) = _META_LEN.unpack_from(data, off)
        off += _META_LEN.size
        if len(data) < off + meta_len:
            raise ValueError("edge message meta blob truncated")
        try:
            meta = json.loads(data[off:off + meta_len])
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise ValueError(
                f"edge message meta not valid JSON: {exc}"
            ) from exc
        if not isinstance(meta, dict):
            raise ValueError("edge message meta is not an object")
        off += meta_len
    if kind == KIND_NACK:
        return Nack(
            str(meta.get("nack_reason", "unspecified")),
            float(meta.get("retry_after_ms", 0.0) or 0.0),
            meta.get("frame_id"),
        )
    if kind == KIND_CTRL:
        return Ctrl(str(meta.get("ctrl_op", "")), meta, data[off:])
    # one copy into a writable buffer: the arrays are views of it, so a
    # consumer may write them and torch.from_numpy shares them safely
    tensors = decode_frame_tensors(memoryview(bytearray(memoryview(data)[off:])))
    return Frame(
        tensors,
        pts=None if pts < 0 else pts,
        duration=None if dur < 0 else dur,
        meta=meta,
    )
