"""gRPC tensor bridge: tensor_src_grpc / tensor_sink_grpc elements.

Reference: ext/nnstreamer/extra/nnstreamer_grpc_*.cc (NNStreamerRPC class,
nnstreamer_grpc_common.h:32-83, protobuf AND flatbuf IDL variants in
nnstreamer_grpc_protobuf.cc / nnstreamer_grpc_flatbuf.cc) +
tensor_src_grpc.c / tensor_sink_grpc.c — each element runs as gRPC
*server or client* per property, streaming tensor messages. Both IDLs are
offered here too (``idl=protobuf`` default, ``idl=flatbuf``), both on the
port's own codecs (converters/protobuf.py, converters/flatbuf.py), whose
bytes grpc streams verbatim. The two IDLs register distinct
service names (as the reference does), so a mismatched pair fails loudly
instead of mis-parsing.

No generated stubs are needed: the service is registered with
``grpc.method_handlers_generic_handler`` using the IDL's serializers.
``grpc`` is imported inside the elements; on a machine without it they
raise an ElementError that names it.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.converters.flatbuf import decode_flatbuf, encode_flatbuf
from nnstreamer_tpu_torch.converters.protobuf import parse_tensors, serialize_frame
from nnstreamer_tpu_torch.elements.base import (
    parse_bool,
    ElementError,
    NegotiationError,
    PropSpec,
    Sink,
    Source,
    Spec,
)
from nnstreamer_tpu_torch.tensors.frame import EOS_FRAME, Frame
from nnstreamer_tpu_torch.tensors.spec import TensorFormat, TensorsSpec

def _require_grpc():
    try:
        import grpc  # noqa: F401

        return grpc
    except ImportError as exc:
        raise ElementError(
            "the grpc python package is not installed; tensor_src_grpc and "
            "tensor_sink_grpc need it"
        ) from exc


class _ProtobufIdl:
    """Wire = ``Tensors`` messages of nnstreamer.proto (reference
    nnstreamer_grpc_protobuf.cc slot), written and read by the port's own
    codec (converters/protobuf.py): grpc carries the raw bytes, so no
    protobuf runtime is needed. ``Empty`` is the empty byte string, as
    protobuf serializes it."""

    name = "protobuf"
    # a wire name, shared with the reference's peers
    service = "nnstreamer_tpu.proto.TensorService"

    tensors_ser = staticmethod(bytes)
    tensors_des = staticmethod(bytes)
    empty_ser = staticmethod(lambda _m: b"")
    empty_des = staticmethod(lambda _b: b"")

    def empty(self):
        return b""

    def frame_to_wire(self, frame: Frame) -> bytes:
        return serialize_frame(frame)

    def wire_to_frame(self, data) -> Frame:
        tensors, _rate = parse_tensors(data)
        return Frame(tuple(tensors))


class _FlatbufIdl(_ProtobufIdl):
    """Wire = flatbuffer-serialized Tensors (converters/flatbuf.py codec,
    nnstreamer.fbs schema — reference nnstreamer_grpc_flatbuf.cc slot).
    The buffer bytes stream verbatim; Empty is the empty byte string."""

    name = "flatbuf"
    service = "nnstreamer_tpu.flatbuf.TensorService"

    def frame_to_wire(self, frame: Frame) -> bytes:
        return encode_flatbuf(frame.tensors)

    def wire_to_frame(self, data) -> Frame:
        tensors, _rate = decode_flatbuf(data)
        return Frame(tuple(tensors))


_IDLS = {"protobuf": _ProtobufIdl, "flatbuf": _FlatbufIdl}


def _make_idl(name: str):
    try:
        return _IDLS[name]()
    except KeyError:
        raise ElementError(
            f"unknown idl {name!r} (choose protobuf or flatbuf)"
        ) from None
    except ImportError as exc:
        raise ElementError(f"idl {name!r} unavailable: {exc}") from exc


def _service_handler(grpc, idl, send_handler=None, recv_handler=None):
    """Build the generic service handler with the IDL's serializers."""
    handlers = {}
    if send_handler is not None:  # client streams Tensors at us
        handlers["SendTensors"] = grpc.stream_unary_rpc_method_handler(
            send_handler,
            request_deserializer=idl.tensors_des,
            response_serializer=idl.empty_ser,
        )
    if recv_handler is not None:  # we stream Tensors to the client
        handlers["RecvTensors"] = grpc.unary_stream_rpc_method_handler(
            recv_handler,
            request_deserializer=idl.empty_des,
            response_serializer=idl.tensors_ser,
        )
    return grpc.method_handlers_generic_handler(idl.service, handlers)


def _bounded_put(q: "queue_mod.Queue", item, should_abort) -> bool:
    """Lossless bounded enqueue that can't wedge the producer thread: block
    with a short timeout and re-check the abort predicate, so gRPC flow
    control backpressures the sender while shutdown always unblocks.
    Returns False if aborted before the item landed."""
    while not should_abort():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue_mod.Full:
            continue
    return False


def _put_unless_stopped(q: "queue_mod.Queue", item, stopped: threading.Event) -> None:
    _bounded_put(q, item, stopped.is_set)


@registry.element("tensor_src_grpc")
class GrpcTensorSrc(Source):
    """Receive Tensors over gRPC and emit them as frames.

    Props: server (true = run a gRPC server accepting SendTensors streams,
    false = connect out and pull via RecvTensors), host, port (0 =
    ephemeral in server mode; read back via ``bound_port``).
    """

    FACTORY_NAME = "tensor_src_grpc"

    PROPERTIES = {
        "server": PropSpec("bool", True),
        "host": PropSpec("str", "127.0.0.1"),
        "port": PropSpec("int", 0, desc="0 = ephemeral in server mode"),
        "idl": PropSpec("enum", "protobuf", ("protobuf", "flatbuf")),
        "connection-timeout": PropSpec("float", 10.0),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.is_server = parse_bool(self.get_property("server", True))
        self.host = str(self.get_property("host", "127.0.0.1"))
        self.port = int(self.get_property("port", 0))
        self.idl_name = str(self.get_property("idl", "protobuf"))
        self.bound_port: Optional[int] = None
        self._queue: "queue_mod.Queue" = queue_mod.Queue(maxsize=64)
        self._server = None
        self._channel = None
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        self._error: Optional[str] = None

    def output_spec(self) -> Spec:
        return TensorsSpec(format=TensorFormat.FLEXIBLE)

    # -- server mode: clients push streams at us ---------------------------
    def _start_server(self, grpc, idl) -> None:
        src = self

        def send_tensors(request_iterator, context):
            # a bare blocking put would wedge this grpc worker thread
            # forever once the consumer stops (the pool is non-daemon,
            # hanging interpreter exit)
            for msg in request_iterator:
                if src._stopped.is_set():
                    break
                _put_unless_stopped(
                    src._queue, idl.wire_to_frame(msg), src._stopped
                )
            return idl.empty()

        self._server = grpc.server(ThreadPoolExecutor(max_workers=4))
        self._server.add_generic_rpc_handlers(
            (_service_handler(grpc, idl, send_handler=send_tensors),)
        )
        self.bound_port = self._server.add_insecure_port(
            f"{self.host}:{self.port}"
        )
        if self.bound_port == 0:
            raise ElementError(f"{self.name}: cannot bind {self.host}:{self.port}")
        self._server.start()

    # -- client mode: we pull a stream from a remote sink ------------------
    def _start_client(self, grpc, idl) -> None:
        self._channel = grpc.insecure_channel(f"{self.host}:{self.port}")
        try:  # fail fast on unreachable server, like EdgeSrc.start
            grpc.channel_ready_future(self._channel).result(
                timeout=float(self.get_property("connection-timeout", 10.0))
            )
        except grpc.FutureTimeoutError as exc:
            self._channel.close()
            self._channel = None
            raise ElementError(
                f"{self.name}: cannot reach gRPC server "
                f"{self.host}:{self.port}"
            ) from exc
        call = self._channel.unary_stream(
            f"/{idl.service}/RecvTensors",
            request_serializer=idl.empty_ser,
            response_deserializer=idl.tensors_des,
        )

        def pull():
            try:
                for msg in call(idl.empty()):
                    if self._stopped.is_set():
                        break
                    _put_unless_stopped(
                        self._queue, idl.wire_to_frame(msg), self._stopped
                    )
            except grpc.RpcError as exc:
                if not self._stopped.is_set():
                    self._error = f"stream broke: {exc.code()}"
            _put_unless_stopped(self._queue, EOS_FRAME, self._stopped)

        self._thread = threading.Thread(target=pull, daemon=True)
        self._thread.start()

    def start(self) -> None:
        grpc = _require_grpc()
        idl = _make_idl(self.idl_name)
        self._stopped.clear()
        if self.is_server:
            self._start_server(grpc, idl)
        else:
            self._start_client(grpc, idl)

    def stop(self) -> None:
        self._stopped.set()
        if self._server is not None:
            self._server.stop(grace=0.5)
            self._server = None
        if self._channel is not None:
            self._channel.close()
            self._channel = None

    def generate(self):
        if self._error:
            raise ElementError(f"{self.name}: {self._error}")
        try:
            return self._queue.get(timeout=0.1)
        except queue_mod.Empty:
            return None


@registry.element("tensor_sink_grpc")
class GrpcTensorSink(Sink):
    """Send rendered frames over gRPC.

    Props: server (true = serve RecvTensors streams to subscribers,
    false = connect out and push via SendTensors), host, port.
    """

    FACTORY_NAME = "tensor_sink_grpc"

    PROPERTIES = {
        "server": PropSpec("bool", True),
        "host": PropSpec("str", "127.0.0.1"),
        "port": PropSpec("int", 0, desc="0 = ephemeral in server mode"),
        "idl": PropSpec("enum", "protobuf", ("protobuf", "flatbuf")),
        "connection-timeout": PropSpec("float", 10.0),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.is_server = parse_bool(self.get_property("server", True))
        self.host = str(self.get_property("host", "127.0.0.1"))
        self.port = int(self.get_property("port", 0))
        self.idl_name = str(self.get_property("idl", "protobuf"))
        self.bound_port: Optional[int] = None
        self._idl = None
        self._server = None
        self._channel = None
        self._push_queue: "queue_mod.Queue" = queue_mod.Queue(maxsize=64)
        self._subscribers: List[queue_mod.Queue] = []
        self._sub_lock = threading.Lock()
        self._client_done = None
        self._stopping = threading.Event()
        self._error: Optional[str] = None

    def _push_abort(self):
        """Abort predicate for client-mode queue puts: a dead stream OR an
        element stop must unblock the producer — a stalled-but-alive stream
        (server stops reading, queue full) never sets _client_done, so
        stop() needs its own flag to avoid spinning forever."""
        done = self._client_done
        return self._stopping.is_set() or (done is not None and done.is_set())

    # -- server mode: subscribers pull a stream ----------------------------
    def _start_server(self, grpc, idl) -> None:
        sink = self

        def recv_tensors(request, context):
            q: "queue_mod.Queue" = queue_mod.Queue(maxsize=64)
            with sink._sub_lock:
                sink._subscribers.append(q)
            try:
                while True:
                    item = q.get()
                    if item is None:
                        break
                    yield item
            finally:
                with sink._sub_lock:
                    if q in sink._subscribers:
                        sink._subscribers.remove(q)

        self._server = grpc.server(ThreadPoolExecutor(max_workers=4))
        self._server.add_generic_rpc_handlers(
            (_service_handler(grpc, idl, recv_handler=recv_tensors),)
        )
        self.bound_port = self._server.add_insecure_port(
            f"{self.host}:{self.port}"
        )
        if self.bound_port == 0:
            raise ElementError(f"{self.name}: cannot bind {self.host}:{self.port}")
        self._server.start()

    # -- client mode: we push a stream to a remote src ---------------------
    def _start_client(self, grpc, idl) -> None:
        self._channel = grpc.insecure_channel(f"{self.host}:{self.port}")
        try:  # fail fast on unreachable server, like GrpcTensorSrc
            grpc.channel_ready_future(self._channel).result(
                timeout=float(self.get_property("connection-timeout", 10.0))
            )
        except grpc.FutureTimeoutError as exc:
            self._channel.close()
            self._channel = None
            raise ElementError(
                f"{self.name}: cannot reach gRPC server "
                f"{self.host}:{self.port}"
            ) from exc
        call = self._channel.stream_unary(
            f"/{idl.service}/SendTensors",
            request_serializer=idl.tensors_ser,
            response_deserializer=idl.empty_des,
        )

        def feed():
            while True:
                item = self._push_queue.get()
                if item is None:
                    return
                yield item

        self._client_done = threading.Event()

        def run():
            try:
                call(feed())
            except grpc.RpcError as exc:
                self._error = f"stream broke: {exc.code()}"
            self._client_done.set()

        threading.Thread(target=run, daemon=True).start()

    def start(self) -> None:
        grpc = _require_grpc()
        self._idl = _make_idl(self.idl_name)
        if self.is_server:
            self._start_server(grpc, self._idl)
        else:
            self._start_client(grpc, self._idl)

    def stop(self) -> None:
        self._stopping.set()
        self.on_eos()
        if self._server is not None:
            self._server.stop(grace=0.5)
            self._server = None
        if self._channel is not None:
            if self._client_done is not None:
                self._client_done.wait(timeout=5)
            self._channel.close()
            self._channel = None

    def render(self, frame: Frame) -> None:
        msg = self._idl.frame_to_wire(self.host_frame(frame))
        if self.is_server:
            with self._sub_lock:
                subs = list(self._subscribers)
            for q in subs:
                try:
                    q.put_nowait(msg)
                except queue_mod.Full:
                    pass  # slow subscriber: drop (reference async mode)
        else:
            # bounded put that notices a dead stream or element stop: once
            # run() exits the feed() generator stops draining and a bare
            # put would block forever on the full queue
            if not _bounded_put(self._push_queue, msg, self._push_abort):
                raise ElementError(
                    f"{self.name}: {self._error or 'gRPC stream closed'}"
                )

    def on_eos(self) -> None:
        if self.is_server:
            with self._sub_lock:
                subs = list(self._subscribers)
            for q in subs:
                # a stalled subscriber's queue may be full — drain one slot
                # so the EOS sentinel lands instead of hanging shutdown
                while True:
                    try:
                        q.put_nowait(None)
                        break
                    except queue_mod.Full:
                        try:
                            q.get_nowait()
                        except queue_mod.Empty:
                            pass
        else:
            try:  # healthy stream: sentinel lands and feed() ends cleanly
                self._push_queue.put_nowait(None)
            except queue_mod.Full:
                _bounded_put(self._push_queue, None, self._push_abort)
