"""protobuf converter subplugin and the ``Tensors`` wire codec, by hand.

The counterpart of ``nnstreamer_tpu/converters/protobuf.py`` (reference
tensor_converter_protobuf.cc with nnstreamer.proto). The schema is
``nns_tensors.proto`` beside this file; the port needs no protobuf runtime.
:func:`serialize_frame` writes the bytes protobuf's own serializer writes:
fields in field-number order, and proto3's omissions (``num_tensor`` 0,
``format`` STATIC, an empty ``name``, ``type`` NNS_INT32 — an int32 tensor
carries no type field — empty ``data``, and an empty packed
``dimension``). :func:`parse_tensors` reads any valid encoding of the
message: packed or unpacked dimensions, unknown fields skipped.
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional, Tuple

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.meta import array_bytes, host_bytes, tensor_from_bytes
from nnstreamer_tpu_torch.tensors.spec import DType, TensorFormat, TensorsSpec

# enum value ↔ dtype (proto Tensor_type, the reference's order)
PB_TO_DTYPE = {
    0: DType.INT32, 1: DType.UINT32, 2: DType.INT16, 3: DType.UINT16,
    4: DType.INT8, 5: DType.UINT8, 6: DType.FLOAT64, 7: DType.FLOAT32,
    8: DType.INT64, 9: DType.UINT64, 10: DType.FLOAT16, 11: DType.BFLOAT16,
}
DTYPE_TO_PB = {v: k for k, v in PB_TO_DTYPE.items()}
_FORMAT_TO_PB = {TensorFormat.STATIC: 0, TensorFormat.FLEXIBLE: 1, TensorFormat.SPARSE: 2}

# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _varint(v: int) -> bytes:
    """Base-128 varint; a negative int32 goes out sign-extended to 64 bits,
    as protobuf writes it."""
    v &= (1 << 64) - 1
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _key(num: int, wire: int) -> bytes:
    return _varint(num << 3 | wire)


def _len_field(num: int, parts: List[bytes]) -> List[bytes]:
    return [_key(num, _LEN), _varint(sum(len(p) for p in parts)), *parts]


def serialize_frame(frame: Frame, fmt: TensorFormat = TensorFormat.STATIC,
                    rate: Optional[Fraction] = None) -> bytes:
    """The frame as a serialized ``Tensors`` message: the bytes of the
    reference's ``frame_to_message(frame, fmt, rate).SerializeToString()``.
    A device tensor is copied to the host once."""
    rate = rate or frame.meta.get("rate")
    names = frame.meta.get("names", {})
    parts: List[bytes] = []
    if frame.num_tensors:
        parts += [_key(1, _VARINT), _varint(frame.num_tensors)]
    if rate:
        fr = []
        for num, v in ((1, rate.numerator), (2, rate.denominator)):
            if v:
                fr += [_key(num, _VARINT), _varint(int(v))]
        parts += _len_field(2, fr)
    for i, t in enumerate(frame.tensors):
        dtype, _, data = array_bytes(t)
        shape = tuple(t.shape)  # a 0-d tensor carries no dimension field
        code = DTYPE_TO_PB[dtype]
        body: List[bytes] = []
        name = str(names.get(i, "")).encode()
        if name:
            body += _len_field(1, [name])
        if code:
            body += [_key(2, _VARINT), _varint(code)]
        if shape:  # packed uint32s, innermost dimension first
            body += _len_field(3, [b"".join(_varint(int(d)) for d in reversed(shape))])
        if data:
            body += _len_field(4, [data])
        parts += _len_field(3, body)
    code = _FORMAT_TO_PB[fmt]
    if code:
        parts += [_key(4, _VARINT), _varint(code)]
    return b"".join(parts)


def _read_varint(buf, pos: int, end: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= end or shift > 63:
            raise ValueError("protobuf: truncated or overlong varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7


def _fields(buf, pos: int, end: int):
    """(field number, wire type, value) of one message's fields; a
    length-delimited value is its (offset, length) in ``buf``."""
    while pos < end:
        key, pos = _read_varint(buf, pos, end)
        num, wire = key >> 3, key & 7
        if wire == _VARINT:
            value, pos = _read_varint(buf, pos, end)
        elif wire == _LEN:
            n, pos = _read_varint(buf, pos, end)
            value = (pos, n)
            pos += n
        elif wire in (_I64, _I32):
            value = None
            pos += 8 if wire == _I64 else 4
        else:
            raise ValueError(f"protobuf: unsupported wire type {wire}")
        if pos > end:
            raise ValueError("protobuf: truncated message")
        yield num, wire, value


def _int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _parse_tensor(buf, pos: int, end: int):
    code, dims, data = 0, [], (pos, 0)
    for num, wire, value in _fields(buf, pos, end):
        if num == 2 and wire == _VARINT:
            code = _int32(value)
        elif num == 3 and wire == _VARINT:
            dims.append(value & 0xFFFFFFFF)
        elif num == 3 and wire == _LEN:
            p, n = value
            while p < value[0] + n:
                d, p = _read_varint(buf, p, value[0] + n)
                dims.append(d & 0xFFFFFFFF)
        elif num == 4 and wire == _LEN:
            data = value
    dtype = PB_TO_DTYPE.get(code, DType.UINT8)
    return tensor_from_bytes(buf, data[0], data[1], dtype, tuple(reversed(dims)))


def parse_tensors(data) -> Tuple[tuple, Tuple[int, int]]:
    """A serialized ``Tensors`` message → (tensors as CPU torch tensors,
    (rate_n, rate_d)); the reference's ``message_to_tensors`` over
    ``Tensors.FromString(data)``, with the message's frame rate."""
    buf = memoryview(data).cast("B")
    tensors, rate = [], (0, 0)
    for num, wire, value in _fields(buf, 0, len(buf)):
        if num == 2 and wire == _LEN:
            rn, rd = rate
            for fnum, fwire, fv in _fields(buf, value[0], value[0] + value[1]):
                if fnum == 1 and fwire == _VARINT:
                    rn = _int32(fv)
                elif fnum == 2 and fwire == _VARINT:
                    rd = _int32(fv)
            rate = (rn, rd)
        elif num == 3 and wire == _LEN:
            tensors.append(_parse_tensor(buf, value[0], value[0] + value[1]))
    return tuple(tensors), rate


@registry.converter_plugin("protobuf")
class ProtobufConverter:
    def negotiate(self, in_spec, props: dict) -> TensorsSpec:
        return TensorsSpec(format=TensorFormat.FLEXIBLE)

    def convert(self, frame: Frame, props: dict) -> Frame:
        tensors, (rn, rd) = parse_tensors(host_bytes(frame.tensors[0]))
        if not tensors:
            raise ValueError("protobuf: empty Tensors message")
        out = frame.with_tensors(tensors)
        if rn and rd:  # the stream's cadence survives the hop
            out = out.with_meta(rate=Fraction(rn, rd))
        return out
