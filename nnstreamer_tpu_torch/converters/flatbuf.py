"""flatbuf converter subplugin and the flatbuffer ``Tensors`` codec, by hand.

The counterpart of ``nnstreamer_tpu/converters/flatbuf.py`` (reference
tensor_converter_flatbuf.cc with nnstreamer.fbs: Tensors{num_tensor, fr,
tensor[], format}, Tensor{name, type, dimension, data}). The port needs
no flatbuffers runtime: :class:`_Builder` lays the buffer out as the
flatbuffers ``Builder`` does — back to front, each scalar aligned to its
size, vectors prefixed by their length, a zero-terminated string, slots at
their default left out (``type``'s default is NNS_END = 10), the
``frame_rate`` struct inline, a table's vtable shared with any earlier
table whose vtable is the same (every ``Tensor`` after the first reuses
the first one's), and the root offset aligned to the largest alignment
used — so :func:`encode_flatbuf` writes the reference's bytes.
"""

from __future__ import annotations

import struct
from fractions import Fraction
from typing import Optional, Sequence, Tuple

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.tensors.frame import Frame
from nnstreamer_tpu_torch.tensors.meta import array_bytes, host_bytes, tensor_from_bytes
from nnstreamer_tpu_torch.tensors.spec import DType, TensorFormat, TensorsSpec

# enum Tensor_type (nnstreamer.fbs order); NNS_END = 10 is the default slot
FB_TO_DTYPE = {
    0: DType.INT32, 1: DType.UINT32, 2: DType.INT16, 3: DType.UINT16,
    4: DType.INT8, 5: DType.UINT8, 6: DType.FLOAT64, 7: DType.FLOAT32,
    8: DType.INT64, 9: DType.UINT64,
}
DTYPE_TO_FB = {v: k for k, v in FB_TO_DTYPE.items()}
FB_TYPE_END = 10

_FORMAT_TO_FB = {TensorFormat.STATIC: 0, TensorFormat.FLEXIBLE: 1, TensorFormat.SPARSE: 2}


class _Builder:
    """The flatbuffers Builder's layout rules over a bytearray filled from
    its end. Offsets are counted from the end of the buffer, so the output
    does not depend on the initial size."""

    def __init__(self, size: int) -> None:
        self.buf = bytearray(max(size, 1))
        self.head = len(self.buf)
        self.minalign = 1
        self.vtable: Optional[list] = None
        self.object_end = 0
        self.vtables = {}  # vtable contents → offset of the written vtable
        self.vector_len = 0

    def offset(self) -> int:
        return len(self.buf) - self.head

    def prep(self, size: int, additional: int) -> None:
        """Pad so that ``size`` is aligned once ``additional`` bytes are
        written, growing the buffer (doubling, data at the end) if needed."""
        self.minalign = max(self.minalign, size)
        align = -(self.offset() + additional) & (size - 1)
        while self.head < align + size + additional:
            old = len(self.buf)
            grown = bytearray(old * 2)
            grown[old:] = self.buf
            self.buf, self.head = grown, self.head + old
        self.buf[self.head - align:self.head] = bytes(align)
        self.head -= align

    def place(self, fmt: str, value: int) -> None:
        self.head -= struct.calcsize(fmt)
        struct.pack_into("<" + fmt, self.buf, self.head, value)

    def prepend(self, fmt: str, value: int) -> None:
        self.prep(struct.calcsize(fmt), 0)
        self.place(fmt, value)

    def prepend_uoffset(self, off: int) -> None:
        self.prep(4, 0)
        self.place("I", self.offset() - off + 4)

    def start_vector(self, elem_size: int, n: int, alignment: int) -> None:
        self.vector_len = n
        self.prep(4, elem_size * n)
        self.prep(alignment, elem_size * n)

    def end_vector(self) -> int:
        self.place("I", self.vector_len)
        return self.offset()

    def _bytes_vector(self, data, terminator: bool) -> int:
        n = len(data)
        self.prep(4, n + terminator)
        if terminator:
            self.place("B", 0)
        self.head -= n
        self.buf[self.head:self.head + n] = data
        self.vector_len = n
        return self.end_vector()

    def create_string(self, s: str) -> int:
        return self._bytes_vector(s.encode(), terminator=True)

    def create_byte_vector(self, data) -> int:
        return self._bytes_vector(data, terminator=False)

    def start_object(self, n_fields: int) -> None:
        self.vtable = [0] * n_fields
        self.object_end = self.offset()

    def slot(self, i: int) -> None:
        self.vtable[i] = self.offset()

    def prepend_slot(self, fmt: str, i: int, value: int, default: int) -> None:
        if value != default:
            self.prepend(fmt, value)
            self.slot(i)

    def prepend_uoffset_slot(self, i: int, off: int, default: int) -> None:
        if off != default:
            self.prepend_uoffset(off)
            self.slot(i)

    def end_object(self) -> int:
        """Write the object's vtable offset and, unless an identical
        vtable was written before, the vtable (trailing empty slots
        trimmed)."""
        self.prepend("i", 0)  # the vtable offset, filled in below
        obj = self.offset()
        fields = [obj - o if o else 0 for o in self.vtable]
        while fields and fields[-1] == 0:
            fields.pop()
        key = (tuple(fields), obj - self.object_end)
        shared = self.vtables.get(key)
        if shared is None:
            for f in reversed(fields):
                self.prepend("H", f)
            self.prepend("H", obj - self.object_end)
            self.prepend("H", (len(fields) + 2) * 2)
            struct.pack_into("<i", self.buf, len(self.buf) - obj, self.offset() - obj)
            self.vtables[key] = self.offset()
        else:
            struct.pack_into("<i", self.buf, len(self.buf) - obj, shared - obj)
        self.vtable = None
        return obj

    def finish(self, root: int) -> bytes:
        self.prep(self.minalign, 4)
        self.prepend_uoffset(root)
        return bytes(memoryview(self.buf)[self.head:])


def encode_flatbuf(
    tensors: Sequence,
    rate: Optional[Tuple[int, int]] = None,
    fmt: TensorFormat = TensorFormat.STATIC,
) -> bytes:
    """Tensors (torch on any device, or numpy) → a flatbuffer ``Tensors``:
    the reference's ``encode_flatbuf`` bytes. float16 and bfloat16 have
    no enum value in the schema and raise ValueError."""
    blobs = []
    for t in tensors:
        dtype, shape, data = array_bytes(t)
        if dtype not in DTYPE_TO_FB:
            raise ValueError(f"flatbuf: dtype {dtype} not representable")
        blobs.append((dtype, shape, data))
    b = _Builder(sum(len(d) for _, _, d in blobs) + 128 * len(blobs) + 128)
    tensor_offs = []
    for dtype, shape, data in blobs:
        data_off = b.create_byte_vector(data)
        b.start_vector(4, len(shape), 4)
        for d in shape:  # prepended outermost last: innermost first on the wire
            b.prepend("I", int(d))
        dim_off = b.end_vector()
        name_off = b.create_string("")
        b.start_object(4)
        b.prepend_uoffset_slot(0, name_off, 0)
        b.prepend_slot("i", 1, DTYPE_TO_FB[dtype], FB_TYPE_END)
        b.prepend_uoffset_slot(2, dim_off, 0)
        b.prepend_uoffset_slot(3, data_off, 0)
        tensor_offs.append(b.end_object())
    b.start_vector(4, len(tensor_offs), 4)
    for off in reversed(tensor_offs):
        b.prepend_uoffset(off)
    vec_off = b.end_vector()
    b.start_object(4)
    b.prepend_slot("i", 0, len(tensor_offs), 0)
    rn, rd = rate if rate else (0, 0)
    b.prep(4, 8)  # inline struct frame_rate{rate_n, rate_d}
    b.prepend("i", int(rd))
    b.prepend("i", int(rn))
    b.slot(1)
    b.prepend_uoffset_slot(2, vec_off, 0)
    b.prepend_slot("i", 3, _FORMAT_TO_FB[fmt], 0)
    return b.finish(b.end_object())


def decode_flatbuf(data) -> Tuple[tuple, Tuple[int, int]]:
    """A flatbuffer ``Tensors`` → (tensors as CPU torch tensors,
    (rate_n, rate_d))."""
    buf = memoryview(data).cast("B")

    def u32(pos):
        return struct.unpack_from("<I", buf, pos)[0]

    def i32(pos):
        return struct.unpack_from("<i", buf, pos)[0]

    def field(table: int, slot: int) -> int:
        """The field's offset in ``table``, 0 when the vtable leaves it out."""
        vt = table - i32(table)
        at = 4 + 2 * slot
        if at >= struct.unpack_from("<H", buf, vt)[0]:
            return 0
        return struct.unpack_from("<H", buf, vt + at)[0]

    def vector(table: int, off: int) -> Tuple[int, int]:
        """(start of the elements, their count) of the vector field at ``off``."""
        at = table + off
        at += u32(at)
        return at + 4, u32(at)

    root = u32(0)
    rate = (0, 0)
    o = field(root, 1)
    if o:
        rate = (i32(root + o), i32(root + o + 4))
    tensors = []
    o = field(root, 2)
    if o:
        base, n = vector(root, o)
        for j in range(n):
            t = base + 4 * j
            t += u32(t)
            to = field(t, 1)
            dtype = FB_TO_DTYPE.get(i32(t + to) if to else FB_TYPE_END, DType.UINT8)
            dims: Tuple[int, ...] = ()
            do = field(t, 2)
            if do:
                start, k = vector(t, do)
                dims = struct.unpack_from(f"<{k}I", buf, start)
            start, size = (0, 0)
            vo = field(t, 3)
            if vo:
                start, size = vector(t, vo)
            tensors.append(tensor_from_bytes(buf, start, size, dtype, tuple(reversed(dims))))
    return tuple(tensors), rate


@registry.converter_plugin("flatbuf")
class FlatbufConverter:
    def negotiate(self, in_spec, props: dict) -> TensorsSpec:
        return TensorsSpec(format=TensorFormat.FLEXIBLE)

    def convert(self, frame: Frame, props: dict) -> Frame:
        tensors, (rn, rd) = decode_flatbuf(host_bytes(frame.tensors[0]))
        if not tensors:
            raise ValueError("flatbuf: empty Tensors frame")
        out = frame.with_tensors(tensors)
        if rn and rd:  # the stream's cadence survives the hop
            out = out.with_meta(rate=Fraction(rn, rd))
        return out
