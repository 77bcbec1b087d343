"""Minimal TFLite flatbuffer reader — no flatbuffers or tensorflow import.

The port's own copy of ``nnstreamer_tpu/tools/tflite_parse.py``, with the
same names and fields: pure ``struct`` and numpy. It parses the subset of
the public TFLite schema (schema.fbs) needed to run a ``.tflite`` graph as
one torch program (tools/tflite_exec.py) and to import its weights into
the zoo's modules (models/mobilenet_v2.py ``load_tflite_params``):
Model / SubGraph / Tensor / Operator / Buffer / QuantizationParameters
plus the builtin option tables of the ops the program runs.

Flatbuffer wire format (little-endian):
- file starts with an int32 offset to the root table (then optional
  file identifier "TFL3")
- table: int32 soffset at the table position points BACK to its vtable;
  vtable = [u16 vtable_bytes, u16 table_bytes, u16 field_off...] where
  field_off is relative to the table position (0 = field absent)
- string/vector/table fields hold a u32 forward offset to their data;
  vectors and strings are length-prefixed (u32 count)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# -- TensorType enum (schema.fbs) --
TENSOR_DTYPES = {
    0: np.float32, 1: np.float16, 2: np.int32, 3: np.uint8,
    4: np.int64, 6: np.bool_, 7: np.int16, 9: np.int8, 10: np.float64,
}

# BuiltinOperator codes (schema.fbs enum) of the ops the readers name
OP_NAMES = {
    0: "ADD", 1: "AVERAGE_POOL_2D", 2: "CONCATENATION", 3: "CONV_2D",
    4: "DEPTHWISE_CONV_2D", 9: "FULLY_CONNECTED", 14: "LOGISTIC",
    17: "MAX_POOL_2D", 18: "MUL", 22: "RESHAPE", 23: "RESIZE_BILINEAR",
    25: "SOFTMAX", 28: "TANH", 34: "PAD", 40: "MEAN", 42: "SQUEEZE",
    49: "RELU", 21: "RELU6", 83: "PACK", 97: "RESIZE_NEAREST_NEIGHBOR",
    114: "QUANTIZE", 6: "DEQUANTIZE", 27: "SPACE_TO_DEPTH",
    26: "SPLIT", 47: "SUB", 39: "TRANSPOSE", 67: "TRANSPOSE_CONV",
    53: "STRIDED_SLICE", 77: "SHAPE", 88: "EXPAND_DIMS", 99: "LEAKY_RELU",
}

PADDING = {0: "SAME", 1: "VALID"}
ACTIVATION = {0: None, 1: "RELU", 2: "RELU_N1_TO_1", 3: "RELU6",
              4: "TANH", 5: "SIGN_BIT"}


class _Reader:
    """Positioned primitive reads over the flatbuffer bytes."""

    def __init__(self, buf: bytes):
        self.buf = buf

    def u8(self, pos): return self.buf[pos]
    def u16(self, pos): return struct.unpack_from("<H", self.buf, pos)[0]
    def i32(self, pos): return struct.unpack_from("<i", self.buf, pos)[0]
    def u32(self, pos): return struct.unpack_from("<I", self.buf, pos)[0]
    def i64(self, pos): return struct.unpack_from("<q", self.buf, pos)[0]
    def f32(self, pos): return struct.unpack_from("<f", self.buf, pos)[0]


class _Table:
    """One flatbuffer table: field access by schema id."""

    def __init__(self, r: _Reader, pos: int):
        self.r = r
        self.pos = pos
        vt = pos - r.i32(pos)  # soffset points back to the vtable
        self._vt = vt
        self._vt_len = r.u16(vt)

    def _off(self, fid: int) -> int:
        """Byte offset of field `fid` within the table, 0 if absent."""
        slot = 4 + 2 * fid
        if slot + 2 > self._vt_len:
            return 0
        return self.r.u16(self._vt + slot)

    def scalar(self, fid: int, kind: str, default=0):
        o = self._off(fid)
        if not o:
            return default
        return getattr(self.r, kind)(self.pos + o)

    def _indirect(self, fid: int) -> Optional[int]:
        o = self._off(fid)
        if not o:
            return None
        p = self.pos + o
        return p + self.r.u32(p)

    def table(self, fid: int) -> Optional["_Table"]:
        p = self._indirect(fid)
        return _Table(self.r, p) if p is not None else None

    def string(self, fid: int) -> Optional[str]:
        p = self._indirect(fid)
        if p is None:
            return None
        n = self.r.u32(p)
        return self.r.buf[p + 4 : p + 4 + n].decode("utf-8", "replace")

    def vector_len(self, fid: int) -> int:
        p = self._indirect(fid)
        return self.r.u32(p) if p is not None else 0

    def vector_scalars(self, fid: int, fmt: str) -> np.ndarray:
        """Numeric vector as a numpy array (fmt: numpy dtype str)."""
        p = self._indirect(fid)
        if p is None:
            return np.zeros((0,), fmt)
        n = self.r.u32(p)
        return np.frombuffer(self.r.buf, dtype=fmt, count=n, offset=p + 4)

    def vector_tables(self, fid: int) -> List["_Table"]:
        p = self._indirect(fid)
        if p is None:
            return []
        n = self.r.u32(p)
        out = []
        for i in range(n):
            ep = p + 4 + 4 * i
            out.append(_Table(self.r, ep + self.r.u32(ep)))
        return out


@dataclass
class QuantParams:
    scale: np.ndarray          # per-tensor (len 1) or per-channel
    zero_point: np.ndarray
    quantized_dimension: int = 0

    @property
    def quantized(self) -> bool:
        return self.scale.size > 0


@dataclass
class Tensor:
    index: int
    name: str
    shape: Tuple[int, ...]
    dtype: Any
    buffer: int
    quant: Optional[QuantParams]
    data: Optional[np.ndarray] = None  # constant data, raw (quantized) dtype

    def dequantized(self) -> Optional[np.ndarray]:
        """Constant data as float32, dequantizing if quant params exist
        ((q - zero_point) * scale, per-channel aware)."""
        if self.data is None:
            return None
        x = self.data
        if self.quant is None or not self.quant.quantized or \
                not np.issubdtype(x.dtype, np.integer):
            return x.astype(np.float32) if x.dtype != np.float32 else x
        s, z, d = (self.quant.scale, self.quant.zero_point,
                   self.quant.quantized_dimension)
        xf = x.astype(np.float32)
        if s.size == 1:
            return (xf - float(z[0] if z.size else 0)) * float(s[0])
        shape = [1] * xf.ndim
        shape[d] = s.size
        zz = z if z.size == s.size else np.zeros_like(s)
        return (xf - zz.reshape(shape)) * s.reshape(shape)


@dataclass
class Operator:
    opcode: int                 # builtin code
    name: str                   # readable builtin name
    inputs: List[int]
    outputs: List[int]
    options: Dict[str, Any] = field(default_factory=dict)
    custom_code: Optional[str] = None


@dataclass
class TFLiteModel:
    tensors: List[Tensor]
    operators: List[Operator]
    inputs: List[int]
    outputs: List[int]
    description: str = ""

    def tensor_by_name(self, name: str) -> Tensor:
        for t in self.tensors:
            if t.name == name:
                return t
        raise KeyError(name)


def _parse_options(op_name: str, t: Optional[_Table]) -> Dict[str, Any]:
    """Decode the builtin-options union table for the op kinds we run."""
    if t is None:
        return {}
    if op_name == "CONV_2D":
        return {
            "padding": PADDING.get(t.scalar(0, "u8"), "SAME"),
            "stride_w": t.scalar(1, "i32", 1),
            "stride_h": t.scalar(2, "i32", 1),
            "activation": ACTIVATION.get(t.scalar(3, "u8")),
            "dilation_w": t.scalar(4, "i32", 1),
            "dilation_h": t.scalar(5, "i32", 1),
        }
    if op_name == "DEPTHWISE_CONV_2D":
        return {
            "padding": PADDING.get(t.scalar(0, "u8"), "SAME"),
            "stride_w": t.scalar(1, "i32", 1),
            "stride_h": t.scalar(2, "i32", 1),
            "depth_multiplier": t.scalar(3, "i32", 1),
            "activation": ACTIVATION.get(t.scalar(4, "u8")),
            "dilation_w": t.scalar(5, "i32", 1),
            "dilation_h": t.scalar(6, "i32", 1),
        }
    if op_name in ("AVERAGE_POOL_2D", "MAX_POOL_2D"):
        return {
            "padding": PADDING.get(t.scalar(0, "u8"), "SAME"),
            "stride_w": t.scalar(1, "i32", 1),
            "stride_h": t.scalar(2, "i32", 1),
            "filter_w": t.scalar(3, "i32", 1),
            "filter_h": t.scalar(4, "i32", 1),
            "activation": ACTIVATION.get(t.scalar(5, "u8")),
        }
    if op_name in ("ADD", "MUL", "SUB"):
        return {"activation": ACTIVATION.get(t.scalar(0, "u8"))}
    if op_name == "SOFTMAX":
        return {"beta": t.scalar(0, "f32", 1.0)}
    if op_name == "RESHAPE":
        return {"new_shape": t.vector_scalars(0, "<i4").tolist()}
    if op_name == "RESIZE_BILINEAR":
        return {
            "align_corners": bool(t.scalar(2, "u8", 0)),
            "half_pixel_centers": bool(t.scalar(3, "u8", 0)),
        }
    if op_name == "CONCATENATION":
        return {"axis": t.scalar(0, "i32", 0),
                "activation": ACTIVATION.get(t.scalar(1, "u8"))}
    if op_name == "MEAN":
        return {"keep_dims": bool(t.scalar(0, "u8", 0))}
    if op_name == "FULLY_CONNECTED":
        return {"activation": ACTIVATION.get(t.scalar(0, "u8"))}
    return {}


def parse(path: str) -> TFLiteModel:
    """Parse a .tflite file into tensors + topologically-ordered ops.

    Only the first subgraph is returned."""
    with open(path, "rb") as f:
        buf = f.read()
    r = _Reader(buf)
    root = _Table(r, r.u32(0))

    # Model: 0 version, 1 operator_codes, 2 subgraphs, 3 description,
    # 4 buffers
    opcodes = []
    for oc in root.vector_tables(1):
        # new-style builtin_code (id 3, int32) supersedes the deprecated
        # int8 field (id 0); files older than the split only carry id 0
        code = oc.scalar(3, "i32", 0) or oc.scalar(0, "u8", 0)
        opcodes.append((code, oc.string(1)))

    buffers: List[Optional[np.ndarray]] = []
    for b in root.vector_tables(4):
        data = b.vector_scalars(0, "<u1")
        buffers.append(data if data.size else None)

    sub = root.vector_tables(2)[0]
    # SubGraph: 0 tensors, 1 inputs, 2 outputs, 3 operators, 4 name
    tensors: List[Tensor] = []
    for i, tt in enumerate(sub.vector_tables(0)):
        shape = tuple(int(v) for v in tt.vector_scalars(0, "<i4"))
        ttype = tt.scalar(1, "u8", 0)
        dtype = TENSOR_DTYPES.get(ttype, np.float32)
        bufidx = tt.scalar(2, "u32", 0)
        quant = None
        qt = tt.table(4)
        if qt is not None:
            quant = QuantParams(
                scale=np.asarray(qt.vector_scalars(2, "<f4"), np.float32),
                zero_point=np.asarray(qt.vector_scalars(3, "<i8")),
                quantized_dimension=qt.scalar(6, "i32", 0),
            )
        data = None
        if 0 < bufidx < len(buffers) and buffers[bufidx] is not None:
            raw = buffers[bufidx]
            data = np.frombuffer(raw.tobytes(), dtype=dtype)
            if shape:
                data = data.reshape(shape)
        tensors.append(Tensor(i, tt.string(3) or f"t{i}", shape, dtype,
                              bufidx, quant, data))

    operators: List[Operator] = []
    for ot in sub.vector_tables(3):
        idx = ot.scalar(0, "u32", 0)
        code, custom = opcodes[idx] if idx < len(opcodes) else (-1, None)
        name = "CUSTOM" if custom else OP_NAMES.get(code, f"OP_{code}")
        operators.append(Operator(
            opcode=code, name=name, custom_code=custom,
            inputs=[int(v) for v in ot.vector_scalars(1, "<i4")],
            outputs=[int(v) for v in ot.vector_scalars(2, "<i4")],
            options=_parse_options(name, ot.table(4)),
        ))

    return TFLiteModel(
        tensors=tensors,
        operators=operators,
        inputs=[int(v) for v in sub.vector_scalars(1, "<i4")],
        outputs=[int(v) for v in sub.vector_scalars(2, "<i4")],
        description=root.string(3) or "",
    )


def summarize(m: TFLiteModel) -> str:
    """Human-readable op-by-op dump (CLI: python -m
    nnstreamer_tpu_torch.tools.tflite_parse <file>)."""
    lines = [f"desc: {m.description}",
             f"inputs: {[m.tensors[i].name for i in m.inputs]}",
             f"outputs: {[m.tensors[i].name for i in m.outputs]}"]
    for k, op in enumerate(m.operators):
        ins = ", ".join(
            f"{m.tensors[i].name}{list(m.tensors[i].shape)}"
            f"{'*' if m.tensors[i].data is not None else ''}"
            for i in op.inputs if i >= 0
        )
        outs = ", ".join(
            f"{m.tensors[i].name}{list(m.tensors[i].shape)}"
            for i in op.outputs
        )
        lines.append(f"[{k:3d}] {op.name} {op.options} ({ins}) -> ({outs})")
    return "\n".join(lines)


if __name__ == "__main__":  # pragma: no cover - debug CLI
    import sys

    print(summarize(parse(sys.argv[1])))
