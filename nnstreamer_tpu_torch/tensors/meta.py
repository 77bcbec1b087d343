"""Flexible-tensor binary header: per-frame self-describing tensor metadata.

A copy of ``nnstreamer_tpu/tensors/meta.py`` (byte for byte the same
header) that also takes torch tensors. The equivalent of GstTensorMetaInfo
(tensor_typedef.h:279-294): for ``format=flexible`` streams each tensor is
prefixed with a compact binary header carrying dtype/shape, parsed and
stripped at element boundaries (tensor_filter.c:617-625). The same header is
the wire format of the distributed edge/query layer (SURVEY.md §5.8), so a
tensor serialized on one host is self-describing on another.

Layout (little-endian, 96 bytes fixed):

    uint32 magic      'NNST' (0x5453_4E4E)
    uint32 version    1
    uint32 dtype      DType code (index into _DTYPE_CODES)
    uint32 format     TensorFormat (0 static, 1 flexible, 2 sparse)
    uint32 media_type reserved media-type tag (0 = tensors)
    uint32 rank
    uint32 dims[16]   innermost-first like the reference; unused = 0
    uint64 payload    payload byte size that follows the header
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch.tensors.spec import DType, TensorFormat, TensorSpec

MAGIC = 0x5453_4E4E  # b'NNST' little-endian
VERSION = 1
_MAX_DIMS = 16
_STRUCT = struct.Struct("<6I16IQ")
HEADER_SIZE = _STRUCT.size  # 96

_DTYPE_CODES = [
    DType.INT8,
    DType.UINT8,
    DType.INT16,
    DType.UINT16,
    DType.INT32,
    DType.UINT32,
    DType.INT64,
    DType.UINT64,
    DType.FLOAT16,
    DType.FLOAT32,
    DType.FLOAT64,
    DType.BFLOAT16,
    DType.BOOL,
]
_DTYPE_TO_CODE = {d: i for i, d in enumerate(_DTYPE_CODES)}

_FORMAT_CODES = [TensorFormat.STATIC, TensorFormat.FLEXIBLE, TensorFormat.SPARSE]
_FORMAT_TO_CODE = {f: i for i, f in enumerate(_FORMAT_CODES)}


@dataclass(frozen=True)
class FlexTensorMeta:
    """Parsed flexible-tensor header."""

    dtype: DType
    shape: Tuple[int, ...]  # canonical row-major (outermost first)
    format: TensorFormat = TensorFormat.FLEXIBLE
    media_type: int = 0
    payload_size: int = 0

    @property
    def spec(self) -> TensorSpec:
        return TensorSpec(self.shape, self.dtype)

    def pack(self) -> bytes:
        if len(self.shape) > _MAX_DIMS:
            raise ValueError(f"rank {len(self.shape)} > {_MAX_DIMS}")
        dims = [0] * _MAX_DIMS
        # innermost-first on the wire, like the reference's uint32[16]
        for i, d in enumerate(reversed(self.shape)):
            dims[i] = int(d)
        return _STRUCT.pack(
            MAGIC,
            VERSION,
            _DTYPE_TO_CODE[self.dtype],
            _FORMAT_TO_CODE[self.format],
            self.media_type,
            len(self.shape),
            *dims,
            self.payload_size,
        )

    @classmethod
    def unpack(cls, buf: bytes, offset: int = 0) -> "FlexTensorMeta":
        if len(buf) - offset < HEADER_SIZE:
            raise ValueError(
                f"buffer too small for flex header: {len(buf) - offset} < {HEADER_SIZE}"
            )
        fields = _STRUCT.unpack_from(buf, offset)
        magic, version, dtype_c, fmt_c, media_type, rank = fields[:6]
        dims = fields[6 : 6 + _MAX_DIMS]
        payload = fields[-1]
        if magic != MAGIC:
            raise ValueError(f"bad flex-tensor magic: {magic:#x}")
        if version != VERSION:
            raise ValueError(f"unsupported flex-tensor version: {version}")
        if rank > _MAX_DIMS:
            raise ValueError(f"bad rank {rank}")
        if dtype_c >= len(_DTYPE_CODES):
            raise ValueError(f"bad dtype code {dtype_c}")
        if fmt_c >= len(_FORMAT_CODES):
            raise ValueError(f"bad format code {fmt_c}")
        shape = tuple(reversed(dims[:rank]))
        return cls(
            dtype=_DTYPE_CODES[dtype_c],
            shape=shape,
            format=_FORMAT_CODES[fmt_c],
            media_type=media_type,
            payload_size=payload,
        )

    # -- array <-> bytes helpers (the serialize path of the edge layer) ----
    @classmethod
    def encode_array(cls, array) -> bytes:
        """array (numpy or torch, any device) → header + raw bytes
        (C-contiguous)."""
        dtype, shape, payload = array_bytes(array)
        meta = cls(dtype=dtype, shape=shape, payload_size=len(payload))
        return meta.pack() + payload

    @classmethod
    def decode_array(cls, buf: bytes, offset: int = 0) -> Tuple[np.ndarray, int]:
        """header + raw bytes → (array, bytes consumed)."""
        meta = cls.unpack(buf, offset)
        start = offset + HEADER_SIZE
        end = start + meta.payload_size
        if len(buf) < end:
            raise ValueError(
                f"truncated flex tensor: need {meta.payload_size} payload bytes"
            )
        a = np.frombuffer(buf[start:end], dtype=meta.dtype.np_dtype)
        return a.reshape(meta.shape), end - offset


def array_bytes(array) -> Tuple[DType, Tuple[int, ...], bytes]:
    """(dtype, shape, C-order bytes) of a numpy array or a torch tensor; a
    device tensor is copied to the host (a wire codec runs there). A 0-d
    tensor goes out as shape (1,), as ``np.ascontiguousarray`` makes it in
    the reference's codecs."""
    if isinstance(array, torch.Tensor):
        t = array.detach().cpu().contiguous()
        dtype = DType.from_any(t.dtype)
        # bfloat16 has no numpy type: its bits go out as uint16
        a = t.view(torch.uint16) if t.dtype is torch.bfloat16 else t
        return dtype, tuple(t.shape) or (1,), a.numpy().tobytes()
    a = np.ascontiguousarray(np.asarray(array))
    return DType.from_any(a.dtype), tuple(int(d) for d in a.shape), a.tobytes()


def host_bytes(t) -> memoryview:
    """The bytes of one tensor (a wire frame: uint8) on the host, as a flat
    memoryview: no copy for a host array or CPU tensor, one device-to-host
    copy for a device tensor."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        t = t.view(torch.uint16) if t.dtype is torch.bfloat16 else t
        t = t.numpy()
    return memoryview(np.ascontiguousarray(t)).cast("B")


def tensor_from_bytes(
    buf, offset: int, size: int, dtype: DType, shape: Tuple[int, ...]
) -> torch.Tensor:
    """``size`` payload bytes at ``offset`` of ``buf`` → a CPU tensor of
    ``dtype`` (one copy of the payload, so the tensor owns aligned memory),
    shaped ``shape`` when that shape holds exactly its elements and flat
    otherwise, as the reference's wire decoders leave it. A torch tensor,
    so bfloat16 needs no numpy type."""
    if size % dtype.itemsize:
        raise ValueError(
            f"{size} payload bytes are not a whole number of {dtype.value} elements"
        )
    if size == 0:
        t = torch.empty((0,), dtype=dtype.torch_dtype)
    else:
        raw = np.frombuffer(buf, np.uint8, count=size, offset=offset)
        t = torch.from_numpy(raw.copy()).view(dtype.torch_dtype)
    if shape and math.prod(shape) == t.numel():
        t = t.reshape(shape)
    return t


def encode_frame_tensors(tensors) -> bytes:
    """Serialize a frame's tensors as concatenated flex-header chunks."""
    return b"".join(FlexTensorMeta.encode_array(t) for t in tensors)


def decode_frame_tensors(buf: bytes) -> Tuple[np.ndarray, ...]:
    """Inverse of encode_frame_tensors."""
    out = []
    offset = 0
    while offset < len(buf):
        a, used = FlexTensorMeta.decode_array(buf, offset)
        out.append(a)
        offset += used
    return tuple(out)
