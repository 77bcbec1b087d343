"""Sparse tensor codec (COO): values + flat uint32 indices.

A copy of ``nnstreamer_tpu/tensors/sparse.py`` (the same bytes).
Reference: gst/nnstreamer/elements/gsttensor_sparseutil.c —
``gst_tensor_sparse_from_dense`` (:116) emits meta header + nnz values + nnz
uint32 flat indices; ``gst_tensor_sparse_to_dense`` (:27) inverts it.

This is a wire/stream compression format: encode/decode run on the host
at stream boundaries (numpy), like the reference. On-device sparsity is a
different concern (the kernels want dense static shapes); sparse frames
are densified before entering a fused compute segment.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from nnstreamer_tpu_torch.tensors.meta import FlexTensorMeta, HEADER_SIZE
from nnstreamer_tpu_torch.tensors.spec import DType, TensorFormat

_NNZ_STRUCT = struct.Struct("<Q")


def sparse_encode(dense: np.ndarray) -> bytes:
    """dense array → flex header (format=sparse) + nnz + values + indices."""
    a = np.ascontiguousarray(np.asarray(dense))
    flat = a.reshape(-1)
    (idx,) = np.nonzero(flat)
    if flat.size > np.iinfo(np.uint32).max:
        raise ValueError("tensor too large for uint32 flat indexing")
    values = flat[idx]
    indices = idx.astype(np.uint32)
    payload = _NNZ_STRUCT.pack(idx.size) + values.tobytes() + indices.tobytes()
    meta = FlexTensorMeta(
        dtype=DType.from_any(a.dtype),
        shape=tuple(int(d) for d in a.shape),
        format=TensorFormat.SPARSE,
        payload_size=len(payload),
    )
    return meta.pack() + payload


def sparse_decode(buf: bytes, offset: int = 0) -> Tuple[np.ndarray, int]:
    """Inverse of sparse_encode → (dense array, bytes consumed)."""
    meta = FlexTensorMeta.unpack(buf, offset)
    if meta.format is not TensorFormat.SPARSE:
        raise ValueError(f"not a sparse chunk: format={meta.format}")
    pos = offset + HEADER_SIZE
    (nnz,) = _NNZ_STRUCT.unpack_from(buf, pos)
    pos += _NNZ_STRUCT.size
    dt = meta.dtype.np_dtype
    values = np.frombuffer(buf[pos : pos + nnz * dt.itemsize], dtype=dt)
    pos += nnz * dt.itemsize
    indices = np.frombuffer(buf[pos : pos + nnz * 4], dtype=np.uint32)
    pos += nnz * 4
    dense = np.zeros(int(np.prod(meta.shape)) if meta.shape else 1, dtype=dt)
    dense[indices] = values
    return dense.reshape(meta.shape), pos - offset


def sparse_density(dense: np.ndarray) -> float:
    """Fraction of nonzero elements (used by tests and the enc element)."""
    a = np.asarray(dense)
    return float(np.count_nonzero(a)) / max(a.size, 1)
