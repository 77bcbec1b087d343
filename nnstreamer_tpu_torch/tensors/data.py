"""Typed scalar operations for control-plane decisions.

A copy of ``nnstreamer_tpu/tensors/data.py``. Reference:
gst/nnstreamer/tensor_data.{c,h} — a tagged-union scalar
(tensor_element, tensor_typedef.h:198-212) with typecast / compare / average
used by tensor_if compared-values, tensor_transform 'stand' mode, and
tensor_rate. Here scalars are 0-d numpy values.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np

from nnstreamer_tpu_torch.tensors.spec import DType

Scalar = Union[int, float, np.number]


def typecast(value: Scalar, dtype: Union[DType, str]) -> np.number:
    """Cast a scalar with C-like saturation-free semantics
    (gst_tensor_data_typecast)."""
    dt = DType.from_any(dtype)
    return np.asarray(value).astype(dt.np_dtype)[()]


def tensor_average(array) -> float:
    """Mean over all elements (gst_tensor_data_raw_average) — used by
    tensor_if TENSOR_AVERAGE_VALUE compared-value mode."""
    return float(np.mean(np.asarray(array, dtype=np.float64)))


def tensor_average_per_channel(array, axis: int = -1) -> np.ndarray:
    """Per-channel mean (gst_tensor_data_raw_average_per_channel) — used by
    tensor_transform stand mode with per-channel option."""
    a = np.asarray(array, dtype=np.float64)
    axes = tuple(i for i in range(a.ndim) if i != (axis % a.ndim))
    return np.mean(a, axis=axes)


def tensor_std(array) -> float:
    """Population standard deviation (gst_tensor_data_raw_std)."""
    return float(np.std(np.asarray(array, dtype=np.float64)))


_COMPARE_OPS = {
    "EQ": np.equal,
    "NE": np.not_equal,
    "GT": np.greater,
    "GE": np.greater_equal,
    "LT": np.less,
    "LE": np.less_equal,
}


def compare(a: Scalar, op: str, b: Scalar) -> bool:
    """Scalar comparison by operator name (tensor_if operators,
    gsttensor_if.h; RANGE ops are composed from these in elements/flow.py)."""
    try:
        fn = _COMPARE_OPS[op.upper()]
    except KeyError as exc:
        raise ValueError(f"unknown compare op {op!r}") from exc
    return bool(fn(a, b))
