"""Tensor specs: the typed contract that flows through a pipeline.

A copy of ``nnstreamer_tpu/tensors/spec.py`` (the port imports nothing of
the JAX package), with :attr:`DType.torch_dtype` added. It is the
redesign of the reference's tensor type system
(gst/nnstreamer/include/tensor_typedef.h:131-296 — GstTensorInfo,
GstTensorsInfo, GstTensorsConfig — and the caps/dim-string utilities in
gst/nnstreamer/nnstreamer_plugin_api_util_impl.c).

Differences from the reference, by design:

- Shapes are canonical row-major tuples (outermost first), matching
  torch/numpy. The reference stores dims innermost-first in ``uint32[4]``
  (tensor_typedef.h:34, Documentation/data-type-and-flow-control.md); we keep
  that colon-string syntax (``d1:d2:d3:d4``, innermost first) at the string
  boundary for user parity and reverse it on parse.
- ``bfloat16`` is a first-class dtype; the reference stops at float16
  (tensor_typedef.h:131-146).
- A dim of ``None`` is a negotiation wildcard (the reference's 0 /
  unspecified dim); specs are fully static after pipeline negotiation.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field, replace
from fractions import Fraction
from typing import Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# Reference limits: NNS_TENSOR_RANK_LIMIT=4 / 16 (flexible),
# NNS_TENSOR_SIZE_LIMIT=16 (tensor_typedef.h:34-44). We allow rank 8
# everywhere (superset) and keep the 16-tensors-per-frame limit.
NNS_TENSOR_RANK_LIMIT = 8
NNS_TENSOR_SIZE_LIMIT = 16


class DType(enum.Enum):
    """Tensor element types (reference: tensor_type, tensor_typedef.h:131-146)."""

    INT8 = "int8"
    UINT8 = "uint8"
    INT16 = "int16"
    UINT16 = "uint16"
    INT32 = "int32"
    UINT32 = "uint32"
    INT64 = "int64"
    UINT64 = "uint64"
    FLOAT16 = "float16"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    BFLOAT16 = "bfloat16"  # TPU-native extension
    BOOL = "bool"  # convenience for predicate streams (tensor_if)

    @property
    def np_dtype(self) -> np.dtype:
        if self is DType.BFLOAT16:
            # numpy has no bfloat16; ml_dtypes supplies one where installed
            import ml_dtypes

            return np.dtype(ml_dtypes.bfloat16)
        return np.dtype(self.value)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.value)

    @property
    def itemsize(self) -> int:
        return self.torch_dtype.itemsize

    @property
    def is_float(self) -> bool:
        return self in (DType.FLOAT16, DType.FLOAT32, DType.FLOAT64, DType.BFLOAT16)

    @property
    def is_integer(self) -> bool:
        return not self.is_float and self is not DType.BOOL

    @classmethod
    def from_any(
        cls, value: Union["DType", str, np.dtype, torch.dtype, type]
    ) -> "DType":
        if isinstance(value, DType):
            return value
        if isinstance(value, torch.dtype):
            return cls(str(value).removeprefix("torch."))
        if isinstance(value, str):
            try:
                return cls(value.strip().lower())
            except ValueError:
                pass
        name = np.dtype(value).name if not isinstance(value, str) else value
        try:
            return cls(name)
        except ValueError as exc:
            raise ValueError(f"unknown tensor dtype: {value!r}") from exc


class TensorFormat(enum.Enum):
    """Stream data format (reference: tensor_format, tensor_typedef.h:67,91-126).

    - STATIC: shapes/dtypes fixed by the negotiated spec; frames carry raw
      tensors only.
    - FLEXIBLE: each frame is self-describing via a per-tensor binary header
      (see tensors/meta.py, reference GstTensorMetaInfo).
    - SPARSE: COO encoding (header + values + flat uint32 indices; reference
      gst/nnstreamer/elements/gsttensor_sparseutil.c).
    """

    STATIC = "static"
    FLEXIBLE = "flexible"
    SPARSE = "sparse"

    @classmethod
    def from_any(cls, value: Union["TensorFormat", str]) -> "TensorFormat":
        if isinstance(value, TensorFormat):
            return value
        return cls(value.strip().lower())


DimValue = Optional[int]  # None = wildcard (reference: dim 0 / unspecified)
Shape = Tuple[DimValue, ...]


def parse_dimension(dim_str: str) -> Shape:
    """Parse a reference-style dim string into a canonical row-major shape.

    The reference's colon syntax is innermost-first: ``3:224:224:1`` is a
    batch-1 NHWC image with 3 channels (gst_tensor_parse_dimension,
    nnstreamer_plugin_api_util_impl.c; Documentation/
    data-type-and-flow-control.md). We reverse on parse so the canonical
    shape is ``(1, 224, 224, 3)``. ``0`` or ``?`` means wildcard.
    """
    parts = [p.strip() for p in dim_str.strip().split(":") if p.strip() != ""]
    if not parts:
        raise ValueError(f"empty dimension string: {dim_str!r}")
    if len(parts) > NNS_TENSOR_RANK_LIMIT:
        raise ValueError(
            f"rank {len(parts)} exceeds limit {NNS_TENSOR_RANK_LIMIT}: {dim_str!r}"
        )
    dims: list = []
    for p in parts:
        if p in ("?", "0"):
            dims.append(None)
        else:
            v = int(p)
            if v < 0:
                raise ValueError(f"negative dim in {dim_str!r}")
            dims.append(v)
    return tuple(reversed(dims))


def format_dimension(shape: Sequence[DimValue]) -> str:
    """Canonical shape → reference-style innermost-first colon string."""
    return ":".join("0" if d is None else str(d) for d in reversed(tuple(shape)))


@dataclass(frozen=True)
class TensorSpec:
    """Shape/dtype/name of one tensor in a frame (reference: GstTensorInfo,
    tensor_typedef.h:238-247)."""

    shape: Shape
    dtype: DType = DType.FLOAT32
    name: Optional[str] = None

    def __post_init__(self):
        shape = tuple(self.shape)
        if len(shape) > NNS_TENSOR_RANK_LIMIT:
            raise ValueError(f"rank {len(shape)} exceeds {NNS_TENSOR_RANK_LIMIT}")
        for d in shape:
            if d is not None and (not isinstance(d, int) or d < 0):
                raise ValueError(f"bad dim {d!r} in shape {shape}")
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "dtype", DType.from_any(self.dtype))

    # -- queries ----------------------------------------------------------
    @property
    def rank(self) -> int:
        return len(self.shape)

    @property
    def is_static(self) -> bool:
        """Fully specified (no wildcard dims) — required post-negotiation."""
        return all(d is not None for d in self.shape)

    @property
    def element_count(self) -> int:
        if not self.is_static:
            raise ValueError(f"spec not static: {self}")
        return math.prod(self.shape) if self.shape else 1

    @property
    def byte_size(self) -> int:
        """Reference: gst_tensor_info_get_size."""
        return self.element_count * self.dtype.itemsize

    def is_compatible(self, other: "TensorSpec") -> bool:
        """Structural compatibility with wildcard dims (either side).

        Mirrors gst_tensor_info_is_equal plus caps-intersection semantics:
        wildcards unify with anything.
        """
        if self.dtype != other.dtype:
            return False
        a, b = self.shape, other.shape
        if len(a) != len(b):
            # Ranks differ: allow trailing-1 padding like the reference's
            # fixed uint32[4] dims padded with 1s.
            la, lb = list(a), list(b)
            while len(la) < len(lb):
                la.insert(0, 1)
            while len(lb) < len(la):
                lb.insert(0, 1)
            a, b = tuple(la), tuple(lb)
        return all(x is None or y is None or x == y for x, y in zip(a, b))

    def merge(self, other: "TensorSpec") -> "TensorSpec":
        """Intersection of two compatible specs (resolve wildcards)."""
        if not self.is_compatible(other):
            raise ValueError(f"incompatible specs: {self} vs {other}")
        a, b = list(self.shape), list(other.shape)
        while len(a) < len(b):
            a.insert(0, 1)
        while len(b) < len(a):
            b.insert(0, 1)
        merged = tuple(x if x is not None else y for x, y in zip(a, b))
        return TensorSpec(merged, self.dtype, self.name or other.name)

    # -- string / construction -------------------------------------------
    @classmethod
    def from_dim_string(
        cls, dim_str: str, dtype: Union[DType, str] = DType.FLOAT32, name: str = None
    ) -> "TensorSpec":
        return cls(parse_dimension(dim_str), DType.from_any(dtype), name)

    @property
    def dim_string(self) -> str:
        return format_dimension(self.shape)

    def with_shape(self, shape: Sequence[DimValue]) -> "TensorSpec":
        return replace(self, shape=tuple(shape))

    def with_dtype(self, dtype) -> "TensorSpec":
        return replace(self, dtype=DType.from_any(dtype))

    def __str__(self) -> str:
        n = f" name={self.name}" if self.name else ""
        return f"Tensor[{self.dim_string}:{self.dtype.value}{n}]"


@dataclass(frozen=True)
class TensorsSpec:
    """Spec of a whole frame: ordered tensors + format + frame rate.

    Reference: GstTensorsConfig = GstTensorsInfo + format + rate_n/rate_d
    (tensor_typedef.h:259-274). The rate is stream metadata used by
    rate-conversion and sync policies, not a tensor property.
    """

    tensors: Tuple[TensorSpec, ...] = ()
    format: TensorFormat = TensorFormat.STATIC
    rate: Optional[Fraction] = None  # frames per second; None = unknown

    def __post_init__(self):
        tensors = tuple(self.tensors)
        if len(tensors) > NNS_TENSOR_SIZE_LIMIT:
            raise ValueError(
                f"{len(tensors)} tensors exceeds limit {NNS_TENSOR_SIZE_LIMIT}"
            )
        object.__setattr__(self, "tensors", tensors)
        object.__setattr__(self, "format", TensorFormat.from_any(self.format))
        if self.rate is not None:
            object.__setattr__(self, "rate", Fraction(self.rate))

    # -- queries ----------------------------------------------------------
    @property
    def num_tensors(self) -> int:
        return len(self.tensors)

    @property
    def is_static(self) -> bool:
        return self.format is TensorFormat.STATIC and all(
            t.is_static for t in self.tensors
        )

    def is_compatible(self, other: "TensorsSpec") -> bool:
        if self.format != other.format:
            return False
        if self.format is not TensorFormat.STATIC:
            return True  # flexible/sparse negotiate per-frame
        if self.num_tensors != other.num_tensors:
            return False
        return all(a.is_compatible(b) for a, b in zip(self.tensors, other.tensors))

    def merge(self, other: "TensorsSpec") -> "TensorsSpec":
        if not self.is_compatible(other):
            raise ValueError(f"incompatible: {self} vs {other}")
        if self.format is not TensorFormat.STATIC:
            return self
        merged = tuple(a.merge(b) for a, b in zip(self.tensors, other.tensors))
        return TensorsSpec(merged, self.format, self.rate or other.rate)

    @property
    def byte_size(self) -> int:
        return sum(t.byte_size for t in self.tensors)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_strings(
        cls,
        dimensions: str,
        types: str = "",
        names: str = "",
        format: Union[TensorFormat, str] = TensorFormat.STATIC,
        rate: Optional[Union[str, Fraction, float, int]] = None,
    ) -> "TensorsSpec":
        """Build from reference-style property strings.

        ``dimensions="3:224:224:1,1001:1"``, ``types="uint8,float32"``,
        ``names="image,logits"`` — the syntax of the reference's
        input/output element properties (tensor_filter_common.c:103-128).
        """
        dim_parts = [d for d in dimensions.split(",") if d.strip()]
        type_parts = [t.strip() for t in types.split(",") if t.strip()]
        name_parts = [n.strip() for n in names.split(",")] if names else []
        specs = []
        for i, d in enumerate(dim_parts):
            dt = type_parts[i] if i < len(type_parts) else (
                type_parts[-1] if type_parts else DType.FLOAT32
            )
            nm = name_parts[i] if i < len(name_parts) and name_parts[i] else None
            specs.append(TensorSpec.from_dim_string(d, dt, nm))
        r = None if rate is None else Fraction(rate)
        return cls(tuple(specs), TensorFormat.from_any(format), r)

    @classmethod
    def of(cls, *specs: TensorSpec, **kw) -> "TensorsSpec":
        return cls(tuple(specs), **kw)

    @classmethod
    def from_arrays(cls, arrays: Iterable, **kw) -> "TensorsSpec":
        specs = tuple(
            TensorSpec(tuple(int(d) for d in a.shape), DType.from_any(a.dtype))
            for a in arrays
        )
        return cls(specs, **kw)

    # -- string ------------------------------------------------------------
    @property
    def dimensions_string(self) -> str:
        return ",".join(t.dim_string for t in self.tensors)

    @property
    def types_string(self) -> str:
        return ",".join(t.dtype.value for t in self.tensors)

    def to_caps_string(self) -> str:
        """Reference-style caps string (other/tensors,...) for logging/wire."""
        s = f"other/tensors,format={self.format.value}"
        if self.format is TensorFormat.STATIC:
            s += (
                f",num_tensors={self.num_tensors}"
                f",dimensions=(string){self.dimensions_string}"
                f",types=(string){self.types_string}"
            )
        if self.rate is not None:
            s += f",framerate={self.rate.numerator}/{self.rate.denominator}"
        return s

    def with_rate(self, rate) -> "TensorsSpec":
        return replace(self, rate=None if rate is None else Fraction(rate))

    def __str__(self) -> str:
        inner = ", ".join(str(t) for t in self.tensors)
        r = f" @{self.rate}fps" if self.rate is not None else ""
        return f"Tensors[{self.format.value}: {inner}{r}]"

    def __iter__(self):
        return iter(self.tensors)

    def __len__(self):
        return len(self.tensors)

    def __getitem__(self, i) -> TensorSpec:
        return self.tensors[i]


# Media ingress specs (what tensor_converter negotiates from;
# reference gsttensor_converter.c:1046-1270 media-type dispatch) are defined
# in elements/converter.py in terms of TensorsSpec.
