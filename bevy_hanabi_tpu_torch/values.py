"""Typed value system for effect authoring.

TPU-native re-design of the reference value/type system
(``bevy_hanabi/src/graph/mod.rs:92-1560``). The reference defines
``ScalarType``/``VectorType``/``MatrixType``/``ValueType`` plus CPU-side value
wrappers whose ``as_bytes`` feeds GPU uniform/storage uploads byte-exactly.

Here the same type lattice exists, but the "device representation" of a value
is a JAX array (``to_jax``) instead of a packed byte blob. Byte-exact packing
(``as_bytes``) is still provided because:

* effect assets serialize round-trip (reference: asset.rs:674-1000),
* the native (C++) runtime bridge exchanges property blocks as C structs,
* layout-packing parity tests (reference: attributes.rs tests) need sizes
  and alignments identical to the reference's std430-ish rules.
"""

from __future__ import annotations

import enum
import math
import struct
from dataclasses import dataclass
from typing import Sequence, Tuple, Union

import numpy as np

__all__ = [
    "ScalarType",
    "VectorType",
    "MatrixType",
    "ValueType",
    "ScalarValue",
    "VectorValue",
    "MatrixValue",
    "Value",
    "value_type_of",
    "as_value",
    "VEC2F",
    "VEC3F",
    "VEC4F",
    "FLOAT",
    "INT",
    "UINT",
    "BOOL",
]


class ScalarType(enum.Enum):
    """Scalar element type (reference: graph/mod.rs ``ScalarType``)."""

    BOOL = "bool"
    FLOAT = "f32"
    INT = "i32"
    UINT = "u32"

    @property
    def size(self) -> int:
        """Size in bytes on device (all 4, like WGSL host-shareable types)."""
        return 4

    @property
    def align(self) -> int:
        return 4

    @property
    def np_dtype(self) -> np.dtype:
        return {
            ScalarType.BOOL: np.dtype(np.bool_),
            ScalarType.FLOAT: np.dtype(np.float32),
            ScalarType.INT: np.dtype(np.int32),
            ScalarType.UINT: np.dtype(np.uint32),
        }[self]

    @property
    def packed_np_dtype(self) -> np.dtype:
        """Dtype used when packing to bytes (bool packs as u32, WGSL-style)."""
        if self is ScalarType.BOOL:
            return np.dtype(np.uint32)
        return self.np_dtype

    def is_numeric(self) -> bool:
        return self is not ScalarType.BOOL

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"ScalarType.{self.name}"


@dataclass(frozen=True)
class VectorType:
    """Vector of 2-4 scalars (reference: graph/mod.rs ``VectorType``)."""

    elem_type: ScalarType
    count: int

    def __post_init__(self) -> None:
        if self.count not in (2, 3, 4):
            raise ValueError(f"vector count must be 2..4, got {self.count}")

    @property
    def size(self) -> int:
        return self.elem_type.size * self.count

    @property
    def align(self) -> int:
        # WGSL alignment rules: vec2 -> 8, vec3/vec4 -> 16.
        return {2: 8, 3: 16, 4: 16}[self.count]

    @property
    def np_dtype(self) -> np.dtype:
        return self.elem_type.np_dtype

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"VectorType({self.elem_type.name}, {self.count})"


@dataclass(frozen=True)
class MatrixType:
    """Column-major float matrix (reference: graph/mod.rs ``MatrixType``)."""

    rows: int
    cols: int

    def __post_init__(self) -> None:
        if not (2 <= self.rows <= 4 and 2 <= self.cols <= 4):
            raise ValueError("matrix dims must be 2..4")

    @property
    def elem_type(self) -> ScalarType:
        return ScalarType.FLOAT

    @property
    def align(self) -> int:
        # Matrix aligns like its column vector type.
        return VectorType(ScalarType.FLOAT, self.rows).align

    @property
    def size(self) -> int:
        # Each column padded to column alignment (WGSL array-of-columns rule).
        col_stride = _round_up(
            VectorType(ScalarType.FLOAT, self.rows).size, self.align
        )
        return col_stride * self.cols


ValueType = Union[ScalarType, VectorType, MatrixType]

# Convenience constants mirroring the reference's shorthand.
BOOL = ScalarType.BOOL
FLOAT = ScalarType.FLOAT
INT = ScalarType.INT
UINT = ScalarType.UINT
VEC2F = VectorType(ScalarType.FLOAT, 2)
VEC3F = VectorType(ScalarType.FLOAT, 3)
VEC4F = VectorType(ScalarType.FLOAT, 4)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def value_type_size(vt: ValueType) -> int:
    return vt.size


def value_type_align(vt: ValueType) -> int:
    return vt.align


def value_type_to_str(vt: ValueType) -> str:
    """Stable string form for serialization (e.g. ``vec3<f32>``)."""
    if isinstance(vt, ScalarType):
        return vt.value
    if isinstance(vt, VectorType):
        return f"vec{vt.count}<{vt.elem_type.value}>"
    if isinstance(vt, MatrixType):
        return f"mat{vt.cols}x{vt.rows}<f32>"
    raise TypeError(f"not a ValueType: {vt!r}")


def value_type_from_str(s: str) -> ValueType:
    for st in ScalarType:
        if s == st.value:
            return st
    if s.startswith("vec"):
        count = int(s[3])
        inner = s[5:-1]
        return VectorType(value_type_from_str(inner), count)  # type: ignore[arg-type]
    if s.startswith("mat"):
        cols, rows = int(s[3]), int(s[5])
        return MatrixType(rows=rows, cols=cols)
    raise ValueError(f"unknown value type string: {s!r}")


@dataclass(frozen=True)
class ScalarValue:
    """A typed scalar constant."""

    value_type: ScalarType
    value: Union[bool, int, float]

    def as_bytes(self) -> bytes:
        if self.value_type is ScalarType.BOOL:
            return struct.pack("<I", 1 if self.value else 0)
        if self.value_type is ScalarType.FLOAT:
            return struct.pack("<f", float(self.value))
        if self.value_type is ScalarType.INT:
            return struct.pack("<i", int(self.value))
        return struct.pack("<I", int(self.value) & 0xFFFFFFFF)

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.value, dtype=self.value_type.np_dtype)

    def cast(self, to: ScalarType) -> "ScalarValue":
        if to is ScalarType.BOOL:
            return ScalarValue(to, bool(self.value))
        if to is ScalarType.FLOAT:
            return ScalarValue(to, float(self.value))
        return ScalarValue(to, int(self.value))


@dataclass(frozen=True)
class VectorValue:
    """A typed vector constant."""

    value_type: VectorType
    values: Tuple[Union[bool, int, float], ...]

    def __post_init__(self) -> None:
        if len(self.values) != self.value_type.count:
            raise ValueError(
                f"expected {self.value_type.count} elements, got {len(self.values)}"
            )

    def as_bytes(self) -> bytes:
        return b"".join(
            ScalarValue(self.value_type.elem_type, v).as_bytes() for v in self.values
        )

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.values, dtype=self.value_type.np_dtype)


@dataclass(frozen=True)
class MatrixValue:
    """A typed matrix constant, stored column-major like the reference."""

    value_type: MatrixType
    # columns[i] is column i, length == rows
    columns: Tuple[Tuple[float, ...], ...]

    def __post_init__(self) -> None:
        if len(self.columns) != self.value_type.cols or any(
            len(c) != self.value_type.rows for c in self.columns
        ):
            raise ValueError("matrix value shape mismatch")

    def as_bytes(self) -> bytes:
        col_type = VectorType(ScalarType.FLOAT, self.value_type.rows)
        stride = _round_up(col_type.size, col_type.align)
        out = bytearray()
        for col in self.columns:
            raw = struct.pack(f"<{len(col)}f", *[float(v) for v in col])
            out += raw + b"\x00" * (stride - len(raw))
        return bytes(out)

    def to_numpy(self) -> np.ndarray:
        # [rows, cols] layout: column i is to_numpy()[:, i].
        return np.stack(
            [np.asarray(c, dtype=np.float32) for c in self.columns], axis=1
        )


Value = Union[ScalarValue, VectorValue, MatrixValue]


def value_type_of(value: Value) -> ValueType:
    return value.value_type


def as_value(v, vt: ValueType = None) -> Value:
    """Coerce a python/numpy value into a typed :class:`Value`.

    Mirrors the reference's ``impl From<...> for Value`` conversions
    (graph/mod.rs), extended to accept numpy arrays and sequences.
    """
    if isinstance(v, (ScalarValue, VectorValue, MatrixValue)):
        return v
    if isinstance(v, bool) or (isinstance(v, np.bool_)):
        return ScalarValue(vt if isinstance(vt, ScalarType) else ScalarType.BOOL, bool(v))
    if isinstance(v, (int, np.integer)):
        if isinstance(vt, ScalarType):
            return ScalarValue(vt, v).cast(vt)
        # an explicit numpy unsigned scalar keeps its unsignedness
        if isinstance(v, np.unsignedinteger) or (
            int(v) > 0x7FFFFFFF and int(v) <= 0xFFFFFFFF
        ):
            return ScalarValue(ScalarType.UINT, int(v))
        return ScalarValue(ScalarType.INT, int(v))
    if isinstance(v, (float, np.floating)):
        return ScalarValue(ScalarType.FLOAT, float(v))
    if isinstance(v, np.ndarray):
        if v.ndim == 0:
            return as_value(v.item(), vt)
        if v.ndim == 1:
            return as_value(tuple(v.tolist()), vt)
        if v.ndim == 2:
            mt = MatrixType(rows=v.shape[0], cols=v.shape[1])
            cols = tuple(tuple(float(x) for x in v[:, i]) for i in range(v.shape[1]))
            return MatrixValue(mt, cols)
        raise ValueError(f"cannot convert array of ndim {v.ndim}")
    if isinstance(v, (tuple, list)):
        seq: Sequence = v
        if len(seq) not in (2, 3, 4):
            raise ValueError(f"vector literals must have 2..4 elements, got {len(seq)}")
        if isinstance(vt, VectorType):
            et = vt.elem_type
        elif all(isinstance(x, bool) for x in seq):
            et = ScalarType.BOOL
        elif all(isinstance(x, (int, np.integer)) and not isinstance(x, bool) for x in seq):
            et = ScalarType.INT
        else:
            et = ScalarType.FLOAT
        conv = {
            ScalarType.BOOL: bool,
            ScalarType.FLOAT: float,
            ScalarType.INT: int,
            ScalarType.UINT: int,
        }[et]
        return VectorValue(VectorType(et, len(seq)), tuple(conv(x) for x in seq))
    raise TypeError(f"cannot convert {type(v).__name__} to Value")


def splat(vt: ValueType, scalar: float) -> Value:
    """Build a value of type ``vt`` with every element equal to ``scalar``."""
    if isinstance(vt, ScalarType):
        return as_value(scalar, vt) if vt is not ScalarType.FLOAT else ScalarValue(vt, float(scalar))
    if isinstance(vt, VectorType):
        conv = float if vt.elem_type is ScalarType.FLOAT else (bool if vt.elem_type is ScalarType.BOOL else int)
        return VectorValue(vt, tuple(conv(scalar) for _ in range(vt.count)))
    if isinstance(vt, MatrixType):
        cols = tuple(tuple(float(scalar) for _ in range(vt.rows)) for _ in range(vt.cols))
        return MatrixValue(vt, cols)
    raise TypeError(f"not a ValueType: {vt!r}")


def num_lanes(vt: ValueType) -> int:
    """Number of scalar lanes (1 for scalar, N for vecN, rows*cols for mat)."""
    if isinstance(vt, ScalarType):
        return 1
    if isinstance(vt, VectorType):
        return vt.count
    return vt.rows * vt.cols


def is_finite_value(v: Value) -> bool:
    if isinstance(v, ScalarValue):
        return not isinstance(v.value, float) or math.isfinite(v.value)
    if isinstance(v, VectorValue):
        return all(not isinstance(x, float) or math.isfinite(x) for x in v.values)
    return all(math.isfinite(x) for col in v.columns for x in col)
