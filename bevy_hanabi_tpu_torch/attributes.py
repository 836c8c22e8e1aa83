"""Per-particle attribute registry and particle layouts.

TPU-native re-design of ``bevy_hanabi/src/attributes.rs``.

The reference packs attributes into one aligned AoS GPU struct
(attributes.rs:1485-1671) because wgpu binds a single storage buffer. On TPU
the particle pool is **SoA**: a pytree ``{attr_name: jnp.ndarray[N, lanes]}``,
which is exactly the layout the VPU wants (each attribute is a contiguous
lane-major array; XLA tiles it [8,128] with no gather).

:class:`ParticleLayout` therefore plays two roles here:

* the *semantic* layout — the ordered set of attributes, which determines the
  compiled step function signature and the pool pytree structure (this is
  what the simulation uses);
* the *packed* layout — byte offsets produced by the same packing algorithm
  as the reference (dedupe, sort by size, pair ``{vec3,f32}`` / ``{vec2,vec2}``,
  insert pads, attributes.rs:1516-1663). This is kept for serialization
  parity, the native (C++) bridge, and for layout-contract tests mirroring
  the reference's unit tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .values import (
    FLOAT,
    INT,
    UINT,
    VEC2F,
    VEC3F,
    VEC4F,
    ScalarType,
    ScalarValue,
    Value,
    ValueType,
    VectorType,
    VectorValue,
    num_lanes,
    value_type_to_str,
)

__all__ = ["Attribute", "ParticleLayout", "HIDDEN_ATTRIBUTES"]


@dataclass(frozen=True)
class Attribute:
    """A named, typed per-particle attribute (reference: attributes.rs:967+)."""

    name: str
    value_type: ValueType
    default: Value

    @property
    def size(self) -> int:
        return self.value_type.size

    @property
    def align(self) -> int:
        return self.value_type.align

    @property
    def lanes(self) -> int:
        """Scalar lane count: the SoA array is ``[N]`` or ``[N, lanes]``."""
        return num_lanes(self.value_type)

    @property
    def np_dtype(self) -> np.dtype:
        return self.value_type.np_dtype  # type: ignore[union-attr]

    def default_numpy(self) -> np.ndarray:
        return self.default.to_numpy()

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Attribute({self.name}: {value_type_to_str(self.value_type)})"

    # ---- registry ----------------------------------------------------

    _REGISTRY: ClassVar[Dict[str, "Attribute"]] = {}

    @staticmethod
    def from_name(name: str) -> "Attribute":
        try:
            return Attribute._REGISTRY[name]
        except KeyError:
            raise KeyError(
                f"unknown attribute {name!r}; known: {sorted(Attribute._REGISTRY)}"
            ) from None

    @staticmethod
    def all() -> Tuple["Attribute", ...]:
        """All 39 built-in attributes (reference: attributes.rs:1338-1378)."""
        return tuple(Attribute._REGISTRY.values())


def _fv(x: float) -> ScalarValue:
    return ScalarValue(FLOAT, x)


def _uv(x: int) -> ScalarValue:
    return ScalarValue(UINT, x)


def _iv(x: int) -> ScalarValue:
    return ScalarValue(INT, x)


def _v2(x: float, y: float) -> VectorValue:
    return VectorValue(VEC2F, (x, y))


def _v3(x: float, y: float, z: float) -> VectorValue:
    return VectorValue(VEC3F, (x, y, z))


def _v4(x: float, y: float, z: float, w: float) -> VectorValue:
    return VectorValue(VEC4F, (x, y, z, w))


def _register(name: str, vt: ValueType, default: Value) -> Attribute:
    attr = Attribute(name, vt, default)
    Attribute._REGISTRY[name] = attr
    return attr


# The 39 built-in attributes, with the reference's names, types and defaults
# (attributes.rs:551-676). Module-level constants mirror `Attribute::POSITION`
# style access: `Attribute.POSITION` also works via the class attributes below.
ID = _register("id", UINT, _uv(0))
PARTICLE_COUNTER = _register("particle_counter", UINT, _uv(0))
POSITION = _register("position", VEC3F, _v3(0.0, 0.0, 0.0))
VELOCITY = _register("velocity", VEC3F, _v3(0.0, 0.0, 0.0))
AGE = _register("age", FLOAT, _fv(0.0))
LIFETIME = _register("lifetime", FLOAT, _fv(1.0))
COLOR = _register("color", UINT, _uv(0xFFFFFFFF))  # packed 4x u8 unorm RGBA
HDR_COLOR = _register("hdr_color", VEC4F, _v4(1.0, 1.0, 1.0, 1.0))
ALPHA = _register("alpha", FLOAT, _fv(1.0))
SIZE = _register("size", FLOAT, _fv(1.0))
SIZE2 = _register("size2", VEC2F, _v2(1.0, 1.0))
SIZE3 = _register("size3", VEC3F, _v3(1.0, 1.0, 1.0))
PREV = _register("prev", UINT, _uv(0xFFFFFFFF))
NEXT = _register("next", UINT, _uv(0xFFFFFFFF))
AXIS_X = _register("axis_x", VEC3F, _v3(1.0, 0.0, 0.0))
AXIS_Y = _register("axis_y", VEC3F, _v3(0.0, 1.0, 0.0))
AXIS_Z = _register("axis_z", VEC3F, _v3(0.0, 0.0, 1.0))
SPRITE_INDEX = _register("sprite_index", INT, _iv(0))
F32_0 = _register("f32_0", FLOAT, _fv(0.0))
F32_1 = _register("f32_1", FLOAT, _fv(0.0))
F32_2 = _register("f32_2", FLOAT, _fv(0.0))
F32_3 = _register("f32_3", FLOAT, _fv(0.0))
F32X2_0 = _register("f32x2_0", VEC2F, _v2(0.0, 0.0))
F32X2_1 = _register("f32x2_1", VEC2F, _v2(0.0, 0.0))
F32X2_2 = _register("f32x2_2", VEC2F, _v2(0.0, 0.0))
F32X2_3 = _register("f32x2_3", VEC2F, _v2(0.0, 0.0))
F32X3_0 = _register("f32x3_0", VEC3F, _v3(0.0, 0.0, 0.0))
F32X3_1 = _register("f32x3_1", VEC3F, _v3(0.0, 0.0, 0.0))
F32X3_2 = _register("f32x3_2", VEC3F, _v3(0.0, 0.0, 0.0))
F32X3_3 = _register("f32x3_3", VEC3F, _v3(0.0, 0.0, 0.0))
F32X4_0 = _register("f32x4_0", VEC4F, _v4(0.0, 0.0, 0.0, 0.0))
F32X4_1 = _register("f32x4_1", VEC4F, _v4(0.0, 0.0, 0.0, 0.0))
F32X4_2 = _register("f32x4_2", VEC4F, _v4(0.0, 0.0, 0.0, 0.0))
F32X4_3 = _register("f32x4_3", VEC4F, _v4(0.0, 0.0, 0.0, 0.0))
U32_0 = _register("u32_0", UINT, _uv(0))
U32_1 = _register("u32_1", UINT, _uv(0))
U32_2 = _register("u32_2", UINT, _uv(0))
U32_3 = _register("u32_3", UINT, _uv(0))
RIBBON_ID = _register("ribbon_id", UINT, _uv(0))

# Expose constants on the class for `Attribute.POSITION`-style access.
for _name, _attr in list(Attribute._REGISTRY.items()):
    setattr(Attribute, _name.upper(), _attr)

# Pseudo-attributes that never occupy layout storage. `id` is derived from the
# pool slot index; `particle_counter` is stored (it survives slot reuse).
HIDDEN_ATTRIBUTES = frozenset({"id"})


@dataclass(frozen=True)
class _PackedField:
    attribute: Attribute
    offset: int


class ParticleLayout:
    """An ordered set of attributes defining one particle's state.

    Semantic SoA layout for the TPU pool, plus reference-parity byte packing
    (algorithm mirrored from attributes.rs:1516-1663: dedupe; greedy packing
    of 16-byte rows pairing vec3+f32 and vec2+vec2/2*f32; PAD fill).
    """

    def __init__(self, attributes: Iterable[Attribute] = ()):
        seen: Dict[str, Attribute] = {}
        for a in attributes:
            if isinstance(a, str):
                a = Attribute.from_name(a)
            if a.name not in seen:
                seen[a.name] = a
        self._attributes: Tuple[Attribute, ...] = tuple(seen.values())
        self._fields: Tuple[_PackedField, ...] = tuple(self._pack(self.storage_attributes()))

    # ---- construction -------------------------------------------------

    @staticmethod
    def new() -> "ParticleLayoutBuilder":
        return ParticleLayoutBuilder()

    @staticmethod
    def empty() -> "ParticleLayout":
        return ParticleLayout(())

    @staticmethod
    def default() -> "ParticleLayout":
        """POSITION + VELOCITY + AGE + LIFETIME, like the reference default."""
        return ParticleLayout((POSITION, VELOCITY, AGE, LIFETIME))

    def merged_with(self, *attrs: Attribute) -> "ParticleLayout":
        return ParticleLayout(self._attributes + tuple(attrs))

    # ---- semantic (SoA) interface -------------------------------------

    def attributes(self) -> Tuple[Attribute, ...]:
        return self._attributes

    def storage_attributes(self) -> Tuple[Attribute, ...]:
        """Attributes that occupy pool storage (drops pseudo-attrs)."""
        return tuple(a for a in self._attributes if a.name not in HIDDEN_ATTRIBUTES)

    def contains(self, attr) -> bool:
        name = attr.name if isinstance(attr, Attribute) else attr
        return any(a.name == name for a in self._attributes)

    def __iter__(self):
        return iter(self._attributes)

    def __len__(self) -> int:
        return len(self._attributes)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, ParticleLayout)
            and [a.name for a in self._attributes] == [a.name for a in other._attributes]
        )

    def __hash__(self) -> int:
        return hash(tuple(a.name for a in self._attributes))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        names = ", ".join(a.name for a in self._attributes)
        return f"ParticleLayout([{names}], size={self.min_binding_size()})"

    def signature(self) -> Tuple[str, ...]:
        """Hashable key for compile caching (≈ pipeline specialization key)."""
        return tuple(sorted(a.name for a in self._attributes))

    # ---- packed (byte) interface — reference-parity --------------------

    @staticmethod
    def _pack(attributes: Sequence[Attribute]) -> List[_PackedField]:
        """Pack into 16-byte rows like the reference.

        Mirrors the *behavior* of attributes.rs:1516-1663: group attributes by
        size; emit all 16-byte attrs; pair each 12-byte attr with a 4-byte one
        (or pad); pair 8-byte attrs together or with two 4-byte ones (or pad);
        then lay out remaining 4-byte attrs, padding the struct to 16 bytes.
        """
        by_size: Dict[int, List[Attribute]] = {4: [], 8: [], 12: [], 16: []}
        for a in attributes:
            by_size[a.size].append(a)

        fields: List[_PackedField] = []
        offset = 0

        def emit(a: Attribute) -> None:
            nonlocal offset
            fields.append(_PackedField(a, offset))
            offset += a.size

        def pad(nbytes: int) -> None:
            nonlocal offset
            offset += nbytes

        for a in by_size[16]:
            emit(a)
        for a in by_size[12]:
            emit(a)
            if by_size[4]:
                emit(by_size[4].pop(0))
            else:
                pad(4)
        while by_size[8]:
            emit(by_size[8].pop(0))
            if by_size[8]:
                emit(by_size[8].pop(0))
            elif len(by_size[4]) >= 2:
                emit(by_size[4].pop(0))
                emit(by_size[4].pop(0))
            else:
                if by_size[4]:
                    emit(by_size[4].pop(0))
                    pad(4)
                else:
                    pad(8)
        for a in by_size[4]:
            emit(a)
        # Pad the struct to its ALIGN — the layout's max WGSL alignment
        # (4 for f32-only, 8 for vec2, 16 for vec3/vec4), not a blanket 16
        # (attributes.rs:1648-1663 next_multiple_of(align)).
        align = ParticleLayout._wgsl_align(attributes)
        if align and offset % align != 0:
            pad(align - offset % align)
        return fields

    @staticmethod
    def _wgsl_align(attributes: Sequence[Attribute]) -> int:
        """Max WGSL struct-member alignment over the attributes
        (gpuweb: vec3/vec4 align 16, vec2 align 8, scalars 4)."""
        if not attributes:
            return 0
        return max(16 if a.size >= 12 else a.size for a in attributes)

    def min_binding_size(self) -> int:
        """Packed byte size of one particle, rounded to the layout's max
        alignment (attributes.rs:1648: next_multiple_of(align))."""
        if not self._fields:
            return 0
        last = self._fields[-1]
        end = last.offset + last.attribute.size
        align = self._wgsl_align(self._attributes)
        return (end + align - 1) // align * align

    def byte_offset(self, attr) -> Optional[int]:
        name = attr.name if isinstance(attr, Attribute) else attr
        for f in self._fields:
            if f.attribute.name == name:
                return f.offset
        return None

    def packed_fields(self) -> Tuple[Tuple[str, int], ...]:
        return tuple((f.attribute.name, f.offset) for f in self._fields)

    def generate_struct_code(self, struct_name: str = "Particle") -> str:
        """C struct declaration for the native bridge (≈ generate_code())."""
        ctype = {
            "f32": "float",
            "i32": "int32_t",
            "u32": "uint32_t",
            "bool": "uint32_t",
        }
        lines = [f"struct {struct_name} {{"]
        pos = 0
        pad_idx = 0
        for f in self._fields:
            if f.offset > pos:
                lines.append(f"    uint32_t _pad{pad_idx}[{(f.offset - pos) // 4}];")
                pad_idx += 1
            vt = f.attribute.value_type
            if isinstance(vt, ScalarType):
                lines.append(f"    {ctype[vt.value]} {f.attribute.name};")
            elif isinstance(vt, VectorType):
                lines.append(
                    f"    {ctype[vt.elem_type.value]} {f.attribute.name}[{vt.count}];"
                )
            pos = f.offset + f.attribute.size
        total = self.min_binding_size()
        if total > pos:
            lines.append(f"    uint32_t _pad{pad_idx}[{(total - pos) // 4}];")
        lines.append("};")
        return "\n".join(lines)

    # ---- serde ----------------------------------------------------------

    def to_json(self) -> List[str]:
        return [a.name for a in self._attributes]

    @staticmethod
    def from_json(names: Sequence[str]) -> "ParticleLayout":
        return ParticleLayout(Attribute.from_name(n) for n in names)


class ParticleLayoutBuilder:
    """Fluent builder mirroring ``ParticleLayout::new().append(..).build()``."""

    def __init__(self) -> None:
        self._attrs: List[Attribute] = []

    def append(self, attr) -> "ParticleLayoutBuilder":
        if isinstance(attr, str):
            attr = Attribute.from_name(attr)
        self._attrs.append(attr)
        return self

    def build(self) -> ParticleLayout:
        return ParticleLayout(self._attrs)
