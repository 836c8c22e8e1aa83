"""Runtime-tunable effect properties (reference: src/properties.rs).

Properties are named values, uniform per effect instance, changeable every
frame without recompiling. On TPU they are simply runtime arguments to the
jitted step (a dict of small arrays), so "re-upload on change" is automatic
and free of retraces. :class:`PropertyLayout` keeps the reference's packed
byte layout (size-sorted, properties.rs:521-870) for serialization parity
and the native-bridge C struct.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .values import Value, ValueType, as_value

__all__ = ["Property", "PropertyLayout", "EffectProperties"]


@dataclass(frozen=True)
class Property:
    """A named property declaration with a typed default (properties.rs:113)."""

    name: str
    default: Value

    @staticmethod
    def new(name: str, default) -> "Property":
        return Property(name, as_value(default))

    @property
    def value_type(self) -> ValueType:
        return self.default.value_type

    @property
    def size(self) -> int:
        return self.default.value_type.size


class PropertyLayout:
    """Packed layout of a property block (properties.rs:521-870).

    Offsets reproduce the reference's pairing packer exactly (16-byte
    types first, then {vec3+f32} pairs, then {vec2+vec2} pairs, then
    remainders) so serialized blocks and the native bridge interoperate
    byte-for-byte with the reference layout.
    """

    def __init__(self, properties: Sequence[Property] = ()):
        self._properties = tuple(properties)
        # The reference's pairing packer, reproduced step for step
        # (properties.rs:561-688): sort ascending by size; emit all 16-byte
        # types (already aligned); pair {vec3 + f32} into 16-byte rows;
        # pair {vec2 + vec2}; then the remainders — leftover vec3s stride
        # 16 (WGSL vec3 alignment), leftover f32s pack tightly.
        order = sorted(
            range(len(self._properties)),
            key=lambda i: self._properties[i].size,
        )
        sizes = [self._properties[i].size for i in order]

        def partition_point(limit):
            # first index whose size >= limit
            for k, s in enumerate(sizes):
                if s >= limit:
                    return k
            return len(sizes)

        index4 = partition_point(16)
        index2 = partition_point(8)
        index3 = partition_point(12)
        num1, num2, num3 = index2, index3 - index2, index4 - index3
        entries: List[Tuple[int, int]] = []  # (property index, offset)
        offset = 0
        for i in order[index4:]:
            entries.append((i, offset))
            offset += 16
        num_pairs = min(num1, num3)
        for k in range(num_pairs):
            entries.append((order[index3 + k], offset))
            offset += 12
            entries.append((order[k], offset))
            offset += 4
        index1 = num_pairs
        index3 += num_pairs
        num1 -= num_pairs
        num3 -= num_pairs
        for k in range(num2 // 2):
            for j in range(2):
                entries.append((order[index2 + k * 2 + j], offset))
                offset += 8
        index2 += (num2 // 2) * 2
        num2 %= 2
        if num3 > num1:
            for k in range(num3):
                entries.append((order[index3 + k], offset))
                offset += 16  # vec3 is 16-byte aligned in WGSL
            if num2:
                entries.append((order[index2], offset))
                offset += 8
        else:
            if num2:
                entries.append((order[index2], offset))
                offset += 8
            for k in range(num1):
                entries.append((order[index1 + k], offset))
                offset += 4
        self._fields = {
            self._properties[i].name: off for i, off in entries
        }
        if entries:
            last_i, last_off = entries[-1]
            self._cpu_size = last_off + self._properties[last_i].size
            align = max(
                self._properties[i].value_type.align for i, _ in entries
            )
            self._size = (self._cpu_size + align - 1) // align * align
        else:
            self._cpu_size = 0
            self._size = 0

    def is_empty(self) -> bool:
        return not self._properties

    def properties(self) -> Tuple[Property, ...]:
        return self._properties

    def offset(self, name: str) -> Optional[int]:
        return self._fields.get(name)

    def cpu_size(self) -> int:
        """Used byte size, unpadded (properties.rs:729-736)."""
        return self._cpu_size

    def min_binding_size(self) -> int:
        """cpu_size rounded up to the layout's max alignment
        (properties.rs:798-806); also the pack() blob size."""
        return self._size

    def pack(self, values: Dict[str, Any]) -> bytes:
        """Pack property values (or defaults) into one byte block."""
        buf = bytearray(self._size)
        for p in self._properties:
            v = values.get(p.name)
            val = as_value(v, p.value_type) if v is not None else p.default
            raw = val.as_bytes()
            off = self._fields[p.name]
            buf[off : off + len(raw)] = raw
        return bytes(buf)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, PropertyLayout)
            and self._properties == other._properties
        )

    def __hash__(self) -> int:
        return hash(self._properties)


class EffectProperties:
    """Per-instance runtime property values with change detection
    (reference: EffectProperties component, properties.rs:216)."""

    def __init__(self, declared: Sequence[Property] = ()):
        self._declared: Dict[str, Property] = {p.name: p for p in declared}
        self._values: Dict[str, np.ndarray] = {}
        self._dirty = True

    def declare(self, prop: Property) -> None:
        self._declared[prop.name] = prop

    def set(self, name: str, value) -> None:
        if name not in self._declared:
            raise KeyError(f"unknown property {name!r}; declared: {sorted(self._declared)}")
        vt = self._declared[name].value_type
        arr = np.asarray(as_value(value, vt).to_numpy())
        self._values[name] = arr
        self._dirty = True

    def set_if_changed(self, name: str, value) -> None:
        vt = self._declared[name].value_type
        arr = np.asarray(as_value(value, vt).to_numpy())
        cur = self._values.get(name)
        if cur is None or not np.array_equal(cur, arr):
            self._values[name] = arr
            self._dirty = True

    def get(self, name: str):
        if name in self._values:
            return self._values[name]
        if name in self._declared:
            return self._declared[name].default.to_numpy()
        raise KeyError(name)

    def as_dict(self) -> Dict[str, np.ndarray]:
        """Resolved name→value dict (defaults filled in) for the jitted step."""
        out = {}
        for name, p in self._declared.items():
            out[name] = self._values.get(name, p.default.to_numpy())
        return out

    def consume_dirty(self) -> bool:
        d = self._dirty
        self._dirty = False
        return d

    def resync(self, declared: Sequence[Property]) -> None:
        """Re-sync declarations from a (possibly changed) asset while
        keeping instance-set values — the hot-reload analogue of the
        reference's ``update_properties_from_asset`` (lib.rs:1853): asset
        defaults refresh, per-instance overrides persist for properties
        that still exist with the same type, and values for removed or
        re-typed properties drop."""
        new_decl = {p.name: p for p in declared}
        kept = {
            n: v
            for n, v in self._values.items()
            if n in new_decl
            and new_decl[n].value_type == self._declared[n].value_type
        }
        self._declared = new_decl
        self._values = kept
        self._dirty = True
