"""Modifier base class, context flags, and the serde registry.

TPU-native re-design of ``bevy_hanabi/src/modifier/mod.rs`` (trait
``Modifier``, modifier/mod.rs:154-181; ``RenderModifier`` :558; reflection
registry modifier/registry.rs). Instead of emitting WGSL strings, ``apply``
evaluates expressions through an :class:`~bevy_hanabi_tpu.compiler.EvalContext`
and mutates the traced particle state / render outputs directly.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, ClassVar, Dict, Tuple, Type

from ..attributes import Attribute
from ..gradient import Gradient

__all__ = [
    "ModifierContext",
    "ShapeDimension",
    "Modifier",
    "register_modifier",
    "modifier_from_json",
    "MODIFIER_REGISTRY",
]


class ModifierContext(enum.Flag):
    """Which pass(es) a modifier participates in (modifier/mod.rs:106)."""

    INIT = enum.auto()
    UPDATE = enum.auto()
    RENDER = enum.auto()


class ShapeDimension(enum.Enum):
    """Surface vs volume sampling for shape modifiers (modifier/mod.rs:87)."""

    SURFACE = "surface"
    VOLUME = "volume"


MODIFIER_REGISTRY: Dict[str, Type["Modifier"]] = {}


def register_modifier(cls):
    """Class decorator registering a modifier for serde by type name
    (equivalent of the reference's reflection registry, modifier/registry.rs)."""
    MODIFIER_REGISTRY[cls.__name__] = cls
    return cls


class Modifier:
    """Base class. Subclasses are dataclasses whose fields are ExprHandles
    (ints), enums, Gradients, or plain scalars — all JSON-serializable."""

    # Overridden per subclass.
    CONTEXT: ClassVar[ModifierContext] = ModifierContext.UPDATE
    ATTRIBUTES: ClassVar[Tuple[Attribute, ...]] = ()

    def __post_init__(self):
        # Ergonomics: the reference's type system forces `.expr()` on a
        # WriterExpr; in Python the near-miss of passing the WriterExpr itself
        # (or its un-called bound method) used to surface only as a JSON
        # serialization failure inside asset.signature(). Coerce the former,
        # diagnose the latter, here at construction time.
        from ..graph.expr import WriterExpr

        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, WriterExpr):
                setattr(self, f.name, v.expr())
            elif callable(v) and isinstance(getattr(v, "__self__", None), WriterExpr):
                raise TypeError(
                    f"{type(self).__name__}.{f.name}: got the bound method "
                    "WriterExpr.expr — call it: `.expr()`"
                )

    def context(self) -> ModifierContext:
        return self.CONTEXT

    def attributes(self) -> Tuple[Attribute, ...]:
        """Particle attributes this modifier requires; their union across all
        of an asset's modifiers derives the particle layout (asset.rs:605)."""
        return self.ATTRIBUTES

    # -- pass hooks ------------------------------------------------------

    def apply(self, module, ctx) -> None:
        """Apply in an init/update context. Default: no-op."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support init/update application"
        )

    def apply_render(self, module, ctx) -> None:
        """Apply in a render context. Default: error."""
        raise NotImplementedError(
            f"{type(self).__name__} is not a render modifier"
        )

    # -- serde -------------------------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"type": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = _field_to_json(v)
        return out

    @classmethod
    def from_json(cls, data: Dict[str, Any]) -> "Modifier":
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in data:
                continue
            kwargs[f.name] = _field_from_json(f.type, data[f.name])
        return cls(**kwargs)


def _field_to_json(v):
    if isinstance(v, enum.Enum):
        return {"$enum": type(v).__name__, "v": v.value}
    if isinstance(v, Gradient):
        return {"$gradient": v.to_json()}
    if isinstance(v, tuple):
        return list(v)
    return v


# Enum types that may appear in modifier fields, populated lazily to avoid
# circular imports.
_ENUM_TYPES: Dict[str, Type[enum.Enum]] = {}


def register_field_enum(e: Type[enum.Enum]) -> Type[enum.Enum]:
    _ENUM_TYPES[e.__name__] = e
    return e


register_field_enum(ShapeDimension)


def _field_from_json(ftype, v):
    if isinstance(v, dict) and "$enum" in v:
        return _ENUM_TYPES[v["$enum"]](v["v"])
    if isinstance(v, dict) and "$gradient" in v:
        return Gradient.from_json(v["$gradient"])
    if isinstance(v, list):
        return tuple(v)
    return v


def modifier_from_json(data: Dict[str, Any]) -> Modifier:
    name = data["type"]
    if name not in MODIFIER_REGISTRY:
        raise KeyError(
            f"unknown modifier type {name!r}; known: {sorted(MODIFIER_REGISTRY)}"
        )
    return MODIFIER_REGISTRY[name].from_json(data)
