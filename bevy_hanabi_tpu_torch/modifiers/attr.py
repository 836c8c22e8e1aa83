"""Attribute set/inherit modifiers (reference: src/modifier/attr.rs)."""

from __future__ import annotations

from dataclasses import dataclass

from ..attributes import Attribute
from .base import Modifier, ModifierContext, register_modifier

__all__ = ["SetAttributeModifier", "InheritAttributeModifier"]


def _attr_name(a) -> str:
    return a.name if isinstance(a, Attribute) else str(a)


@register_modifier
@dataclass
class SetAttributeModifier(Modifier):
    """Set a particle attribute to an expression value (attr.rs:57)."""

    attribute: str
    value: int  # ExprHandle

    CONTEXT = ModifierContext.INIT | ModifierContext.UPDATE

    def __post_init__(self):
        super().__post_init__()
        self.attribute = _attr_name(self.attribute)

    def attributes(self):
        return (Attribute.from_name(self.attribute),)

    def apply(self, module, ctx) -> None:
        ctx.set_attr(self.attribute, ctx.eval(self.value))


@register_modifier
@dataclass
class InheritAttributeModifier(Modifier):
    """Copy an attribute from the parent particle at spawn (attr.rs:148)."""

    attribute: str

    CONTEXT = ModifierContext.INIT

    def __post_init__(self):
        super().__post_init__()
        self.attribute = _attr_name(self.attribute)

    def attributes(self):
        return (Attribute.from_name(self.attribute),)

    def apply(self, module, ctx) -> None:
        if ctx.parent_particle is None:
            raise ValueError(
                f"InheritAttributeModifier({self.attribute!r}) requires a parent effect"
            )
        if self.attribute not in ctx.parent_particle:
            raise KeyError(
                f"parent layout lacks inherited attribute {self.attribute!r}"
            )
        ctx.set_attr(self.attribute, ctx.parent_particle[self.attribute])
