"""GPU spawn-event emission (reference: src/modifier/mod.rs:631-717)."""

from __future__ import annotations

import enum
from dataclasses import dataclass

from .base import Modifier, ModifierContext, register_field_enum, register_modifier

__all__ = ["EventEmitCondition", "EmitSpawnEventModifier"]


@register_field_enum
class EventEmitCondition(enum.Enum):
    """When a particle emits spawn events for child effects."""

    ALWAYS = "always"
    ON_DIE = "on_die"


@register_modifier
@dataclass
class EmitSpawnEventModifier(Modifier):
    """Emit ``count`` spawn events into child channel ``child_index``.

    Events carry the emitting (parent) particle index so children can inherit
    attributes; they are consumed by the child's init pass on the next step,
    mirroring the reference's one-frame event latency.
    """

    condition: EventEmitCondition
    count: int  # ExprHandle, uint
    child_index: int = 0

    CONTEXT = ModifierContext.UPDATE
    ATTRIBUTES = ()

    def apply(self, module, ctx) -> None:
        count = ctx.eval(self.count)
        ctx.emit_events(self.child_index, count, self.condition.value)
