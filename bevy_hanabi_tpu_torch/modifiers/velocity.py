"""Velocity-shape init modifiers (port of ``bevy_hanabi_tpu/modifiers/velocity.py``).

Only :class:`SetVelocitySphereModifier` is ported so far. Velocities are
produced in emitter space; the runtime rotates them by the emitter
transform for global-space effects.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..attributes import Attribute
from .base import Modifier, ModifierContext, register_modifier

__all__ = ["SetVelocitySphereModifier"]


def _normalize(v):
    # Safe normalize: a zero-length vector yields zero velocity, not NaN.
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    return v * torch.rsqrt(torch.clamp(sq, min=1e-24))


@register_modifier
@dataclass
class SetVelocitySphereModifier(Modifier):
    """Velocity radially away from a center point (velocity.rs:111)."""

    center: int  # vec3
    speed: int  # f32

    CONTEXT = ModifierContext.INIT | ModifierContext.UPDATE
    ATTRIBUTES = (Attribute.POSITION, Attribute.VELOCITY)

    def apply(self, module, ctx) -> None:
        center = ctx.eval(self.center)
        speed = ctx.eval(self.speed)
        direction = _normalize(ctx.get_attr("position") - center)
        if speed.dim() >= 1:
            speed = speed[..., None]
        ctx.set_attr("velocity", direction * speed)
