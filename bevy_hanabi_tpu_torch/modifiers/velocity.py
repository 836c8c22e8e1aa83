"""Velocity-shape init modifiers (port of ``bevy_hanabi_tpu/modifiers/velocity.py``).

Velocities are produced in emitter space; the runtime rotates them by the
emitter transform for global-space effects.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..attributes import Attribute
from .base import Modifier, ModifierContext, register_modifier

__all__ = [
    "SetVelocityCircleModifier",
    "SetVelocitySphereModifier",
    "SetVelocityTangentModifier",
]


def _normalize(v):
    # Safe normalize: a zero-length vector yields zero velocity, not NaN.
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    return v * torch.rsqrt(torch.clamp(sq, min=1e-24))


def _per_lane(speed):
    return speed[..., None] if speed.dim() >= 1 else speed


@register_modifier
@dataclass
class SetVelocityCircleModifier(Modifier):
    """Radial velocity in the plane orthogonal to ``axis`` (velocity.rs:28)."""

    center: int  # vec3
    axis: int  # vec3 (unit)
    speed: int  # f32

    CONTEXT = ModifierContext.INIT | ModifierContext.UPDATE
    ATTRIBUTES = (Attribute.POSITION, Attribute.VELOCITY)

    def apply(self, module, ctx) -> None:
        center = ctx.eval(self.center)
        axis = ctx.eval(self.axis)
        speed = ctx.eval(self.speed)
        delta = ctx.get_attr("position") - center
        radial = _normalize(delta - torch.sum(delta * axis, dim=-1, keepdim=True) * axis)
        ctx.set_attr("velocity", radial * _per_lane(speed))


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
        ctx.set_attr("velocity", direction * _per_lane(speed))


@register_modifier
@dataclass
class SetVelocityTangentModifier(Modifier):
    """Velocity tangent to an axis through an origin (velocity.rs:170)."""

    origin: int  # vec3
    axis: int  # vec3
    speed: int  # f32

    CONTEXT = ModifierContext.INIT | ModifierContext.UPDATE
    ATTRIBUTES = (Attribute.POSITION, Attribute.VELOCITY)

    def apply(self, module, ctx) -> None:
        origin = ctx.eval(self.origin)
        axis = ctx.eval(self.axis)
        speed = ctx.eval(self.speed)
        radial = ctx.get_attr("position") - origin
        # the axis broadcast to every lane, as jnp.cross takes it (velocity.py:93)
        tangent = _normalize(torch.linalg.cross(axis.expand(radial.shape), radial, dim=-1))
        ctx.set_attr("velocity", tangent * _per_lane(speed))
