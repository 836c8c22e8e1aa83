"""Acceleration modifiers (port of ``bevy_hanabi_tpu/modifiers/accel.py``;
reference: src/modifier/accel.rs)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..attributes import Attribute
from ..graph.expr import BuiltInOp
from .base import Modifier, ModifierContext, register_modifier

__all__ = ["AccelModifier", "RadialAccelModifier", "TangentAccelModifier"]


def _normalize(v):
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


@register_modifier
@dataclass
class AccelModifier(Modifier):
    """``velocity += accel * dt`` (accel.rs:36-87)."""

    accel: int  # ExprHandle, vec3

    CONTEXT = ModifierContext.UPDATE
    ATTRIBUTES = (Attribute.VELOCITY,)

    def apply(self, module, ctx) -> None:
        a = ctx.eval(self.accel)
        dt = ctx.sim.get(BuiltInOp.DELTA_TIME)
        v = ctx.get_attr("velocity")
        ctx.set_attr("velocity", v + a * dt)


@register_modifier
@dataclass
class RadialAccelModifier(Modifier):
    """Accelerate radially away from an origin (accel.rs:110)."""

    origin: int  # vec3
    accel: int  # f32

    CONTEXT = ModifierContext.UPDATE
    ATTRIBUTES = (Attribute.POSITION, Attribute.VELOCITY)

    def apply(self, module, ctx) -> None:
        origin = ctx.eval(self.origin)
        accel = ctx.eval(self.accel)
        dt = ctx.sim.get(BuiltInOp.DELTA_TIME)
        radial = _normalize(ctx.get_attr("position") - origin)
        v = ctx.get_attr("velocity")
        if accel.dim() >= 1:
            accel = accel[..., None]
        ctx.set_attr("velocity", v + radial * (accel * dt))


@register_modifier
@dataclass
class TangentAccelModifier(Modifier):
    """Accelerate tangentially around an axis through an origin (accel.rs:214)."""

    origin: int  # vec3
    axis: int  # vec3
    accel: int  # f32

    CONTEXT = ModifierContext.UPDATE
    ATTRIBUTES = (Attribute.POSITION, Attribute.VELOCITY)

    def apply(self, module, ctx) -> None:
        origin = ctx.eval(self.origin)
        axis = ctx.eval(self.axis)
        accel = ctx.eval(self.accel)
        dt = ctx.sim.get(BuiltInOp.DELTA_TIME)
        radial = _normalize(ctx.get_attr("position") - origin)
        tangent = _normalize(torch.linalg.cross(axis.expand(radial.shape), radial, dim=-1))
        v = ctx.get_attr("velocity")
        if accel.dim() >= 1:
            accel = accel[..., None]
        ctx.set_attr("velocity", v + tangent * (accel * dt))
