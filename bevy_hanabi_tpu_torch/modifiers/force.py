"""Force modifiers (port of ``bevy_hanabi_tpu/modifiers/force.py``;
reference: src/modifier/force.rs)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..attributes import Attribute
from ..graph.expr import BuiltInOp
from .base import Modifier, ModifierContext, register_modifier

__all__ = ["ConformToSphereModifier", "LinearDragModifier"]


def _smoothstep(lo, hi, x):
    t = torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


@register_modifier
@dataclass
class ConformToSphereModifier(Modifier):
    """Attractor that makes particles stick to a sphere surface.

    Vectorized port of the correction math generated at force.rs:199-232:
    particles within ``influence_dist`` of the surface get their radial
    velocity component corrected toward ``sign(surface_dist) * shell_factor *
    max_attraction_speed`` at a rate bounded by the (sticky-boosted)
    attraction acceleration; tangent velocity is untouched.
    """

    origin: int  # vec3
    radius: int  # f32
    influence_dist: int  # f32
    attraction_accel: int  # f32
    max_attraction_speed: int  # f32
    shell_half_thickness: Optional[int] = None  # f32, default 0.1
    sticky_factor: Optional[int] = None  # f32, default 2.0

    CONTEXT = ModifierContext.UPDATE
    ATTRIBUTES = (Attribute.POSITION, Attribute.VELOCITY)

    def apply(self, module, ctx) -> None:
        c = ctx.eval(self.origin)
        r = ctx.eval(self.radius)
        influence_dist = ctx.eval(self.influence_dist)
        # the defaults are f32 constants, as the JAX package's jnp.float32
        shell_half_thickness = (
            ctx.eval(self.shell_half_thickness)
            if self.shell_half_thickness is not None
            else float(np.float32(0.1))
        )
        max_attraction_speed = ctx.eval(self.max_attraction_speed)
        attraction_accel = ctx.eval(self.attraction_accel)
        sticky_factor = (
            ctx.eval(self.sticky_factor) if self.sticky_factor is not None else 2.0
        )
        dt = ctx.sim.get(BuiltInOp.DELTA_TIME)

        pos = ctx.get_attr("position")
        vel = ctx.get_attr("velocity")
        rel_pos = c - pos
        origin_dist = torch.sqrt(torch.sum(rel_pos * rel_pos, dim=-1))
        origin_dir = rel_pos / origin_dist[..., None]
        surface_dist = origin_dist - r
        affected = surface_dist <= influence_dist

        cur_radial_speed = torch.sum(vel * origin_dir, dim=-1)
        shell_factor = _smoothstep(0.0, shell_half_thickness, torch.abs(surface_dist))
        max_radial_speed = torch.sign(surface_dist) * shell_factor * max_attraction_speed
        delta_speed = max_radial_speed - cur_radial_speed
        sticky_accel = attraction_accel * sticky_factor
        conforming_accel = sticky_accel + (attraction_accel - sticky_accel) * shell_factor
        conforming_delta_speed = dt * conforming_accel
        impulse = (
            torch.sign(delta_speed)
            * torch.minimum(torch.abs(delta_speed), conforming_delta_speed)
        )[..., None] * origin_dir
        ctx.set_attr("velocity", torch.where(affected[..., None], vel + impulse, vel))


@register_modifier
@dataclass
class LinearDragModifier(Modifier):
    """``velocity *= max(0, 1 - drag*dt)`` (force.rs:249)."""

    drag: int  # f32

    CONTEXT = ModifierContext.UPDATE
    ATTRIBUTES = (Attribute.VELOCITY,)

    @staticmethod
    def constant(module, drag: float) -> "LinearDragModifier":
        return LinearDragModifier(module.lit(float(drag)))

    def apply(self, module, ctx) -> None:
        drag = ctx.eval(self.drag)
        dt = ctx.sim.get(BuiltInOp.DELTA_TIME)
        factor = torch.clamp(1.0 - drag * dt, min=0.0)
        v = ctx.get_attr("velocity")
        if factor.dim() >= 1:
            factor = factor[..., None]
        ctx.set_attr("velocity", v * factor)
