"""Position-shape init modifiers (port of ``bevy_hanabi_tpu/modifiers/position.py``).

Only :class:`SetPositionSphereModifier` is ported so far. Shapes sample in
emitter space; the runtime applies the emitter transform for global-space
effects. Random draws use the context's per-lane PCG stream in the same
order as the JAX package, so trajectories match.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..attributes import Attribute
from ..values import FLOAT
from .base import Modifier, ModifierContext, ShapeDimension, register_modifier

__all__ = ["SetPositionSphereModifier"]

_TAU = 6.283185307179586476925286766559


@register_modifier
@dataclass
class SetPositionSphereModifier(Modifier):
    """Random position on/in a sphere via Archimedes' hat-box (position.rs:138)."""

    center: int  # vec3
    radius: int  # f32
    dimension: ShapeDimension = ShapeDimension.SURFACE

    CONTEXT = ModifierContext.INIT | ModifierContext.UPDATE
    ATTRIBUTES = (Attribute.POSITION,)

    def apply(self, module, ctx) -> None:
        c = ctx.eval(self.center)
        if self.dimension is ShapeDimension.VOLUME:
            r = torch.pow(ctx.draw(FLOAT), 1.0 / 3.0) * ctx.eval(self.radius)
        else:
            r = ctx.eval(self.radius)
        theta = ctx.draw(FLOAT) * _TAU
        z = ctx.draw(FLOAT) * 2.0 - 1.0
        sinphi = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        direction = torch.stack(
            [sinphi * torch.cos(theta), sinphi * torch.sin(theta), z], dim=-1
        )
        if r.dim() >= 1:
            r = r[..., None]
        ctx.set_attr("position", c + r * direction)
