"""Position-shape init modifiers (port of ``bevy_hanabi_tpu/modifiers/position.py``).

Shapes sample in emitter space; the runtime applies the emitter transform
for global-space effects. Random draws use the context's per-lane PCG
stream in the same order as the JAX package, so trajectories match.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..attributes import Attribute
from ..values import FLOAT
from .base import Modifier, ModifierContext, ShapeDimension, register_modifier

__all__ = [
    "SetPositionCircleModifier",
    "SetPositionSphereModifier",
    "SetPositionCone3dModifier",
]

_TAU = 6.283185307179586476925286766559


def orthonormal_basis(n):
    """Branchless ONB from a unit normal (same construction as the WGSL in
    position.rs:80-95, after Duff et al. 2017)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    tangent = torch.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]], dim=-1
    )
    bitangent = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return tangent, bitangent


@register_modifier
@dataclass
class SetPositionCircleModifier(Modifier):
    """Random position on a circle perimeter or disc (position.rs:23)."""

    center: int  # vec3
    axis: int  # vec3 (unit)
    radius: int  # f32
    dimension: ShapeDimension = ShapeDimension.SURFACE

    CONTEXT = ModifierContext.INIT | ModifierContext.UPDATE
    ATTRIBUTES = (Attribute.POSITION,)

    def apply(self, module, ctx) -> None:
        c = ctx.eval(self.center)
        n = ctx.eval(self.axis)
        if n.dim() == 1:
            n = n.expand(len(ctx.seed), 3)
        tangent, bitangent = orthonormal_basis(n)
        # the radius draw comes before the angle's (position.py:66-71)
        if self.dimension is ShapeDimension.VOLUME:
            r = torch.sqrt(ctx.draw(FLOAT)) * ctx.eval(self.radius)
        else:
            r = ctx.eval(self.radius)
        theta = ctx.draw(FLOAT) * _TAU
        direction = tangent * torch.cos(theta)[..., None] + bitangent * torch.sin(theta)[..., None]
        if r.dim() >= 1:
            r = r[..., None]
        ctx.set_attr("position", c + r * direction)


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


@register_modifier
@dataclass
class SetPositionCone3dModifier(Modifier):
    """Random position in a truncated cone along +Y (position.rs:248).

    The reference's sampling: height ratio ``frand()^(1/3)``, radius ratio
    ``sqrt(frand())`` at the interpolated ring radius, uniform angle, drawn
    in that order (position.py:127-134). ``dimension`` is ignored, as by
    the reference's generated code.
    """

    height: int  # f32
    base_radius: int  # f32
    top_radius: int  # f32
    dimension: ShapeDimension = ShapeDimension.VOLUME

    CONTEXT = ModifierContext.INIT | ModifierContext.UPDATE
    ATTRIBUTES = (Attribute.POSITION,)

    def apply(self, module, ctx) -> None:
        h0 = ctx.eval(self.height)
        alpha_h = torch.pow(ctx.draw(FLOAT), 1.0 / 3.0)
        h = h0 * alpha_h
        rt = ctx.eval(self.top_radius)
        rb = ctx.eval(self.base_radius)
        r0 = rb + (rt - rb) * alpha_h
        alpha_r = torch.sqrt(ctx.draw(FLOAT))
        r = r0 * alpha_r
        theta = ctx.draw(FLOAT) * _TAU
        pos = torch.stack([r * torch.cos(theta), h, r * torch.sin(theta)], dim=-1)
        ctx.set_attr("position", pos)
