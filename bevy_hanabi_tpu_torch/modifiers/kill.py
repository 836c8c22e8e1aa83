"""Kill-region modifiers (port of ``bevy_hanabi_tpu/modifiers/kill.py``;
reference: src/modifier/kill.rs)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..attributes import Attribute
from .base import Modifier, ModifierContext, register_modifier

__all__ = ["KillSphereModifier", "KillAabbModifier"]


@register_modifier
@dataclass
class KillSphereModifier(Modifier):
    """Kill particles inside (or outside) a sphere (kill.rs:24).

    ``sqr_radius`` is the squared radius expression, as in the reference.
    """

    center: int  # vec3
    sqr_radius: int  # f32
    kill_inside: bool = True

    CONTEXT = ModifierContext.UPDATE
    ATTRIBUTES = (Attribute.POSITION,)

    def with_kill_inside(self, kill_inside: bool) -> "KillSphereModifier":
        return KillSphereModifier(self.center, self.sqr_radius, kill_inside)

    def apply(self, module, ctx) -> None:
        center = ctx.eval(self.center)
        sqr_radius = ctx.eval(self.sqr_radius)
        diff = ctx.get_attr("position") - center
        sqr_dist = torch.sum(diff * diff, dim=-1)
        mask = sqr_dist < sqr_radius if self.kill_inside else sqr_dist > sqr_radius
        ctx.kill(mask)


@register_modifier
@dataclass
class KillAabbModifier(Modifier):
    """Kill particles entering (or exiting) an axis-aligned box (kill.rs:109).

    kill_inside: kill where all(|pos-center| < half_size);
    otherwise kill where any(|pos-center| > half_size).
    """

    center: int  # vec3
    half_size: int  # vec3
    kill_inside: bool = True

    CONTEXT = ModifierContext.UPDATE
    ATTRIBUTES = (Attribute.POSITION,)

    def with_kill_inside(self, kill_inside: bool) -> "KillAabbModifier":
        return KillAabbModifier(self.center, self.half_size, kill_inside)

    def apply(self, module, ctx) -> None:
        center = ctx.eval(self.center)
        half_size = ctx.eval(self.half_size)
        dist = torch.abs(ctx.get_attr("position") - center)
        if self.kill_inside:
            mask = torch.all(dist < half_size, dim=-1)
        else:
            mask = torch.any(dist > half_size, dim=-1)
        ctx.kill(mask)
