"""Render modifiers (port of ``bevy_hanabi_tpu/modifiers/output.py``).

These run in a :class:`~bevy_hanabi_tpu_torch.compiler.RenderContext` and
mutate its per-particle render outputs; the per-pixel stages (texture
sampling, the flipbook cell, squircle rounding) are recorded as declarative
state on the context and applied by the rasterizer. Every render modifier of
the JAX package's ``output.py`` is ported, with the enums its fields use.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..attributes import Attribute
from ..cpu_value import CpuValue
from ..gradient import Gradient
from .base import Modifier, ModifierContext, register_field_enum, register_modifier

__all__ = [
    "ImageSampleMapping",
    "ColorBlendMode",
    "ColorBlendMask",
    "ParticleTextureModifier",
    "SetColorModifier",
    "ColorOverLifetimeModifier",
    "SetSizeModifier",
    "SizeOverLifetimeModifier",
    "OrientMode",
    "OrientModifier",
    "FlipbookModifier",
    "ScreenSpaceSizeModifier",
    "RoundModifier",
]


@register_field_enum
class ImageSampleMapping(enum.Enum):
    """How a sampled texture modulates the base color (output.rs:21)."""

    MODULATE = "modulate"  # color *= tex
    MODULATE_RGB = "modulate_rgb"  # color.rgb *= tex.rgb
    MODULATE_OPACITY_FROM_R = "modulate_opacity_from_r"  # color.a *= tex.r


@register_field_enum
class ColorBlendMode(enum.Enum):
    """How a color modifier combines with the current color (output.rs:154)."""

    OVERWRITE = "overwrite"
    ADD = "add"
    MODULATE = "modulate"


@register_field_enum
class ColorBlendMask(enum.IntFlag):
    """Which channels a color modifier writes (output.rs:178)."""

    R = 1
    G = 2
    B = 4
    A = 8
    RGB = 7
    RGBA = 15


def blend_color(current, new, blend: ColorBlendMode, mask: ColorBlendMask):
    """Apply a masked color blend (mirrors output.rs:341-351)."""
    if blend is ColorBlendMode.OVERWRITE:
        combined = new
    elif blend is ColorBlendMode.ADD:
        combined = current + new
    else:
        combined = current * new
    if mask == ColorBlendMask.RGBA:
        return combined
    chans = [combined[..., i] if mask & (1 << i) else current[..., i] for i in range(4)]
    return torch.stack(chans, dim=-1)


def _eval_cpu_value(ctx, v, lanes: int):
    """Evaluate a CpuValue per particle: constants broadcast, uniform ranges
    draw from the per-lane PCG stream (output.py:90-103)."""
    dev = ctx.device
    if isinstance(v, CpuValue):
        if v.is_uniform:
            from ..ops import rng

            a = torch.as_tensor(v.value, dtype=torch.float32, device=dev)
            b = torch.as_tensor(v.upper, dtype=torch.float32, device=dev)
            ctx.seed, r = rng.rand_vec(ctx.seed, lanes)
            return a + r * (b - a)
        v = v.value
    return torch.as_tensor(v, dtype=torch.float32, device=dev)


@register_modifier
@dataclass
class ParticleTextureModifier(Modifier):
    """Modulate particle color with a texture sample (output.rs:69)."""

    texture_slot: int
    sample_mapping: ImageSampleMapping = ImageSampleMapping.MODULATE

    CONTEXT = ModifierContext.RENDER
    ATTRIBUTES = ()

    def apply_render(self, module, ctx) -> None:
        ctx.needs_uv = True
        ctx.texture_layers.append((self.texture_slot, self.sample_mapping))


@register_modifier
@dataclass
class SetColorModifier(Modifier):
    """Set a single base color for all particles (output.rs:229), with a
    blend mode and a channel write mask (output.rs:233-236)."""

    color: CpuValue  # vec4
    blend: ColorBlendMode = ColorBlendMode.OVERWRITE
    mask: ColorBlendMask = ColorBlendMask.RGBA

    CONTEXT = ModifierContext.RENDER
    ATTRIBUTES = ()

    def __post_init__(self):
        super().__post_init__()
        if not isinstance(self.color, CpuValue):
            self.color = CpuValue.single(tuple(self.color))

    def to_json(self):
        return {
            "type": type(self).__name__,
            "color": self.color.to_json(),
            "blend": self.blend.value,
            "mask": int(self.mask),
        }

    @classmethod
    def from_json(cls, data):
        return cls(
            CpuValue.from_json(data["color"]),
            ColorBlendMode(data.get("blend", "overwrite")),
            ColorBlendMask(data.get("mask", 15)),
        )

    def apply_render(self, module, ctx) -> None:
        c = _eval_cpu_value(ctx, self.color, 4)
        new = c.expand(ctx.num_particles, 4)
        ctx.color = blend_color(ctx.color, new, self.blend, self.mask)


@register_modifier
@dataclass
class ColorOverLifetimeModifier(Modifier):
    """Color from a gradient keyed on age/lifetime (output.rs:290)."""

    gradient: Gradient
    blend: ColorBlendMode = ColorBlendMode.OVERWRITE
    mask: ColorBlendMask = ColorBlendMask.RGBA

    CONTEXT = ModifierContext.RENDER
    ATTRIBUTES = (Attribute.AGE, Attribute.LIFETIME)

    def apply_render(self, module, ctx) -> None:
        life_ratio = ctx.get_attr("age") / ctx.get_attr("lifetime")
        sampled = self.gradient.sample_torch(life_ratio)
        ctx.color = blend_color(ctx.color, sampled, self.blend, self.mask)


@register_modifier
@dataclass
class SetSizeModifier(Modifier):
    """Set a single world-space size for all particles (output.rs:379)."""

    size: CpuValue  # vec3

    CONTEXT = ModifierContext.RENDER
    ATTRIBUTES = ()

    def __post_init__(self):
        super().__post_init__()
        if not isinstance(self.size, CpuValue):
            s = self.size
            if isinstance(s, (int, float)):
                s = (float(s),) * 3
            self.size = CpuValue.single(tuple(s))

    def to_json(self):
        return {"type": type(self).__name__, "size": self.size.to_json()}

    @classmethod
    def from_json(cls, data):
        return cls(CpuValue.from_json(data["size"]))

    def apply_render(self, module, ctx) -> None:
        s = _eval_cpu_value(ctx, self.size, 3)
        ctx.size = s.expand(ctx.num_particles, 3)


@register_modifier
@dataclass
class SizeOverLifetimeModifier(Modifier):
    """Size from a gradient keyed on age/lifetime (output.rs:414)."""

    gradient: Gradient
    screen_space_size: bool = False

    CONTEXT = ModifierContext.RENDER
    ATTRIBUTES = (Attribute.AGE, Attribute.LIFETIME)

    def apply_render(self, module, ctx) -> None:
        life_ratio = ctx.get_attr("age") / ctx.get_attr("lifetime")
        sampled = self.gradient.sample_torch(life_ratio)
        if sampled.shape[-1] == 1:
            sampled = sampled.expand(sampled.shape[:-1] + (3,))
        elif sampled.shape[-1] == 2:
            sampled = torch.cat([sampled, torch.ones_like(sampled[..., :1])], dim=-1)
        ctx.size = sampled
        if self.screen_space_size:
            ctx.screen_space_size = True


@register_field_enum
class OrientMode(enum.Enum):
    """Billboard orientation modes (output.rs:466)."""

    PARALLEL_CAMERA_DEPTH_PLANE = "parallel_camera_depth_plane"
    FACE_CAMERA_POSITION = "face_camera_position"
    ALONG_VELOCITY = "along_velocity"


@register_modifier
@dataclass
class OrientModifier(Modifier):
    """Set the particle local frame (axis_x/y/z) per OrientMode (output.rs:562)."""

    mode: OrientMode = OrientMode.PARALLEL_CAMERA_DEPTH_PLANE
    rotation: Optional[int] = None  # ExprHandle, f32 radians

    CONTEXT = ModifierContext.RENDER

    def attributes(self):
        if self.mode is OrientMode.ALONG_VELOCITY:
            return (Attribute.POSITION, Attribute.VELOCITY)
        return (Attribute.POSITION,)

    def apply_render(self, module, ctx) -> None:
        cam = ctx.camera
        if cam is None:
            raise ValueError("OrientModifier requires a camera on the RenderContext")
        n = ctx.num_particles
        pos = ctx.get_attr("position")
        dev = pos.device

        def norm(v):
            return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))

        def cross(a, b):
            a, b = torch.broadcast_tensors(a, b)
            return torch.linalg.cross(a, b, dim=-1)

        def rotate_in_plane(x0, y0):
            if self.rotation is None:
                return x0, y0
            rot = ctx.eval(self.rotation)
            c = torch.cos(rot)[..., None]
            s = torch.sin(rot)[..., None]
            return x0 * c + y0 * s, x0 * s - y0 * c

        if self.mode is OrientMode.PARALLEL_CAMERA_DEPTH_PLANE:
            rot3 = cam.rotation.to(dev)
            r0 = rot3[:, 0].expand(n, 3)
            r1 = rot3[:, 1].expand(n, 3)
            ctx.axis_x, ctx.axis_y = rotate_in_plane(r0, r1)
            ctx.axis_z = rot3[:, 2].expand(n, 3)
        elif self.mode is OrientMode.FACE_CAMERA_POSITION:
            axis_z = norm(cam.position.to(dev) - pos)
            axis_x0 = norm(cross(cam.up.to(dev).expand(n, 3), axis_z))
            axis_y0 = cross(axis_z, axis_x0)
            ctx.axis_x, ctx.axis_y = rotate_in_plane(axis_x0, axis_y0)
            ctx.axis_z = axis_z
        else:  # ALONG_VELOCITY
            direction = norm(pos - cam.position.to(dev))
            axis_x = norm(ctx.get_attr("velocity"))
            axis_y = cross(direction, axis_x)
            ctx.axis_x = axis_x
            ctx.axis_y = axis_y
            ctx.axis_z = cross(axis_x, axis_y)


@register_modifier
@dataclass
class FlipbookModifier(Modifier):
    """Sprite-sheet animation via SPRITE_INDEX (output.rs:763)."""

    sprite_grid_size: Tuple[int, int] = (1, 1)  # (cols, rows)

    CONTEXT = ModifierContext.RENDER
    ATTRIBUTES = (Attribute.SPRITE_INDEX,)

    def apply_render(self, module, ctx) -> None:
        ctx.needs_uv = True
        ctx.sprite_grid_size = tuple(self.sprite_grid_size)


@register_modifier
@dataclass
class ScreenSpaceSizeModifier(Modifier):
    """Interpret size in screen pixels instead of world units (output.rs:830)."""

    CONTEXT = ModifierContext.RENDER
    ATTRIBUTES = (Attribute.POSITION, Attribute.SIZE)

    def apply_render(self, module, ctx) -> None:
        ctx.screen_space_size = True


@register_modifier
@dataclass
class RoundModifier(Modifier):
    """Squircle particle shape: |x|^n + |y|^n <= 1, n = 2/roundness (output.rs:886)."""

    roundness: int  # ExprHandle, f32 in [0,1]

    CONTEXT = ModifierContext.RENDER
    ATTRIBUTES = ()

    @staticmethod
    def ellipse(module) -> "RoundModifier":
        return RoundModifier(module.lit(1.0))

    def apply_render(self, module, ctx) -> None:
        ctx.needs_uv = True
        ctx.roundness = ctx.eval(self.roundness)
