"""Re-creations of reference examples (port of a subset of
``bevy_hanabi_tpu/models/examples.py``).

Ported: ``example_2d`` (the squircle, RoundModifier), ``example_circle``
(the flipbook: a sprite sheet through ParticleTextureModifier and
FlipbookModifier) and ``example_puffs`` (an icosphere triangle mesh lit per
fragment by the user modifier :class:`LambertianLightingModifier`). The
definitions are the JAX package's, so both packages build equal assets
(``to_json`` agrees).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import attributes as A
from ..asset import EffectAsset
from ..gradient import Gradient
from ..graph import ExprWriter
from ..modifiers import (
    ColorOverLifetimeModifier,
    FlipbookModifier,
    Modifier,
    ModifierContext,
    OrientMode,
    OrientModifier,
    ParticleTextureModifier,
    RoundModifier,
    SetAttributeModifier,
    SetColorModifier,
    SetPositionCircleModifier,
    SetVelocityCircleModifier,
    SetVelocitySphereModifier,
    ShapeDimension,
    SizeOverLifetimeModifier,
    SetSizeModifier,
    register_modifier,
)
from ..spawn import SpawnerSettings
from ..values import FLOAT, INT

__all__ = [
    "LambertianLightingModifier",
    "example_2d",
    "example_circle",
    "example_puffs",
]


def _age_life(w, age=0.0, life=5.0):
    return (
        SetAttributeModifier(A.AGE, w.lit(age).expr()),
        SetAttributeModifier(A.LIFETIME, w.lit(life).expr()),
    )


def example_2d() -> EffectAsset:
    """examples/2d.rs: flat circle emitter with rounded square particles."""
    w = ExprWriter()
    age, life = _age_life(w)
    gradient = Gradient.linear((0.5, 0.5, 1.0, 1.0), (0.5, 0.5, 1.0, 0.0))
    module = w.finish()
    asset = (
        EffectAsset("2d", 4096, SpawnerSettings.rate(30.0), module)
        .init(
            SetPositionCircleModifier(
                module.lit((0.0, 0.0, 0.0)),
                module.lit((0.0, 0.0, 1.0)),
                module.lit(0.05),
                ShapeDimension.SURFACE,
            )
        )
        .init(
            SetVelocityCircleModifier(
                module.lit((0.0, 0.0, 0.0)), module.lit((0.0, 0.0, 1.0)), module.lit(0.1)
            )
        )
        .init(age)
        .init(life)
        .render(ColorOverLifetimeModifier(gradient))
        .render(
            SizeOverLifetimeModifier(Gradient.linear((0.02,), (0.06,)))
        )
        .render(RoundModifier(module.lit(2.0 / 3.0)))
    )
    asset.z_layer_2d = 0.1
    return asset


def example_circle(frame_count: int = 8) -> EffectAsset:
    """examples/circle.rs: flipbook sprite-sheet animation on a circle."""
    w = ExprWriter()
    age = SetAttributeModifier(A.AGE, w.rand(FLOAT).expr())
    life = SetAttributeModifier(A.LIFETIME, w.lit(5.0).expr())
    # sprite index animates with age
    sprite = (
        (w.attr(A.AGE) / w.attr(A.LIFETIME) * float(frame_count))
        .min(w.lit(float(frame_count - 1)))
        .cast(INT)
    )
    asset = (
        EffectAsset("circle", 4096, SpawnerSettings.rate(30.0), w.finish())
        .init(
            SetPositionCircleModifier(
                w.module.lit((0.0, 0.1, 0.0)),
                w.module.lit((0.0, 1.0, 0.0)),
                w.module.lit(0.4),
                ShapeDimension.SURFACE,
            )
        )
        .init(
            SetVelocityCircleModifier(
                w.module.lit((0.0, 0.0, 0.0)),
                w.module.lit((0.0, 1.0, 0.0)),
                (w.lit(1.0) + w.lit(0.5) * w.rand(FLOAT)).expr(),
            )
        )
        .init(age)
        .init(life)
        .update(SetAttributeModifier(A.SPRITE_INDEX, sprite.expr()))
        .render(ParticleTextureModifier(0))
        .render(FlipbookModifier((frame_count, 1)))
        .render(SetSizeModifier((0.3, 0.3, 0.3)))
    )
    return asset


@register_modifier
@dataclass
class LambertianLightingModifier(Modifier):
    """Custom user modifier from examples/puffs.rs: fake Lambertian shading
    of billboards using the camera-facing normal. Demonstrates that user
    code can define new render modifiers outside the framework."""

    light_dir: tuple = (0.0, 1.0, 0.0)
    band: float = 0.7

    CONTEXT = ModifierContext.RENDER
    ATTRIBUTES = ()

    def apply_render(self, module, ctx) -> None:
        if getattr(ctx, "mesh_has_normals", False):
            # the asset's mesh carries per-vertex normals: defer to the
            # rasterizer's per-fragment Lambert (normals vary across a mesh
            # particle; the billboard axis_z shade would flatten it)
            ctx.mesh_lighting = (tuple(self.light_dir), float(self.band))
            return
        ld = torch.as_tensor(self.light_dir, dtype=torch.float32, device=ctx.axis_z.device)
        normal = ctx.axis_z  # billboard faces the camera
        ndotl = torch.clamp(torch.sum(normal * ld, dim=-1), self.band, 1.0)
        ctx.color = torch.cat([ctx.color[:, :3] * ndotl[:, None], ctx.color[:, 3:]], dim=1)

    def to_json(self):
        return {
            "type": type(self).__name__,
            "light_dir": list(self.light_dir),
            "band": self.band,
        }

    @classmethod
    def from_json(cls, data):
        return cls(tuple(data["light_dir"]), data["band"])


def example_puffs() -> EffectAsset:
    """examples/puffs.rs: smoke puffs with custom Lambertian shading, drawn
    as an icosphere TRIANGLE MESH per particle (puffs.rs:101-110 builds a
    SphereKind::Ico mesh and attaches it via EffectMesh)."""
    from ..render.mesh import ParticleMesh

    w = ExprWriter()
    size = (w.rand(FLOAT) * 2.0 + 0.5).expr()
    return (
        EffectAsset("puffs", 4096, SpawnerSettings.burst(16.0, 0.45), w.finish())
        .with_mesh(ParticleMesh.icosphere(0.5, subdivisions=1))
        .init(
            SetPositionCircleModifier(
                w.module.lit((0.0, 0.0, 0.0)),
                w.module.lit((0.0, 0.0, 1.0)),
                w.module.lit(1.0),
                ShapeDimension.VOLUME,
            )
        )
        .init(SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
        .init(SetAttributeModifier(A.LIFETIME, w.lit(3.0).expr()))
        .init(SetAttributeModifier(A.SIZE, size))
        .init(SetVelocitySphereModifier(w.module.lit((0.0, -1.0, 0.0)), w.module.lit(1.0)))
        .render(OrientModifier(OrientMode.FACE_CAMERA_POSITION))
        .render(SetColorModifier((0.8, 0.8, 0.85, 0.6)))
        .render(LambertianLightingModifier((0.577, 0.577, 0.577), 0.7))
    )
