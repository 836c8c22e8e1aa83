"""Benchmark effects (port of ``bevy_hanabi_tpu/models/benchmarks.py``).

Ported so far: ``gradient_effect`` (the benchmark headline's effect),
``spawn_gravity_effect`` (the opaque effect of the painter device gate) and
the firework event tree, ``firework_effect`` with its trail child
``firework_trail_effect``. The definitions are the JAX package's, so both
packages build equal assets (``to_json`` agrees).
"""

from __future__ import annotations

from .. import VEC3F
from .. import attributes as A
from ..asset import AlphaMode, EffectAsset
from ..gradient import Gradient
from ..graph import ExprWriter
from ..modifiers import (
    AccelModifier,
    ColorOverLifetimeModifier,
    EmitSpawnEventModifier,
    EventEmitCondition,
    InheritAttributeModifier,
    LinearDragModifier,
    OrientMode,
    OrientModifier,
    SetAttributeModifier,
    SetPositionSphereModifier,
    SetVelocitySphereModifier,
    ShapeDimension,
    SizeOverLifetimeModifier,
)
from ..spawn import SpawnerSettings

__all__ = ["spawn_gravity_effect", "gradient_effect", "firework_effect", "firework_trail_effect"]


def spawn_gravity_effect(capacity: int = 32768, rate: float = 8192.0) -> EffectAsset:
    """BASELINE config 1 (examples/spawn.rs): rate spawner + gravity."""
    w = ExprWriter()
    w.add_property("gravity", (0.0, -3.0, 0.0))
    return (
        EffectAsset("spawn", capacity, SpawnerSettings.rate(rate), w.finish())
        .init(SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
        .init(SetAttributeModifier(A.LIFETIME, w.lit(4.0).expr()))
        .init(
            SetPositionSphereModifier(
                w.lit((0.0, 0.0, 0.0)).expr(), w.lit(0.5).expr(), ShapeDimension.VOLUME
            )
        )
        .init(
            SetVelocitySphereModifier(
                w.lit((0.0, 0.0, 0.0)).expr(), w.lit(2.0).uniform(w.lit(4.0)).expr()
            )
        )
        .update(AccelModifier(w.prop("gravity").expr()))
    )


def gradient_effect(capacity: int = 32768) -> EffectAsset:
    """BASELINE config 2 (examples/gradient.rs): sphere init + radial velocity
    + ColorOverLifetime, billboard render."""
    w = ExprWriter()
    color = (
        Gradient()
        .with_key(0.0, (1.0, 0.0, 0.0, 1.0))
        .with_key(0.5, (1.0, 1.0, 0.0, 1.0))
        .with_key(1.0, (0.0, 0.0, 1.0, 0.0))
    )
    return (
        EffectAsset("gradient", capacity, SpawnerSettings.rate(capacity / 5.0), w.finish())
        .init(SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
        .init(SetAttributeModifier(A.LIFETIME, w.lit(5.0).expr()))
        .init(
            SetPositionSphereModifier(
                w.lit((0.0, 0.0, 0.0)).expr(), w.lit(1.0).expr(), ShapeDimension.SURFACE
            )
        )
        .init(
            SetVelocitySphereModifier(w.lit((0.0, 0.0, 0.0)).expr(), w.lit(2.0).expr())
        )
        .render(OrientModifier(OrientMode.PARALLEL_CAMERA_DEPTH_PLANE))
        .render(ColorOverLifetimeModifier(color))
        .render(SizeOverLifetimeModifier(Gradient.linear((0.1,), (0.02,))))
        .with_alpha_mode(AlphaMode.BLEND)
    )


def firework_effect(capacity: int = 65536) -> EffectAsset:
    """BASELINE config 4 (examples/firework.rs): rocket burst + HDR colors +
    size/color gradients + drag; emits OnDie events for a trail child."""
    w = ExprWriter()
    color = (
        Gradient()
        .with_key(0.0, (4.0, 4.0, 4.0, 1.0))  # HDR white flash
        .with_key(0.1, (4.0, 2.0, 0.0, 1.0))
        .with_key(0.7, (2.0, 0.2, 0.0, 1.0))
        .with_key(1.0, (0.5, 0.0, 0.0, 0.0))
    )
    size = Gradient.linear((0.06,), (0.01,))
    return (
        EffectAsset("firework", capacity, SpawnerSettings.burst(2048.0, 2.0), w.finish())
        .init(SetAttributeModifier(A.AGE, w.lit(0.0).uniform(w.lit(0.2)).expr()))
        .init(SetAttributeModifier(A.LIFETIME, w.lit(0.8).uniform(w.lit(1.4)).expr()))
        .init(
            SetPositionSphereModifier(
                w.lit((0.0, 3.0, 0.0)).expr(), w.lit(0.25).expr(), ShapeDimension.VOLUME
            )
        )
        .init(
            SetVelocitySphereModifier(
                w.lit((0.0, 3.0, 0.0)).expr(), w.lit(5.0).uniform(w.lit(9.0)).expr()
            )
        )
        .update(AccelModifier(w.lit((0.0, -6.0, 0.0)).expr()))
        .update(LinearDragModifier(w.lit(4.0).expr()))
        .update(
            EmitSpawnEventModifier(EventEmitCondition.ON_DIE, w.module.lit(4, None), 0)
        )
        .render(OrientModifier(OrientMode.PARALLEL_CAMERA_DEPTH_PLANE))
        .render(ColorOverLifetimeModifier(color))
        .render(SizeOverLifetimeModifier(size))
        .with_alpha_mode(AlphaMode.ADD)
    )


def firework_trail_effect(capacity: int = 262144) -> EffectAsset:
    """Trail child for :func:`firework_effect` (consumes OnDie events)."""
    w = ExprWriter()
    color = Gradient.linear((3.0, 2.0, 1.0, 1.0), (0.0, 0.0, 0.0, 0.0))
    return (
        EffectAsset("firework_trail", capacity, SpawnerSettings.once(0.0), w.finish())
        .init(InheritAttributeModifier(A.POSITION))
        .init(SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
        .init(SetAttributeModifier(A.LIFETIME, w.lit(0.3).uniform(w.lit(0.6)).expr()))
        # random drift direction (a velocity-sphere centered at the particle's
        # own position has zero radial length and would degenerate to rest)
        .init(
            SetAttributeModifier(
                A.VELOCITY,
                (
                    (w.rand(VEC3F) * w.lit(2.0) - w.lit((1.0, 1.0, 1.0)))
                    * w.lit(0.2).uniform(w.lit(0.6))
                ).expr(),
            )
        )
        .render(ColorOverLifetimeModifier(color))
        .render(SizeOverLifetimeModifier(Gradient.linear((0.02,), (0.0,))))
        .with_alpha_mode(AlphaMode.ADD)
    )
