"""Benchmark effects (port of ``bevy_hanabi_tpu/models/benchmarks.py``).

Only ``gradient_effect``, the benchmark headline's effect, is ported; the
definition is the JAX package's, so both packages build equal assets
(``to_json`` agrees).
"""

from __future__ import annotations

from .. import attributes as A
from ..asset import AlphaMode, EffectAsset
from ..gradient import Gradient
from ..graph import ExprWriter
from ..modifiers import (
    ColorOverLifetimeModifier,
    OrientMode,
    OrientModifier,
    SetAttributeModifier,
    SetPositionSphereModifier,
    SetVelocitySphereModifier,
    ShapeDimension,
    SizeOverLifetimeModifier,
)
from ..spawn import SpawnerSettings

__all__ = ["gradient_effect"]


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
