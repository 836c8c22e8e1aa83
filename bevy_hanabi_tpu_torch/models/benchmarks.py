"""Benchmark effects (port of ``bevy_hanabi_tpu/models/benchmarks.py``).

Ported so far: ``gradient_effect`` (the benchmark headline's effect),
``spawn_gravity_effect`` (the opaque effect of the painter device gate),
``force_field_effect`` (the attractor and kill box of BASELINE config 3),
the firework event tree, ``firework_effect`` with its trail child
``firework_trail_effect``, ``debris_effect`` (the opaque member of the
JAX package's mixed-blend scene, bench.py:702-723), the ribbon effects ``ribbon_bench_effect``
and ``ribbon_order_check_effect``, the textured-mesh gate's
``textured_mesh_check_effect``, and ``instancing_effect``, the per-instance
effect of the instanced benchmark (hundreds of instances through
``InstancedEffect``). The definitions are the JAX package's, so both
packages build equal assets (``to_json`` agrees).
"""

from __future__ import annotations

from .. import VEC3F
from .. import attributes as A
from ..asset import AlphaMode, EffectAsset, SimulationCondition
from ..gradient import Gradient
from ..graph import ExprWriter
from ..modifiers import (
    AccelModifier,
    ColorOverLifetimeModifier,
    ConformToSphereModifier,
    EmitSpawnEventModifier,
    EventEmitCondition,
    InheritAttributeModifier,
    KillAabbModifier,
    LinearDragModifier,
    OrientMode,
    OrientModifier,
    SetAttributeModifier,
    SetPositionSphereModifier,
    SetSizeModifier,
    SetVelocitySphereModifier,
    ShapeDimension,
    SizeOverLifetimeModifier,
)
from ..spawn import SpawnerSettings
from ..values import FLOAT, UINT

__all__ = [
    "spawn_gravity_effect",
    "gradient_effect",
    "force_field_effect",
    "firework_effect",
    "firework_trail_effect",
    "debris_effect",
    "ribbon_bench_effect",
    "ribbon_order_check_effect",
    "textured_mesh_check_effect",
    "instancing_effect",
]


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


def force_field_effect(capacity: int = 100_000) -> EffectAsset:
    """BASELINE config 3 (examples/force_field.rs): conform-to-sphere
    attractor + kill-AABB, 100k particles."""
    w = ExprWriter()
    w.add_property("attractor", (0.0, 1.0, 0.0))
    return (
        EffectAsset(
            "force_field", capacity, SpawnerSettings.rate(capacity / 4.0), w.finish()
        )
        .init(SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
        .init(SetAttributeModifier(A.LIFETIME, w.lit(4.0).expr()))
        .init(
            SetPositionSphereModifier(
                w.lit((0.0, -2.0, 0.0)).expr(), w.lit(0.4).expr(), ShapeDimension.VOLUME
            )
        )
        .init(
            SetVelocitySphereModifier(
                w.lit((0.0, -2.0, 0.0)).expr(), w.lit(3.0).uniform(w.lit(5.0)).expr()
            )
        )
        .update(
            ConformToSphereModifier(
                w.prop("attractor").expr(),
                w.lit(1.0).expr(),
                w.lit(10.0).expr(),
                w.lit(30.0).expr(),
                w.lit(5.0).expr(),
            )
        )
        .update(LinearDragModifier(w.lit(1.0).expr()))
        .update(
            KillAabbModifier(
                w.lit((0.0, 0.0, 0.0)).expr(), w.lit((8.0, 8.0, 8.0)).expr(), False
            )
        )
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


def debris_effect(capacity: int = 65536) -> EffectAsset:
    """The opaque debris of the JAX package's mixed-blend scene
    (bench.py:702-723): spawned in a ball of radius 3, moving away from its
    centre at 1 unit a second, living 4 s, HDR orange, size 0.05, OPAQUE;
    a quarter of the pool spawned a second."""
    w = ExprWriter()
    return (
        EffectAsset("debris", capacity, SpawnerSettings.rate(capacity / 4.0), w.finish())
        .init(
            SetPositionSphereModifier(
                w.module.lit((0.0, 0.0, 0.0)), w.module.lit(3.0), ShapeDimension.VOLUME
            )
        )
        .init(SetVelocitySphereModifier(w.module.lit((0.0, 0.0, 0.0)), w.module.lit(1.0)))
        .init(SetAttributeModifier(A.LIFETIME, w.lit(4.0).expr()))
        .init(SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
        .init(SetAttributeModifier(A.HDR_COLOR, w.lit((0.9, 0.6, 0.2, 1.0)).expr()))
        .render(SetSizeModifier((0.05,) * 3))
        .with_alpha_mode(AlphaMode.OPAQUE)
    )


def ribbon_bench_effect(
    capacity: int = 1 << 20, num_ribbons: int = 4096
) -> EffectAsset:
    """BASELINE config 5, ribbon half (examples/ribbon.rs at scale): a
    steady-churn pool whose particles chain into ``num_ribbons`` trails.

    Each spawn joins ribbon ``PARTICLE_COUNTER % num_ribbons``; ribbons fan
    out from a circle and drift, so segments exercise the real sorted
    (RIBBON_ID, AGE, COUNTER) adjacency path the reference implements with
    a single-threaded GPU insertion sort (vfx_sort.wgsl:33-39) — its one
    self-declared perf cliff."""
    import math

    w = ExprWriter()
    rid = w.attr(A.PARTICLE_COUNTER) % w.lit(num_ribbons, UINT)
    angle = rid.cast(FLOAT) * (2.0 * math.pi / num_ribbons)
    origin = (angle.cos() * 3.0).vec3(angle.sin() * 3.0, w.lit(0.0))
    return (
        EffectAsset(
            "ribbon_bench",
            capacity,
            SpawnerSettings.rate(capacity / 4.0 * 1.05),
            w.finish(),
        )
        .init(SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
        .init(SetAttributeModifier(A.LIFETIME, w.lit(4.0).expr()))
        .init(SetAttributeModifier(A.RIBBON_ID, rid.expr()))
        .init(SetAttributeModifier(A.POSITION, origin.expr()))
        .init(
            SetAttributeModifier(
                A.VELOCITY,
                ((w.rand(VEC3F) * 2.0 - w.lit((1.0, 1.0, 1.0))) * 0.4).expr(),
            )
        )
        .render(SetSizeModifier((0.04, 0.04, 0.04)))
        .with_alpha_mode(AlphaMode.ADD)
    )


def ribbon_order_check_effect(
    capacity: int = 8192, num_ribbons: int = 64
) -> EffectAsset:
    """Device-gate variant of ``ribbon_bench_effect`` with NO
    transcendentals: init math is PCG rand (bit-exact across backends,
    ops/rng.py) plus mul/add only, so a rendered TPU frame is
    bit-comparable to the CPU frame and the gate certifies the
    (RIBBON_ID, AGE, COUNTER) segment sort ORDER — a TPU-vs-CPU delta
    here means dropped/duplicated/mis-ordered segments, not VPU sin/cos
    ULP noise. (``ribbon_bench_effect``'s cos/sin fan origins shift
    positions ~1e-3 rel between backends, flipping pixel coverage at
    quad edges; transcendental drift is certified separately by the
    trajectory device check with rtol.) Ribbons fan from a line with a
    linear depth stagger so trails stay distinct and overlap across
    tiles."""
    w = ExprWriter()
    rid = w.attr(A.PARTICLE_COUNTER) % w.lit(num_ribbons, UINT)
    ridf = rid.cast(FLOAT)
    origin = (ridf * (4.0 / num_ribbons) - 2.0).vec3(
        ridf * (2.0 / num_ribbons) - 1.0,
        ridf * (1.0 / num_ribbons),
    )
    return (
        EffectAsset(
            "ribbon_order_check",
            capacity,
            SpawnerSettings.rate(capacity / 4.0 * 1.05),
            w.finish(),
        )
        .init(SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
        .init(SetAttributeModifier(A.LIFETIME, w.lit(4.0).expr()))
        .init(SetAttributeModifier(A.RIBBON_ID, rid.expr()))
        .init(SetAttributeModifier(A.POSITION, origin.expr()))
        .init(
            SetAttributeModifier(
                A.VELOCITY,
                ((w.rand(VEC3F) * 2.0 - w.lit((1.0, 1.0, 1.0))) * 0.4).expr(),
            )
        )
        .render(SetSizeModifier((0.04, 0.04, 0.04)))
        .with_alpha_mode(AlphaMode.ADD)
    )


def textured_mesh_check_effect(capacity: int = 2048) -> EffectAsset:
    """Device-gate effect for the triangle-mesh + texture raster path,
    transcendental-free for the same reason as
    ``ribbon_order_check_effect``: cube-volume rand positions and linear
    rand velocities (bit-exact PCG + mul/add) instead of
    ``gradient_effect``'s sphere init (sphere sampling runs device
    sin/cos whose ~1e-3 backend ULP drift flips triangle-edge pixel
    coverage — measured 11 flipped pixels on a 31-pixel scene = an 8.5%
    checksum delta that says nothing about the raster). Attach a mesh
    and ParticleTextureModifier at the call site."""
    w = ExprWriter()
    color = (
        Gradient()
        .with_key(0.0, (1.0, 0.2, 0.2, 1.0))
        .with_key(1.0, (0.2, 0.2, 1.0, 0.6))
    )
    return (
        EffectAsset(
            "textured_mesh_check",
            capacity,
            SpawnerSettings.rate(capacity / 5.0),
            w.finish(),
        )
        .init(SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
        .init(SetAttributeModifier(A.LIFETIME, w.lit(5.0).expr()))
        .init(
            SetAttributeModifier(
                A.POSITION,
                ((w.rand(VEC3F) * 2.0 - w.lit((1.0, 1.0, 1.0))) * 1.5).expr(),
            )
        )
        .init(
            SetAttributeModifier(
                A.VELOCITY,
                ((w.rand(VEC3F) * 2.0 - w.lit((1.0, 1.0, 1.0))) * 0.5).expr(),
            )
        )
        .render(ColorOverLifetimeModifier(color))
        .with_alpha_mode(AlphaMode.BLEND)
    )


def instancing_effect(capacity: int = 4096) -> EffectAsset:
    """BASELINE config 5 (examples/instancing.rs): small per-instance effect,
    stepped as hundreds of instances via InstancedEffect (1M+ total)."""
    w = ExprWriter()
    color = Gradient.linear((1.0, 1.0, 1.0, 1.0), (0.2, 0.2, 1.0, 0.0))
    return (
        EffectAsset("instancing", capacity, SpawnerSettings.rate(capacity / 3.0), w.finish())
        .init(SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
        .init(SetAttributeModifier(A.LIFETIME, w.lit(3.0).expr()))
        .init(
            SetPositionSphereModifier(
                w.lit((0.0, 0.0, 0.0)).expr(), w.lit(0.3).expr(), ShapeDimension.VOLUME
            )
        )
        .init(
            SetVelocitySphereModifier(
                w.lit((0.0, 0.0, 0.0)).expr(), w.lit(0.5).uniform(w.lit(1.0)).expr()
            )
        )
        .update(AccelModifier(w.lit((0.0, 1.0, 0.0)).expr()))
        .render(ColorOverLifetimeModifier(color))
        .with_simulation_condition(SimulationCondition.ALWAYS)
    )
