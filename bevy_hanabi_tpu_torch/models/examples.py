"""Re-creations of every reference example (examples/*.rs), the port of
``bevy_hanabi_tpu/models/examples.py``.

Each builder returns an :class:`EffectAsset` (or a small dict of assets for
multi-effect examples) reproducing the behavior of the corresponding
reference example through this framework's API. App-level behaviors
(activation toggling, spawn-on-command, visibility culling, multi-camera)
are exercised through :class:`~bevy_hanabi_tpu_torch.runtime.HanabiScene`.
The definitions are the JAX package's, so both packages build equal assets
(``to_json`` agrees); only the user modifier
:class:`LambertianLightingModifier` shades with torch ops.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import attributes as A
from ..asset import AlphaMode, EffectAsset
from ..cpu_value import CpuValue
from ..gradient import Gradient
from ..graph import ExprWriter
from ..modifiers import (
    AccelModifier,
    ColorOverLifetimeModifier,
    EmitSpawnEventModifier,
    EventEmitCondition,
    FlipbookModifier,
    InheritAttributeModifier,
    KillAabbModifier,
    LinearDragModifier,
    Modifier,
    ModifierContext,
    OrientMode,
    OrientModifier,
    ParticleTextureModifier,
    RoundModifier,
    SetAttributeModifier,
    ScreenSpaceSizeModifier,
    SetColorModifier,
    SetPositionCircleModifier,
    SetPositionCone3dModifier,
    SetPositionSphereModifier,
    SetSizeModifier,
    SetVelocityCircleModifier,
    SetVelocitySphereModifier,
    SetVelocityTangentModifier,
    ShapeDimension,
    SizeOverLifetimeModifier,
    TangentAccelModifier,
    register_modifier,
)
from ..spawn import SpawnerSettings
from ..values import FLOAT, INT, UINT, VEC3F, VEC4F

TAU = 6.283185307179586


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


def example_activate() -> EffectAsset:
    """examples/activate.rs: bubbles, spawner toggled on/off at runtime."""
    w = ExprWriter()
    age, life = _age_life(w)
    asset = (
        EffectAsset(
            "activate",
            4096,
            SpawnerSettings.rate(30.0).with_starts_active(False),
            w.finish(),
        )
        .init(
            SetPositionSphereModifier(
                w.module.lit((0.0, 0.0, 0.0)), w.module.lit(0.05), ShapeDimension.VOLUME
            )
        )
        .init(
            SetVelocitySphereModifier(w.module.lit((0.0, 0.0, 0.0)), w.module.lit(0.1))
        )
        .init(age)
        .init(life)
        .update(AccelModifier(w.module.lit((0.0, 0.2, 0.0))))  # buoyancy
        .update(
            KillAabbModifier(
                w.module.lit((0.0, -2.02, 0.0)), w.module.lit((2.0, 2.0, 2.0)), False
            )
        )
        .render(
            ColorOverLifetimeModifier(
                Gradient.linear((0.7, 0.9, 1.0, 0.8), (0.7, 0.9, 1.0, 0.0))
            )
        )
    )
    return asset


def example_billboard() -> EffectAsset:
    """examples/billboard.rs: camera-plane billboards with random per-particle
    in-plane rotation (stored in F32_0) and random packed COLOR."""
    w = ExprWriter()
    age, life = _age_life(w)
    color = w.rand(VEC4F).pack4x8unorm()
    rotation = (w.rand(FLOAT) * TAU).expr()
    asset = (
        EffectAsset("billboard", 8192, SpawnerSettings.rate(64.0), w.finish())
        .init(
            SetPositionCircleModifier(
                w.module.lit((0.0, 0.1, 0.0)),
                w.module.lit((0.0, 1.0, 0.0)),
                w.module.lit(1.0),
                ShapeDimension.SURFACE,
            )
        )
        .init(
            SetVelocityCircleModifier(
                w.module.lit((0.0, 0.0, 0.0)),
                w.module.lit((0.0, 1.0, 0.0)),
                (w.lit(0.5) + w.lit(0.2) * w.rand(FLOAT)).expr(),
            )
        )
        .init(age)
        .init(life)
        .init(SetAttributeModifier(A.COLOR, color.expr()))
        .init(SetAttributeModifier(A.F32_0, rotation))
        .render(
            OrientModifier(
                OrientMode.PARALLEL_CAMERA_DEPTH_PLANE,
                rotation=w.module.attr(A.F32_0),
            )
        )
        .render(SetSizeModifier((0.2, 0.2, 0.2)))
    )
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


def example_expr() -> EffectAsset:
    """examples/expr.rs: time-animated acceleration expression."""
    w = ExprWriter()
    age, _ = _age_life(w)
    life = SetAttributeModifier(A.LIFETIME, w.lit(2.5).uniform(w.lit(3.5)).expr())
    anim = (w.time() * 1.0).sin() * 6.0 - 6.0
    accel = w.lit(0.0).vec3(anim, 0.0)
    asset = (
        EffectAsset("expr", 32768, SpawnerSettings.rate(500.0), w.finish())
        .init(
            SetPositionCircleModifier(
                w.module.lit((0.0, 0.0, 0.0)),
                w.module.lit((0.0, 1.0, 0.0)),
                w.module.lit(4.0),
                ShapeDimension.SURFACE,
            )
        )
        .init(
            SetVelocityTangentModifier(
                w.module.lit((0.0, 0.0, 0.0)),
                w.module.lit((0.0, 1.0, 0.0)),
                w.module.lit(3.0),
            )
        )
        .init(age)
        .init(life)
        .update(AccelModifier(accel.expr()))
        .render(
            ColorOverLifetimeModifier(
                Gradient.linear((2.0, 0.5, 0.1, 1.0), (0.1, 0.1, 1.0, 0.0))
            )
        )
        .render(SizeOverLifetimeModifier(Gradient.linear((0.1,), (0.0,))))
    )
    return asset


_INIT_SHAPES = (
    "circle",
    "sphere",
    "cone",
)


def example_init(shape: str = "sphere") -> EffectAsset:
    """examples/init.rs: showcase each position shape modifier."""
    w = ExprWriter()
    module = w.module
    if shape == "circle":
        pos = SetPositionCircleModifier(
            module.lit((0.0, 0.0, 0.0)),
            module.lit((0.0, 0.0, 1.0)),
            module.lit(5.0),
            ShapeDimension.SURFACE,
        )
    elif shape == "sphere":
        pos = SetPositionSphereModifier(
            module.lit((0.0, 0.0, 0.0)), module.lit(5.0), ShapeDimension.VOLUME
        )
    elif shape == "cone":
        pos = SetPositionCone3dModifier(
            module.lit(10.0), module.lit(1.0), module.lit(4.0), ShapeDimension.VOLUME
        )
    else:
        raise ValueError(f"unknown shape {shape!r}; options: {_INIT_SHAPES}")
    life = SetAttributeModifier(A.LIFETIME, w.lit(1e9).expr())
    return (
        EffectAsset(f"init_{shape}", 32768, SpawnerSettings.once(8192.0), w.finish())
        .init(pos)
        .init(life)
        .render(OrientModifier(OrientMode.FACE_CAMERA_POSITION))
        .render(SetColorModifier((1.0, 1.0, 1.0, 1.0)))
        .render(SetSizeModifier((0.1, 0.1, 0.1)))
    )


def example_lifetime() -> dict:
    """examples/lifetime.rs: three burst effects, lifetime vs gradient span."""
    out = {}
    # side-by-side emitters like the reference's three entities (lifetime.rs)
    for (name, life), x in zip(
        [("short", 1.0), ("exact", 5.0), ("long", 12.0)], (-3.0, 0.0, 3.0)
    ):
        w = ExprWriter()
        g = Gradient.linear((1.0, 0.2, 0.2, 1.0), (0.2, 0.2, 1.0, 1.0))
        out[name] = (
            EffectAsset(f"lifetime_{name}", 4096, SpawnerSettings.burst(50.0, 5.0), w.finish())
            .init(
                SetPositionSphereModifier(
                    w.module.lit((x, 0.0, 0.0)), w.module.lit(0.5), ShapeDimension.VOLUME
                )
            )
            .init(
                SetVelocitySphereModifier(
                    w.module.lit((x, 0.0, 0.0)), w.module.lit(2.0)
                )
            )
            .init(SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
            .init(SetAttributeModifier(A.LIFETIME, w.lit(life).expr()))
            .render(ColorOverLifetimeModifier(g))
        )
    return out


def example_lightning(particles_per_bolt: int = 256) -> EffectAsset:
    """examples/lightning.rs: a bolt built purely from expressions over
    PARTICLE_COUNTER + a ``wave_seed`` property (expression stress test)."""
    w = ExprWriter()
    w.add_property("wave_seed", 0.0)
    n = float(particles_per_bolt)
    cells = 8  # zig-zag control points, interpolated like the reference
    idx = (w.attr(A.PARTICLE_COUNTER) % w.lit(particles_per_bolt, UINT)).cast(FLOAT)
    progress = idx / (n - 1.0)
    seed_i = ((w.prop("wave_seed") + 100.0) * 1000.0).cast(UINT)

    def cell_hash(cell_expr, mult: int, modulus: int):
        """Pseudo-random in [-1,1] per integer cell id (expression-only)."""
        h = (
            cell_expr.cast(UINT) * w.lit(mult, UINT) + seed_i * w.lit(67891, UINT)
        ) % w.lit(modulus, UINT)
        return h.cast(FLOAT) / float(modulus) * 2.0 - 1.0

    # piecewise-linear jitter: interpolate hashes of the surrounding cells
    cpos = progress * float(cells)
    c0 = cpos.floor()
    t = cpos - c0

    def jitter(mult: int, modulus: int):
        a = cell_hash(c0, mult, modulus)
        b = cell_hash(c0 + 1.0, mult, modulus)
        return a.mix(b, t)

    envelope = progress * (1.0 - progress) * 4.0
    x = jitter(12345, 10111) * 0.8 * envelope
    z = jitter(54321, 7919) * 0.4 * envelope
    y = 8.0 - progress * 8.0
    pos = x.vec3(y, z)
    bolt_life = 0.35
    return (
        EffectAsset(
            "lightning",
            particles_per_bolt * 4,
            SpawnerSettings.burst(n, bolt_life),
            w.finish(),
        )
        .init(SetAttributeModifier(A.POSITION, pos.expr()))
        .init(SetAttributeModifier(A.AGE, (idx * 0.0001).expr()))
        .init(SetAttributeModifier(A.LIFETIME, w.lit(bolt_life).expr()))
        .render(SetColorModifier((4.0, 4.0, 8.0, 1.0)))
        .render(SizeOverLifetimeModifier(Gradient.linear((0.08,), (0.0,))))
        .with_alpha_mode(AlphaMode.ADD)
    )


def example_multicam() -> EffectAsset:
    """examples/multicam.rs: one effect rendered from several cameras."""
    w = ExprWriter()
    age, life = _age_life(w)
    return (
        EffectAsset("multicam", 32768, SpawnerSettings.rate(5.0), w.finish())
        .init(
            SetPositionSphereModifier(
                w.module.lit((0.0, 0.0, 0.0)), w.module.lit(2.0), ShapeDimension.SURFACE
            )
        )
        .init(SetVelocitySphereModifier(w.module.lit((0.0, 0.0, 0.0)), w.module.lit(6.0)))
        .init(age)
        .init(life)
        .update(AccelModifier(w.module.lit((0.0, -3.0, 0.0))))
        .render(
            ColorOverLifetimeModifier(
                Gradient.linear((1.0, 1.0, 0.0, 1.0), (1.0, 0.0, 0.0, 0.0))
            )
        )
        .render(SizeOverLifetimeModifier(Gradient.linear((0.1,), (0.3,))))
    )


def example_ordering() -> EffectAsset:
    """examples/ordering.rs: fast radial burst with drag, tests blend order."""
    w = ExprWriter()
    return (
        EffectAsset("ordering", 2048, SpawnerSettings.rate(128.0), w.finish())
        .init(
            SetPositionSphereModifier(
                w.module.lit((0.0, 0.0, 0.0)), w.module.lit(2.0), ShapeDimension.VOLUME
            )
        )
        .init(
            SetVelocitySphereModifier(
                w.module.lit((0.0, 0.0, 0.0)),
                (w.rand(FLOAT) * 20.0 + 60.0).expr(),
            )
        )
        .init(SetAttributeModifier(A.AGE, w.lit(0.0).uniform(w.lit(0.2)).expr()))
        .init(SetAttributeModifier(A.LIFETIME, w.lit(2.0).uniform(w.lit(3.0)).expr()))
        .update(LinearDragModifier(w.module.lit(5.0)))
        .update(AccelModifier(w.module.lit((0.0, -8.0, 0.0))))
        .render(
            ColorOverLifetimeModifier(
                Gradient.linear((4.0, 3.0, 1.0, 1.0), (1.0, 0.1, 0.1, 0.0))
            )
        )
        .render(SizeOverLifetimeModifier(Gradient.linear((0.05,), (0.12,))))
        .with_alpha_mode(AlphaMode.BLEND)
    )


def example_portal() -> EffectAsset:
    """examples/portal.rs: circle rim + tangent acceleration + AlongVelocity."""
    w = ExprWriter()
    return (
        EffectAsset("portal", 16384, SpawnerSettings.rate(5000.0), w.finish())
        .init(
            SetPositionCircleModifier(
                w.module.lit((0.0, 0.0, 0.0)),
                w.module.lit((0.0, 0.0, 1.0)),
                w.module.lit(4.0),
                ShapeDimension.SURFACE,
            )
        )
        .init(SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
        .init(SetAttributeModifier(A.LIFETIME, w.lit(0.6).uniform(w.lit(1.3)).expr()))
        .init(SetAttributeModifier(A.VELOCITY, w.lit((0.0, 0.0, 0.0)).expr()))
        .update(LinearDragModifier(w.module.lit(2.0)))
        .update(
            TangentAccelModifier(
                w.module.lit((0.0, 0.0, 0.0)), w.module.lit((0.0, 0.0, 1.0)), w.module.lit(30.0)
            )
        )
        .render(OrientModifier(OrientMode.ALONG_VELOCITY))
        .render(
            ColorOverLifetimeModifier(
                Gradient.linear((4.0, 2.0, 8.0, 1.0), (2.0, 0.0, 4.0, 0.0))
            )
        )
        .render(SizeOverLifetimeModifier(Gradient.linear((0.06,), (0.0,))))
        .with_alpha_mode(AlphaMode.ADD)
    )


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


def example_random() -> EffectAsset:
    """examples/random.rs: burst with random count AND random period."""
    w = ExprWriter()
    age, life = _age_life(w)
    return (
        EffectAsset(
            "random",
            8192,
            SpawnerSettings.burst(CpuValue.uniform(1.0, 100.0), CpuValue.uniform(1.0, 4.0)),
            w.finish(),
        )
        .init(
            SetPositionSphereModifier(
                w.module.lit((0.0, 0.0, 0.0)), w.module.lit(0.5), ShapeDimension.VOLUME
            )
        )
        .init(SetVelocitySphereModifier(w.module.lit((0.0, 0.0, 0.0)), w.module.lit(2.0)))
        .init(age)
        .init(life)
        .update(AccelModifier(w.module.lit((0.0, -3.0, 0.0))))
        .render(
            ColorOverLifetimeModifier(
                Gradient.linear((0.7, 0.7, 1.0, 1.0), (0.7, 0.7, 1.0, 0.0))
            )
        )
    )


def example_ribbon() -> EffectAsset:
    """examples/ribbon.rs: one continuous ribbon trailing a moving emitter.

    The emitter position animates via an expression of time (the reference
    moves the Transform on the CPU; here the expression graph does it)."""
    w = ExprWriter()
    t = w.time()
    pos = (t * 3.0).sin().vec3((t * 2.0).cos(), (t * 1.5).sin() * 0.5)
    return (
        EffectAsset("ribbon", 512, SpawnerSettings.rate(60.0), w.finish())
        .init(SetAttributeModifier(A.POSITION, pos.expr()))
        .init(SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
        .init(SetAttributeModifier(A.LIFETIME, w.lit(1.5).expr()))
        .init(SetAttributeModifier(A.SIZE, w.lit(0.08).expr()))
        .init(SetAttributeModifier(A.RIBBON_ID, w.lit(0, UINT).expr()))
        .render(
            ColorOverLifetimeModifier(
                Gradient.linear((3.0, 0.0, 0.0, 1.0), (3.0, 0.0, 0.0, 0.0))
            )
        )
        .render(SizeOverLifetimeModifier(Gradient.linear((1.0,), (0.0,))))
        .with_alpha_mode(AlphaMode.ADD)
    )


def example_spawn_on_command() -> EffectAsset:
    """examples/spawn_on_command.rs: inactive once-spawner triggered by
    reset(); spawn color and surface normal are properties."""
    w = ExprWriter()
    w.add_property("spawn_color", 0xFFFFFFFF)
    w.add_property("normal", (0.0, 1.0, 0.0))
    normal = w.prop("normal")
    pos = normal * 0.1
    spread = w.rand(FLOAT) * 2.0 - 1.0
    speed = w.rand(FLOAT) * 0.2
    tangent = normal.cross(w.lit((0.0, 0.0, 1.0)))
    velocity = (normal + tangent * spread * 0.5) * speed
    return (
        EffectAsset(
            "spawn_on_command",
            32768,
            SpawnerSettings.once(100.0).with_starts_active(False),
            w.finish(),
        )
        .init(SetAttributeModifier(A.POSITION, pos.expr()))
        .init(SetAttributeModifier(A.VELOCITY, velocity.expr()))
        .init(SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
        .init(SetAttributeModifier(A.LIFETIME, w.lit(5.0).expr()))
        .init(SetAttributeModifier(A.COLOR, w.prop("spawn_color").expr()))
        # 3 logical pixels, constant in screen space (spawn_on_command.rs:144-148)
        .render(SetSizeModifier(3.0))
        .render(ScreenSpaceSizeModifier())
    )


def example_visibility() -> EffectAsset:
    """examples/visibility.rs: WhenVisible vs Always simulation conditions."""
    w = ExprWriter()
    age, life = _age_life(w)
    return (
        EffectAsset("visibility", 4096, SpawnerSettings.burst(50.0, 15.0), w.finish())
        .init(
            SetPositionSphereModifier(
                w.module.lit((0.0, 0.0, 0.0)), w.module.lit(0.5), ShapeDimension.VOLUME
            )
        )
        .init(SetAttributeModifier(A.VELOCITY, w.lit((3.0, 0.0, 0.0)).expr()))
        .init(age)
        .init(life)
        .render(
            ColorOverLifetimeModifier(
                Gradient.linear((1.0, 1.0, 1.0, 1.0), (1.0, 1.0, 1.0, 0.0))
            )
        )
    )


def example_worms() -> dict:
    """examples/worms.rs: head particles emitting ribbon-trail children that
    inherit position; ribbon id from the parent's particle counter."""
    wh = ExprWriter()
    head_pos = (wh.rand(VEC3F) + wh.lit((-0.5, -0.5, 0.0))) * 8.0
    heads = (
        EffectAsset("worm_heads", 128, SpawnerSettings.rate(2.0), wh.finish())
        .init(SetAttributeModifier(A.POSITION, head_pos.expr()))
        .init(SetAttributeModifier(A.AGE, wh.lit(0.0).expr()))
        .init(SetAttributeModifier(A.LIFETIME, wh.lit(3.0).expr()))
        .init(
            SetAttributeModifier(
                A.VELOCITY, (wh.rand(VEC3F) * 2.0 - 1.0).expr()
            )
        )
        # expose PARTICLE_COUNTER in the head layout so bodies can inherit it
        .init(SetAttributeModifier(A.U32_0, wh.attr(A.PARTICLE_COUNTER).expr()))
        .update(
            EmitSpawnEventModifier(
                EventEmitCondition.ALWAYS, wh.module.lit(1, UINT), 0
            )
        )
        .render(SetSizeModifier((0.12, 0.12, 0.12)))
    )
    wb = ExprWriter()
    body = (
        EffectAsset("worm_bodies", 8192, SpawnerSettings.once(0.0), wb.finish())
        .init(InheritAttributeModifier(A.POSITION))
        .init(SetAttributeModifier(A.AGE, wb.lit(0.0).expr()))
        .init(SetAttributeModifier(A.LIFETIME, wb.lit(0.75).expr()))
        .init(SetAttributeModifier(A.SIZE, wb.lit(0.1).expr()))
        .init(
            SetAttributeModifier(A.RIBBON_ID, wb.parent_attr(A.PARTICLE_COUNTER).expr())
        )
        .render(
            ColorOverLifetimeModifier(
                Gradient.linear((0.2, 1.0, 0.3, 1.0), (0.2, 1.0, 0.3, 0.0))
            )
        )
    )
    return {"heads": heads, "bodies": body}


def example_mesh_path() -> EffectAsset:
    """A custom-mesh effect carrying a Bevy mesh AssetPath (asset.rs:335):
    the path survives RON round-trips opaquely (golden-pinned) while the
    TPU render side would pair it with a ParticleMesh for geometry."""
    w = ExprWriter()
    age, life = _age_life(w, life=3.0)
    module = w.finish()
    asset = (
        EffectAsset("mesh_path", 1024, SpawnerSettings.rate(64.0), module)
        .init(
            SetAttributeModifier(A.POSITION, module.lit((0.0, 0.0, 0.0)))
        )
        .init(
            SetAttributeModifier(A.VELOCITY, module.lit((0.0, 1.0, 0.0)))
        )
        .init(age)
        .init(life)
        .render(SetColorModifier((0.8, 0.8, 1.0, 1.0)))
    )
    return asset.with_mesh_asset_path("shapes.glb#Mesh0/Primitive0")


def examples_registry() -> dict:
    """name -> zero-arg builder for every re-created example."""
    return {
        "2d": example_2d,
        "activate": example_activate,
        "billboard": example_billboard,
        "circle": example_circle,
        "expr": example_expr,
        "init_circle": lambda: example_init("circle"),
        "init_sphere": lambda: example_init("sphere"),
        "init_cone": lambda: example_init("cone"),
        "lifetime": example_lifetime,
        "lightning": example_lightning,
        "mesh_path": example_mesh_path,
        "multicam": example_multicam,
        "ordering": example_ordering,
        "portal": example_portal,
        "puffs": example_puffs,
        "random": example_random,
        "ribbon": example_ribbon,
        "spawn_on_command": example_spawn_on_command,
        "visibility": example_visibility,
        "worms": example_worms,
    }
