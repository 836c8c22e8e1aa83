"""Ported benchmark effects, reference examples and texture helpers."""

from .benchmarks import (  # noqa: F401
    debris_effect,
    firework_effect,
    firework_trail_effect,
    force_field_effect,
    gradient_effect,
    instancing_effect,
    ribbon_bench_effect,
    ribbon_order_check_effect,
    spawn_gravity_effect,
    textured_mesh_check_effect,
)
from .examples import (  # noqa: F401
    LambertianLightingModifier,
    example_2d,
    example_activate,
    example_billboard,
    example_circle,
    example_expr,
    example_init,
    example_lifetime,
    example_lightning,
    example_mesh_path,
    example_multicam,
    example_ordering,
    example_portal,
    example_puffs,
    example_random,
    example_ribbon,
    example_spawn_on_command,
    example_visibility,
    example_worms,
    examples_registry,
)
from .texutils import make_anim_sprite_sheet, make_circle_texture, make_cloud_texture  # noqa: F401
