"""Ported benchmark effects, reference examples and texture helpers."""

from .benchmarks import (  # noqa: F401
    firework_effect,
    firework_trail_effect,
    force_field_effect,
    gradient_effect,
    ribbon_bench_effect,
    ribbon_order_check_effect,
    spawn_gravity_effect,
    textured_mesh_check_effect,
)
from .examples import (  # noqa: F401
    LambertianLightingModifier,
    example_2d,
    example_circle,
    example_puffs,
)
from .texutils import make_anim_sprite_sheet, make_circle_texture, make_cloud_texture  # noqa: F401
