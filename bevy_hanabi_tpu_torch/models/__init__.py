"""Ported benchmark effects."""

from .benchmarks import (  # noqa: F401
    firework_effect,
    firework_trail_effect,
    force_field_effect,
    gradient_effect,
    ribbon_bench_effect,
    ribbon_order_check_effect,
    spawn_gravity_effect,
)
