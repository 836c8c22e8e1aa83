"""Ported benchmark effects."""

from .benchmarks import firework_effect, firework_trail_effect, gradient_effect  # noqa: F401
