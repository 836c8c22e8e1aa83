"""Ported benchmark effects."""

from .benchmarks import gradient_effect  # noqa: F401
