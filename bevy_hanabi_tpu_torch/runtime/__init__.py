"""Pools and compiled effects."""

from .pool import ParticlePool  # noqa: F401
from .effect import CompiledEffect, StepInputs  # noqa: F401
