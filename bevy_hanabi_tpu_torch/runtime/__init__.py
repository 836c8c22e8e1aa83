"""Pools, compiled effects, instanced groups, event buffers and the scene."""

from .pool import ParticlePool  # noqa: F401
from .effect import CompiledEffect, StepInputs  # noqa: F401
from .events import EventBuffer  # noqa: F401
from .instanced import InstancedEffect  # noqa: F401
from .scene import EffectInstance, HanabiScene  # noqa: F401
