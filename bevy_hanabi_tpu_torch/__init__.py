"""bevy_hanabi_tpu_torch — the PyTorch + CUDA port of ``bevy_hanabi_tpu``.

A second package beside the JAX one, which stays the reference. It imports
``torch`` and never ``jax``: the authoring layer (values, attributes,
expression graph, modifiers' data, assets, spawners) is a copy of the JAX
package's jax-free modules, and an asset crosses between the packages as
JSON (``EffectAsset.from_json(jax_asset.to_json())``).

The ported slice is the benchmark headline frame: ``gradient_effect``
stepped by :class:`CompiledEffect` and rendered by the tile rasterizer
(``tile_slots=1``, ``blend``), whose hot regions are hand-written CUDA
kernels for Hopper (``csrc/``, built on first use). Every device tensor
lives where ``CompiledEffect(asset, device=...)`` puts it.
"""

from .values import (  # noqa: F401
    BOOL,
    FLOAT,
    INT,
    UINT,
    VEC2F,
    VEC3F,
    VEC4F,
    as_value,
)
from .attributes import Attribute, ParticleLayout  # noqa: F401
from .asset import (  # noqa: F401
    AlphaMode,
    EffectAsset,
    MotionIntegration,
    SimulationCondition,
    SimulationSpace,
)
from .compiler import SimParams  # noqa: F401
from .cpu_value import CpuValue  # noqa: F401
from .gradient import Gradient, GradientKey  # noqa: F401
from .graph import ExprWriter, Module  # noqa: F401
from .spawn import EffectSpawner, SpawnerSettings  # noqa: F401
from . import modifiers  # noqa: F401
from .modifiers import *  # noqa: F401,F403
from .runtime.effect import CompiledEffect, StepInputs  # noqa: F401
from .runtime.pool import ParticlePool  # noqa: F401
from .render.camera import CameraParams, look_at, perspective  # noqa: F401
from .render.raster import RasterConfig, rasterize  # noqa: F401
