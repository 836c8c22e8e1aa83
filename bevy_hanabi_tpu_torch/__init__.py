"""bevy_hanabi_tpu_torch — the PyTorch + CUDA port of ``bevy_hanabi_tpu``.

A second package beside the JAX one, which stays the reference. It imports
``torch`` and never ``jax``: the authoring layer (values, attributes,
expression graph, modifiers' data, assets, spawners) is a copy of the JAX
package's jax-free modules, and an asset crosses between the packages as
JSON (``EffectAsset.from_json(jax_asset.to_json())``).

Ported so far: the benchmark headline frame (``gradient_effect`` stepped by
:class:`CompiledEffect` and rendered by the tile rasterizer in each of its
binnings, ``tile_slots`` 0, 1 and 2, ``blend``), the force field
(``force_field_effect``: the attractor, drag and kill box), the firework
event tree (``firework_effect`` →
``firework_trail_effect`` through :class:`HanabiScene`'s ``add``,
``update``, ``update_chunk`` and ``render``, GPU spawn events, ``add``
blending), the mixed scene (opaque and mask particles, the depth test, the
painter and phase-split pipelines, ``update_render_chunk``), ribbons
(``render/ribbon.py``: sorted segment quads, round and textured), instanced
groups (:class:`InstancedEffect`, ``HanabiScene.add_group``), every
reference example (``models/examples.py``) and sharding over a mesh of
devices driven by one process (``parallel/``: :class:`ShardedEffect`,
:class:`ShardedRenderer`, ``CompiledEffect(mesh=)``,
``HanabiScene.add(mesh=)`` and ``add_sharded_group``). The hot regions are hand-written CUDA kernels for Hopper
(``csrc/``, built on first use). Every device tensor lives where
``CompiledEffect(asset, device=...)`` or ``HanabiScene(device=...)`` puts
it.
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
from .properties import EffectProperties, Property  # noqa: F401
from .time import EffectSimulationClock  # noqa: F401
from .cpu_value import CpuValue  # noqa: F401
from .gradient import Gradient, GradientKey  # noqa: F401
from .graph import ExprWriter, Module  # noqa: F401
from .spawn import EffectSpawner, SpawnerSettings  # noqa: F401
from . import modifiers  # noqa: F401
from .modifiers import *  # noqa: F401,F403
from .runtime.effect import CompiledEffect, StepInputs  # noqa: F401
from .runtime.instanced import InstancedEffect  # noqa: F401
from .runtime.pool import ParticlePool  # noqa: F401
from .runtime.events import EventBuffer  # noqa: F401
from .runtime.scene import EffectInstance, HanabiScene  # noqa: F401
from .render.camera import CameraParams, look_at, perspective  # noqa: F401
from .render.raster import RasterConfig, rasterize  # noqa: F401
from .render.renderer import EffectRenderer  # noqa: F401
from .parallel.mesh import Mesh, ShardedEffect, make_mesh  # noqa: F401
from .parallel.render import ShardedRenderer  # noqa: F401
