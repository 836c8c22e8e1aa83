"""Effect asset: the serializable description of a particle effect.

TPU-native re-design of ``bevy_hanabi/src/asset.rs``. An
:class:`EffectAsset` owns the expression :class:`~bevy_hanabi_tpu.graph.Module`
and three ordered modifier lists (init/update/render), plus simulation
settings. ``particle_layout()`` derives the attribute set from the modifiers
(asset.rs:605), which on TPU determines the SoA pool pytree structure and the
jit signature of the compiled step.

Serialization is JSON (the reference uses RON via bevy reflection,
asset.rs:674-1000); round-tripping an asset preserves simulation semantics
bit-for-bit because expression handles are stable arena indices.
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from .attributes import Attribute, ParticleLayout
from .graph.expr import ExprHandle, Module
from .modifiers.base import Modifier, ModifierContext, modifier_from_json
from .modifiers.event import EmitSpawnEventModifier
from .properties import Property, PropertyLayout
from .spawn import SpawnerSettings

__all__ = [
    "EffectAsset",
    "AlphaMode",
    "SimulationSpace",
    "SimulationCondition",
    "MotionIntegration",
    "EffectParent",
]


class SimulationSpace(enum.Enum):
    """Which space particles simulate in (asset.rs ``SimulationSpace``)."""

    GLOBAL = "global"  # emitter transform applied once at spawn
    LOCAL = "local"  # particles follow the emitter transform every frame


class SimulationCondition(enum.Enum):
    """When the effect simulates (asset.rs:54)."""

    WHEN_VISIBLE = "when_visible"
    ALWAYS = "always"


class MotionIntegration(enum.Enum):
    """Euler integration of POSITION from VELOCITY (asset.rs:29).

    PRE_UPDATE integrates before update modifiers run, POST_UPDATE after
    (the default), NONE disables built-in integration.
    """

    NONE = "none"
    PRE_UPDATE = "pre_update"
    POST_UPDATE = "post_update"


@dataclass(frozen=True)
class AlphaMode:
    """Render blending mode (asset.rs:117-210)."""

    kind: str  # blend | premultiply | add | multiply | mask | opaque
    mask_cutoff: Optional[ExprHandle] = None  # only for kind == "mask"

    BLEND = None  # filled below
    PREMULTIPLY = None
    ADD = None
    MULTIPLY = None
    OPAQUE = None

    @staticmethod
    def mask(cutoff: ExprHandle) -> "AlphaMode":
        return AlphaMode("mask", cutoff)

    def is_opaque(self) -> bool:
        return self.kind in ("opaque", "mask")


AlphaMode.BLEND = AlphaMode("blend")
AlphaMode.PREMULTIPLY = AlphaMode("premultiply")
AlphaMode.ADD = AlphaMode("add")
AlphaMode.MULTIPLY = AlphaMode("multiply")
AlphaMode.OPAQUE = AlphaMode("opaque")


@dataclass(frozen=True)
class EffectParent:
    """Marks an effect instance as the child of another (asset.rs:1156).

    The ``entity`` is a scene-level instance name; children consume the
    parent's GPU spawn events and may inherit parent attributes.
    """

    entity: str


class EffectAsset:
    """A complete effect description (asset.rs:272-336 + builder :391-560)."""

    def __init__(
        self,
        name: str,
        capacity: int,
        spawner: SpawnerSettings,
        module: Optional[Module] = None,
    ) -> None:
        if capacity <= 0:
            raise ValueError("effect capacity must be positive")
        self.name = name
        self.capacity = int(capacity)
        self.spawner = spawner
        self.module = module if module is not None else Module()
        self.init_modifiers: List[Modifier] = []
        self.update_modifiers: List[Modifier] = []
        self.render_modifiers: List[Modifier] = []
        self.simulation_space = SimulationSpace.GLOBAL
        self.simulation_condition = SimulationCondition.WHEN_VISIBLE
        self.motion_integration = MotionIntegration.POST_UPDATE
        self.alpha_mode: AlphaMode = AlphaMode.BLEND
        self.z_layer_2d: float = 0.0
        self.prng_seed: Optional[int] = None  # None => re-rolled per instance
        self.ribbon_group: Optional[int] = None
        self.mesh = None  # Optional[render.mesh.ParticleMesh]; None = quad
        # Opaque Bevy mesh AssetPath (reference EffectAsset::mesh,
        # asset.rs:335 — Option<AssetPath>, e.g. "shapes.glb#Mesh0/Primitive0").
        # This framework cannot resolve Bevy assets; the path is CARRIED so
        # reference `.effect` files round-trip byte-identically. Assign a
        # renderable geometry via with_mesh(ParticleMesh) separately.
        self.mesh_asset_path: Optional[str] = None

    # -- builder (asset.rs:391-560) ---------------------------------------

    def init(self, modifier: Modifier) -> "EffectAsset":
        if not (modifier.context() & ModifierContext.INIT):
            raise ValueError(f"{type(modifier).__name__} is not an init modifier")
        self.init_modifiers.append(modifier)
        return self

    def update(self, modifier: Modifier) -> "EffectAsset":
        if not (modifier.context() & ModifierContext.UPDATE):
            raise ValueError(f"{type(modifier).__name__} is not an update modifier")
        self.update_modifiers.append(modifier)
        return self

    def render(self, modifier: Modifier) -> "EffectAsset":
        if not (modifier.context() & ModifierContext.RENDER):
            raise ValueError(f"{type(modifier).__name__} is not a render modifier")
        self.render_modifiers.append(modifier)
        return self

    def with_spawner(self, spawner: SpawnerSettings) -> "EffectAsset":
        self.spawner = spawner
        return self

    def with_simulation_space(self, space: SimulationSpace) -> "EffectAsset":
        self.simulation_space = space
        return self

    def with_simulation_condition(self, cond: SimulationCondition) -> "EffectAsset":
        self.simulation_condition = cond
        return self

    def with_motion_integration(self, mi: MotionIntegration) -> "EffectAsset":
        self.motion_integration = mi
        return self

    def with_alpha_mode(self, mode: AlphaMode) -> "EffectAsset":
        self.alpha_mode = mode
        return self

    def with_property(self, name: str, default) -> "EffectAsset":
        self.module.add_property(name, default)
        return self

    def with_mesh(self, mesh) -> "EffectAsset":
        """Render particles as instances of a ParticleMesh (EffectMesh
        analogue, reference lib.rs:745)."""
        self.mesh = mesh
        return self

    def with_mesh_asset_path(self, path: Optional[str]) -> "EffectAsset":
        """Carry a Bevy mesh AssetPath opaquely (asset.rs:335) so reference
        `.effect` files keep their custom-mesh reference through
        round-trips. Does not affect rendering here — pair with
        ``with_mesh`` to supply actual geometry."""
        self.mesh_asset_path = path
        return self

    # -- derived -----------------------------------------------------------

    def particle_layout(self) -> ParticleLayout:
        """Union of all modifier attribute requirements (asset.rs:605), plus
        any attribute read directly by an expression in the module (the
        reference would fail shader compilation on such reads; deriving them
        into the layout is strictly friendlier)."""
        attrs: List[Attribute] = []
        for m in self.init_modifiers + self.update_modifiers + self.render_modifiers:
            attrs.extend(m.attributes())
        for i in range(1, len(self.module) + 1):
            e = self.module.get(i)
            if e.kind == "attribute":
                attrs.append(Attribute.from_name(e.name))
        return ParticleLayout(attrs)

    def property_layout(self) -> PropertyLayout:
        return PropertyLayout(
            tuple(Property(n, v) for n, v in self.module.properties().items())
        )

    def channel_const_count(self, channel: int) -> Optional[int]:
        """Compile-time-constant emit count of ``channel``, or None.

        When the channel has exactly ONE EmitSpawnEventModifier whose
        ``count`` expression is a positive literal K, every compacted
        event carries count K, so a consuming child can map spawn ranks
        to events with ``rank // K`` instead of a prefix-sum lookup
        (consume_events fast path)."""
        counts = []
        for m in self.update_modifiers:
            if (
                isinstance(m, EmitSpawnEventModifier)
                and m.child_index == channel
            ):
                e = self.module.get(m.count)
                if e.kind != "literal":
                    return None
                try:
                    counts.append(int(e.value.value))
                except (TypeError, ValueError, AttributeError):
                    return None
        if len(counts) == 1 and counts[0] > 0:
            return counts[0]
        return None

    def num_event_channels(self) -> int:
        """Number of child spawn-event channels this effect emits into."""
        channels = [
            m.child_index
            for m in self.update_modifiers
            if isinstance(m, EmitSpawnEventModifier)
        ]
        return (max(channels) + 1) if channels else 0

    def emits_gpu_spawn_events(self) -> bool:
        return self.num_event_channels() > 0

    def signature(self) -> Tuple:
        """Hashable FULL-asset key — the hot-reload drift detector
        (any edit, spawner included, must register as drift)."""
        return (
            self.name,
            self.capacity,
            self.particle_layout().signature(),
            json.dumps(self.to_json(), sort_keys=True),
        )

    def compile_signature(self) -> Tuple:
        """Hashable key over everything a COMPILED executable can depend
        on ≈ the reference's pipeline specialization key. This is
        ``signature()`` minus the spawner: spawn counts enter at runtime
        as StepInputs (the reference feeds them via a buffer the same
        way, spawn.rs tick → GpuSpawnerParams), so jit caches keyed on
        this survive live spawner edits — keying them on the full
        signature would force a multi-second whole-scene re-trace per
        editor rate-slider tweak and strand the old executable."""
        js = self.to_json()
        del js["spawner"]
        return (
            self.name,
            self.capacity,
            self.particle_layout().signature(),
            json.dumps(js, sort_keys=True),
        )

    # -- serde (asset.rs:674-1000; .effect file loader :1072) ---------------

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "capacity": self.capacity,
            "spawner": self.spawner.to_json(),
            "module": self.module.to_json(),
            "init_modifiers": [m.to_json() for m in self.init_modifiers],
            "update_modifiers": [m.to_json() for m in self.update_modifiers],
            "render_modifiers": [m.to_json() for m in self.render_modifiers],
            "simulation_space": self.simulation_space.value,
            "simulation_condition": self.simulation_condition.value,
            "motion_integration": self.motion_integration.value,
            "alpha_mode": {
                "kind": self.alpha_mode.kind,
                "mask_cutoff": self.alpha_mode.mask_cutoff,
            },
            "z_layer_2d": self.z_layer_2d,
            "prng_seed": self.prng_seed,
            "ribbon_group": self.ribbon_group,
            "mesh": self.mesh.to_json() if self.mesh is not None else None,
            "mesh_asset_path": self.mesh_asset_path,
        }

    @staticmethod
    def from_json(data: Dict[str, Any]) -> "EffectAsset":
        asset = EffectAsset(
            data["name"],
            data["capacity"],
            SpawnerSettings.from_json(data["spawner"]),
            Module.from_json(data["module"]),
        )
        asset.init_modifiers = [modifier_from_json(m) for m in data.get("init_modifiers", [])]
        asset.update_modifiers = [
            modifier_from_json(m) for m in data.get("update_modifiers", [])
        ]
        asset.render_modifiers = [
            modifier_from_json(m) for m in data.get("render_modifiers", [])
        ]
        asset.simulation_space = SimulationSpace(data.get("simulation_space", "global"))
        asset.simulation_condition = SimulationCondition(
            data.get("simulation_condition", "when_visible")
        )
        asset.motion_integration = MotionIntegration(
            data.get("motion_integration", "post_update")
        )
        am = data.get("alpha_mode", {"kind": "blend"})
        asset.alpha_mode = AlphaMode(am["kind"], am.get("mask_cutoff"))
        asset.z_layer_2d = data.get("z_layer_2d", 0.0)
        asset.prng_seed = data.get("prng_seed")
        asset.ribbon_group = data.get("ribbon_group")
        if data.get("mesh"):
            from .render.mesh import ParticleMesh

            asset.mesh = ParticleMesh.from_json(data["mesh"])
        asset.mesh_asset_path = data.get("mesh_asset_path")
        return asset

    def save(self, path: str, format: Optional[str] = None) -> None:
        """Write a ``.effect`` file.

        ``format`` is ``"json"`` (this framework's native serialization) or
        ``"ron"`` (the reference's canonical RON format, asset.rs:674 — so
        exported assets load back into bevy_hanabi). Defaults by extension:
        ``.ron`` saves RON, anything else JSON."""
        if format is None:
            format = "ron" if path.endswith(".ron") else "json"
        if format == "ron":
            from .ron import asset_to_ron

            with open(path, "w") as f:
                f.write(asset_to_ron(self))
            return
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    @staticmethod
    def load(path: str) -> "EffectAsset":
        """Load a ``.effect`` file — this framework's JSON or the
        reference's RON (EffectAssetLoader, asset.rs:1072-1130), detected
        from the content: RON assets start with ``(``, JSON with ``{``."""
        with open(path) as f:
            text = f.read()
        stripped = text.lstrip()
        if stripped.startswith("(") or stripped.startswith("//"):
            from .ron import asset_from_ron

            return asset_from_ron(text)
        return EffectAsset.from_json(json.loads(text))

    def save_ron(self, path: str) -> None:
        """Write the reference's canonical RON ``.effect`` format."""
        self.save(path, format="ron")

    @staticmethod
    def load_ron(path: str) -> "EffectAsset":
        """Load a reference-format RON ``.effect`` file."""
        from .ron import asset_from_ron

        with open(path) as f:
            return asset_from_ron(f.read())
