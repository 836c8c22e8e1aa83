"""Scene orchestration: many effects, instanced groups, parent/child event
routing, rendering (port of ``bevy_hanabi_tpu/runtime/scene.py``).

A host-side registry of effect instances that each frame ticks spawners,
routes last frame's GPU spawn events from parents to children (the same
one-frame latency as the reference, vfx_init.wgsl:123-129), steps every
instance, and renders. The random streams draw in the JAX package's order —
the scene RNG once per :meth:`HanabiScene.add` and :meth:`add_group` and
once a frame for every group's frame seeds, each instance's RNG once per
step, each spawner its own — so frame seeds and spawner ticks are bit-equal
to the JAX package's.

Ported: ``add`` (with parents, textures, ``raster_override`` and
``cull_pad``), ``add_group`` (instanced groups: many instances of one asset
stepped as one :class:`~.instanced.InstancedEffect`), ``remove``, the
controls (``set_property``, ``set_textures``, ``set_transform``,
``set_visible``, ``reset_spawner``, ``set_spawner_active``, on effects and
groups), ``stats``, ``warmup``, ``update`` (with ``cameras=`` frustum
culling), ``update_chunk`` (one family chunk per event tree, one chunk per
group), ``update_render_chunk`` for one camera or a list of cameras,
``render`` and ``render_views`` through both pipelines of the JAX package's
render plan: the phase split (opaque and mask passes threading a depth
plane, then transparent passes tested against it, same-blend runs batched)
and the painter pass (every effect and group in one back-to-front sort with
per-entry blend equations, textured effects through a stacked texture atlas
and mesh effects with their Lambert setups merged), ``scene_depth`` and
``return_depth`` included, ribbon effects as their segment quads and mesh
effects as their expanded entries (neither batched, nor textured effects).
Hot reload (``hot_reload``, :meth:`HanabiScene.apply_asset_changes`),
``DebugSettings`` captures and validation (checked steps) and LOCAL-space
effects are ported, and so is sharding over a
:class:`~..parallel.mesh.Mesh` driven by this one process: ``add(mesh=)``
splits an effect's pool (event-linked ones included; a child inherits its
parent's mesh) and ``add_sharded_group`` a group's pools over the mesh's
devices. Sharded pools render with gather semantics (assembled on the
scene's device, so the single-device algorithm runs unchanged) everywhere
but a sharded group's own pass in :meth:`HanabiScene.render`'s split
pipeline, which goes through :class:`~..parallel.render.ShardedRenderer`.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..asset import EffectAsset, SimulationCondition, SimulationSpace
from ..properties import EffectProperties, Property
from ..spawn import EffectSpawner
from ..time import EffectSimulationClock
from ..utils.profiling import DebugSettings, profile_span
from .effect import CompiledEffect, StepChecks, StepInputs, identity_transform
from .events import EventBuffer
from .instanced import InstancedEffect
from .pool import ParticlePool, ShardedPool, gathered

__all__ = ["HanabiScene", "EffectInstance", "DebugSettings"]


@dataclass
class EffectInstance:
    """One live effect instance (≈ ParticleEffect + EffectSpawner +
    CompiledParticleEffect + EffectProperties components)."""

    name: str
    asset: EffectAsset
    fx: CompiledEffect
    pool: ParticlePool
    spawner: Optional[EffectSpawner]
    properties: EffectProperties
    transform: Any
    parent: Optional[str] = None
    child_channel: int = 0
    visible: bool = True
    # per-instance RNG for frame seeds (pinned when asset.prng_seed is set)
    rng: Any = None
    # events emitted by this instance's LAST step, per channel
    last_events: Dict[int, EventBuffer] = field(default_factory=dict)
    renderer: Any = None
    # asset signature captured at the last (re)compile: hot-reload drift
    # detection (lib.rs:1796)
    compiled_signature: Any = None
    # texture images by slot, f32 [H, W, 4] tensors on the scene's device,
    # and the objects they were uploaded from (the painter's atlas shares a
    # layer between effects given the same object)
    textures: tuple = ()
    texture_sources: tuple = ()
    # RasterConfig field overrides (dataclasses.replace kwargs) for THIS
    # effect's passes; an overridden effect renders in its own pass
    raster_override: Any = None
    # frustum-culling pad (world units) around the pool AABB; None = this
    # effect opts out of per-camera raster culling (a WhenVisible asset
    # still gets simulation gating with the default pad)
    cull_pad: Optional[float] = None
    # explicit capacity passed to add() (None = asset.capacity); a hot
    # reload that leaves asset.capacity alone keeps it
    capacity_override: Optional[int] = None

    def alive_count(self) -> int:
        return int(self.pool.alive_count())


class HanabiScene:
    """Host-side effect world (≈ HanabiPlugin's systems as one object).

    ``device`` is required: every pool of the scene lives there."""

    def __init__(self, seed: int = 0, *, device) -> None:
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)
        self._effects: Dict[str, EffectInstance] = {}
        self._groups: Dict[str, dict] = {}  # instanced groups
        self._order: List[str] = []  # parents before children
        self.clock = EffectSimulationClock()
        self._frame = 0
        # family chunk steps for update_chunk, keyed by member names
        self._family_fn: Dict = {}
        self.debug = DebugSettings()
        self._new_effect_added = False
        # hot-reload policy for live EffectAsset edits (scene.py:159-169):
        # "eager" checks every asset at each update/chunk/render entry point
        # and recompiles drifted ones; "periodic" rides the rotating drift
        # batch of _check_footguns (every asset within ~120 frames); "off"
        # never recompiles, drift only warns
        self.hot_reload = "eager"
        # frustum culling: pool AABBs cached per frame, and the latch that
        # turns on render culling once the scene is camera-driven
        self._aabb_frame = -1
        self._aabb_cache: Dict[str, tuple] = {}
        self._frustum_sim = False
        self.render_culling: Optional[bool] = None
        self.last_frame_ms: Optional[float] = None  # the last update()'s host wall time

    # -- authoring-world API ------------------------------------------------

    def add(
        self,
        asset: EffectAsset,
        name: Optional[str] = None,
        transform: Optional[Any] = None,
        parent: Optional[str] = None,
        textures: Sequence[Any] = (),
        capacity: Optional[int] = None,
        prng_seed: Optional[int] = None,
        raster_override: Optional[Dict[str, Any]] = None,
        mesh=None,
        cull_pad: Optional[float] = None,
    ) -> str:
        """Spawn an effect instance (≈ commands.spawn(ParticleEffect)).

        ``parent`` names an effect with an EmitSpawnEventModifier; this
        effect then consumes the lowest event channel no sibling uses.
        ``textures`` ([H, W, 4] RGBA images, by slot) are uploaded to the
        scene's device once. ``prng_seed`` overrides ``asset.prng_seed``
        for this instance. ``raster_override`` (RasterConfig field ->
        value) customizes THIS effect's raster passes on top of the scene
        config, e.g. ``{"tile_span": 4}`` for a large-splat effect; such an
        effect renders in its own pass, never batched nor in the painter
        pass. ``cull_pad`` (world units) opts the effect into per-camera
        raster culling with its pool AABB padded by that much.

        ``mesh`` (a :class:`~..parallel.mesh.Mesh`) shards THIS instance's
        pool over every device of the mesh, event-emitting and consuming
        effects included: emission compacts per shard, the child consumes
        the gap-separated buffer with the unsharded trajectories. A child
        of a sharded parent inherits the parent's mesh unless given its own,
        which must be the same mesh (scene.py:183-255)."""
        name = name or f"{asset.name}#{len(self._effects)}"
        if name in self._effects:
            raise ValueError(f"effect instance {name!r} already exists")
        parent_layout = None
        child_channel = 0
        parent_const = None
        if parent is not None:
            if parent not in self._effects:
                raise KeyError(f"parent effect {parent!r} not found")
            p = self._effects[parent]
            if not p.asset.emits_gpu_spawn_events():
                raise ValueError(f"parent {parent!r} has no EmitSpawnEventModifier")
            if p.fx.mesh is not None:
                if mesh is None:
                    mesh = p.fx.mesh
                elif mesh is not p.fx.mesh:
                    raise ValueError(
                        f"child of sharded parent {parent!r} must shard on "
                        "the parent's mesh (pass the same Mesh object or "
                        "omit mesh to inherit it)"
                    )
            parent_layout = p.asset.particle_layout()
            # Children read distinct event channels (modifier/mod.rs:664):
            # the lowest channel unused by surviving siblings.
            used = {e.child_channel for e in self._effects.values() if e.parent == parent}
            child_channel = next(c for c in range(len(used) + 1) if c not in used)
            if child_channel >= p.asset.num_event_channels():
                raise ValueError(
                    f"parent {parent!r} emits on "
                    f"{p.asset.num_event_channels()} event channel(s); "
                    f"cannot attach a child on channel {child_channel}"
                )
            # a sharded parent's buffer keeps per-shard prefixes separated by
            # zero-count gaps: the rank // K shortcut assumes a dense prefix
            if p.fx.mesh is None:
                parent_const = p.asset.channel_const_count(child_channel)
        fx = CompiledEffect.get(
            asset,
            self.device,
            parent_layout=parent_layout,
            parent_const_count=parent_const,
            mesh=mesh,
        )
        pool = fx.create_pool(capacity)
        # asset.prng_seed pins the instance's random streams; otherwise they
        # derive from the scene RNG.
        if prng_seed is not None:
            inst_seed = prng_seed
        elif asset.prng_seed is not None:
            inst_seed = asset.prng_seed
        else:
            inst_seed = int(self._rng.integers(0, 2**63))
        spawner = (
            None
            if parent is not None
            else EffectSpawner(asset.spawner, rng=np.random.default_rng(inst_seed))
        )
        props = EffectProperties([Property(n, v) for n, v in asset.module.properties().items()])
        inst = EffectInstance(
            name=name,
            asset=asset,
            fx=fx,
            pool=pool,
            spawner=spawner,
            properties=props,
            transform=(
                np.asarray(transform, np.float32) if transform is not None else identity_transform()
            ),
            parent=parent,
            child_channel=child_channel,
            rng=np.random.default_rng(inst_seed + 1),
            compiled_signature=asset.signature(),
            textures=self._upload(textures),
            texture_sources=tuple(textures),
            raster_override=dict(raster_override) if raster_override else None,
            cull_pad=cull_pad,
            capacity_override=capacity,
        )
        self._effects[name] = inst
        self._new_effect_added = True
        if parent is not None:
            self._order.insert(self._order.index(parent) + 1, name)
            self._restrict_parent_payload(parent)
        else:
            self._order.append(name)
        return name

    def _restrict_parent_payload(self, parent: str) -> None:
        """Rebind the parent with event payload capture restricted to the
        union of its children's inherited attributes (scene.py:305-333)."""
        p = self._effects[parent]
        union = set()
        for e in self._effects.values():
            if e.parent == parent:
                union |= set(e.fx._inherited_attrs)
        union_t = tuple(sorted(union))
        if p.fx.payload_attrs == union_t:
            return
        p.fx = CompiledEffect.get(
            p.asset,
            self.device,
            parent_layout=p.fx.parent_layout,
            parent_const_count=p.fx.parent_const_count,
            payload_attrs=union_t,
            mesh=p.fx.mesh,
        )
        # the buffer layout changed: drop in-flight events and the family
        # steps that captured the old parent binding
        p.last_events = {}
        self._family_fn = {k: v for k, v in self._family_fn.items() if parent not in k}

    def add_group(
        self,
        asset: EffectAsset,
        count: int,
        name: Optional[str] = None,
        transforms: Optional[Any] = None,
        capacity: Optional[int] = None,
        textures: Sequence[Any] = (),
        raster_override: Optional[Dict[str, Any]] = None,
        cull_pad: Optional[float] = None,
    ) -> str:
        """Add ``count`` instances of one asset stepped as ONE pass
        (scene.py:335-391): the Batcher analogue (reference
        render/batch.rs), an :class:`InstancedEffect` whose spawners tick
        in one vectorized bank. GLOBAL simulation space only (per-instance
        transforms bake in at spawn); event-linked assets are not batchable
        (route them through :meth:`add`)."""
        from ..spawn import make_spawner_bank

        if asset.emits_gpu_spawn_events():
            raise ValueError("event-emitting assets cannot be grouped; use add()")
        if asset.simulation_space is not SimulationSpace.GLOBAL:
            raise ValueError("instanced groups require GLOBAL simulation space")
        name = name or f"{asset.name}[group]#{len(self._groups)}"
        if name in self._groups or name in self._effects:
            raise ValueError(f"effect {name!r} already exists")
        fx = InstancedEffect(asset, count, capacity, device=self.device)
        if transforms is None:
            tfs = np.broadcast_to(identity_transform(), (count, 3, 4))
        else:
            tfs = np.asarray(transforms, np.float32).reshape(count, 3, 4)
        self._groups[name] = {
            "name": name,
            "asset": asset,
            "fx": fx,
            "pools": fx.create_pools(),
            "bank": make_spawner_bank(asset.spawner, count, seed=int(self._rng.integers(0, 2**63))),
            "transforms": tfs,
            "properties": EffectProperties(
                [Property(n, v) for n, v in asset.module.properties().items()]
            ),
            "visible": True,
            "textures": self._upload(textures),
            "texture_sources": tuple(textures),
            "renderer": None,
            "compiled_signature": asset.signature(),
            "raster_override": dict(raster_override) if raster_override else None,
            "cull_pad": cull_pad,
            "capacity_override": capacity,
        }
        self._new_effect_added = True
        return name

    def add_sharded_group(
        self,
        asset: EffectAsset,
        count: int,
        name: Optional[str] = None,
        mesh=None,
        dp: Optional[int] = None,
        sp: Optional[int] = None,
        transforms: Optional[Any] = None,
        capacity: Optional[int] = None,
        textures: Sequence[Any] = (),
        render_mode: str = "auto",
        cull_pad: Optional[float] = None,
    ) -> str:
        """Add a group whose pools shard across a mesh (scene.py:393-455): a
        :class:`~..parallel.mesh.ShardedEffect`, instances over the mesh's
        ``dp`` axis and each pool's particles over ``sp``, beside effects
        that stay on the scene's device. Pass ``mesh`` or ``dp``/``sp``
        factors of the CUDA device count (:func:`~..parallel.mesh.make_mesh`).
        :meth:`render`'s split pipeline draws it through a
        :class:`~..parallel.render.ShardedRenderer` of ``render_mode``
        (psum for additive blending, slice otherwise, under "auto")."""
        from ..parallel.mesh import ShardedEffect, make_mesh
        from ..spawn import make_spawner_bank

        if asset.emits_gpu_spawn_events():
            raise ValueError("event-emitting assets cannot be grouped; use add()")
        if asset.simulation_space is not SimulationSpace.GLOBAL:
            raise ValueError("instanced groups require GLOBAL simulation space")
        if mesh is None:
            mesh = make_mesh(dp=dp, sp=sp)
        name = name or f"{asset.name}[sharded]#{len(self._groups)}"
        if name in self._groups or name in self._effects:
            raise ValueError(f"effect {name!r} already exists")
        fx = ShardedEffect(asset, count, mesh, capacity, device=self.device)
        if transforms is None:
            tfs = np.broadcast_to(identity_transform(), (count, 3, 4))
        else:
            tfs = np.asarray(transforms, np.float32).reshape(count, 3, 4)
        self._groups[name] = {
            "name": name,
            "asset": asset,
            "fx": fx,
            "pools": fx.create_pools(),
            "bank": make_spawner_bank(asset.spawner, count, seed=int(self._rng.integers(0, 2**63))),
            "transforms": tfs,
            "properties": EffectProperties(
                [Property(n, v) for n, v in asset.module.properties().items()]
            ),
            "visible": True,
            "textures": self._upload(textures),
            "texture_sources": tuple(textures),
            "renderer": None,
            "sharded": True,
            "render_mode": render_mode,
            "compiled_signature": asset.signature(),
            "raster_override": None,
            "cull_pad": cull_pad,
            "capacity_override": capacity,
        }
        self._new_effect_added = True
        return name

    def group_alive(self, name: str) -> int:
        g = self._groups[name]
        return int(g["fx"].total_alive(g["pools"]))

    def _group_flat_pool(self, g) -> ParticlePool:
        """A group's [I, N, ...] pools as one flat pool for rendering, each
        instance's ribbons kept apart (scene.py:464-474). A sharded group's
        pools are assembled on the scene's device first (scene.py:34-44:
        the single-device algorithm then runs on them unchanged)."""
        return gathered(g["pools"], self.device).flatten(composite_ribbon_ids=True)

    def _flat_pool(self, inst: EffectInstance) -> ParticlePool:
        """An effect's pool, a sharded one assembled on the scene's device."""
        return gathered(inst.pool, self.device)

    def remove(self, name: str) -> None:
        """Remove an effect or a group (an effect's children first)."""
        if name in self._groups:
            del self._groups[name]
        else:
            children = [e.name for e in self._effects.values() if e.parent == name]
            if children:
                raise ValueError(f"remove children first: {children}")
            del self._effects[name]
            self._order.remove(name)
            self._family_fn = {k: v for k, v in self._family_fn.items() if name not in k}
        self._aabb_frame = -1

    def __getitem__(self, name: str) -> EffectInstance:
        return self._effects[name]

    def __contains__(self, name: str) -> bool:
        return name in self._effects

    def effects(self) -> List[EffectInstance]:
        return [self._effects[n] for n in self._order]

    def set_property(self, name: str, prop: str, value) -> None:
        if name in self._groups:
            self._groups[name]["properties"].set(prop, value)
        else:
            self._effects[name].properties.set(prop, value)

    def _upload(self, textures) -> tuple:
        from ..render.raster import texture_tensor

        return tuple(texture_tensor(t, self.device) for t in textures)

    def set_textures(self, name: str, textures: Sequence[Any]) -> None:
        """Swap an effect's or group's texture images (the EffectMaterial
        image swap, lib.rs:694-702); its renderer is rebuilt on next use."""
        if name in self._groups:
            g = self._groups[name]
            g["textures"] = self._upload(textures)
            g["texture_sources"] = tuple(textures)
            g["renderer"] = None
            return
        inst = self._effects[name]
        inst.textures = self._upload(textures)
        inst.texture_sources = tuple(textures)
        inst.renderer = None

    def set_transform(self, name: str, transform) -> None:
        """An effect's [3, 4] emitter transform, or a group's [I, 3, 4]."""
        if name in self._groups:
            g = self._groups[name]
            n = g["fx"].num_instances
            g["transforms"] = np.asarray(transform, np.float32).reshape(n, 3, 4)
        else:
            self._effects[name].transform = np.asarray(transform, np.float32)

    def set_visible(self, name: str, visible: bool) -> None:
        if name in self._groups:
            self._groups[name]["visible"] = visible
        else:
            self._effects[name].visible = visible

    def reset_spawner(self, name: str) -> None:
        """Restart an effect's spawner cycle, or every spawner of a group."""
        if name in self._groups:
            self._groups[name]["bank"].reset()
            return
        sp = self._effects[name].spawner
        if sp is not None:
            sp.reset()

    def set_spawner_active(self, name: str, active: bool) -> None:
        if name in self._groups:
            self._groups[name]["bank"].set_active(active)
            return
        sp = self._effects[name].spawner
        if sp is not None:
            sp.set_active(active)

    def total_alive(self) -> int:
        return sum(e.alive_count() for e in self.effects()) + sum(
            self.group_alive(n) for n in self._groups
        )

    def warmup(self) -> None:
        """Run every instance's step once (the readiness protocol's
        replacement, scene.py:2341): one update of zero time."""
        self.update(0.0)

    def stats(self) -> dict:
        """Scene observability snapshot (scene.py:1241-1294; it reads back
        from the device, so call it off the hot path): per-effect alive
        counts and event-buffer fill levels, group totals, the share of each
        effect's and group's frames its generated step kernel stepped
        (``fused_step_share``, by name), and the last ``update()``'s host
        wall time. Warns once per child when spawn events arrive while its
        pool is already full: those spawns are dropped."""
        from ..utils.diag import warn_once

        effects = {}
        for name, inst in self._effects.items():
            events = {}
            for chan, ev in (inst.last_events or {}).items():
                events[chan] = {
                    "events": int(ev.num_events),
                    "capacity": int(ev.parent_slot.shape[-1]),
                }
            effects[name] = {
                "alive": inst.alive_count(),
                "capacity": int(inst.pool.capacity),
                "events": events,
            }
        for name, inst in self._effects.items():
            if inst.parent is None:
                continue
            pev = (self._effects[inst.parent].last_events or {}).get(inst.child_channel)
            if pev is None:
                continue
            requested = int(torch.sum(pev.count))
            cap = int(inst.pool.capacity)
            if requested > 0 and effects[name]["alive"] >= cap:
                warn_once(
                    f"child-saturation:{name}",
                    f"child effect {name!r} has a full pool ({cap} alive) while "
                    f"{requested} spawn(s) are requested by parent {inst.parent!r}: "
                    "those spawns are dropped. Raise the child's capacity.",
                )
        return {
            "frame": self._frame,
            "time": self.clock.time,
            "last_frame_ms": self.last_frame_ms,
            "total_alive": self.total_alive(),
            "effects": effects,
            "groups": {name: {"alive": self.group_alive(name)} for name in self._groups},
            "fused_step_share": {
                **{name: inst.fx.fused_step_share for name, inst in self._effects.items()},
                **{name: g["fx"].effect.fused_step_share for name, g in self._groups.items()},
            },
        }

    # -- visibility: frustum vs pool AABB ----------------------------------
    # As in the JAX package (scene.py:549-789): the AABB of every entity
    # that takes part in culling is computed on the device from its pool
    # (one masked min/max per entity, ONE readback for all of them, at most
    # once per frame), unioned with the emitter positions so a fresh effect
    # is visible at its emitter, and padded by ``cull_pad`` (or the default
    # pad) to cover splat extents. An entity takes part when it sets
    # ``cull_pad`` or its asset simulates WhenVisible.

    DEFAULT_CULL_PAD = 0.5

    @staticmethod
    def _cullable(asset, cull_pad) -> bool:
        return cull_pad is not None or asset.simulation_condition is SimulationCondition.WHEN_VISIBLE

    def _refresh_aabbs(self) -> Dict[str, tuple]:
        """The world AABB ``(min, max)`` of every cullable entity, describing
        the pools as of frame start; computed at most once per frame."""
        if self._aabb_frame == self._frame:
            return self._aabb_cache
        # (name, pool, emitter transforms [K, 3, 4], pad, local space)
        entries = [
            (inst.name, self._flat_pool(inst), np.asarray(inst.transform, np.float32)[None],
             self.DEFAULT_CULL_PAD if inst.cull_pad is None else inst.cull_pad,
             inst.asset.simulation_space is SimulationSpace.LOCAL)
            for inst in self._effects.values() if self._cullable(inst.asset, inst.cull_pad)
        ] + [
            # groups are GLOBAL: the box of every lane is the union of the
            # instances' boxes
            (n, self._group_flat_pool(g), np.asarray(g["transforms"], np.float32),
             self.DEFAULT_CULL_PAD if g["cull_pad"] is None else g["cull_pad"], False)
            for n, g in self._groups.items() if self._cullable(g["asset"], g["cull_pad"])
        ]
        cache: Dict[str, tuple] = {}
        if entries:
            big = 3.0e38
            boxes = []
            for _, pool, _, _, _ in entries:
                m = pool.alive[:, None]
                pos = pool.attrs["position"]
                boxes.append(
                    torch.stack([torch.where(m, pos, big).amin(0), torch.where(m, pos, -big).amax(0)])
                )
            res = torch.stack(boxes).cpu().numpy()  # the one readback
            for (name, _, tfs, pad, local), (mn, mx) in zip(entries, res):
                tf = tfs[0]
                em = tfs[:, :, 3]  # emitter world positions
                if local:
                    # the box through R|t: centre transformed, extents through |R|
                    if np.all(mn <= mx):
                        c = tf[:, :3] @ ((mn + mx) * 0.5) + tf[:, 3]
                        e = np.abs(tf[:, :3]) @ ((mx - mn) * 0.5)
                        mn, mx = c - e, c + e
                    else:
                        mn = np.full(3, 3.0e38, np.float32)
                        mx = -mn
                mn = np.minimum(mn, em.min(0)) - pad
                mx = np.maximum(mx, em.max(0)) + pad
                if self.debug.validate and (np.isnan(mn).any() or np.isnan(mx).any()):
                    raise FloatingPointError(
                        f"debug validation: effect {name!r} has a nan pool AABB — an alive "
                        "lane carries a non-finite position; without validation this "
                        "would silently frustum-cull the effect"
                    )
                cache[name] = (mn, mx)
        self._aabb_cache = cache
        self._aabb_frame = self._frame
        return cache

    def _culling_names(self, for_render: bool) -> set:
        """The entities that take part in culling: those with a ``cull_pad``
        always; WhenVisible ones for simulation, and for render culling
        only once the scene is camera-driven (``update(dt, cameras=...)`` or
        a render chunk has run), unless ``render_culling`` overrides that
        latch (scene.py:691-744)."""
        render_cull = self._frustum_sim if self.render_culling is None else self.render_culling

        def participates(asset, pad):
            if pad is not None:
                return True
            return asset.simulation_condition is SimulationCondition.WHEN_VISIBLE and (
                not for_render or render_cull
            )

        return {n for n, i in self._effects.items() if participates(i.asset, i.cull_pad)} | {
            n for n, g in self._groups.items() if participates(g["asset"], g["cull_pad"])
        }

    def _culled_names(self, cameras, for_render: bool = False) -> set:
        """Names of the entities taking part in culling whose padded AABB is
        outside EVERY given camera frustum."""
        with profile_span("hanabi:cull"):
            from ..render.camera import aabb_in_frustum, frustum_planes

            cameras = list(cameras)
            if not cameras:
                return set()
            names = self._culling_names(for_render)
            if not names:
                return set()
            aabbs = self._refresh_aabbs()
            planes = [frustum_planes(c) for c in cameras]
            return {
                n
                for n in names
                if n in aabbs and not any(aabb_in_frustum(p, aabbs[n][0], aabbs[n][1]) for p in planes)
            }

    def _per_view_visibility(self, cameras, insts, groups):
        """Per-camera visibility for multi-view rendering (scene.py:746-789,
        the reference's per-view RenderVisibleEntities,
        render/mod.rs:5580-5600): bool ``[V, n_effects]`` and ``[V,
        n_groups]``, True where the entity's padded AABB meets THAT camera's
        frustum. Entities not taking part in culling are visible in every
        view. A view masks the alive lanes of what it does not see."""
        with profile_span("hanabi:cull"):
            from ..render.camera import aabb_in_frustum, frustum_planes

            planes = [frustum_planes(c) for c in cameras]
            aabbs = self._refresh_aabbs()
            names = self._culling_names(for_render=True)

            def row(name):
                if name not in names or name not in aabbs:
                    return [True] * len(planes)
                mn, mx = aabbs[name]
                return [bool(aabb_in_frustum(p, mn, mx)) for p in planes]

            vis_eff = np.asarray([row(i.name) for i in insts], np.bool_).reshape(len(insts), len(planes)).T
            vis_grp = np.asarray([row(g["name"]) for g in groups], np.bool_).reshape(
                len(groups), len(planes)).T
            return vis_eff, vis_grp

    # -- hot reload (≈ compile_effects change detection, lib.rs:1703-1838) ---

    def apply_asset_changes(self, name: Optional[str] = None) -> List[str]:
        """Detect live ``EffectAsset`` edits and recompile the affected
        effects and groups (scene.py:793-872; the reference's
        ``compile_effects`` rebuild, lib.rs:1703-1838, and
        ``update_properties_from_asset``, lib.rs:1853).

        Per drifted entity: a spawner-only edit retargets the live spawner
        without a recompile (a group's spawner bank is rebuilt, its cycle
        state reset); the pool is KEPT when the particle layout and capacity
        are unchanged; a layout-only change migrates it (shared attributes
        carry over, new ones take their defaults, alive particles survive);
        a capacity change resets it; properties re-sync (values an instance
        set persist where the property still exists with its type);
        renderers and family steps are dropped, and a recompile cascades to
        the descendants of a recompiled parent (unaffected ones no-op through
        the compiled-effect cache). Runs at every update, chunk and render
        entry point under ``hot_reload == "eager"``. Returns the names
        recompiled (or spawner-retargeted)."""
        sig_memo: Dict[int, Any] = {}

        def sig_of(asset):
            s = sig_memo.get(id(asset))
            if s is None:
                s = sig_memo[id(asset)] = asset.signature()
            return s

        if name is not None:
            if name in self._effects:
                eff_names, grp_names = [name], []
            elif name in self._groups:
                eff_names, grp_names = [], [name]
            else:
                raise KeyError(f"unknown effect {name!r}")
        else:
            eff_names, grp_names = list(self._order), list(self._groups)

        drifted = {
            n for n in eff_names
            if sig_of(self._effects[n].asset) != self._effects[n].compiled_signature
        }
        changed: List[str] = []
        if drifted:
            # scene order keeps parents first; a recompiled parent cascades
            # to its subtree (layout, channel constants, payload)
            cascade = set(drifted)
            for n in self._order:
                if self._effects[n].parent in cascade:
                    cascade.add(n)
            for n in self._order:
                if n in cascade and self._recompile_effect(n, sig_of(self._effects[n].asset)):
                    changed.append(n)
        for gname in grp_names:
            g = self._groups[gname]
            sig = sig_of(g["asset"])
            if sig != g["compiled_signature"]:
                self._recompile_group(gname, sig)
                changed.append(gname)
        return changed

    @staticmethod
    def _spawner_edit(old_sig, new_sig):
        """``(spawner changed, nothing but the spawner changed)`` between two
        asset signatures."""
        old_js, new_js = json.loads(old_sig[3]), json.loads(new_sig[3])
        changed = {k for k in set(old_js) | set(new_js) if old_js.get(k) != new_js.get(k)}
        return "spawner" in changed, changed <= {"spawner"} and new_sig[:3] == old_sig[:3]

    def _recompile_effect(self, name: str, new_sig) -> bool:
        """scene.py:873-949."""
        inst = self._effects[name]
        asset = inst.asset
        old_sig = inst.compiled_signature
        if new_sig != old_sig:
            spawner_changed, spawner_only = self._spawner_edit(old_sig, new_sig)
            if inst.spawner is not None and spawner_changed:
                inst.spawner.retarget(asset.spawner)
            if spawner_only:
                # the compiled step is untouched
                inst.compiled_signature = new_sig
                return True
        parent_layout = parent_const = None
        if inst.parent is not None:
            p = self._effects[inst.parent]
            parent_layout = p.asset.particle_layout()
            if p.fx.mesh is None:  # a sharded parent's buffer has gaps
                parent_const = p.asset.channel_const_count(inst.child_channel)
        new_fx = CompiledEffect.get(
            asset,
            self.device,
            parent_layout=parent_layout,
            parent_const_count=parent_const,
            payload_attrs=inst.fx.payload_attrs,
            mesh=inst.fx.mesh,
        )
        layout_changed = new_sig[2] != old_sig[2]
        if asset.capacity != old_sig[1]:
            # an asset capacity edit wins, and RETIRES the add()-time
            # override, which would otherwise resurrect on the next edit
            new_cap = asset.capacity
            inst.capacity_override = None
        else:
            new_cap = inst.capacity_override or inst.pool.capacity
        pool_changed = layout_changed or new_cap != inst.pool.capacity
        if new_fx is inst.fx and not pool_changed and new_sig == old_sig:
            return False  # a cascade no-op
        events_compatible = (
            not pool_changed and new_fx.payload_attrs == inst.fx.payload_attrs
        )
        if pool_changed:
            # a sharded pool migrates assembled, then splits over the mesh again
            inst.pool = new_fx.place_pool(self._migrate_pool(
                self._flat_pool(inst), gathered(new_fx.create_pool(new_cap), self.device)))
        inst.fx = new_fx
        if not events_compatible:
            inst.last_events = {}
        inst.renderer = None
        inst.compiled_signature = new_sig
        inst.properties.resync([Property(n, v) for n, v in asset.module.properties().items()])
        self._family_fn = {k: v for k, v in self._family_fn.items() if name not in k}
        if inst.parent is not None:
            # the child's inherited attributes may have changed
            self._restrict_parent_payload(inst.parent)
        return True

    @staticmethod
    def _migrate_pool(old: ParticlePool, new: ParticlePool) -> ParticlePool:
        """``new`` (a fresh pool of the new layout, or a group's fresh
        pools) carrying ``old``'s state: at the same capacity the alive mask,
        seeds, counter and every shared attribute (new attributes keep their
        defaults); a capacity change resets the pool (scene.py:951-966)."""
        if old.alive.shape != new.alive.shape:
            return new
        for k, v in new.attrs.items():
            ov = old.attrs.get(k)
            if ov is not None and ov.shape == v.shape and ov.dtype == v.dtype:
                new.attrs[k] = ov
        return ParticlePool(attrs=new.attrs, alive=old.alive, seed=old.seed, counter=old.counter)

    def _recompile_group(self, gname: str, new_sig) -> None:
        """scene.py:967-1038."""
        from ..spawn import make_spawner_bank

        g = self._groups[gname]
        asset = g["asset"]
        old_sig = g["compiled_signature"]
        count = g["fx"].num_instances
        spawner_changed, spawner_only = self._spawner_edit(old_sig, new_sig)
        if spawner_changed:
            # a group's spawners are one vectorized bank: rebuilt with the
            # new settings, their cycle state reset
            g["bank"] = make_spawner_bank(asset.spawner, count, seed=int(self._rng.integers(0, 2**63)))
        if spawner_only:
            g["compiled_signature"] = new_sig
            return
        layout_changed = new_sig[2] != old_sig[2]
        old_cap = g["fx"].capacity
        if asset.capacity != old_sig[1]:
            new_cap = asset.capacity
            g["capacity_override"] = None
        else:
            new_cap = g["capacity_override"] or old_cap
        if g.get("sharded"):
            from ..parallel.mesh import ShardedEffect

            fx = ShardedEffect(asset, count, g["fx"].mesh, new_cap, device=self.device)
        else:
            fx = InstancedEffect(asset, count, new_cap, device=self.device)
        g["fx"] = fx
        if layout_changed or new_cap != old_cap:
            pools = self._migrate_pool(gathered(g["pools"], self.device),
                                       gathered(fx.create_pools(), self.device))
            g["pools"] = fx.place_pools(pools) if g.get("sharded") else pools
        g["renderer"] = None
        g["properties"].resync([Property(n, v) for n, v in asset.module.properties().items()])
        g["compiled_signature"] = new_sig

    def _begin(self) -> None:
        """Every update, chunk and render entry point starts here: an eager
        hot reload of drifted assets (scene.py:1055, 1408, 1695, 2235, 2393)."""
        if self.hot_reload == "eager":
            self.apply_asset_changes()

    def _check_footguns(self) -> None:
        """Every 30 frames, a quarter of all entities is checked for asset
        drift, so every live asset is within 120 frames (scene.py:1152-1195):
        under ``hot_reload == "periodic"`` a drifted one recompiles, under
        ``"off"`` it only warns (eager mode applied changes already)."""
        from ..utils.diag import warn_once

        if self._frame % 30 != 0 or not (self._effects or self._groups):
            return
        entities = [(n, i.asset, i.compiled_signature) for n, i in self._effects.items()] + [
            (n, g["asset"], g["compiled_signature"]) for n, g in self._groups.items()
        ]
        batch = -(-len(entities) // 4)
        tick = self._frame // 30
        for k in range(batch):
            name, asset, sig = entities[(tick * batch + k) % len(entities)]
            if asset.signature() == sig:
                continue
            if self.hot_reload == "off":
                warn_once(
                    f"asset-drift:{name}",
                    f"effect {name!r}: EffectAsset was modified after add(); the compiled "
                    "effect still runs the OLD definition (hot_reload='off'). Call "
                    "apply_asset_changes() or remove and re-add the instance (reference "
                    "recompiles here, lib.rs:1796).",
                )
            else:
                self.apply_asset_changes(name)

    # -- simulation ----------------------------------------------------------

    def update(self, dt: float, cameras=None) -> None:
        """Advance one frame (scene.py:1042-1150): every effect in scene
        order, then every group in one pass each.

        ``cameras`` (a camera or a sequence): a WhenVisible effect or group
        whose padded pool/emitter AABB is outside every given frustum ticks
        no spawner and does not step. Without ``cameras`` the manual
        ``set_visible`` flag alone gates. Under ``debug.validate`` every
        step is a checked step. ``last_frame_ms`` keeps the call's host wall
        time (the device work it enqueued may still run)."""
        t0 = time.perf_counter()
        self.debug.on_frame_start(self._new_effect_added)
        with profile_span("hanabi:update"):
            self._update(dt, cameras)
        self.last_frame_ms = (time.perf_counter() - t0) * 1000.0

    def _update(self, dt: float, cameras) -> None:
        """The body of :meth:`update`."""
        self._begin()
        self._new_effect_added = False
        if cameras is not None and not isinstance(cameras, (list, tuple)):
            cameras = [cameras]
        if cameras:
            self._frustum_sim = True
        culled = self._culled_names(cameras) if cameras else set()
        sim = self.clock.advance(dt)
        self._frame += 1
        self._check_footguns()
        validate = self.debug.validate
        # Children consume events emitted by their parent's PREVIOUS step.
        prev_events = {n: dict(e.last_events) for n, e in self._effects.items()}
        # (parent, channel) pairs consumed this frame: a paused parent's
        # buffer must not be re-consumed next frame (events fire once)
        consumed: list = []
        stepped: set = set()
        for name in self._order:
            inst = self._effects[name]
            if inst.asset.simulation_condition is SimulationCondition.WHEN_VISIBLE and (
                not inst.visible or name in culled
            ):
                continue
            frame_seed = np.uint32(inst.rng.integers(0, 2**32))
            props = inst.properties.as_dict()
            step = inst.fx.step_checked if validate else inst.fx.step
            if inst.parent is not None:
                parent = self._effects[inst.parent]
                consumed.append((inst.parent, inst.child_channel))
                events_in = prev_events[inst.parent].get(inst.child_channel)
                if events_in is None:
                    events_in = parent.fx.make_empty_events(parent.pool.capacity)
                inst.pool, events_out = step(
                    inst.pool,
                    StepInputs.make(0, frame_seed, inst.transform, props),
                    sim,
                    events_in=events_in,
                    parent_pool=parent.pool,
                )
            else:
                with profile_span("hanabi:spawn"):
                    n_spawn = inst.spawner.tick(self.clock.delta) if inst.spawner else 0
                inst.pool, events_out = step(
                    inst.pool, StepInputs.make(n_spawn, frame_seed, inst.transform, props), sim
                )
            inst.last_events = events_out
            stepped.add(name)
        # A parent that did not step (paused WhenVisible) keeps stale
        # last_events; drop channels a child consumed this frame.
        for pname, chan in consumed:
            if pname not in stepped:
                self._effects[pname].last_events.pop(chan, None)

        # Instanced groups: one pass per group.
        for gname, g in self._groups.items():
            if self._group_paused(g, culled):
                continue
            with profile_span("hanabi:spawn"):
                counts = g["bank"].tick(self.clock.delta)
            seeds = self._rng.integers(0, 2**32, size=g["fx"].num_instances, dtype=np.uint32)
            inputs = g["fx"].make_inputs(counts, seeds, g["transforms"], g["properties"].as_dict())
            if g.get("sharded"):
                inputs = g["fx"].shard_inputs(inputs)
            step = g["fx"].step_checked if validate else g["fx"].step
            g["pools"], _ = step(g["pools"], inputs, sim)

    @staticmethod
    def _group_paused(g, culled) -> bool:
        return g["asset"].simulation_condition is SimulationCondition.WHEN_VISIBLE and (
            not g["visible"] or g["name"] in culled
        )

    def _root_of(self, name: str) -> str:
        inst = self._effects[name]
        while inst.parent is not None:
            inst = self._effects[inst.parent]
        return inst.name

    def _collect_chunk_inputs(self, frames: int, dt: float, on_frame=None, culled=frozenset()):
        """Host-side prep for a chunk (scene.py:1296-1391): freeze
        visibility, resolve event trees, precompute every frame's spawner
        ticks, seeds, transforms and property values, the groups' after the
        effects' each frame. Returns ``(active_effects, active_groups,
        families, per_effect_inputs, per_group_inputs, sims)``.

        ``on_frame(scene, i)`` runs on the host before frame ``i``'s inputs
        are captured. ``culled``: frustum-culled names, frozen for the chunk
        like visibility; WhenVisible effects and groups in it pause."""

        def family_paused(name):
            rname = self._root_of(name)
            root = self._effects[rname]
            return root.asset.simulation_condition is SimulationCondition.WHEN_VISIBLE and (
                not root.visible or rname in culled
            )

        active_effects = [n for n in self._order if not family_paused(n)]
        active_groups = [n for n, g in self._groups.items() if not self._group_paused(g, culled)]
        # event trees: root -> topologically ordered member names; childless
        # emitters run as single-member trees so their last_events stay fresh
        families: Dict[str, list] = {}
        for n in active_effects:
            inst = self._effects[n]
            if inst.parent is not None or inst.fx.num_event_channels:
                families.setdefault(self._root_of(n), []).append(n)

        sims = []
        per_effect_inputs = {n: [] for n in active_effects}
        per_group_inputs = {n: [] for n in active_groups}
        for i in range(frames):
            if on_frame is not None:
                on_frame(self, i)
            sims.append(self.clock.advance(dt))
            for name in active_effects:
                inst = self._effects[name]
                n_spawn = (
                    inst.spawner.tick(self.clock.delta)
                    if inst.spawner and inst.parent is None
                    else 0
                )
                per_effect_inputs[name].append(
                    StepInputs.make(
                        n_spawn,
                        np.uint32(inst.rng.integers(0, 2**32)),
                        inst.transform,
                        inst.properties.as_dict(),
                    )
                )
            for gname in active_groups:
                g = self._groups[gname]
                per_group_inputs[gname].append(
                    g["fx"].make_inputs(
                        g["bank"].tick(self.clock.delta),
                        self._rng.integers(0, 2**32, size=g["fx"].num_instances, dtype=np.uint32),
                        g["transforms"],
                        g["properties"].as_dict(),
                    )
                )
        self._frame += frames
        return active_effects, active_groups, families, per_effect_inputs, per_group_inputs, sims

    def update_chunk(self, frames: int, dt: float, on_frame=None) -> None:
        """Advance ``frames`` frames: one ``step_chunk`` per effect outside
        any event tree, one family chunk per tree, one ``step_chunk`` per
        group (scene.py:1393-1485). The pending event buffers ride between
        the frames of a family on the device; nothing reads back per
        frame. Under ``debug.validate`` every chunk is checked, with one
        readback each."""
        self._begin()
        (active_effects, active_groups, families, per_effect_inputs, per_group_inputs,
         sims) = self._collect_chunk_inputs(frames, dt, on_frame)
        validate = self.debug.validate
        family_members = {n for mem in families.values() for n in mem}
        for name in active_effects:
            if name in family_members:
                continue
            inst = self._effects[name]
            ii, ss = CompiledEffect.stack_frames(per_effect_inputs[name], sims)
            chunk = inst.fx.step_chunk_checked if validate else inst.fx.step_chunk
            inst.pool = chunk(inst.pool, ii, ss)

        for names in families.values():
            insts = [self._effects[n] for n in names]
            index = {n: i for i, n in enumerate(names)}
            # the "##checked" sentinel never collides with an effect name in
            # the cache invalidation's membership tests
            key = tuple(names) + (("##checked",) if validate else ())
            fam_fn = self._family_fn.get(key)
            if fam_fn is None:
                fam_fn = CompiledEffect.make_family_chunk_step(
                    [
                        (
                            inst.fx,
                            index[inst.parent] if inst.parent is not None else None,
                            inst.child_channel,
                        )
                        for inst in insts
                    ],
                    checked=validate,
                )
                self._family_fn[key] = fam_fn
            stacked = [CompiledEffect.stack_frames(per_effect_inputs[n], sims) for n in names]
            member_inputs = tuple(ii for ii, _ in stacked)
            ss = stacked[0][1]
            pendings = tuple(
                {
                    ch: inst.last_events.get(ch) or inst.fx.make_empty_events(inst.pool.capacity)
                    for ch in range(inst.fx.num_event_channels)
                }
                for inst in insts
            )
            carry = (tuple(inst.pool for inst in insts), pendings)
            pools, pendings = fam_fn(carry, member_inputs, ss)
            for inst, pool, pend in zip(insts, pools, pendings):
                inst.pool = pool
                inst.last_events = pend
        for gname in active_groups:
            g = self._groups[gname]
            ii, ss = CompiledEffect.stack_frames(per_group_inputs[gname], sims)
            if g.get("sharded"):
                ii = g["fx"].shard_inputs_stacked(ii)
            chunk = g["fx"].step_chunk_checked if validate else g["fx"].step_chunk
            g["pools"] = chunk(g["pools"], ii, ss)

    def update_render_chunk(
        self,
        frames: int,
        dt: float,
        camera,
        config=None,
        background=None,
        scene_depth=None,
        on_frame=None,
        pipeline: str = "auto",
    ):
        """Advance AND render ``frames`` frames of the whole scene
        (scene.py:1640-1858).

        The JAX package's ``lax.scan`` is a K-frame Python loop here, which
        only enqueues device work: each frame steps every member in scene
        order (children consume their parent's PREVIOUS-frame events, as in
        :meth:`update_chunk`) and every group, then renders the fresh pools
        through the render plan frozen at call time (visibility, frustum
        culling, ordering, batching and phases, like the JAX package); a
        group draws its flat pool with its first instance's property values
        (scene.py:1952-1974).

        ``camera`` may be a SEQUENCE of cameras sharing one viewport: every
        frame then renders every view, as :meth:`render_views` does (the
        plan under ``cameras[0]``, each view's culling masking the alive
        lanes of what it does not see). Under ``debug.validate`` every step
        and frame is checked, with one readback after the chunk.

        Returns ``(image, checksums)``: the last frame's [H, W, 4]
        framebuffer ([V, H, W, 4] for a camera list) and a [K] device tensor
        of per-frame framebuffer sums (over every view); nothing reads back
        inside the loop."""
        self._begin()
        cams = list(camera) if isinstance(camera, (list, tuple)) else None
        if cams is not None:
            self._check_views(cams)
        camera0 = cams[0] if cams is not None else camera
        config, background = self._frame_config(camera0, config, background)
        # the chunk is camera-driven by construction: WhenVisible gating on
        self._frustum_sim = True
        culled = self._culled_names(cams if cams is not None else [camera], for_render=True)
        names, gnames, _, per_effect_inputs, per_group_inputs, sims = self._collect_chunk_inputs(
            frames, dt, on_frame, culled=culled
        )
        insts = [self._effects[n] for n in names]
        groups = [self._groups[g] for g in gnames]
        index = {n: i for i, n in enumerate(names)}
        plan = self._scene_render_plan(insts, camera0, pipeline, culled=culled, groups=groups)
        if cams is not None:
            hidden = self._hidden_per_view(cams, insts, groups)
        bg = torch.tensor(background, dtype=torch.float32, device=self.device).expand(
            config.height, config.width, 4
        )
        pendings = [
            {
                ch: inst.last_events.get(ch) or inst.fx.make_empty_events(inst.pool.capacity)
                for ch in range(inst.fx.num_event_channels)
            }
            for inst in insts
        ]
        checks = StepChecks() if self.debug.validate else None
        img = bg if cams is None else bg.expand(len(cams), *bg.shape)
        sums = []
        for j in range(frames):
            new_pendings = []
            for inst in insts:
                ev_in = (
                    None
                    if inst.parent is None
                    else pendings[index[inst.parent]][inst.child_channel]
                )
                inst.pool, ev_out = inst.fx._step(
                    inst.pool, per_effect_inputs[inst.name][j], sims[j], ev_in, None, checks=checks
                )
                new_pendings.append(ev_out)
            pendings = new_pendings
            for g in groups:
                g["pools"], _ = g["fx"]._step(g["pools"], per_group_inputs[g["name"]][j],
                                              sims[j], checks)
            # the frame renderer of scene.py:1860-2097: the plan over the
            # fresh pools, each effect with this frame's transform and
            # properties, each group with its first instance's properties
            inputs = [(per_effect_inputs[n][j].transform, per_effect_inputs[n][j].properties)
                      for n in names]
            group_props = [
                {k: v[0] for k, v in per_group_inputs[g][j].properties.items()} for g in gnames
            ]

            def frame(cam, hid=frozenset()):
                return self._render_frame(insts, plan, inputs, sims[j], cam, config, bg,
                                          scene_depth, groups=groups, group_props=group_props,
                                          hidden=hid)

            if cams is None:
                img = frame(camera)
            else:
                img = torch.stack([frame(c, h) for c, h in zip(cams, hidden)])
            if checks is not None:
                checks.finite({"framebuffer": img}, f"the render of frame {j} of the chunk")
            sums.append(img.sum())
        for inst, pend in zip(insts, pendings):
            inst.last_events = pend
        if checks is not None:
            checks.raise_if_failed()
        return img, (torch.stack(sums) if sums else torch.zeros(0, device=self.device))

    @staticmethod
    def _check_views(cameras) -> None:
        if not cameras:
            raise ValueError("a camera list must not be empty")
        if any(c.viewport != cameras[0].viewport for c in cameras):
            raise ValueError("all views must share one viewport")

    def _hidden_per_view(self, cameras, insts, groups) -> List[set]:
        """For each camera, the names of the effects and groups of the plan
        that its frustum culls (:meth:`_per_view_visibility`)."""
        vis_eff, vis_grp = self._per_view_visibility(cameras, insts, groups)
        return [
            {i.name for i, ok in zip(insts, ve) if not ok}
            | {g["name"] for g, ok in zip(groups, vg) if not ok}
            for ve, vg in zip(vis_eff, vis_grp)
        ]

    def render_views(self, cameras, config=None, background=None, scene_depth=None,
                     pipeline: str = "auto") -> torch.Tensor:
        """Render the CURRENT scene state from V cameras sharing one
        viewport (scene.py:2196-2339); returns a [V, H, W, 4] image stack.

        A loop over the views through :meth:`render`'s passes, the plan
        (ordering, batching, phases) frozen under ``cameras[0]`` as in the
        JAX package: same-kind transparent PASSES composite in camera-0
        order in every view (within a pass, and across opaque and mask
        content, per-pixel depth is exact per view). Culling is per view: an
        entity outside EVERY frustum leaves the plan; one outside only SOME
        keeps its pass with its alive lanes masked in those views, so it
        contributes nothing there. ``scene_depth`` is shared by all views."""
        self._begin()
        cameras = list(cameras)
        self._check_views(cameras)
        config, background = self._frame_config(cameras[0], config, background)
        insts = [self._effects[n] for n in self._order]
        groups = list(self._groups.values())
        plan = self._scene_render_plan(
            insts, cameras[0], pipeline, culled=self._culled_names(cameras, for_render=True),
            groups=groups,
        )
        hidden = self._hidden_per_view(cameras, insts, groups)
        fb = torch.tensor(background, dtype=torch.float32, device=self.device).expand(
            config.height, config.width, 4
        )
        inputs = [(inst.transform, inst.properties.as_dict()) for inst in insts]
        group_props = []
        for g in groups:
            n = g["fx"].num_instances
            ins = g["fx"].make_inputs(np.zeros(n, np.int32), np.zeros(n, np.uint32),
                                      g["transforms"], g["properties"].as_dict())
            group_props.append({k: v[0] for k, v in ins.properties.items()})
        sim = self.clock.sim_params()
        return torch.stack([
            self._render_frame(insts, plan, inputs, sim, cam, config, fb, scene_depth,
                               groups=groups, group_props=group_props, hidden=hid)
            for cam, hid in zip(cameras, hidden)
        ])

    # -- rendering -------------------------------------------------------------

    def _scene_render_plan(self, insts, camera, pipeline="auto", culled=frozenset(), groups=()):
        """The render plan (scene.py:1499-1638): visible, unculled effects
        back to front by emitter distance under ``camera``, split into
        opaque/mask and transparent phases, each phase's same-blend runs
        batched into ("batch", idxs, kind) and the rest as ("eff", i, kind)
        (mask, ribbon, mesh, textured and raster-overridden effects never
        batch), then each phase's visible ``groups`` as ("grp", gi, kind).
        Returns ``(opaque_passes, transp_passes)``. "auto" takes the painter
        pass, the single descriptor ("painter", idxs, group_idxs) in
        ``transp_passes``, when every visible effect and group is eligible
        (no raster override) and the split plan has two or more passes;
        "painter" always does, and raises for an ineligible one; "split"
        never."""
        with profile_span("hanabi:plan"):
            if pipeline not in ("auto", "split", "painter"):
                raise ValueError(f"pipeline must be 'auto', 'split' or 'painter'; got {pipeline!r}")
            view_h = np.asarray(camera.view)
            cam_pos = -view_h[:3, :3].T @ view_h[:3, 3]

            def dist_key(i):
                t = np.asarray(insts[i].transform)[:, 3]
                return (-float(np.linalg.norm(cam_pos - t)), insts[i].asset.z_layer_2d)

            vis_idx = sorted(
                (i for i, inst in enumerate(insts) if inst.visible and inst.name not in culled),
                key=dist_key,
            )

            def batch_key(inst):
                """The blend state a batch shares; None for an effect that never
                batches (mask cutoffs, ribbon segments, meshes and textures are
                per effect)."""
                asset = inst.asset
                kind = asset.alpha_mode.kind
                if (kind == "mask" or asset.particle_layout().contains("ribbon_id")
                        or asset.mesh is not None or inst.textures or inst.raster_override
                        or inst.fx.mesh is not None):
                    return None
                return kind

            def build_passes(idxs):
                runs = []
                for i in idxs:
                    key = batch_key(insts[i])
                    if runs and key is not None and runs[-1][0] == key:
                        runs[-1][1].append(i)
                    else:
                        runs.append([key, [i]])
                passes = []
                for key, members in runs:
                    if key is not None and len(members) > 1:
                        passes.append(("batch", tuple(members), key))
                    else:
                        passes.extend(("eff", i, insts[i].asset.alpha_mode.kind) for i in members)
                return tuple(passes)

            opaque = [i for i in vis_idx if insts[i].asset.alpha_mode.is_opaque()]
            vis_groups = [gi for gi, g in enumerate(groups) if g["visible"] and g["name"] not in culled]
            opq_groups = [gi for gi in vis_groups if groups[gi]["asset"].alpha_mode.is_opaque()]
            opaque_passes = build_passes(opaque) + tuple(
                ("grp", gi, groups[gi]["asset"].alpha_mode.kind) for gi in opq_groups
            )
            transp_passes = build_passes([i for i in vis_idx if i not in opaque]) + tuple(
                ("grp", gi, groups[gi]["asset"].alpha_mode.kind)
                for gi in vis_groups if gi not in opq_groups
            )
            if pipeline == "split":
                return opaque_passes, transp_passes
            eligible = not any(insts[i].raster_override for i in vis_idx) and not any(
                groups[gi]["raster_override"] for gi in vis_groups
            )
            if pipeline == "painter" and not eligible:
                raise ValueError(
                    "pipeline='painter' requires every visible effect/group to be "
                    "painter-eligible (no per-effect raster overrides) — use 'auto' to fall "
                    "back to the split pipeline automatically"
                )
            n_passes = len(opaque_passes) + len(transp_passes)
            if (vis_idx or vis_groups) and eligible and (pipeline == "painter" or n_passes >= 2):
                return (), (("painter", tuple(vis_idx), tuple(vis_groups)),)
            return opaque_passes, transp_passes

    def _frame_config(self, camera, config, background):
        """The raster config aligned to the camera viewport, and the clear
        colour: ``background``, else ``config.background``, else opaque black."""
        from ..render.raster import RasterConfig

        vw, vh = camera.viewport
        if background is None:
            background = config.background if config is not None else (0.0, 0.0, 0.0, 1.0)
        if config is None:
            config = RasterConfig(width=vw, height=vh)
        elif (config.width, config.height) != (vw, vh):
            config = dataclasses.replace(config, width=vw, height=vh)
        return config, background

    def render(
        self,
        camera,
        config=None,
        background=None,
        scene_depth=None,
        return_depth: bool = False,
        pipeline: str = "auto",
    ):
        """Render every visible effect (scene.py:2347-2527) into a
        [height, width, 4] f32 image on the scene's device, through the
        plan of :meth:`_scene_render_plan`. ``config`` defaults to a
        ``RasterConfig`` sized from the camera viewport; a mismatched one is
        aligned to the viewport. ``scene_depth`` ([H, W] view distances,
        +inf where empty) occludes particles behind it in every pass;
        ``return_depth=True`` returns ``(image, depth)``, the scene depth
        merged with everything the opaque and mask entries wrote. Under
        ``debug.validate`` a phase-split frame must be finite
        (``FloatingPointError`` otherwise, scene.py:2515-2520)."""
        with profile_span("hanabi:render"):
            self._begin()
            config, background = self._frame_config(camera, config, background)
            fb = torch.tensor(background, dtype=torch.float32, device=self.device).expand(
                config.height, config.width, 4
            )
            insts = [self._effects[n] for n in self._order]
            groups = list(self._groups.values())
            plan = self._scene_render_plan(
                insts, camera, pipeline, culled=self._culled_names([camera], for_render=True),
                groups=groups,
            )
            inputs = [(inst.transform, inst.properties.as_dict()) for inst in insts]
            out = self._render_frame(
                insts, plan, inputs, self.clock.sim_params(), camera, config, fb, scene_depth,
                return_depth, groups=groups,
                group_props=[g["properties"].as_dict() for g in groups], sharded_passes=True,
            )
            painter = bool(plan[1]) and plan[1][0][0] == "painter"
            if self.debug.validate and not painter:
                img = out[0] if return_depth else out
                if not bool(torch.isfinite(img).all()):
                    raise FloatingPointError(
                        "debug validation: rendered framebuffer contains non-finite pixels — a "
                        "nan or inf reached the raster output (poison read, bad color "
                        "expression, or degenerate projection)"
                    )
            return out

    @staticmethod
    def _view_pool(pool: ParticlePool, hidden: bool) -> ParticlePool:
        """``pool``, or for a view that culls it the same pool with every
        lane dead (the JAX package's per-view alive mask, scene.py:1919-1928)."""
        if not hidden:
            return pool
        return ParticlePool(pool.attrs, torch.zeros_like(pool.alive), pool.seed, pool.counter)

    def _render_frame(self, insts, plan, inputs, sim, camera, config, fb, scene_depth=None,
                      return_depth=False, groups=(), group_props=(), hidden=frozenset(),
                      sharded_passes=False):
        """Run a render plan onto ``fb``. ``inputs[i]`` is effect i's
        (transform, properties), ``group_props[gi]`` the properties group
        ``gi`` draws with; the effects and groups named in ``hidden`` draw
        with every lane masked (a view that culls them). Phase split as the
        reference's render phases: opaque and mask passes draw first
        threading the depth plane, then the transparent passes test against
        it. Sharded pools draw assembled on the scene's device, but with
        ``sharded_passes`` (:meth:`render`) a sharded group's own pass goes
        through its :class:`~..parallel.render.ShardedRenderer`
        (scene.py:2485-2491)."""
        opaque_passes, transp_passes = plan
        pools = [self._view_pool(self._flat_pool(i), i.name in hidden) for i in insts]
        gpools = [self._view_pool(self._group_flat_pool(g), g["name"] in hidden) for g in groups]
        if scene_depth is not None:
            scene_depth = torch.as_tensor(scene_depth, dtype=torch.float32, device=self.device)
        if transp_passes and transp_passes[0][0] == "painter":
            _, idxs, gidxs = transp_passes[0]
            return self._render_painter(
                [insts[i] for i in idxs], [pools[i] for i in idxs], [inputs[i] for i in idxs],
                camera, config, sim, fb, scene_depth, return_depth,
                groups=[groups[gi] for gi in gidxs], gpools=[gpools[gi] for gi in gidxs],
                group_props=[group_props[gi] for gi in gidxs],
            )
        depth_acc = scene_depth
        entities = (insts, pools, inputs, groups, gpools, group_props)
        for desc in opaque_passes:
            fb, depth_acc = self._run_pass(desc, entities, camera, config, sim, fb, depth_acc, True,
                                           sharded_passes)
        if opaque_passes:
            scene_depth = depth_acc
        for desc in transp_passes:
            fb, _ = self._run_pass(desc, entities, camera, config, sim, fb, scene_depth, False,
                                   sharded_passes)
        if not return_depth:
            return fb
        if depth_acc is None:
            depth_acc = torch.full((config.height, config.width), torch.inf, device=self.device)
        return fb, depth_acc

    def _run_pass(self, desc, entities, camera, config, sim, fb, depth, write_depth,
                  sharded_passes=False):
        """One "eff", "batch" or "grp" pass: returns ``(fb, depth)``.
        ``entities`` is ``(insts, pools, inputs, groups, gpools,
        group_props)``."""
        insts, pools, inputs, groups, gpools, group_props = entities
        tag, which, kind = desc
        if tag == "grp" and sharded_passes and groups[which].get("sharded"):
            out = self._render_sharded_group(groups[which], group_props[which], camera, config,
                                             sim, fb, depth, write_depth)
        elif tag == "batch":
            out = self._render_batch(
                [insts[i] for i in which], [pools[i] for i in which], [inputs[i] for i in which],
                kind, camera, config, sim, fb, depth, write_depth,
            )
        elif tag == "grp":
            out = self._render_entity(groups[which], gpools[which], None, group_props[which],
                                      camera, config, sim, fb, depth, write_depth)
        else:
            transform, props = inputs[which]
            out = self._render_entity(insts[which], pools[which], transform, props, camera,
                                      config, sim, fb, depth, write_depth)
        return out if write_depth else (out, depth)

    @staticmethod
    def _render_entity(entity, pool, transform, props, camera, config, sim, fb, scene_depth=None,
                       return_depth=False):
        """The ``"eff"`` and ``"grp"`` passes: one effect (an
        :class:`EffectInstance`) or group (its dict and flat pool) through its
        EffectRenderer, at the scene config with the entity's raster override."""
        from ..render.renderer import EffectRenderer

        group = isinstance(entity, dict)
        override = entity["raster_override"] if group else entity.raster_override
        if override:
            config = dataclasses.replace(config, **override)
        renderer = entity["renderer"] if group else entity.renderer
        if not isinstance(renderer, EffectRenderer) or renderer.config != config:
            asset = entity["asset"] if group else entity.asset
            textures = entity["textures"] if group else entity.textures
            renderer = EffectRenderer(asset, config, textures=textures)
            if group:
                entity["renderer"] = renderer
            else:
                entity.renderer = renderer
        return renderer.render(
            pool,
            camera,
            sim=sim,
            properties=props,
            transform=transform,
            framebuffer=fb,
            scene_depth=scene_depth,
            return_depth=return_depth,
        )

    def _render_sharded_group(self, g, props, camera, config, sim, fb, scene_depth=None,
                              return_depth=False):
        """Rasterize a sharded group from its mesh, then composite the image
        onto the scene framebuffer with the effect's blend equation
        (scene.py:2529-2563)."""
        from ..parallel.render import ShardedRenderer
        from ..render.renderer import composite_by_mode, neutral_background

        alpha_kind = g["asset"].alpha_mode.kind
        cfg = dataclasses.replace(config, background=neutral_background(alpha_kind))
        r = g["renderer"]
        if not isinstance(r, ShardedRenderer) or r.config != cfg:
            r = ShardedRenderer(g["fx"], cfg, textures=g["textures"], mode=g["render_mode"])
            g["renderer"] = r
        out = r.render(g["pools"], camera, sim=sim, properties=props, scene_depth=scene_depth,
                       return_depth=return_depth)
        if return_depth:
            img, depth = out
            return composite_by_mode(img, fb, alpha_kind), depth
        return composite_by_mode(out, fb, alpha_kind)

    def _render_batch(self, insts, pools, inputs, alpha_kind, camera, config, sim, fb,
                      scene_depth=None, return_depth=False):
        """Rasterize several same-blend-state effects in one pass: one
        (tile, depth) sort for the whole batch (scene.py:2565-2656) over the
        concatenated required draw columns (mask effects never batch)."""
        from ..render.extract import concat_draws, extract_draw_data
        from ..render.raster import rasterize
        from ..render.renderer import composite_by_mode, neutral_background

        cfg0 = dataclasses.replace(config, background=neutral_background(alpha_kind))
        flat = concat_draws([
            extract_draw_data(i.asset, pool, camera, sim=sim, properties=pr, transform=tr)
            for i, pool, (tr, pr) in zip(insts, pools, inputs)
        ])
        out = rasterize(flat, camera, cfg0, alpha_mode=alpha_kind, scene_depth=scene_depth,
                        return_depth=return_depth)
        if return_depth:
            img, depth = out
            return composite_by_mode(img, fb, alpha_kind), depth
        return composite_by_mode(out, fb, alpha_kind)

    def _render_painter(self, insts, pools, inputs, camera, config, sim, fb, scene_depth=None,
                        return_depth=False, groups=(), gpools=(), group_props=()):
        """Every visible effect and group in ONE painter pass (scene.py:2658-2769):
        one global (tile, depth) sort, one window gather, one blend loop
        whose per-entry mode ids select the equation; opaque and mask
        entries write depth mid-loop; a ribbon effect joins as its segment
        quads, a mesh effect as its expanded entries, and textured effects
        through one atlas, a layer for each distinct texture object
        (scene.py:47-75's shared conversion). ``insts`` are in
        back-to-front emitter order, which breaks sort ties only; the
        groups' entries follow the effects', each group's flat pool drawn
        with ``group_props``; ``pools`` and ``gpools`` are the pools each
        effect and group draws."""
        from ..render.extract import concat_painter_draws, extract_draw_data
        from ..render.mesh import expand_mesh_draw
        from ..render.raster import rasterize
        from ..render.ribbon import build_ribbon_segments

        shared = {}  # id(source) -> the first upload of that object
        sources = [(i.texture_sources, i.textures) for i in insts] + [
            (g["texture_sources"], g["textures"]) for g in groups
        ]
        textures = [
            tuple(shared.setdefault(id(src), t) for src, t in zip(srcs, texs))
            for srcs, texs in sources
        ]
        entries = [(i.asset, i.fx.layout, pool, tr, pr)
                   for i, pool, (tr, pr) in zip(insts, pools, inputs)]
        entries += [(g["asset"], g["fx"].effect.layout, gpool, None, pr)
                    for g, gpool, pr in zip(groups, gpools, group_props)]
        draws = []
        for (asset, layout, pool, tr, pr), texs in zip(entries, textures):
            draw = extract_draw_data(asset, pool, camera, sim=sim, properties=pr,
                                     textures=list(texs), transform=tr)
            if layout.contains("ribbon_id"):
                draw = build_ribbon_segments(draw, camera)
            elif asset.mesh is not None:
                draw = expand_mesh_draw(draw, asset.mesh)
            draws.append(draw)
        flat = concat_painter_draws(draws, [e[0].alpha_mode.kind for e in entries],
                                    textures_per_draw=textures)
        return rasterize(flat, camera, config, alpha_mode="scene", scene_depth=scene_depth,
                         framebuffer=fb, return_depth=return_depth)
