"""Scene orchestration: many effects, parent/child event routing, rendering
(port of ``bevy_hanabi_tpu/runtime/scene.py``, the subset the firework
event tree runs).

A host-side registry of effect instances that each frame ticks spawners,
routes last frame's GPU spawn events from parents to children (the same
one-frame latency as the reference, vfx_init.wgsl:123-129), steps every
instance, and composites renders back to front. The random streams draw in
the JAX package's order — the scene RNG once per :meth:`HanabiScene.add`,
each instance's RNG once per step, each spawner its own — so frame seeds
and spawner ticks are bit-equal to the JAX package's.

Ported: ``add`` (with parents), ``update``, ``update_chunk`` (one family
chunk per event tree), and ``render`` through the split pipeline's
transparent ``"batch"`` and ``"eff"`` passes. Every other branch raises
``NotImplementedError`` naming itself: groups and sharding, cameras for
culling, opaque and mask passes (the depth test), mesh particles, the
painter pipeline, ``update_render_chunk``, ``render_views``, debug
validation, and hot reload (an asset edited after ``add``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..asset import EffectAsset, SimulationCondition
from ..properties import EffectProperties, Property
from ..spawn import EffectSpawner
from ..time import EffectSimulationClock
from .effect import CompiledEffect, StepInputs, identity_transform
from .events import EventBuffer
from .pool import ParticlePool

__all__ = ["HanabiScene", "EffectInstance", "DebugSettings"]


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"HanabiScene: {what} is not ported")


@dataclass
class DebugSettings:
    """The JAX package's debug switch; ``validate=True`` (checked
    executables) is not ported and raises when the scene runs."""

    validate: bool = False


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
    # asset signature captured at add() time: an edit after add() raises
    compiled_signature: Any = None

    def alive_count(self) -> int:
        return int(self.pool.alive_count())


class HanabiScene:
    """Host-side effect world (≈ HanabiPlugin's systems as one object).

    ``device`` is required: every pool of the scene lives there."""

    def __init__(self, seed: int = 0, *, device) -> None:
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)
        self._effects: Dict[str, EffectInstance] = {}
        self._order: List[str] = []  # parents before children
        self.clock = EffectSimulationClock()
        self._frame = 0
        # family chunk steps for update_chunk, keyed by member names
        self._family_fn: Dict = {}
        self.debug = DebugSettings()

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
        ``prng_seed`` overrides ``asset.prng_seed`` for this instance."""
        if textures:
            raise _unported("add(textures=...)")
        if raster_override:
            raise _unported("add(raster_override=...)")
        if mesh is not None:
            raise _unported("add(mesh=...) sharding")
        if cull_pad is not None:
            raise _unported("add(cull_pad=...) frustum culling")
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
            parent_const = p.asset.channel_const_count(child_channel)
        fx = CompiledEffect.get(
            asset,
            self.device,
            parent_layout=parent_layout,
            parent_const_count=parent_const,
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
        )
        self._effects[name] = inst
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
        )
        # the buffer layout changed: drop in-flight events and the family
        # steps that captured the old parent binding
        p.last_events = {}
        self._family_fn = {k: v for k, v in self._family_fn.items() if parent not in k}

    def add_group(self, *args, **kwargs):
        raise _unported("add_group (instanced groups)")

    def add_sharded_group(self, *args, **kwargs):
        raise _unported("add_sharded_group (sharding)")

    def __getitem__(self, name: str) -> EffectInstance:
        return self._effects[name]

    def __contains__(self, name: str) -> bool:
        return name in self._effects

    def effects(self) -> List[EffectInstance]:
        return [self._effects[n] for n in self._order]

    def set_property(self, name: str, prop: str, value) -> None:
        self._effects[name].properties.set(prop, value)

    def set_transform(self, name: str, transform) -> None:
        self._effects[name].transform = np.asarray(transform, np.float32)

    def set_visible(self, name: str, visible: bool) -> None:
        self._effects[name].visible = visible

    def total_alive(self) -> int:
        return sum(e.alive_count() for e in self.effects())

    def _refuse_unported(self) -> None:
        """The JAX package re-checks every asset for edits (hot reload) and
        may run checked executables here; the port has neither."""
        if self.debug.validate:
            raise _unported("DebugSettings.validate (checked executables)")
        for inst in self._effects.values():
            if inst.asset.signature() != inst.compiled_signature:
                raise _unported(
                    f"hot reload: effect {inst.name!r} was edited after add(); "
                    "remove and re-add it"
                )

    # -- simulation ----------------------------------------------------------

    def update(self, dt: float, cameras=None) -> None:
        """Advance one frame (scene.py:1042-1127, without groups and cameras)."""
        if cameras is not None:
            raise _unported("update(cameras=...) frustum culling")
        self._refuse_unported()
        sim = self.clock.advance(dt)
        self._frame += 1
        # Children consume events emitted by their parent's PREVIOUS step.
        prev_events = {n: dict(e.last_events) for n, e in self._effects.items()}
        # (parent, channel) pairs consumed this frame: a paused parent's
        # buffer must not be re-consumed next frame (events fire once)
        consumed: list = []
        stepped: set = set()
        for name in self._order:
            inst = self._effects[name]
            if (
                inst.asset.simulation_condition is SimulationCondition.WHEN_VISIBLE
                and not inst.visible
            ):
                continue
            frame_seed = np.uint32(inst.rng.integers(0, 2**32))
            props = inst.properties.as_dict()
            if inst.parent is not None:
                parent = self._effects[inst.parent]
                consumed.append((inst.parent, inst.child_channel))
                events_in = prev_events[inst.parent].get(inst.child_channel)
                if events_in is None:
                    events_in = parent.fx.make_empty_events(parent.pool.capacity)
                inst.pool, events_out = inst.fx.step(
                    inst.pool,
                    StepInputs.make(0, frame_seed, inst.transform, props),
                    sim,
                    events_in=events_in,
                )
            else:
                n_spawn = inst.spawner.tick(self.clock.delta) if inst.spawner else 0
                inst.pool, events_out = inst.fx.step(
                    inst.pool, StepInputs.make(n_spawn, frame_seed, inst.transform, props), sim
                )
            inst.last_events = events_out
            stepped.add(name)
        # A parent that did not step (paused WhenVisible) keeps stale
        # last_events; drop channels a child consumed this frame.
        for pname, chan in consumed:
            if pname not in stepped:
                self._effects[pname].last_events.pop(chan, None)

    def _root_of(self, name: str) -> str:
        inst = self._effects[name]
        while inst.parent is not None:
            inst = self._effects[inst.parent]
        return inst.name

    def _collect_chunk_inputs(self, frames: int, dt: float, on_frame=None):
        """Host-side prep for a chunk (scene.py:1296-1391, without groups):
        freeze visibility, resolve event trees, precompute every frame's
        spawner ticks, seeds, transforms and property values.

        ``on_frame(scene, i)`` runs on the host before frame ``i``'s inputs
        are captured."""

        def family_paused(name):
            root = self._effects[self._root_of(name)]
            return (
                root.asset.simulation_condition is SimulationCondition.WHEN_VISIBLE
                and not root.visible
            )

        active_effects = [n for n in self._order if not family_paused(n)]
        # event trees: root -> topologically ordered member names; childless
        # emitters run as single-member trees so their last_events stay fresh
        families: Dict[str, list] = {}
        for n in active_effects:
            inst = self._effects[n]
            if inst.parent is not None or inst.fx.num_event_channels:
                families.setdefault(self._root_of(n), []).append(n)

        sims = []
        per_effect_inputs = {n: [] for n in active_effects}
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
        self._frame += frames
        return active_effects, families, per_effect_inputs, sims

    def update_chunk(self, frames: int, dt: float, on_frame=None) -> None:
        """Advance ``frames`` frames: one ``step_chunk`` per effect outside
        any event tree, one family chunk per tree (scene.py:1393-1469,
        without groups). The pending event buffers ride between the frames
        of a family on the device; nothing reads back per frame."""
        self._refuse_unported()
        active_effects, families, per_effect_inputs, sims = self._collect_chunk_inputs(
            frames, dt, on_frame
        )
        family_members = {n for mem in families.values() for n in mem}
        for name in active_effects:
            if name in family_members:
                continue
            inst = self._effects[name]
            ii, ss = CompiledEffect.stack_frames(per_effect_inputs[name], sims)
            inst.pool = inst.fx.step_chunk(inst.pool, ii, ss)

        for names in families.values():
            insts = [self._effects[n] for n in names]
            index = {n: i for i, n in enumerate(names)}
            key = tuple(names)
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
                    ]
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

    def update_render_chunk(self, *args, **kwargs):
        raise _unported("update_render_chunk")

    def render_views(self, *args, **kwargs):
        raise _unported("render_views")

    # -- rendering -------------------------------------------------------------

    def _scene_render_plan(self, insts, camera, pipeline="auto"):
        """The transparent passes of the split pipeline (scene.py:1499-1638,
        without groups and culling): visible effects back to front by
        emitter distance under ``camera``, same-blend runs batched into
        ("batch", idxs, kind), a lone effect as ("eff", i, kind). Raises
        where the JAX package's plan would need what is not ported: an
        opaque or mask effect (the depth test), a mesh effect, or the
        painter pipeline (asked for, or picked by the auto rule for two or
        more passes)."""
        if pipeline not in ("auto", "split", "painter"):
            raise ValueError(f"pipeline must be 'auto', 'split' or 'painter'; got {pipeline!r}")
        view_h = np.asarray(camera.view)
        cam_pos = -view_h[:3, :3].T @ view_h[:3, 3]

        def dist_key(i):
            t = np.asarray(insts[i].transform)[:, 3]
            return (-float(np.linalg.norm(cam_pos - t)), insts[i].asset.z_layer_2d)

        vis_idx = sorted((i for i, inst in enumerate(insts) if inst.visible), key=dist_key)
        if any(insts[i].asset.alpha_mode.kind in ("opaque", "mask") for i in vis_idx):
            raise _unported("opaque and mask passes (they need the depth test)")
        if any(insts[i].asset.mesh is not None for i in vis_idx):
            raise _unported("mesh particles")
        runs = []
        for i in vis_idx:
            kind = insts[i].asset.alpha_mode.kind
            if runs and runs[-1][0] == kind:
                runs[-1][1].append(i)
            else:
                runs.append([kind, [i]])
        passes = [
            ("batch", tuple(members), kind) if len(members) > 1 else ("eff", members[0], kind)
            for kind, members in runs
        ]
        if pipeline == "painter" or (pipeline == "auto" and len(passes) >= 2):
            raise _unported("the painter pipeline (the plan has >= 2 passes or it was asked for)")
        return passes

    def render(
        self,
        camera,
        config=None,
        background=None,
        scene_depth=None,
        return_depth: bool = False,
        pipeline: str = "auto",
    ) -> torch.Tensor:
        """Composite all visible effects back to front by emitter distance
        (scene.py:2347-2527) into a [height, width, 4] f32 image on the
        scene's device. ``config`` defaults to a ``RasterConfig`` sized from
        the camera viewport; a mismatched one is aligned to the viewport.
        The clear colour is ``background``, else ``config.background``,
        else opaque black."""
        from ..render.raster import RasterConfig

        if scene_depth is not None or return_depth:
            raise _unported("render with the depth test (scene_depth / return_depth)")
        self._refuse_unported()
        vw, vh = camera.viewport
        if background is None:
            background = config.background if config is not None else (0.0, 0.0, 0.0, 1.0)
        if config is None:
            config = RasterConfig(width=vw, height=vh)
        elif (config.width, config.height) != (vw, vh):
            config = dataclasses.replace(config, width=vw, height=vh)
        fb = torch.tensor(background, dtype=torch.float32, device=self.device).expand(
            config.height, config.width, 4
        )
        sim = self.clock.sim_params()
        insts_all = [self._effects[n] for n in self._order]
        for tag, which, kind in self._scene_render_plan(insts_all, camera, pipeline):
            if tag == "batch":
                fb = self._render_batch([insts_all[i] for i in which], kind, camera, config, sim, fb)
            else:
                fb = self._render_effect(insts_all[which], camera, config, sim, fb)
        return fb

    def _render_effect(self, inst, camera, config, sim, fb):
        """The ``"eff"`` pass: one effect through its EffectRenderer."""
        from ..render.renderer import EffectRenderer

        if inst.renderer is None or inst.renderer.config != config:
            inst.renderer = EffectRenderer(inst.asset, config)
        return inst.renderer.render(
            inst.pool,
            camera,
            sim=sim,
            properties=inst.properties.as_dict(),
            transform=inst.transform,
            framebuffer=fb,
        )

    def _render_batch(self, insts, alpha_kind, camera, config, sim, fb):
        """Rasterize several same-blend-state effects in one pass: one
        (tile, depth) sort for the whole batch (scene.py:2565-2656)."""
        from ..render.extract import ParticleDrawData, extract_draw_data
        from ..render.raster import rasterize
        from ..render.renderer import composite_by_mode, neutral_background

        cfg0 = dataclasses.replace(config, background=neutral_background(alpha_kind))
        draws = [
            extract_draw_data(
                i.asset,
                i.pool,
                camera,
                sim=sim,
                properties=i.properties.as_dict(),
                transform=i.transform,
            )
            for i in insts
        ]
        flat = ParticleDrawData(
            *(
                torch.cat([getattr(d, f.name) for d in draws])
                for f in dataclasses.fields(ParticleDrawData)
            )
        )
        out = rasterize(flat, camera, cfg0, alpha_mode=alpha_kind)
        return composite_by_mode(out, fb, alpha_kind)
