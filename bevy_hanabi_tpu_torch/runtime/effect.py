"""Compiled effect: asset → per-frame simulation step
(port of ``bevy_hanabi_tpu/runtime/effect.py``).

One step does spawn + init + update + reap over the whole pool with plain
PyTorch ops on the pool's device. The JAX package's ``lax.scan`` over K
frames becomes a K-frame Python loop; nothing in it reads back from the
device, so the host only enqueues work.

Spawn without atomics: dead lanes are ranked by exclusive cumsum; lanes
with rank < S become this frame's spawns, seeded with
``pcg_hash(rank ^ pcg_hash(frame_seed))`` exactly like the JAX package.

GPU spawn events: a step returns ``(pool, events_out)`` with one
:class:`~.events.EventBuffer` per emitted channel, and a child effect
consumes its parent's previous-frame buffer (``events_in``): its spawn
request is the buffer's device-side total, so no step reads back from the
device. :meth:`CompiledEffect.make_family_chunk_step` runs a whole
parent→child tree for K frames with the pending buffers carried between
frames.

``CompiledEffect(mesh=)`` splits the pool's particle axis over every device
of a :class:`~..parallel.mesh.Mesh` (a :class:`~.pool.ShardedPool`). A
frame then runs in two phases: each shard counts its dead lanes, the counts
cross to every shard's device, and each shard steps its own lanes with the
spawn ranks, the spawn total and the lane indices of the whole pool, so the
trajectories are the unsharded ones bit for bit. Each shard compacts its
own emitted events; the buffer keeps each shard's prefix in place, with
zero-count gaps between them, and every shard of a child reads the whole
buffer (effect.py:155-179, 697-750).

On the card, an effect whose step :mod:`..codegen` can generate (no GPU
events, no mesh, an emitter for every modifier and node) steps through that
one kernel (:class:`~.fused.FusedStep`), which writes the pool's tensors in
place; every unchecked, unsharded frame takes it. Every other frame takes
the eager step. ``fused_frames`` and ``eager_frames`` count the two.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import codegen
from ..asset import EffectAsset, MotionIntegration, SimulationSpace
from ..attributes import ParticleLayout
from ..compiler import InitContext, SimParams, UpdateContext
from ..ops import rng
from ..ops.compaction import exclusive_rank
from ..ops.linalg import affine3, rotate3
from ..utils.profiling import profile_span
from .events import EventBuffer, EventTally, build_event_buffer, channel_emissions, consume_events
from .fused import FusedStep
from .pool import ParticlePool, ShardedPool, gathered, to_device

__all__ = ["CompiledEffect", "StepInputs", "StepChecks", "identity_transform"]


def identity_transform() -> np.ndarray:
    """Emitter transform: rows of a 3x4 [R|t] matrix (host numpy)."""
    return np.concatenate(
        [np.eye(3, dtype=np.float32), np.zeros((3, 1), np.float32)], axis=1
    )


class StepInputs(NamedTuple):
    """Per-frame host inputs for one effect instance: a spawn count, a
    32-bit frame seed, the emitter transform and property values."""

    spawn_count: Any  # int32[]
    frame_seed: Any  # uint32[]
    transform: Any  # f32[3,4]
    properties: Dict[str, Any]

    @staticmethod
    def make(spawn_count=0, frame_seed=0, transform=None, properties=None) -> "StepInputs":
        return StepInputs(
            np.asarray(spawn_count, np.int32),
            np.asarray(frame_seed, np.uint32),
            transform if transform is not None else identity_transform(),
            dict(properties or {}),
        )


class StepChecks:
    """The failure flags of one checked step or chunk (the JAX package's
    checkify instrumentation, effect.py:280-346, as explicit checks).

    :meth:`index` tests a gather's data-derived indices BEFORE the gather
    and hands back clamped ones, so the gather reads in bounds on every
    device (an out-of-range CUDA index is a device-side assert that poisons
    the context). :meth:`finite` flags non-finite floats in what a step
    produced. The flags stay on the device until :meth:`raise_if_failed`,
    the one readback of the step or chunk, raises for the first failure:
    ``FloatingPointError`` (its message says "nan") or ``IndexError``.
    ``readbacks`` counts those readbacks, and stays 0 while
    ``DebugSettings.validate`` is off."""

    readbacks = 0

    def __init__(self) -> None:
        self._flags: list = []
        self._failures: list = []

    def index(self, idx: torch.Tensor, size: int, what: str) -> torch.Tensor:
        """Flag ``idx`` outside ``[0, size)``; returns it clamped there."""
        self._flags.append(((idx < 0) | (idx >= size)).any())
        self._failures.append((IndexError, f"index out of bounds gathering from {what} (size {size})"))
        return idx.clamp(0, size - 1)

    def finite(self, tensors: Dict[str, torch.Tensor], what: str) -> None:
        """Flag a non-finite value in any float tensor of ``tensors``."""
        for name, t in tensors.items():
            if t.is_floating_point():
                self._flags.append(~torch.isfinite(t).all())
                self._failures.append(
                    (FloatingPointError, f"nan or inf generated by {what} in {name!r}")
                )

    def raise_if_failed(self) -> None:
        if not self._flags:
            return
        StepChecks.readbacks += 1
        home = self._flags[0].device  # a sharded step's flags lie on its shards' devices
        failed = torch.stack([f.to(home) for f in self._flags]).cpu().tolist()  # the one readback
        failures, self._flags, self._failures = self._failures, [], []
        for bad, (kind, message) in zip(failed, failures):
            if bad:
                raise kind(f"debug validation: {message}")


class Shard(NamedTuple):
    """Where one shard's lanes sit in the pool a sharded step steps (in each
    instance's pool, for a group): ``rank_base`` counts the dead lanes of
    the shards before it and ``num_free`` those of the whole pool ([] or
    [I] int32, on the shard's device), ``lane_base`` is the index of its
    first lane and ``lanes`` the whole pool's lane count."""

    rank_base: torch.Tensor
    num_free: torch.Tensor
    lane_base: int
    lanes: int


class CompiledEffect:
    """An :class:`EffectAsset` bound to a device, stepping its pools.

    ``device`` is required: the port never defaults to the CPU on the card
    path. Use :meth:`get` to share one instance between effect instances of
    the same asset. ``parent_layout`` marks an effect that consumes GPU
    spawn events from a parent of that layout; ``parent_const_count`` the
    parent channel's constant emit count (``rank // K`` map);
    ``payload_attrs`` restricts the payload this effect's own events
    capture. A step method takes over the pool passed to it, as the JAX
    package donates it: the pool is updated in place, and its old tensors
    may be overwritten (the generated step on the card writes them) or
    replaced (the eager step). The rule is the same on every device and
    path: use the returned pool, and ``clone()`` the tensors of a frame you
    keep.

    ``mesh`` (a :class:`~..parallel.mesh.Mesh`) shards the pool's particle
    axis over all of its devices (the module's docstring); ``device`` is
    then where the effect's event buffers are assembled.

    ``fused_step`` is the generated step (:class:`~.fused.FusedStep`), or
    None and ``fuse_reason`` says why; ``fused_frames`` and
    ``eager_frames`` count the frames each step took.
    """

    _CACHE: "dict" = {}

    @staticmethod
    def get(
        asset: EffectAsset,
        device,
        parent_layout: Optional[ParticleLayout] = None,
        parent_const_count: Optional[int] = None,
        payload_attrs: Optional[tuple] = None,
        mesh=None,
    ) -> "CompiledEffect":
        """The shared instance for this asset signature, parent layout,
        constant count, payload restriction, device and mesh
        (effect.py:96-102)."""
        key = (
            asset.signature(),
            parent_layout.signature() if parent_layout else None,
            parent_const_count,
            payload_attrs,
            torch.device(device),
            mesh,
        )
        fx = CompiledEffect._CACHE.get(key)
        if fx is None:
            fx = CompiledEffect(
                asset, device, parent_layout, parent_const_count, payload_attrs, mesh=mesh
            )
            CompiledEffect._CACHE[key] = fx
        return fx

    def __init__(
        self,
        asset: EffectAsset,
        device,
        parent_layout: Optional[ParticleLayout] = None,
        parent_const_count: Optional[int] = None,
        payload_attrs: Optional[tuple] = None,
        mesh=None,
    ) -> None:
        # a snapshot: the step reads its modifiers on every call, so a later
        # edit of the caller's asset (hot reload) must not leak into an
        # effect compiled from the old definition (the JAX package's traced
        # executables keep theirs), nor into the cache entry of its old key
        self.asset = asset = copy.deepcopy(asset)
        self.device = torch.device(device)
        self.layout = asset.particle_layout()
        if not self.layout.contains("position"):
            raise ValueError(
                f"the particle layout of effect {asset.name!r} is missing "
                "the POSITION attribute — add a position-writing init "
                "modifier (e.g. SetPositionSphereModifier or "
                "SetAttributeModifier(A.POSITION, ...))"
            )
        if self.layout.contains("ribbon_id") and not self.layout.contains("age"):
            raise ValueError(
                f"effect {asset.name!r} uses RIBBON_ID, which requires the "
                "AGE attribute for segment ordering"
            )
        self.mesh = mesh
        self.event_shards = 1 if mesh is None else mesh.size
        if asset.capacity % self.event_shards:
            raise ValueError(
                f"effect capacity {asset.capacity} not divisible by the "
                f"mesh device count {self.event_shards}"
            )
        self.parent_layout = parent_layout
        self.consumes_events = parent_layout is not None
        self.parent_const_count = parent_const_count
        self.payload_attrs = (
            tuple(sorted(payload_attrs)) if payload_attrs is not None else None
        )
        self.num_event_channels = asset.num_event_channels()

        # attributes actually read from the parent (InheritAttributeModifier
        # + parent_attr expression reads): payload gathers are limited to
        # these (effect.py:182-199)
        inherited = set()
        if self.consumes_events:
            from ..modifiers.attr import InheritAttributeModifier

            for m in asset.init_modifiers + asset.update_modifiers + asset.render_modifiers:
                if isinstance(m, InheritAttributeModifier):
                    inherited.add(m.attribute)
            for i in range(1, len(asset.module) + 1):
                if asset.module.get(i).kind == "parent_attribute":
                    inherited.add(asset.module.get(i).name)
        self._inherited_attrs = tuple(sorted(inherited))

        has = self.layout.contains
        self._has_age = has("age")
        self._has_lifetime = has("lifetime")
        self._integrate = (
            asset.motion_integration is not MotionIntegration.NONE
            and has("position")
            and has("velocity")
        )
        self._global_space = asset.simulation_space is SimulationSpace.GLOBAL
        source, self.fuse_reason = codegen.try_generate(asset, self.consumes_events,
                                                         mesh is not None)
        self.fused_step: Optional[FusedStep] = None if source is None else FusedStep(source)
        self.fused_frames = 0
        self.eager_frames = 0

    @property
    def fused_step_share(self) -> float:
        """The share of this effect's frames the generated kernel stepped."""
        total = self.fused_frames + self.eager_frames
        return self.fused_frames / total if total else 0.0

    # -- pool ------------------------------------------------------------

    def create_pool(self, capacity: Optional[int] = None, poison: bool = False):
        """A pool with every slot dead: a :class:`~.pool.ParticlePool` on the
        effect's device, or with a mesh a :class:`~.pool.ShardedPool` of
        ``capacity / D`` lanes on each of its D devices."""
        capacity = capacity or self.asset.capacity
        if self.mesh is None:
            return ParticlePool.create(self.layout, capacity, self.device, poison=poison)
        if capacity % self.event_shards:
            raise ValueError(
                f"pool capacity {capacity} not divisible by the mesh device "
                f"count {self.event_shards}"
            )
        size = capacity // self.event_shards
        return ShardedPool(
            [[ParticlePool.create(self.layout, size, dev, poison=poison)
              for dev in self.mesh.flat_devices()]],
            instanced=False,
        )

    def place_pool(self, pool: ParticlePool):
        """``pool`` (a whole pool, on any device) as this effect keeps it:
        on its device, or split over its mesh."""
        if self.mesh is None:
            return ParticlePool(
                {k: v.to(self.device) for k, v in pool.attrs.items()},
                pool.alive.to(self.device), pool.seed.to(self.device),
                pool.counter.to(self.device),
            )
        return ShardedPool.split(pool, self.mesh.devices, instanced=False)

    def make_empty_events(self, capacity: Optional[int] = None) -> EventBuffer:
        """Empty event buffer shaped for THIS effect's emissions (payload
        restricted to ``payload_attrs``), on this effect's device (where a
        sharded effect assembles its buffers)."""
        return EventBuffer.empty(
            capacity or self.asset.capacity,
            self.layout,
            attrs=self.payload_attrs,
            device=self.device,
        )

    # -- public step -------------------------------------------------------

    def step(
        self,
        pool: ParticlePool,
        inputs: StepInputs,
        sim: SimParams,
        events_in: Optional[EventBuffer] = None,
        parent_pool: Optional[ParticlePool] = None,
    ):
        """Advance one frame. Returns ``(pool, events_out)`` where
        ``events_out`` is a dict channel→EventBuffer for child effects
        (empty for an effect that emits nothing). ``pool`` is taken over:
        its tensors may be overwritten (the class's in-place rule)."""
        return self._step(pool, inputs, sim, events_in, parent_pool)

    def step_checked(
        self,
        pool: ParticlePool,
        inputs: StepInputs,
        sim: SimParams,
        events_in: Optional[EventBuffer] = None,
        parent_pool: Optional[ParticlePool] = None,
    ):
        """:meth:`step` under debug validation (effect.py:280-309): the
        data-derived gathers bound-checked before they are made, the
        produced pool checked for non-finite floats, one readback; raises
        at the offending frame (a poison read, 0xFFFFFFFF == f32 NaN,
        effect_cache.rs:270-296). Use only under ``DebugSettings.validate``."""
        checks = StepChecks()
        out = self._step(pool, inputs, sim, events_in, parent_pool, checks=checks)
        checks.raise_if_failed()
        return out

    def _refuse_events(self, method: str) -> None:
        if self.num_event_channels or self.consumes_events:
            raise ValueError(f"{method} does not support event-linked effects")

    def step_chunk(self, pool: ParticlePool, inputs_stacked: StepInputs, sims_stacked: SimParams):
        """Advance K frames; every leaf of the stacked inputs has a leading
        [K] axis. Only for effects without event channels (events need the
        family chunk, :meth:`make_family_chunk_step`). ``pool`` is taken
        over: its tensors may be overwritten (the class's in-place rule)."""
        self._refuse_events("step_chunk")
        with profile_span("hanabi:chunk"):
            for inputs, sim in _unstack(inputs_stacked, sims_stacked):
                pool, _ = self._step(pool, inputs, sim, None, None)
        return pool

    def step_chunk_checked(self, pool: ParticlePool, inputs_stacked: StepInputs, sims_stacked):
        """:meth:`step_chunk` with every frame checked as in
        :meth:`step_checked` and ONE readback for the chunk
        (effect.py:325-346)."""
        self._refuse_events("step_chunk")
        checks = StepChecks()
        for inputs, sim in _unstack(inputs_stacked, sims_stacked):
            pool, _ = self._step(pool, inputs, sim, None, None, checks=checks)
        checks.raise_if_failed()
        return pool

    def step_render_chunk(
        self,
        pool: ParticlePool,
        inputs_stacked: StepInputs,
        sims_stacked,
        camera,
        config,
        textures=(),
    ):
        """Advance K frames AND render each one; a ribbon effect renders
        its segment quads (:func:`~..render.ribbon.build_ribbon_segments`),
        a mesh effect its expanded entries
        (:func:`~..render.mesh.expand_mesh_draw`), in that precedence
        (effect.py:392-399). ``textures`` ([H, W, 4] RGBA, by slot) are
        uploaded to the pool's device once for the chunk.

        Returns ``(pool, last_image, checksums)``: the image is
        [height, width, 4] f32 and ``checksums`` the [K] per-frame
        framebuffer sums, all on the pool's device. ``pool`` is taken over:
        its tensors may be overwritten (the class's in-place rule)."""
        from ..render.extract import extract_draw_data
        from ..render.mesh import expand_mesh_draw
        from ..render.raster import rasterize
        from ..render.raster import texture_tensor
        from ..render.ribbon import build_ribbon_segments

        self._refuse_events("step_render_chunk")
        with profile_span("hanabi:chunk"):
            alpha_mode = self.asset.alpha_mode.kind
            mesh = self.asset.mesh
            textures = [texture_tensor(t, self.device) for t in textures]
            ribbons = self.layout.contains("ribbon_id")
            img = torch.zeros((config.height, config.width, 4), dtype=torch.float32,
                              device=self.device)
            sums = []
            for inputs, sim in _unstack(inputs_stacked, sims_stacked):
                pool, _ = self._step(pool, inputs, sim, None, None)
                draw = extract_draw_data(
                    self.asset,
                    gathered(pool, self.device),
                    camera,
                    sim=sim,
                    properties=inputs.properties,
                    textures=list(textures),
                    transform=inputs.transform,
                )
                if ribbons:
                    draw = build_ribbon_segments(draw, camera)
                elif mesh is not None:
                    draw = expand_mesh_draw(draw, mesh)
                img = rasterize(draw, camera, config, alpha_mode=alpha_mode, textures=textures)
                sums.append(img.sum())
            return pool, img, torch.stack(sums)

    @staticmethod
    def make_family_chunk_step(members, checked: bool = False):
        """A K-frame step over an event-linked effect tree (effect.py:436-497).

        ``members``: topologically ordered (parents first) sequence of
        ``(fx, parent_index, channel)`` — ``parent_index`` indexes into
        ``members`` (None for roots); ``channel`` is the event channel the
        member consumes from its parent. Returns
        ``fn(carry, member_inputs_K, sims_K) -> (pools, pendings)`` where
        ``carry = (tuple(pools), tuple(pendings))`` and ``pendings[i]`` is
        member i's emitted-events dict ``{channel: EventBuffer}``.

        Within each frame every member consumes its parent's PREVIOUS-frame
        buffer (the reference's one-frame latency, vfx_init.wgsl:123-129)
        and contributes its own emissions for the next frame. The JAX
        package's ``lax.scan`` is a Python loop over the frames here; no
        frame reads back from the device.

        ``checked=True`` checks every member's every frame as
        :meth:`step_checked` does, with one readback after the chunk, for
        ``DebugSettings.validate``. ``tallies`` (one :class:`~.events.EventTally`
        or None a member) count each member's events on the device.
        """
        fxs = tuple(m[0] for m in members)
        parent_idx = tuple(m[1] for m in members)
        chans = tuple(m[2] for m in members)

        def fam_chunk(carry, member_inputs, sims, tallies=None):
            pools, pendings = list(carry[0]), tuple(carry[1])
            tallies = tallies or (None,) * len(fxs)
            frames = [list(_unstack(ins, sims)) for ins in member_inputs]
            checks = StepChecks() if checked else None
            for j in range(len(frames[0]) if frames else 0):
                new_pendings = []
                for i, fx in enumerate(fxs):
                    ev_in = None if parent_idx[i] is None else pendings[parent_idx[i]][chans[i]]
                    inputs, sim = frames[i][j]
                    pools[i], ev_out = fx._step(pools[i], inputs, sim, ev_in, None, checks=checks,
                                                tally=tallies[i])
                    new_pendings.append(ev_out)
                pendings = tuple(new_pendings)
            if checks is not None:
                checks.raise_if_failed()
            return tuple(pools), pendings

        return fam_chunk

    @staticmethod
    def stack_frames(inputs_list, sims_list):
        """Stack per-frame StepInputs/SimParams into [K]-leading host arrays."""
        inputs = StepInputs(
            np.stack([np.asarray(i.spawn_count) for i in inputs_list]),
            np.stack([np.asarray(i.frame_seed) for i in inputs_list]),
            np.stack([np.asarray(i.transform) for i in inputs_list]),
            {
                k: np.stack([np.asarray(i.properties[k]) for i in inputs_list])
                for k in inputs_list[0].properties
            },
        )
        sims = SimParams(
            **{
                f.name: (
                    None
                    if getattr(sims_list[0], f.name) is None
                    else np.stack([np.asarray(getattr(s, f.name), np.float32) for s in sims_list])
                )
                for f in dataclasses.fields(SimParams)
            }
        )
        return inputs, sims

    # -- body ---------------------------------------------------------------

    def _step(
        self,
        pool: ParticlePool,
        inputs: StepInputs,
        sim: SimParams,
        events_in: Optional[EventBuffer],
        parent_pool: Optional[ParticlePool],
        instances: int = 0,
        checks: Optional[StepChecks] = None,
        shard: Optional[Shard] = None,
        emissions: bool = False,
        staged=None,
        tally: Optional[EventTally] = None,
    ):
        """One frame. ``instances`` > 0 steps an instanced group
        (:class:`~.instanced.InstancedEffect`) in one pass: ``pool`` is the
        flat ``[I*N]`` view of its ``[I, N]`` pools with ``counter`` [I],
        and ``inputs`` hold [I] spawn counts and frame seeds, [I, 3, 4]
        transforms and [I, ...] property values. Every lane carries its
        instance's values (the reference Batcher's shape,
        vfx_update.wgsl:51-72): the spawn ranks, counts and counters are
        per instance, ``PARTICLE_INDEX`` is the lane's index in its
        instance, so each instance steps as the JAX package's vmapped
        ``_step`` steps it, and an emitting asset's buffers carry a leading
        [I] axis, each instance compacted on its own. ``checks`` (a
        :class:`StepChecks`) turns on the checked step's bound and
        non-finite checks. ``shard`` steps ``pool`` as one shard of a
        sharded pool (:class:`Shard`); a sharded effect's
        :class:`~.pool.ShardedPool` goes through :meth:`_step_sharded`.
        ``emissions``: each emitted channel's ``(mask, count, captured)``
        in place of its buffer (a sharded group's shard, whose instances'
        lanes are compacted with those of the other shards). ``staged``: a
        group's chunk of words for the generated step and this frame's index
        in it (:meth:`~.fused.FusedStep.stage`). ``tally`` (a scene member's
        :class:`~.events.EventTally`) takes the frame's emitted events and,
        for a child, the spawns requested and made. A frame is one
        ``hanabi:step`` span; a shard's step runs inside its frame's, and
        each emission's compaction and a child's consumption are
        ``hanabi:events`` spans inside it."""
        if shard is not None:
            return self._step_frame(pool, inputs, sim, events_in, parent_pool, instances, checks,
                                    shard, emissions, tally)
        with profile_span("hanabi:step"):
            fused = self.fused_step
            if fused is not None and checks is None and events_in is None \
                    and pool.device.type == "cuda":
                pool = fused.step(pool, inputs, sim, instances, staged)
                self.fused_frames += 1
                return pool, {}
            self.eager_frames += 1
            if self.mesh is not None:
                return self._step_sharded(pool, inputs, sim, events_in, parent_pool, checks,
                                          tally)
            return self._step_frame(pool, inputs, sim, events_in, parent_pool, instances, checks,
                                    None, emissions, tally)

    def _step_frame(self, pool, inputs, sim, events_in, parent_pool, instances, checks, shard,
                    emissions, tally=None):
        """The body of :meth:`_step`: one frame of ``pool`` on its device.
        ``tally`` takes the frame's counts in one :meth:`~.events.EventTally.add`;
        a shard's, only the spawns (:meth:`_step_sharded` adds the emissions)."""
        dev = pool.device
        n = pool.alive.shape[-1]
        group = instances > 0
        per = n // instances if group else n  # lanes an instance
        slot_ids = torch.arange(n, dtype=rng.U32, device=dev)
        if group:
            slot_ids = slot_ids % per
        if shard is not None:
            # PARTICLE_INDEX is the lane's index in the whole pool
            slot_ids = slot_ids + shard.lane_base

        def lanes(x: torch.Tensor) -> torch.Tensor:
            """A per-instance [I, ...] tensor repeated to the [I*N, ...] lanes."""
            return x.repeat_interleave(per, dim=0)

        # ---- spawn ranking (replaces dead-list atomics) ----
        dead = ~pool.alive
        if group:
            free_rank = exclusive_rank(dead.view(instances, per)).view(n)
            num_free = torch.sum(dead.view(instances, per), dim=-1, dtype=torch.int32)
        else:
            free_rank = exclusive_rank(dead)  # 0-based among dead
            num_free = torch.sum(dead, dtype=torch.int32)
        if shard is not None:
            # ranked among the whole pool's dead lanes, as one cumsum over
            # it ranks them (GSPMD's cross-shard scan in the JAX package)
            free_rank = free_rank + (lanes(shard.rank_base) if group else shard.rank_base)
            num_free = shard.num_free

        parent_payload: Dict[str, torch.Tensor] = {}
        spawns = None  # a child's (requested, spawned) device scalars
        if self.consumes_events:
            if events_in is None:
                raise ValueError(
                    f"effect {self.asset.name!r} consumes GPU spawn events; pass events_in"
                )
            with profile_span("hanabi:events"):
                parent_slot, requested, parent_payload = consume_events(
                    events_in,
                    free_rank,
                    attrs=self._inherited_attrs,
                    const_count=self.parent_const_count,
                    checks=checks,
                    lanes=None if shard is None else shard.lanes,
                )
                # the request is a device scalar: no readback
                spawn_total = torch.minimum(requested, num_free)
            spawns = (requested, spawn_total)
        elif group:
            # one request an instance, host data
            requested = torch.as_tensor(
                np.asarray(inputs.spawn_count, np.int32).reshape(instances), device=dev
            )
            spawn_total = torch.minimum(requested, num_free)
        else:
            # the root's request is host data
            spawn_total = torch.clamp(num_free, max=int(inputs.spawn_count))
        spawn_mask = dead & (free_rank < (lanes(spawn_total) if group else spawn_total))

        # ---- init pass ----
        if group:
            seeds = np.asarray(inputs.frame_seed, np.uint32).reshape(instances).astype(np.int64)
            frame_hash = lanes(torch.as_tensor(rng.pcg_hash(seeds), device=dev))
        else:
            frame_hash = int(rng.pcg_hash(rng.as_u32(np.int64(np.uint32(inputs.frame_seed)))))
        spawn_seed = rng.initial_seed(free_rank.to(rng.U32), frame_hash)

        defaults: Dict[str, torch.Tensor] = {}
        for a in self.layout.storage_attributes():
            shape = (n,) if a.lanes == 1 else (n, a.lanes)
            defaults[a.name] = to_device(a.default_numpy().astype(a.np_dtype), dev).expand(shape)
        if "particle_counter" in defaults:
            base = lanes(pool.counter) if group else pool.counter
            defaults["particle_counter"] = (base + free_rank.to(rng.U32)) & 0xFFFFFFFF
        properties = inputs.properties
        if group:
            properties = {
                k: lanes(v if isinstance(v, torch.Tensor) else to_device(np.asarray(v), dev))
                for k, v in properties.items()
            }

        # Inherited attributes come from the event payload (captured at
        # emission — immune to parent slot recycling); a parent_pool gather
        # remains as fallback for payload-less buffers.
        parent_particle = None
        if self.consumes_events and self._inherited_attrs:
            if parent_payload:
                parent_particle = parent_payload
            elif parent_pool is not None:
                parent_pool = gathered(parent_pool, dev)
                if checks is not None:
                    parent_slot = checks.index(parent_slot, parent_pool.capacity, "the parent pool")
                parent_particle = {
                    k: parent_pool.attrs[k][parent_slot]
                    for k in self._inherited_attrs
                    if k in parent_pool.attrs
                }

        ictx = InitContext(
            self.asset.module,
            defaults,
            spawn_seed,
            sim=sim,
            properties=properties,
            parent_particle=parent_particle,
            particle_index=slot_ids,
            lane_properties=group,
        )
        for m in self.asset.init_modifiers:
            m.apply(self.asset.module, ictx)

        # Emitter transform (global sim space): position w=1, velocity w=0.
        # Broadcast math, not `@` (no TF32; ops/linalg.py).
        # An instanced group applies instance i's [3, 4] to its lanes through
        # an [I, N, 3] view of the columns.
        if self._global_space:
            tf = torch.tensor(np.asarray(inputs.transform, np.float32), device=dev)
            rot, tr = tf[..., :3], tf[..., 3]
            if group:
                rot, tr = rot[:, None], tr[:, None]
            for name in ("position", "velocity"):
                if name not in ictx.particle:
                    continue
                v = ictx.particle[name]
                if group:
                    v = v.expand(n, 3).reshape(instances, per, 3)
                v = affine3(v, rot, tr) if name == "position" else rotate3(v, rot)
                ictx.particle[name] = v.reshape(n, 3)

        # Merge spawned lanes into the pool.
        attrs = {}
        for name, old in pool.attrs.items():
            m = spawn_mask if old.dim() == 1 else spawn_mask[:, None]
            attrs[name] = torch.where(m, ictx.particle[name], old)
        seed = torch.where(spawn_mask, ictx.seed, pool.seed)
        alive = pool.alive | spawn_mask
        counter = (pool.counter + spawn_total.to(rng.U32)) & 0xFFFFFFFF

        # ---- update pass ----
        uctx = UpdateContext(
            self.asset.module,
            attrs,
            seed,
            sim=sim,
            properties=properties,
            particle_index=slot_ids,
            alive=alive,
            lane_properties=group,
        )
        dt = float(np.float32(sim.delta_time))
        if self._has_age:
            uctx.particle["age"] = uctx.particle["age"] + dt
        if self._has_age and self._has_lifetime:
            uctx.alive = uctx.alive & (uctx.particle["age"] < uctx.particle["lifetime"])
        if self._integrate and self.asset.motion_integration is MotionIntegration.PRE_UPDATE:
            uctx.particle["position"] = uctx.particle["position"] + uctx.particle["velocity"] * dt
        for m in self.asset.update_modifiers:
            m.apply(self.asset.module, uctx)
        if self._integrate and self.asset.motion_integration is MotionIntegration.POST_UPDATE:
            uctx.particle["position"] = uctx.particle["position"] + uctx.particle["velocity"] * dt

        # ---- emitted events, aggregated per channel ----
        events_out: Dict[int, EventBuffer] = {}
        if self.num_event_channels:
            with profile_span("hanabi:events"):
                per_channel = channel_emissions(uctx.events_out)
                if self.payload_attrs is None:
                    captured = uctx.particle
                else:
                    captured = {k: uctx.particle[k] for k in self.payload_attrs
                                if k in uctx.particle}
                for channel in range(self.num_event_channels):
                    if channel not in per_channel:
                        buf = self.make_empty_events(per)
                        events_out[channel] = buf.stacked(instances) if group else buf
                    elif emissions:
                        events_out[channel] = (*per_channel[channel], captured)
                    else:
                        mask, counts = per_channel[channel]
                        buf = build_event_buffer(mask, counts, parent_attrs=captured,
                                                 instances=instances)
                        if shard is not None:
                            # the global slot of the emitting lane, gap rows too
                            buf.parent_slot = buf.parent_slot + shard.lane_base
                        events_out[channel] = buf

        if checks is not None:
            checks.finite(uctx.particle, f"the step of effect {self.asset.name!r}")
        pool.attrs = uctx.particle
        pool.alive = uctx.alive
        pool.seed = uctx.seed
        pool.counter = counter
        if tally is not None:
            tally.add(spawns, events_out if shard is None else {})
        return pool, events_out

    def _step_sharded(self, pool: ShardedPool, inputs, sim, events_in, parent_pool, checks,
                      tally=None):
        """One frame of a pool split over the mesh (the module's docstring).
        Phase 1 counts each shard's dead lanes; phase 2 steps each shard on
        its device with its :class:`Shard` from those counts, reading the
        whole parent buffer there; the shards' event buffers are assembled
        on the effect's device (effect.py:697-750). Every shard makes the
        whole pool's spawns: ``tally`` takes them from the first."""
        shards = pool.flat
        size = shards[0].capacity
        dead = [torch.sum(~p.alive, dtype=torch.int32) for p in shards]
        outs = []
        for d, p in enumerate(shards):
            dev = p.device
            counts = [c.to(dev) for c in dead]
            shard = Shard(
                rank_base=torch.stack(counts[:d]).sum(dtype=torch.int32) if d else
                torch.zeros((), dtype=torch.int32, device=dev),
                num_free=torch.stack(counts).sum(dtype=torch.int32),
                lane_base=d * size,
                lanes=size * len(shards),
            )
            ev_in = None if events_in is None else events_in.to(dev)
            _, ev_out = self._step(p, inputs, sim, ev_in, parent_pool, checks=checks, shard=shard,
                                   tally=tally if d == 0 else None)
            outs.append(ev_out)
        events = {ch: EventBuffer.concat([o[ch] for o in outs], self.device) for ch in outs[0]}
        if tally is not None:
            tally.add(None, events)
        return pool, events


def _unstack(inputs_stacked: StepInputs, sims_stacked: SimParams):
    """Per-frame (StepInputs, SimParams) from [K]-leading stacked host arrays."""
    k = len(np.asarray(inputs_stacked.spawn_count))
    fields = [f.name for f in dataclasses.fields(SimParams)]
    for j in range(k):
        inputs = StepInputs(
            inputs_stacked.spawn_count[j],
            inputs_stacked.frame_seed[j],
            inputs_stacked.transform[j],
            {name: v[j] for name, v in inputs_stacked.properties.items()},
        )
        sim = SimParams(
            **{
                f: None if getattr(sims_stacked, f) is None else getattr(sims_stacked, f)[j]
                for f in fields
            }
        )
        yield inputs, sim
