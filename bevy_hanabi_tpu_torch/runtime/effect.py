"""Compiled effect: asset → per-frame simulation step
(port of ``bevy_hanabi_tpu/runtime/effect.py``).

One step does spawn + init + update + reap over the whole pool with plain
PyTorch ops on the pool's device. The JAX package's ``lax.scan`` over K
frames becomes a K-frame Python loop; nothing in it reads back from the
device, so the host only enqueues work.

Spawn without atomics: dead lanes are ranked by exclusive cumsum; lanes
with rank < S become this frame's spawns, seeded with
``pcg_hash(rank ^ pcg_hash(frame_seed))`` exactly like the JAX package.

GPU spawn events (event-linked assets) are not ported: such assets raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..asset import EffectAsset, MotionIntegration, SimulationSpace
from ..compiler import InitContext, SimParams, UpdateContext
from ..ops import rng
from ..ops.compaction import exclusive_rank
from ..ops.linalg import affine3, rotate3
from .pool import ParticlePool, to_device

__all__ = ["CompiledEffect", "StepInputs", "identity_transform"]


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


class CompiledEffect:
    """An :class:`EffectAsset` bound to a device, stepping its pools.

    ``device`` is required: the port never defaults to the CPU on the card
    path. Pools passed to :meth:`step`, :meth:`step_chunk` and
    :meth:`step_render_chunk` are updated in place (their tensors are
    replaced, the JAX package donates them): do not keep using the input
    pool's old tensors after a step.
    """

    def __init__(self, asset: EffectAsset, device) -> None:
        self.asset = asset
        self.device = torch.device(device)
        self.layout = asset.particle_layout()
        if not self.layout.contains("position"):
            raise ValueError(
                f"the particle layout of effect {asset.name!r} is missing "
                "the POSITION attribute — add a position-writing init "
                "modifier (e.g. SetPositionSphereModifier or "
                "SetAttributeModifier(A.POSITION, ...))"
            )
        if asset.num_event_channels():
            raise NotImplementedError(
                f"effect {asset.name!r} is event-linked; GPU spawn events are not ported"
            )
        if self.layout.contains("ribbon_id"):
            raise NotImplementedError(f"effect {asset.name!r} draws ribbons, which are not ported")
        has = self.layout.contains
        self._has_age = has("age")
        self._has_lifetime = has("lifetime")
        self._integrate = (
            asset.motion_integration is not MotionIntegration.NONE
            and has("position")
            and has("velocity")
        )
        self._global_space = asset.simulation_space is SimulationSpace.GLOBAL

    # -- pool ------------------------------------------------------------

    def create_pool(self, capacity: Optional[int] = None, poison: bool = False) -> ParticlePool:
        return ParticlePool.create(
            self.layout, capacity or self.asset.capacity, self.device, poison=poison
        )

    # -- public step -------------------------------------------------------

    def step(self, pool: ParticlePool, inputs: StepInputs, sim: SimParams) -> ParticlePool:
        """Advance one frame; returns the (updated) pool."""
        return self._step(pool, inputs, sim)

    def step_chunk(self, pool: ParticlePool, inputs_stacked: StepInputs, sims_stacked: SimParams):
        """Advance K frames; every leaf of the stacked inputs has a leading [K] axis."""
        for inputs, sim in _unstack(inputs_stacked, sims_stacked):
            pool = self._step(pool, inputs, sim)
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
        """Advance K frames AND render each one.

        Returns ``(pool, last_image, checksums)``: the image is
        [height, width, 4] f32 and ``checksums`` the [K] per-frame
        framebuffer sums, all on the pool's device."""
        from ..render.extract import extract_draw_data
        from ..render.raster import rasterize

        alpha_mode = self.asset.alpha_mode.kind
        if self.asset.mesh is not None:
            raise NotImplementedError("step_render_chunk: mesh particles are not ported")
        img = torch.zeros((config.height, config.width, 4), dtype=torch.float32, device=self.device)
        sums = []
        for inputs, sim in _unstack(inputs_stacked, sims_stacked):
            pool = self._step(pool, inputs, sim)
            draw = extract_draw_data(
                self.asset,
                pool,
                camera,
                sim=sim,
                properties=inputs.properties,
                textures=list(textures),
                transform=inputs.transform,
            )
            img = rasterize(draw, camera, config, alpha_mode=alpha_mode, textures=list(textures))
            sums.append(img.sum())
        return pool, img, torch.stack(sums)

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

    def _step(self, pool: ParticlePool, inputs: StepInputs, sim: SimParams) -> ParticlePool:
        dev = pool.device
        n = pool.alive.shape[-1]
        slot_ids = torch.arange(n, dtype=rng.U32, device=dev)

        # ---- spawn ranking (replaces dead-list atomics) ----
        dead = ~pool.alive
        free_rank = exclusive_rank(dead)  # 0-based among dead
        num_free = torch.sum(dead, dtype=torch.int32)
        spawn_total = torch.clamp(num_free, max=int(inputs.spawn_count))
        spawn_mask = dead & (free_rank < spawn_total)

        # ---- init pass ----
        frame_hash = int(rng.pcg_hash(rng.as_u32(np.int64(np.uint32(inputs.frame_seed)))))
        spawn_seed = rng.initial_seed(free_rank.to(rng.U32), frame_hash)

        defaults: Dict[str, torch.Tensor] = {}
        for a in self.layout.storage_attributes():
            shape = (n,) if a.lanes == 1 else (n, a.lanes)
            defaults[a.name] = to_device(a.default_numpy().astype(a.np_dtype), dev).expand(shape)
        if "particle_counter" in defaults:
            defaults["particle_counter"] = (pool.counter + free_rank.to(rng.U32)) & 0xFFFFFFFF

        ictx = InitContext(
            self.asset.module,
            defaults,
            spawn_seed,
            sim=sim,
            properties=inputs.properties,
            particle_index=slot_ids,
        )
        for m in self.asset.init_modifiers:
            m.apply(self.asset.module, ictx)

        # Emitter transform (global sim space): position w=1, velocity w=0.
        # Broadcast math, not `@` (no TF32; ops/linalg.py).
        if self._global_space:
            tf = torch.as_tensor(np.asarray(inputs.transform, np.float32), device=dev)
            rot, tr = tf[:, :3], tf[:, 3]
            if "position" in ictx.particle:
                ictx.particle["position"] = affine3(ictx.particle["position"], rot, tr)
            if "velocity" in ictx.particle:
                ictx.particle["velocity"] = rotate3(ictx.particle["velocity"], rot)

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
            properties=inputs.properties,
            particle_index=slot_ids,
            alive=alive,
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

        pool.attrs = uctx.particle
        pool.alive = uctx.alive
        pool.seed = uctx.seed
        pool.counter = counter
        return pool


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
