"""Multi-instance batching: many emitters of one asset in one pass
(port of ``bevy_hanabi_tpu/runtime/instanced.py``).

The reference merges compatible effect instances into one compute dispatch
and locates each thread's instance by a binary search over per-batch prefix
sums (Batcher, render/batch.rs:145-188; vfx_update.wgsl:51-72). The JAX
package vmaps the single-instance step over a leading instance axis. Here
the pools keep the JAX package's ``[I, N, ...]`` shape, and a step runs
once over their flat ``[I*N]`` view, every lane carrying its instance's
spawn count, frame seed, transform and property values
(``CompiledEffect._step(..., instances=I)``): the spawn ranks are one
cumsum over the ``[I, N]`` view, so no instance is stepped on its own and
no loop over instances runs on the host.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..asset import EffectAsset, SimulationSpace
from ..compiler import SimParams
from ..utils.profiling import profile_span
from .effect import CompiledEffect, StepChecks, StepInputs, _unstack, identity_transform
from .pool import ParticlePool, gathered, to_device

__all__ = ["InstancedEffect"]


def stacked_pools(layout, instances: int, capacity: int, device, poison: bool = False):
    """``instances`` empty pools of ``capacity`` lanes stacked on a leading
    [I] axis, on ``device``."""
    one = ParticlePool.create(layout, capacity, device, poison=poison)

    def stack(t):
        return t.expand((instances,) + tuple(t.shape)).contiguous()

    return ParticlePool(
        {k: stack(v) for k, v in one.attrs.items()},
        stack(one.alive),
        stack(one.seed),
        stack(one.counter),
    )


class InstancedEffect:
    """``num_instances`` independent instances of one asset, stepped as one.

    Equivalent of the reference's EffectBatch (batch.rs:92): instances share
    the asset, layout and compiled step and differ only in per-instance
    runtime data. ``device`` is required, as for :class:`CompiledEffect`.
    The step methods take over the pools passed to them, by
    :class:`CompiledEffect`'s rule: the pools are updated in place and their
    old tensors may be overwritten, on every device and path; use the
    returned pools, and ``clone()`` the tensors of a frame you keep."""

    def __init__(self, asset: EffectAsset, num_instances: int, capacity: Optional[int] = None,
                 *, device) -> None:
        from ..properties import Property

        self.asset = asset
        # .get shares the compiled step between instances and groups of the
        # same asset (the ShaderCache dedupe, render/shader_cache.rs:18-62)
        self.effect = CompiledEffect.get(asset, device)
        self.device = self.effect.device
        self.num_instances = int(num_instances)
        self.capacity = int(capacity or asset.capacity)
        # declared per-instance shape and dtype of each property, which tell
        # a shared value from per-instance values in make_inputs
        self._prop_decl = {
            n: Property(n, v).default.to_numpy() for n, v in asset.module.properties().items()
        }

    def create_pools(self, poison: bool = False) -> ParticlePool:
        """Stacked pools: every tensor gains a leading [I] instance axis."""
        return stacked_pools(self.effect.layout, self.num_instances, self.capacity, self.device,
                             poison)

    def make_inputs(self, spawn_counts, frame_seeds, transforms=None,
                    properties: Optional[Dict[str, Any]] = None) -> StepInputs:
        """Batch per-instance inputs; each leaf gains a leading [I] axis
        (host numpy, instanced.py:69-109)."""
        i = self.num_instances
        if transforms is None:
            transforms = np.broadcast_to(identity_transform(), (i, 3, 4))
        props = {}
        for k, v in (properties or {}).items():
            decl = self._prop_decl.get(k)
            if decl is not None:
                # The declared dtype (a float32 coercion would corrupt int
                # properties above 2^24); the declared shape decides shared
                # against per-instance: a bare [k] vec is ALWAYS the shared
                # value, even when k == num_instances.
                v = np.asarray(v, decl.dtype)
                if v.shape == decl.shape:
                    v = np.broadcast_to(v, (i,) + v.shape)
                elif v.shape != (i,) + decl.shape:
                    raise ValueError(
                        f"property {k!r}: expected shared shape "
                        f"{decl.shape} or per-instance shape "
                        f"{(i,) + decl.shape}, got {v.shape}"
                    )
            else:
                v = np.asarray(v, np.float32)
                if v.ndim == 0 or v.shape[0] != i:
                    v = np.broadcast_to(v, (i,) + v.shape)
            props[k] = v
        return StepInputs(
            np.asarray(spawn_counts, np.int32).reshape(i),
            np.asarray(frame_seeds, np.uint32).reshape(i),
            transforms,
            props,
        )

    def _stage(self, inputs_stacked: StepInputs):
        """A chunk's per-instance words for the generated step, uploaded once
        (:meth:`~.fused.FusedStep.stage`); None where the eager step takes
        the chunk."""
        fused = self.effect.fused_step
        if fused is None or self.device.type != "cuda":
            return None
        return fused.stage(inputs_stacked, self.num_instances, self.device)

    def _step(self, pools: ParticlePool, inputs: StepInputs, sim: SimParams,
              checks=None, shard=None, emissions=False, staged=None):
        """One frame of every instance: the flat step over the pools' view,
        its results written back in the [I, N, ...] shape. Returns
        ``(pools, events_out)``: an emitting asset's buffers, one a channel,
        every field with a leading [I] axis, each instance's events
        compacted on their own (:func:`~.events.build_event_buffer` with
        ``instances``), as JAX's vmapped step returns them. ``checks``: a
        checked step's :class:`~.effect.StepChecks`; ``shard`` and
        ``emissions``: a sharded group's shard (:class:`~.effect.Shard`),
        whose emissions its group compacts, and ``staged``, a chunk's words
        for the generated step (:meth:`CompiledEffect._step`)."""
        i, n = pools.alive.shape
        flat = ParticlePool(
            {k: v.reshape((i * n,) + tuple(v.shape[2:])) for k, v in pools.attrs.items()},
            pools.alive.reshape(i * n),
            pools.seed.reshape(i * n),
            pools.counter,
        )
        flat, events = self.effect._step(flat, inputs, sim, None, None, instances=i,
                                         checks=checks, shard=shard, emissions=emissions,
                                         staged=staged)
        pools.attrs = {k: v.reshape((i, n) + tuple(v.shape[1:])) for k, v in flat.attrs.items()}
        pools.alive = flat.alive.reshape(i, n)
        pools.seed = flat.seed.reshape(i, n)
        pools.counter = flat.counter
        return pools, events

    def step(self, pools: ParticlePool, inputs: StepInputs, sim: SimParams):
        """Advance all instances one frame; returns ``(pools, events_out)``,
        an emitting asset's per-instance event buffers (instanced.py:111-121).
        An asset that consumes events raises as in the JAX package: an
        instance has no parent. ``pools`` is taken over: its tensors may be
        overwritten (the class's in-place rule)."""
        return self._step(pools, inputs, sim)

    def step_checked(self, pools: ParticlePool, inputs: StepInputs, sim: SimParams):
        """:meth:`step` under debug validation (instanced.py:122-136): every
        instance's produced state checked for non-finite floats, one
        readback (:meth:`CompiledEffect.step_checked`)."""
        checks = StepChecks()
        pools, events = self._step(pools, inputs, sim, checks)
        checks.raise_if_failed()
        return pools, events

    def step_chunk_checked(self, pools: ParticlePool, inputs_stacked: StepInputs, sims_stacked):
        """:meth:`step_chunk` with every frame checked and one readback for
        the chunk (instanced.py:138-150)."""
        checks = StepChecks()
        for inputs, sim in _unstack(inputs_stacked, sims_stacked):
            pools, _ = self._step(pools, inputs, sim, checks)
        checks.raise_if_failed()
        return pools

    def step_chunk(self, pools: ParticlePool, inputs_stacked: StepInputs, sims_stacked):
        """K frames x I instances. Leaves of ``inputs_stacked`` are [K, I,
        ...]; of ``sims_stacked`` [K]. The JAX package's ``lax.scan`` is a
        K-frame loop here that only enqueues device work; an emitting
        asset's events are built each frame and dropped, as the scan drops
        them. ``pools`` is taken over: its tensors may be overwritten (the
        class's in-place rule)."""
        with profile_span("hanabi:chunk"):
            staged = self._stage(inputs_stacked)
            for j, (inputs, sim) in enumerate(_unstack(inputs_stacked, sims_stacked)):
                pools, _ = self._step(pools, inputs, sim,
                                      staged=None if staged is None else (staged, j))
        return pools

    def step_render_chunk(self, pools: ParticlePool, inputs_stacked, sims_stacked, camera,
                          config, textures=()):
        """K frames x I instances stepped AND rendered (instanced.py:
        186-267): each frame steps every instance, extracts the flat
        ``[I*N]`` draw set with each lane's render modifiers seeing its
        instance's own property values, and rasterizes all instances in one
        pass. GLOBAL simulation space and quad billboards only (ribbons and
        meshes render per instance; LOCAL instances would need per-instance
        render transforms), as in the JAX package.

        Returns ``(pools, last_image, checksums)``. ``pools`` is taken over:
        its tensors may be overwritten (the class's in-place rule)."""
        from ..render.extract import extract_draw_data
        from ..render.raster import rasterize, texture_tensor

        fx = self.effect
        if fx.num_event_channels or fx.consumes_events:
            raise ValueError("step_render_chunk does not support event-linked effects")
        if self.asset.simulation_space == SimulationSpace.LOCAL:
            raise ValueError(
                "instanced step_render_chunk supports GLOBAL simulation space only (LOCAL "
                "instances need per-instance render transforms)"
            )
        if fx.layout.contains("ribbon_id") or self.asset.mesh:
            raise ValueError(
                "instanced step_render_chunk renders quad billboards only "
                "(ribbons/meshes: render per instance)"
            )
        alpha_mode = self.asset.alpha_mode.kind
        i = self.num_instances
        with profile_span("hanabi:chunk"):
            textures = [texture_tensor(t, self.device) for t in textures]
            img = torch.zeros((config.height, config.width, 4), dtype=torch.float32,
                              device=self.device)
            sums = []
            staged = self._stage(inputs_stacked)
            for j, (inputs, sim) in enumerate(_unstack(inputs_stacked, sims_stacked)):
                pools, _ = self._step(pools, inputs, sim,
                                      staged=None if staged is None else (staged, j))
                per_lane = {
                    k: to_device(np.asarray(v), self.device).repeat_interleave(self.capacity,
                                                                               dim=0)
                    for k, v in inputs.properties.items()
                }
                draw = extract_draw_data(self.asset, gathered(pools, self.device).flatten(),
                                         camera, sim=sim, properties=per_lane,
                                         textures=list(textures), instances=i)
                img = rasterize(draw, camera, config, alpha_mode=alpha_mode, textures=textures)
                sums.append(img.sum())
            return pools, img, torch.stack(sums)

    def alive_counts(self, pools: ParticlePool) -> torch.Tensor:
        return torch.sum(pools.alive, dim=-1, dtype=torch.int32)

    def total_alive(self, pools: ParticlePool) -> torch.Tensor:
        return torch.sum(pools.alive, dtype=torch.int32)
