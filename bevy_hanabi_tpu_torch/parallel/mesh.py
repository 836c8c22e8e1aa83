"""Device-mesh sharding of instanced particle pools
(port of ``bevy_hanabi_tpu/parallel/mesh.py``).

The JAX package is single-controller: one process drives a
``jax.sharding.Mesh`` and GSPMD inserts the collectives. The port keeps that
model without ``torch.distributed``: a :class:`Mesh` is a ``[dp, sp]`` grid
of ``torch.device`` driven by one process, each shard's tensors live on its
device, and what crosses between shards is an explicit copy (``.to``) or
sum. A grid may name one device more than once, so one card runs every
shard, route and slice of a ``(dp=4, sp=2)`` mesh.

* ``dp`` (data parallel), the **instance axis**: independent emitters shard
  with nothing exchanged in the step.
* ``sp`` (pool parallel), the **particle axis**: each instance's pool is
  split over ``sp`` devices. The one exchange of a step is the dead-lane
  count of each shard: the spawn ranks of a shard start after the dead
  lanes of the shards before it, and the spawn total is clamped by the dead
  lanes of all of them (GSPMD's cross-shard cumsum and reductions).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..asset import EffectAsset
from ..compiler import SimParams
from ..runtime.effect import StepInputs, Shard
from ..runtime.events import build_event_buffer
from ..runtime.instanced import InstancedEffect, stacked_pools
from ..runtime.pool import ParticlePool, ShardedPool
from ..utils.profiling import profile_span

__all__ = ["Mesh", "make_mesh", "ShardedEffect"]


class Mesh:
    """A ``[dp, sp]`` grid of devices with the axis names ``("dp", "sp")``."""

    def __init__(self, devices, axis_names=("dp", "sp")) -> None:
        self.devices = tuple(tuple(torch.device(d) for d in row) for row in devices)
        self.axis_names = tuple(axis_names)
        if not self.devices or len({len(row) for row in self.devices}) != 1:
            raise ValueError("a mesh is a non-empty rectangular grid of devices")

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "sp": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def flat_devices(self) -> list:
        """The devices row by row: shard ``d * sp + s`` is ``devices[d][s]``."""
        return [d for row in self.devices for d in row]


def make_mesh(devices=None, dp: Optional[int] = None, sp: Optional[int] = None) -> Mesh:
    """Build a ``(dp, sp)`` mesh over the given devices, or every CUDA device
    (mesh.py:38-55). A device may appear more than once."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices=[...]")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if dp is None and sp is None:
        dp, sp = n, 1
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"dp*sp must equal device count: {dp}*{sp} != {n}")
    return Mesh([devices[d * sp:(d + 1) * sp] for d in range(dp)])


def _rows(x, lo: int, hi: int):
    """Instances ``[lo, hi)`` of a per-instance host leaf."""
    return np.asarray(x)[lo:hi]


class ShardedEffect(InstancedEffect):
    """Instanced effect whose pools shard over a device mesh.

    Pools are a :class:`~..runtime.pool.ShardedPool`: shard ``[d][s]`` holds
    instances ``[d*I/dp, (d+1)*I/dp)`` over lanes ``[s*N/sp, (s+1)*N/sp)`` on
    ``mesh.devices[d][s]``. Per-instance inputs stay host arrays and each
    ``dp`` row of shards takes its instances' rows; ``SimParams`` are shared.
    ``device`` (default: the mesh's first) is where :meth:`assemble`,
    :meth:`alive_counts` and the inherited ``step_render_chunk`` put the
    whole pool."""

    def __init__(self, asset: EffectAsset, num_instances: int, mesh: Mesh,
                 capacity: Optional[int] = None, *, device=None) -> None:
        super().__init__(asset, num_instances, capacity,
                         device=mesh.devices[0][0] if device is None else device)
        self.mesh = mesh
        dp, sp = mesh.shape["dp"], mesh.shape["sp"]
        if num_instances % dp != 0:
            raise ValueError(f"num_instances {num_instances} not divisible by dp={dp}")
        if self.capacity % sp != 0:
            raise ValueError(f"capacity {self.capacity} not divisible by sp={sp}")
        self._local_instances = num_instances // dp
        self._local_capacity = self.capacity // sp

    def create_pools(self, poison: bool = False) -> ShardedPool:
        return ShardedPool(
            [[stacked_pools(self.effect.layout, self._local_instances, self._local_capacity,
                            dev, poison) for dev in row] for row in self.mesh.devices],
            instanced=True,
        )

    def place_pools(self, pools: ParticlePool) -> ShardedPool:
        """Whole ``[I, N, ...]`` pools split over the mesh."""
        return ShardedPool.split(pools, self.mesh.devices, instanced=True)

    def assemble(self, pools: ShardedPool, device=None) -> ParticlePool:
        """The whole ``[I, N, ...]`` pools on ``device`` (default: the
        effect's), for checks, checkpoints and single-device rendering."""
        return pools.assemble(self.device if device is None else device)

    def _check_inputs(self, inputs: StepInputs, lead: int) -> StepInputs:
        i = self.num_instances
        for name, leaf in (("spawn_count", inputs.spawn_count),
                           ("frame_seed", inputs.frame_seed),
                           ("transform", inputs.transform),
                           *inputs.properties.items()):
            shape = np.shape(leaf)
            if len(shape) <= lead or shape[lead] != i:
                raise ValueError(f"input {name!r} of shape {shape} has no instance axis of {i}")
        return inputs

    def shard_inputs(self, inputs: StepInputs) -> StepInputs:
        """Per-instance inputs (leaves [I, ...]) for :meth:`step`: they stay
        host arrays, and each ``dp`` row of shards takes its instances' rows
        at the step (mesh.py:104-107 puts them on the mesh instead)."""
        return self._check_inputs(inputs, 0)

    def shard_inputs_stacked(self, inputs_stacked: StepInputs) -> StepInputs:
        """K-frame stacked inputs: leaves are [K, I, ...] (mesh.py:109-119)."""
        return self._check_inputs(inputs_stacked, 1)

    def _stage(self, inputs_stacked: StepInputs):
        """No chunk of words: a shard's step is the eager one. (The group's
        effect, shared with unsharded groups by ``CompiledEffect.get``, has
        a generated step, so the group's ``_stage`` would upload words that
        no shard reads.)"""
        return None

    def _step(self, pools: ShardedPool, inputs: StepInputs, sim: SimParams, checks=None,
              staged=None):
        """One frame of every shard, in two phases: each shard counts the
        dead lanes of its instances, the counts cross to every shard of
        their row, then each shard steps its lanes ranked among its
        instances' whole pools (:class:`~..runtime.effect.Shard`). Returns
        ``(pools, events_out)``: an emitting asset's buffers, each field
        with a leading [I] axis, on the effect's device, each instance's
        events compacted over its whole lanes (:meth:`_events`). The frame
        is one ``hanabi:step`` span."""
        il, nl = self._local_instances, self._local_capacity
        with profile_span("hanabi:step"):
            dead = [[torch.sum(~p.alive, dim=-1, dtype=torch.int32) for p in row]
                    for row in pools.shards]
            emitted = [[None] * len(row) for row in pools.shards]
            for d, row in enumerate(pools.shards):
                lo, hi = d * il, (d + 1) * il
                ins = StepInputs(
                    _rows(inputs.spawn_count, lo, hi),
                    _rows(inputs.frame_seed, lo, hi),
                    _rows(inputs.transform, lo, hi),
                    {k: _rows(v, lo, hi) for k, v in inputs.properties.items()},
                )
                for s, p in enumerate(row):
                    dev = p.device
                    counts = [c.to(dev) for c in dead[d]]
                    base = (torch.stack(counts[:s]).sum(dim=0, dtype=torch.int32) if s
                            else torch.zeros((il,), dtype=torch.int32, device=dev))
                    total = torch.stack(counts).sum(dim=0, dtype=torch.int32)
                    row[s], emitted[d][s] = InstancedEffect._step(
                        self, p, ins, sim, checks,
                        shard=Shard(base, total, s * nl, self.capacity), emissions=True)
            return pools, self._events(emitted)

    def _events(self, emitted) -> dict:
        """Each channel's buffer from the shards' emissions: shard [d][s]'s
        ``[il*nl]`` lanes are lanes ``[s*nl, (s+1)*nl)`` of instances ``[d*il,
        (d+1)*il)``, so the shards' lanes join into ``[I, N]`` on the
        effect's device and one :func:`~..runtime.events.build_event_buffer`
        compacts each instance over its whole lanes, as JAX's vmapped step
        over the sharded pools does (one ``event_compact_segmented``
        launch)."""
        il, nl = self._local_instances, self._local_capacity
        i, n = self.num_instances, self.capacity

        def joined(parts):
            """The shards' [il*nl, ...] tensors as the [I*N, ...] lanes."""
            rows = [torch.cat([t.to(self.device).reshape((il, nl) + tuple(t.shape[1:]))
                               for t in row], dim=1) for row in parts]
            out = torch.cat(rows)
            return out.reshape((i * n,) + tuple(out.shape[2:]))

        events = {}
        for ch in range(self.effect.num_event_channels):
            if not isinstance(emitted[0][0][ch], tuple):  # no modifier emits on it
                events[ch] = self.effect.make_empty_events(n).stacked(i)
                continue
            part = [[shard[ch] for shard in row] for row in emitted]
            captured = {k: joined([[e[2][k] for e in row] for row in part])
                        for k in part[0][0][2]}
            events[ch] = build_event_buffer(joined([[e[0] for e in row] for row in part]),
                                            joined([[e[1] for e in row] for row in part]),
                                            captured, instances=i)
        return events

    def alive_counts(self, pools: ShardedPool) -> torch.Tensor:
        """Alive lanes of each instance, [I] int32 on the effect's device."""
        rows = [
            torch.stack([torch.sum(p.alive, dim=-1, dtype=torch.int32).to(self.device)
                         for p in row]).sum(dim=0, dtype=torch.int32)
            for row in pools.shards
        ]
        return torch.cat(rows)

    def total_alive(self, pools: ShardedPool) -> torch.Tensor:
        return torch.sum(self.alive_counts(pools), dtype=torch.int32)
