"""SoA particle pool (port of ``bevy_hanabi_tpu/runtime/pool.py``).

The same layout as the JAX package: ``attrs`` ``{name: [N] | [N, k]}``,
``alive`` bool[N], ``seed`` the per-lane PCG state and ``counter`` the total
spawned. PyTorch has no usable ``uint32``, so ``seed``, ``counter`` and any
uint32 attribute are int64 tensors holding the uint32 value
(:mod:`..ops.rng`); :meth:`from_numpy` / :meth:`to_numpy` convert at the
boundary, which is how a JAX pool crosses to the port and back.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..attributes import Attribute, ParticleLayout
from ..ops import rng

__all__ = ["ParticlePool", "ShardedPool", "gathered"]

# Debug poison: reference fills fresh slabs with 0xFFFFFFFF in debug builds
# (effect_cache.rs:270-296) so stale reads are obvious. Same trick here.
_POISON_BITS = np.uint32(0xFFFFFFFF)


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A copy of a host array on ``device`` (uint32 -> int64 carrier)."""
    a = np.asarray(a)
    return torch.tensor(a.astype(np.int64) if a.dtype == np.uint32 else a, device=device)


class ParticlePool:
    """Fixed-capacity SoA particle storage for one effect.

    Fields:
      attrs:   dict attr_name -> [N] or [N, k] tensor
      alive:   bool[N]
      seed:    int64[N] per-lane PCG state (uint32 values)
      counter: int64[] total particles ever spawned (uint32 value)
    """

    def __init__(self, attrs: Dict[str, torch.Tensor], alive, seed, counter):
        self.attrs = attrs
        self.alive = alive
        self.seed = seed
        self.counter = counter

    # -- construction --------------------------------------------------------

    @staticmethod
    def create(
        layout: ParticleLayout,
        capacity: int,
        device,
        poison: bool = False,
    ) -> "ParticlePool":
        """Allocate a pool with every slot dead on ``device``.

        ``poison=True`` bit-fills attribute storage with 0xFFFFFFFF (debug aid,
        mirrors effect_cache.rs:270-296); default is attribute defaults.
        """
        attrs: Dict[str, torch.Tensor] = {}
        for a in layout.storage_attributes():
            shape = (capacity,) if a.lanes == 1 else (capacity, a.lanes)
            if poison:
                if a.np_dtype == np.dtype(np.bool_):
                    raw = np.ones(shape, np.bool_)
                else:
                    raw = np.full(shape, _POISON_BITS).view(a.np_dtype)
                attrs[a.name] = to_device(raw, device)
            else:
                default = np.broadcast_to(a.default_numpy().astype(a.np_dtype), shape)
                attrs[a.name] = to_device(default, device)
        return ParticlePool(
            attrs=attrs,
            alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
            seed=torch.zeros((capacity,), dtype=rng.U32, device=device),
            counter=torch.zeros((), dtype=rng.U32, device=device),
        )

    @staticmethod
    def from_numpy(attrs: Dict[str, np.ndarray], alive, seed, counter, device) -> "ParticlePool":
        """Build a pool from host arrays in the JAX package's dtypes (for
        example ``{k: np.asarray(v) for k, v in jax_pool.attrs.items()}``).
        Stacked ``[I, N, ...]`` pools of an instanced group cross the same
        way: every array keeps its shape, ``counter`` is then ``[I]``."""
        return ParticlePool(
            attrs={k: to_device(v, device) for k, v in attrs.items()},
            alive=to_device(np.asarray(alive, np.bool_), device),
            seed=to_device(np.asarray(seed, np.uint32), device),
            counter=to_device(np.asarray(counter, np.uint32), device),
        )

    def to_numpy(self):
        """``(attrs, alive, seed, counter)`` as host arrays in the JAX
        package's dtypes (int64 carriers come back as uint32)."""

        def host(t):
            a = t.detach().cpu().numpy()
            return a.astype(np.uint32) if t.dtype == rng.U32 else a

        return (
            {k: host(v) for k, v in self.attrs.items()},
            host(self.alive),
            host(self.seed),
            host(self.counter),
        )

    # -- inspection -----------------------------------------------------------

    def flatten(self, composite_ribbon_ids: bool = False) -> "ParticlePool":
        """View instanced ``[I, N, ...]`` pools as one flat ``[I*N]`` pool
        (pool.py:103-128). The counter is summed (it only seeds
        PARTICLE_COUNTER for future spawns, which a flat view never makes).

        ``composite_ribbon_ids`` rewrites the flat ``ribbon_id`` to
        ``rid * I + instance`` (modulo 2^32, as uint32) so same-rid trails
        of different instances stay distinct ribbons after flattening."""
        i, n = self.alive.shape
        attrs = {k: v.reshape((i * n,) + tuple(v.shape[2:])) for k, v in self.attrs.items()}
        if composite_ribbon_ids and "ribbon_id" in attrs:
            inst = torch.arange(i * n, dtype=rng.U32, device=self.device) // n
            attrs["ribbon_id"] = (rng.as_u32(attrs["ribbon_id"]) * i + inst) & 0xFFFFFFFF
        return ParticlePool(
            attrs=attrs,
            alive=self.alive.reshape(i * n),
            seed=self.seed.reshape(i * n),
            counter=torch.sum(self.counter) & 0xFFFFFFFF,
        )

    @property
    def capacity(self) -> int:
        return int(self.alive.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.alive.device

    def alive_count(self) -> torch.Tensor:
        """Device scalar count of alive particles (≈ EffectMetadata.alive_count)."""
        return torch.sum(self.alive, dtype=torch.int32)

    def get(self, attr) -> torch.Tensor:
        name = attr.name if isinstance(attr, Attribute) else attr
        return self.attrs[name]

    # -- checkpoint (pool.py:145-165): the JAX package's npz layout, arrays
    #    in its dtypes, so a pool saved by either package loads in the other

    def save(self, path: str) -> None:
        attrs, alive, seed, counter = self.to_numpy()
        arrays = {f"attr:{k}": v for k, v in attrs.items()}
        np.savez(path, alive=alive, seed=seed, counter=counter, **arrays)

    @staticmethod
    def load(path: str, device) -> "ParticlePool":
        """A pool saved by :meth:`save` (or the JAX package's), on ``device``."""
        data = np.load(path if path.endswith(".npz") else path + ".npz")
        attrs = {k[len("attr:"):]: data[k] for k in data.files if k.startswith("attr:")}
        return ParticlePool.from_numpy(attrs, data["alive"], data["seed"], data["counter"], device)


class ShardedPool:
    """A pool split over the devices of a mesh (:mod:`..parallel.mesh`): a
    ``[rows][cols]`` grid of :class:`ParticlePool` shards, each on its own
    device, driven by one process.

    An instanced group's pools (``instanced=True``, :class:`~..parallel.mesh.
    ShardedEffect`) split the instance axis over the rows (``dp``) and the
    particle axis over the columns (``sp``): shard ``[d][s]`` holds
    instances ``[d*I/dp, (d+1)*I/dp)`` and lanes ``[s*N/sp, (s+1)*N/sp)`` of
    each, and its counter ``[I/dp]`` is its instances' own (the same in every
    column). A single effect's pool (``instanced=False``,
    ``CompiledEffect(mesh=)``) splits the particle axis over every device of
    the mesh: one row of D shards, each holding the pool's counter."""

    def __init__(self, shards, instanced: bool):
        self.shards = [list(row) for row in shards]
        self.instanced = bool(instanced)

    @property
    def flat(self) -> list:
        """The shards, row by row."""
        return [p for row in self.shards for p in row]

    @property
    def capacity(self) -> int:
        """Lanes of the whole pool (of each instance for a group)."""
        return sum(p.capacity for p in self.shards[0])

    @property
    def device(self) -> torch.device:
        """The first shard's device."""
        return self.shards[0][0].device

    def alive_count(self) -> torch.Tensor:
        """Device scalar count of alive particles, on the first shard's device."""
        counts = [p.alive_count().to(self.device) for p in self.flat]
        return torch.stack(counts).sum(dtype=torch.int32)

    def assemble(self, device=None) -> ParticlePool:
        """The whole pool on ``device`` (default: the first shard's), in the
        natural lane order: ``[N]`` for an effect, ``[I, N, ...]`` for a group."""
        device = torch.device(device) if device is not None else self.device

        def cat(get, dim):
            if not self.instanced:
                return torch.cat([get(p).to(device) for p in self.shards[0]], dim=0)
            return torch.cat(
                [torch.cat([get(p).to(device) for p in row], dim=1) for row in self.shards],
                dim=0,
            )

        first = self.shards[0][0]
        counter = (
            torch.cat([row[0].counter.to(device) for row in self.shards])
            if self.instanced
            else first.counter.to(device)
        )
        return ParticlePool(
            attrs={k: cat(lambda p, k=k: p.attrs[k], 1) for k in first.attrs},
            alive=cat(lambda p: p.alive, 1),
            seed=cat(lambda p: p.seed, 1),
            counter=counter,
        )

    def to_numpy(self):
        """The assembled pool's :meth:`ParticlePool.to_numpy`."""
        return self.assemble().to_numpy()

    @staticmethod
    def split(pool: ParticlePool, devices, instanced: bool) -> "ShardedPool":
        """``pool`` (``[N]``, or ``[I, N, ...]`` for a group) split over a
        ``[rows][cols]`` grid of devices as the class describes; every shard
        is a copy on its device."""
        def piece(t, dev):
            return t.to(dev, copy=True, memory_format=torch.contiguous_format)

        if not instanced:
            devs = [d for row in devices for d in row]
            size = pool.capacity // len(devs)
            row = []
            for j, dev in enumerate(devs):
                lo, hi = j * size, (j + 1) * size
                row.append(ParticlePool(
                    {k: piece(v[lo:hi], dev) for k, v in pool.attrs.items()},
                    piece(pool.alive[lo:hi], dev),
                    piece(pool.seed[lo:hi], dev),
                    piece(pool.counter, dev),
                ))
            return ShardedPool([row], instanced=False)
        i, n = pool.alive.shape
        il, nl = i // len(devices), n // len(devices[0])
        grid = []
        for d, row_devs in enumerate(devices):
            ri = slice(d * il, (d + 1) * il)
            row = []
            for s, dev in enumerate(row_devs):
                rn = slice(s * nl, (s + 1) * nl)
                row.append(ParticlePool(
                    {k: piece(v[ri, rn], dev) for k, v in pool.attrs.items()},
                    piece(pool.alive[ri, rn], dev),
                    piece(pool.seed[ri, rn], dev),
                    piece(pool.counter[ri], dev),
                ))
            grid.append(row)
        return ShardedPool(grid, instanced=True)


def gathered(pool, device) -> ParticlePool:
    """``pool`` itself, or a :class:`ShardedPool` assembled on ``device``."""
    return pool.assemble(device) if isinstance(pool, ShardedPool) else pool
