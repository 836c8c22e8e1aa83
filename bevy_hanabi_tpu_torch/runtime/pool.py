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

__all__ = ["ParticlePool"]

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
