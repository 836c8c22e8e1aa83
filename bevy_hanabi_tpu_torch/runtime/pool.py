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
        example ``{k: np.asarray(v) for k, v in jax_pool.attrs.items()}``)."""
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
