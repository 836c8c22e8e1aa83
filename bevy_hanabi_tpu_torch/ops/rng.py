"""Counter/state-based PCG random numbers, bit-exact with the reference.

Port of ``bevy_hanabi_tpu/ops/rng.py`` (the reference's WGSL recipe,
bevy_hanabi ``src/render/vfx_common.wgsl:260-364``). PyTorch's CPU backend
implements neither shifts nor comparisons for ``uint32``, so every PCG
state here is an **int64 tensor holding a uint32 value**: each multiply,
add and shift is followed by ``& 0xFFFFFFFF`` so the bits match the
uint32 arithmetic of the JAX package exactly (no product exceeds 2^62).

All functions are stateless over tensors: they take a ``seed`` tensor (any
shape) and return ``(new_seed, value)``.
"""

from __future__ import annotations

import torch

__all__ = [
    "U32",
    "as_u32",
    "pcg_hash",
    "to_float01",
    "frand",
    "frand2",
    "frand3",
    "frand4",
    "rand_vec",
    "rand_uniform",
    "rand_normal",
    "initial_seed",
]

_TAU = 6.283185307179586476925286766559

# dtype carrying uint32 values (see module docstring)
U32 = torch.int64
_MASK = 0xFFFFFFFF


def as_u32(x, device=None) -> torch.Tensor:
    """Any integer tensor / array / python int -> int64 tensor of its
    uint32 bit pattern (negative int32 values wrap like a bitcast)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    return (x.to(device=device or x.device, dtype=U32)) & _MASK


def pcg_hash(x):
    """One round of the reference's PCG hash, bit-for-bit on uint32 values."""
    state = (x * 747796405 + 2891336453) & _MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _MASK
    return (word >> 22) ^ word


def to_float01(u):
    """Map uint32 to float in [0, 1) using the 23-mantissa-bit trick."""
    bits = (u & 0x007FFFFF) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def initial_seed(index, spawner_seed):
    """Per-particle initial seed: ``pcg_hash(index ^ spawner_seed)``."""
    return pcg_hash(index ^ spawner_seed)


def frand(seed):
    """One float in [0,1). Matches vfx_common.wgsl ``frand``."""
    seed = pcg_hash(seed)
    return seed, to_float01(pcg_hash(seed))


def frand2(seed):
    s1 = pcg_hash(seed)
    s2 = pcg_hash(s1)
    return s2, torch.stack([to_float01(s1), to_float01(s2)], dim=-1)


def frand3(seed):
    s1 = pcg_hash(seed)
    s2 = pcg_hash(s1)
    s3 = pcg_hash(s2)
    v = torch.stack([to_float01(s1), to_float01(s2), to_float01(s3)], dim=-1)
    return s3, v


def frand4(seed):
    """vec4 from 3 hashes with bit-splicing, matching ``frand4``."""
    r0 = pcg_hash(seed)
    r1 = pcg_hash(r0)
    r2 = pcg_hash(r1)
    x = to_float01(r0)
    y = to_float01(((r0 & 0xFF000000) >> 8) | (r1 & 0x0000FFFF))
    z = to_float01(((r1 & 0xFFFF0000) >> 8) | (r2 & 0x000000FF))
    w = to_float01(r2 >> 8)
    return r2, torch.stack([x, y, z, w], dim=-1)


_FRAND_BY_COUNT = {1: frand, 2: frand2, 3: frand3, 4: frand4}


def rand_vec(seed, count: int):
    """[0,1) uniform of 1..4 components; returns (new_seed, value)."""
    return _FRAND_BY_COUNT[count](seed)


def rand_uniform(seed, a, b, count: int):
    """``a + frandN() * (b - a)`` (vfx_common.wgsl rand_uniform_*)."""
    seed, r = rand_vec(seed, count)
    return seed, a + r * (b - a)


def rand_normal(seed, mean, std_dev, count: int):
    """Box-Muller normal matching vfx_common.wgsl rand_normal_*."""
    seed, u = frand(seed)
    seed, v = rand_vec(seed, count)
    r = torch.sqrt(-2.0 * torch.log(u))
    if count > 1:
        r = r[..., None]
    return seed, mean + std_dev * r * torch.cos(_TAU * v)
