"""Procedural texture helpers (reference: examples/texutils.rs; the port's copy
of the numpy-only ``bevy_hanabi_tpu/models/texutils.py``).

The reference's examples generate sprite-sheet and gradient textures on the
CPU for ParticleTextureModifier/FlipbookModifier; these are the numpy
equivalents, returning float32 ``[H, W, 4]`` arrays ready for
:class:`~bevy_hanabi_tpu_torch.render.renderer.EffectRenderer`'s texture list.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_circle_texture", "make_anim_sprite_sheet", "make_cloud_texture"]


def make_circle_texture(size: int = 64, softness: float = 0.15) -> np.ndarray:
    """Soft white disc with alpha falloff (the classic particle sprite)."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32)
    c = (size - 1) / 2.0
    r = np.sqrt((x - c) ** 2 + (y - c) ** 2) / c
    alpha = np.clip((1.0 - r) / max(softness, 1e-3), 0.0, 1.0)
    tex = np.ones((size, size, 4), np.float32)
    tex[..., 3] = alpha
    return tex


def make_anim_sprite_sheet(
    frames: int = 8, size: int = 32, shrink: bool = True
) -> np.ndarray:
    """Horizontal sprite sheet of a disc animating its radius over frames
    (what examples/circle.rs builds procedurally for the flipbook)."""
    cells = []
    for f in range(frames):
        t = f / max(frames - 1, 1)
        radius = (1.0 - 0.8 * t) if shrink else (0.2 + 0.8 * t)
        y, x = np.mgrid[0:size, 0:size].astype(np.float32)
        c = (size - 1) / 2.0
        r = np.sqrt((x - c) ** 2 + (y - c) ** 2) / c
        alpha = (r <= radius).astype(np.float32)
        cell = np.ones((size, size, 4), np.float32)
        cell[..., 3] = alpha
        cells.append(cell)
    return np.concatenate(cells, axis=1)  # [size, frames*size, 4]


def make_cloud_texture(size: int = 64, seed: int = 0, octaves: int = 4) -> np.ndarray:
    """Tileable value-noise blob for smoke/puff sprites."""
    rng = np.random.default_rng(seed)
    acc = np.zeros((size, size), np.float32)
    amp = 1.0
    total = 0.0
    for o in range(octaves):
        cells = 2 ** (o + 2)
        grid = rng.random((cells, cells), np.float32)
        big = np.kron(grid, np.ones((size // cells + 1, size // cells + 1), np.float32))
        acc += amp * big[:size, :size]
        total += amp
        amp *= 0.5
    noise = acc / total
    y, x = np.mgrid[0:size, 0:size].astype(np.float32)
    c = (size - 1) / 2.0
    r = np.sqrt((x - c) ** 2 + (y - c) ** 2) / c
    falloff = np.clip(1.0 - r, 0.0, 1.0)
    tex = np.ones((size, size, 4), np.float32)
    tex[..., 3] = np.clip(noise * falloff * 1.8, 0.0, 1.0)
    return tex
