"""HDR post-processing helpers: bloom + tonemapping
(port of ``bevy_hanabi_tpu/render/post.py``).

The reference renders HDR colours (e.g. firework.rs's 4x white flash) and
relies on Bevy's bloom + tonemapping passes for the final look. Rendering
is headless here, so the equivalent passes live in this module: a
threshold + separable gaussian bloom and filmic tonemaps, plain PyTorch on
the image's device. The blur's taps are explicit shifted multiply-adds in
f32 (not a library convolution, which may take TF32 on the card), over a
zero-padded axis: the JAX package's SAME 1-D convolution.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["bloom", "tonemap_reinhard", "tonemap_aces"]


def _gaussian_kernel(sigma: float) -> np.ndarray:
    radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur_axis(x: torch.Tensor, k: np.ndarray, axis: int) -> torch.Tensor:
    """One SAME 1-D correlation of ``x`` ([H, W, C]) with taps ``k`` along
    ``axis``, zero padding on both ends."""
    r = k.shape[0] // 2
    length = x.shape[axis]
    # F.pad's pairs run from the last axis: (C lo, C hi, W lo, W hi, H lo, H hi)
    xp = F.pad(x, (0, 0, 0, 0, r, r) if axis == 0 else (0, 0, r, r))
    out = None
    for j, w in enumerate(k.tolist()):
        tap = xp.narrow(axis, j, length) * w
        out = tap if out is None else out + tap
    return out


def _blur_separable(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """[H, W, C] gaussian blur: two SAME 1-D passes, H then W."""
    k = _gaussian_kernel(sigma)
    return _blur_axis(_blur_axis(img, k, 0), k, 1)


def bloom(
    img: torch.Tensor,
    threshold: float = 1.0,
    sigma: float = 4.0,
    intensity: float = 0.7,
) -> torch.Tensor:
    """Add a glow around HDR-bright pixels (Bevy ``Bloom`` analogue).

    ``img`` is [H, W, 4] linear HDR. Pixels whose channels exceed
    ``threshold`` contribute their excess to a gaussian-blurred glow that
    is added back (energy-additive, like the reference's additive bloom
    pipeline). Alpha passes through unchanged.
    """
    rgb = img[..., :3]
    bright = torch.clamp(rgb - threshold, min=0.0)
    glow = _blur_separable(bright, sigma)
    return torch.cat([rgb + intensity * glow, img[..., 3:4]], dim=-1)


def tonemap_reinhard(img: torch.Tensor) -> torch.Tensor:
    """x / (1 + x) per channel; alpha unchanged."""
    rgb = img[..., :3]
    return torch.cat([rgb / (1.0 + rgb), img[..., 3:4]], dim=-1)


def tonemap_aces(img: torch.Tensor) -> torch.Tensor:
    """Narkowicz ACES filmic approximation (the default Bevy tonemapper's
    common stand-in); alpha unchanged."""
    x = img[..., :3]
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    mapped = torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)
    return torch.cat([mapped, img[..., 3:4]], dim=-1)
