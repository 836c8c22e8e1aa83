"""Camera parameters and projection math (port of ``bevy_hanabi_tpu/render/camera.py``).

Cameras are authored on the host: ``view`` and ``proj`` are 4x4 numpy (or
torch) matrices. The derived quantities render modifiers read are small
float32 CPU tensors computed with the JAX package's closed forms; callers
move them to the particles' device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch

from ..ops.linalg import affine4_inv

__all__ = ["CameraParams", "look_at", "perspective"]


def _host_f32(m) -> np.ndarray:
    if isinstance(m, torch.Tensor):
        m = m.detach().cpu().numpy()
    return np.asarray(m, np.float32)


@dataclass
class CameraParams:
    """View/projection for one render view.

    view:      4x4 world→view matrix
    proj:      4x4 view→clip matrix
    viewport:  (width, height) in pixels
    """

    view: Any
    proj: Any
    viewport: Tuple[int, int]

    @property
    def world_from_view(self) -> torch.Tensor:
        """Inverse view matrix (camera→world): the same f32 closed-form
        affine inverse as the JAX package; a projective bottom row gets the
        true inverse in f64 on the host."""
        v = _host_f32(self.view)
        if not np.array_equal(v[3], [0.0, 0.0, 0.0, 1.0]):
            return torch.from_numpy(np.linalg.inv(v.astype(np.float64)).astype(np.float32))
        return affine4_inv(torch.from_numpy(v))

    @property
    def rotation(self) -> torch.Tensor:
        """3x3 camera rotation in world space: columns = right, up, back."""
        return self.world_from_view[:3, :3]

    @property
    def position(self) -> torch.Tensor:
        """Camera position in world space."""
        return self.world_from_view[:3, 3]

    @property
    def up(self) -> torch.Tensor:
        """Camera up axis in world space (view.world_from_view[1].xyz)."""
        return self.world_from_view[:3, 1]

    @property
    def proj_scale(self) -> torch.Tensor:
        """(clip_from_view[0][0], clip_from_view[1][1])."""
        p = _host_f32(self.proj)
        return torch.tensor([p[0, 0], p[1, 1]], dtype=torch.float32)


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Right-handed world→view matrix looking from ``eye`` at ``target``."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    f = target - eye
    f = f / np.linalg.norm(f)
    r = np.cross(f, up)
    r = r / np.linalg.norm(r)
    u = np.cross(r, f)
    # camera looks down -Z in view space
    rot = np.stack([r, u, -f], axis=0)
    t = -rot @ eye
    m = np.zeros((4, 4), np.float32)
    m[:3, :3] = rot
    m[:3, 3] = t
    m[3, 3] = 1.0
    return m


def perspective(fov_y: float, aspect: float, near: float, far: float) -> np.ndarray:
    """Right-handed perspective projection, depth mapped to [0, 1].

    ``fov_y`` is in RADIANS (like Bevy's PerspectiveProjection.fov).
    """
    if not 0.0 < fov_y < np.pi:
        raise ValueError(
            f"fov_y is in radians and must be in (0, pi); got {fov_y!r} — "
            "for degrees use math.radians(...)"
        )
    f = 1.0 / np.tan(fov_y / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = far / (near - far)
    m[2, 3] = near * far / (near - far)
    m[3, 2] = -1.0
    return m
