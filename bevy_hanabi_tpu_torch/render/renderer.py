"""Pool → image for one effect, and layer compositing
(port of ``bevy_hanabi_tpu/render/renderer.py``).

:func:`composite_by_mode` and :class:`EffectRenderer` are ported whole:
the depth test, the written depth plane, ribbons (their segment quads),
meshes (their expanded quad and triangle entries) and textures.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

from ..asset import EffectAsset
from ..compiler import SimParams
from ..runtime.pool import ParticlePool
from .camera import CameraParams
from .extract import extract_draw_data
from .mesh import expand_mesh_draw
from .raster import RasterConfig, rasterize, texture_tensor
from .ribbon import build_ribbon_segments

__all__ = ["EffectRenderer", "composite_by_mode"]


def composite_by_mode(img, framebuffer, alpha_mode: str):
    """Composite a pre-rendered effect layer onto a framebuffer using the
    effect's blend equation (the dst factors of asset.rs:212-240):

    * ``add``: dst accumulates (src blended with ONE dst factor), so the
      layer's premultiplied sums simply add; no dst attenuation.
    * ``multiply``: the layer (rendered over a neutral WHITE transparent
      background) is a per-pixel modulation factor for dst.
    * everything else ("blend"/"premultiply"/"opaque"/"mask"): "over".
    """
    if alpha_mode == "add":
        rgb = framebuffer[..., :3] + img[..., :3]
        alpha = torch.clamp(framebuffer[..., 3:4] + img[..., 3:4], max=1.0)
    elif alpha_mode == "multiply":
        rgb = framebuffer[..., :3] * img[..., :3]
        alpha = framebuffer[..., 3:4]
    else:
        a = img[..., 3:4]
        rgb = img[..., :3] + framebuffer[..., :3] * (1.0 - a)
        alpha = a + framebuffer[..., 3:4] * (1.0 - a)
    return torch.cat([rgb, alpha], dim=-1)


def neutral_background(alpha_mode: str):
    """The clear colour a layer is rendered over before compositing: white
    transparent for ``multiply``, black transparent otherwise."""
    return (1.0, 1.0, 1.0, 0.0) if alpha_mode == "multiply" else (0.0, 0.0, 0.0, 0.0)


class EffectRenderer:
    """Renders one effect's pool with its render modifiers applied.

    ``textures`` ([H, W, 4] RGBA images, by slot) are uploaded once to
    each device the renderer draws on."""

    def __init__(self, asset: EffectAsset, config: RasterConfig, textures: Sequence[Any] = ()) -> None:
        self.asset = asset
        self.config = config
        self._aligned = False
        self.textures = tuple(textures)
        self._device_textures = {}
        self._alpha_mode = asset.alpha_mode.kind
        self._ribbons = asset.particle_layout().contains("ribbon_id")

    def textures_on(self, device) -> tuple:
        """The renderer's textures on ``device``, uploaded on first use."""
        device = torch.device(device)
        texs = self._device_textures.get(device)
        if texs is None:
            texs = tuple(texture_tensor(t, device) for t in self.textures)
            self._device_textures[device] = texs
        return texs

    def render(
        self,
        pool: ParticlePool,
        camera: CameraParams,
        sim: SimParams = None,
        properties: Optional[Dict[str, Any]] = None,
        transform: Optional[Any] = None,
        framebuffer: Optional[torch.Tensor] = None,
        scene_depth: Optional[torch.Tensor] = None,
        return_depth: bool = False,
    ):
        """Rasterize the pool; optionally composite over ``framebuffer``
        with the effect's own blend equation. ``scene_depth`` ([H, W] view
        distances) occludes fragments behind it; ``return_depth=True``
        (opaque and mask effects) returns ``(image, depth)``, the depth
        plane seeded from ``scene_depth``. The raster grid follows the
        camera viewport (a mismatched config is aligned on first use)."""
        if not self._aligned:
            vw, vh = camera.viewport
            if (self.config.width, self.config.height) != (vw, vh):
                self.config = dataclasses.replace(self.config, width=vw, height=vh)
            self._aligned = True
        textures = self.textures_on(pool.device)
        draw = extract_draw_data(
            self.asset,
            pool,
            camera,
            sim=sim if sim is not None else SimParams(),
            properties=properties or {},
            textures=list(textures),
            transform=transform,
        )
        if self._ribbons:
            draw = build_ribbon_segments(draw, camera)
        elif self.asset.mesh is not None:
            draw = expand_mesh_draw(draw, self.asset.mesh)
        config = self.config
        if framebuffer is not None:
            config = dataclasses.replace(config, background=neutral_background(self._alpha_mode))
        out = rasterize(
            draw,
            camera,
            config,
            alpha_mode=self._alpha_mode,
            textures=list(textures),
            scene_depth=scene_depth,
            return_depth=return_depth,
        )
        img, depth = out if return_depth else (out, None)
        if framebuffer is not None:
            img = composite_by_mode(img, framebuffer, self._alpha_mode)
        return (img, depth) if return_depth else img
