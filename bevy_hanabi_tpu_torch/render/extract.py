"""Render extraction: pool → per-particle draw data
(port of ``bevy_hanabi_tpu/render/extract.py``).

Global-space quads only so far: default colour, size and camera-facing
axes, the render modifiers, and screen-space size. Local-space effects and
the alpha-mask cutoff raise ``NotImplementedError``; the modifiers that
would fill the other draw columns (roundness, flipbook, textures, ribbons,
meshes) are not ported, so no asset of the port can ask for them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import torch

from ..asset import EffectAsset, SimulationSpace
from ..compiler import RenderContext, SimParams
from ..ops.linalg import mat4_mul, mvp_w
from ..runtime.pool import ParticlePool
from .camera import CameraParams

__all__ = ["ParticleDrawData", "extract_draw_data"]


@dataclass
class ParticleDrawData:
    """Everything the rasterizer needs, SoA over particles."""

    position: Any  # [N,3] world space
    axis_x: Any  # [N,3] world, scaled by size.x (half extents = 0.5*axis)
    axis_y: Any  # [N,3] world, scaled by size.y
    color: Any  # [N,4] linear RGBA (HDR allowed)
    alive: Any  # bool[N]


def extract_draw_data(
    asset: EffectAsset,
    pool: ParticlePool,
    camera: CameraParams,
    sim: SimParams = None,
    properties=None,
    textures: Optional[List[Any]] = None,
    transform: Optional[Any] = None,
) -> ParticleDrawData:
    """Run render modifiers over the pool and build draw data.

    ``textures`` and ``transform`` keep the JAX package's signature; no
    ported modifier samples a texture, and a transform only matters for
    local-space effects, which raise."""
    n = pool.alive.shape[-1]
    dev = pool.device
    particle = dict(pool.attrs)
    if asset.simulation_space is SimulationSpace.LOCAL and transform is not None:
        raise NotImplementedError("extract_draw_data: local-space effects are not ported")
    if getattr(asset.alpha_mode, "mask_cutoff", None) is not None:
        raise NotImplementedError("extract_draw_data: the alpha-mask cutoff is not ported")

    ctx = RenderContext(
        asset.module,
        particle,
        pool.seed,
        sim=sim if sim is not None else SimParams(),
        properties=properties or {},
        particle_index=torch.arange(n, dtype=torch.int64, device=dev),
        alive=pool.alive,
        camera=camera,
        alpha_cutoff=0.0,
    )

    # ---- defaults (lib.rs:867-951) ----
    if "color" in particle:
        packed = particle["color"]
        ctx.color = torch.stack(
            [((packed >> (8 * i)) & 0xFF).to(torch.float32) / 255.0 for i in range(4)],
            dim=-1,
        )
    elif "hdr_color" in particle:
        ctx.color = particle["hdr_color"]
    else:
        ctx.color = torch.ones((n, 4), dtype=torch.float32, device=dev)
    if "alpha" in particle:
        ctx.color = torch.cat(
            [ctx.color[:, :3], (ctx.color[:, 3] * particle["alpha"])[:, None]], dim=1
        )

    # The FIRST size attribute in layout order wins (lib.rs:876-905).
    size = torch.ones((n, 3), dtype=torch.float32, device=dev)
    size_attrs = [
        a.name
        for a in asset.particle_layout().attributes()
        if a.name in ("size", "size2", "size3")
    ]
    if size_attrs:
        first = size_attrs[0]
        if first == "size":
            size = size * particle["size"][:, None]
        elif first == "size2":
            size = torch.cat([size[:, :2] * particle["size2"], size[:, 2:]], dim=1)
        else:
            size = particle["size3"].expand(n, 3)
    ctx.size = size

    rot = camera.rotation.to(dev)
    ctx.axis_x = rot[:, 0].expand(n, 3)
    ctx.axis_y = rot[:, 1].expand(n, 3)
    ctx.axis_z = rot[:, 2].expand(n, 3)

    for m in asset.render_modifiers:
        m.apply_render(asset.module, ctx)

    position = ctx.particle.get("position")
    if position is None:
        position = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    # ---- screen-space size (output.rs:838-862) ----
    sz = ctx.size
    if ctx.screen_space_size:
        mvp = mat4_mul(torch.as_tensor(camera.proj), torch.as_tensor(camera.view))
        w_cs = mvp_w(mvp.to(dev), position)
        wpx, hpx = camera.viewport
        ps = camera.proj_scale
        denom = float(torch.minimum(wpx * ps[0], hpx * ps[1]))
        sz = sz * (w_cs[:, None] * 2.0) / denom

    return ParticleDrawData(
        position=position,
        axis_x=ctx.axis_x * sz[:, 0:1],
        axis_y=ctx.axis_y * sz[:, 1:2],
        color=ctx.color,
        alive=pool.alive,
    )
