"""Render extraction: pool → per-particle draw data
(port of ``bevy_hanabi_tpu/render/extract.py``).

Global-space quads: default colour, size and camera-facing axes, the render
modifiers, screen-space size, the per-particle alpha-mask cutoff, and the
ribbon sort's columns (``ribbon_id``, ``age``, ``counter``), which
:func:`~.ribbon.build_ribbon_segments` turns into segment quads.
:func:`concat_painter_draws` merges quad draw sets (ribbon segments
included) into one painter draw set. Local-space effects raise
``NotImplementedError``; the modifiers that would fill the other draw
columns (roundness, flipbook, textures, meshes) are not ported, so no asset
of the port can ask for them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, List, Optional

import torch

from ..asset import EffectAsset, SimulationSpace
from ..compiler import RenderContext, SimParams
from ..ops.linalg import mat4_mul, mvp_w
from ..runtime.pool import ParticlePool
from .camera import CameraParams

__all__ = [
    "ParticleDrawData",
    "extract_draw_data",
    "concat_draws",
    "PAINTER_MODE_IDS",
    "concat_painter_draws",
]


@dataclass
class ParticleDrawData:
    """Everything the rasterizer needs, SoA over particles."""

    position: Any  # [N,3] world space
    axis_x: Any  # [N,3] world, scaled by size.x (half extents = 0.5*axis)
    axis_y: Any  # [N,3] world, scaled by size.y
    color: Any  # [N,4] linear RGBA (HDR allowed)
    alive: Any  # bool[N]
    alpha_cutoff: Any = None  # [N] per-particle mask cutoff (AlphaMode::Mask)
    # [N] per-entry blend mode id for the painter pass (alpha_mode="scene"):
    # PAINTER_MODE_IDS. None everywhere else.
    mode_id: Any = None
    # the ribbon sort's columns, from the pool where the layout has them:
    # RIBBON_ID and PARTICLE_COUNTER as int64 tensors holding the uint32
    # values (ops/rng.py), AGE as f32. None on a segment draw.
    ribbon_id: Any = None
    age: Any = None
    counter: Any = None


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

    # ---- alpha-mask cutoff, per particle (extract.py:307-318) ----
    alpha_cutoff = None
    cutoff_handle = asset.alpha_mode.mask_cutoff
    if cutoff_handle is not None:
        alpha_cutoff = ctx.eval(cutoff_handle).to(torch.float32).expand(n).contiguous()
        ctx.alpha_cutoff = alpha_cutoff

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
        alpha_cutoff=alpha_cutoff,
        ribbon_id=particle.get("ribbon_id"),
        age=particle.get("age"),
        counter=particle.get("particle_counter"),
    )


def concat_draws(draws) -> ParticleDrawData:
    """The required quad columns of ``draws`` concatenated into one draw set
    (the scene's batch pass, scene.py:2605-2636). The optional columns are
    left out: a batch never holds a mask effect, and the painter columns are
    :func:`concat_painter_draws`'."""
    return ParticleDrawData(
        **{f: torch.cat([getattr(d, f) for d in draws])
           for f in ("position", "axis_x", "axis_y", "color", "alive")}
    )


# Blend-mode ids carried per entry by the painter pass (raster.py
# alpha_mode="scene"): one global back-to-front sort blends every effect's
# entries with per-entry equations.
PAINTER_MODE_IDS = {
    "blend": 0,
    "premultiply": 1,
    "add": 2,
    "multiply": 3,
    "opaque": 4,
    "mask": 5,
}


def concat_painter_draws(draws, kinds, textures_per_draw=None) -> ParticleDrawData:
    """Concatenate per-effect quad draw sets into ONE painter draw set
    (extract.py:394-619, the quad branch).

    ``kinds`` are the effects' alpha-mode kinds, becoming the per-entry
    ``mode_id`` column; mask effects contribute their per-particle
    ``alpha_cutoff`` (others pad 0, never read). Ribbon segments join as
    the quads :func:`~.ribbon.build_ribbon_segments` makes, their
    appearance already in segment order. The JAX package also merges mesh
    triangles, a texture atlas and Lambert lighting here; none of those is
    ported, so textures raise."""
    if textures_per_draw is not None and any(textures_per_draw):
        raise NotImplementedError(
            "concat_painter_draws: the painter texture atlas is not ported"
        )
    cutoff = torch.cat(
        [
            d.alpha_cutoff
            if d.alpha_cutoff is not None
            else torch.zeros(d.alive.shape, dtype=torch.float32, device=d.alive.device)
            for d in draws
        ]
    )
    mode_id = torch.cat(
        [
            torch.full(d.alive.shape, PAINTER_MODE_IDS[k], dtype=torch.int32, device=d.alive.device)
            for d, k in zip(draws, kinds)
        ]
    )
    return dataclasses.replace(concat_draws(draws), alpha_cutoff=cutoff, mode_id=mode_id)
