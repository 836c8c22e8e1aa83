"""Render extraction: pool → per-particle draw data
(port of ``bevy_hanabi_tpu/render/extract.py``).

Global-space draws: default colour, size and camera-facing axes, the render
modifiers (with the roundness, flipbook, texture-layer and mesh-lighting
state they record for the rasterizer), screen-space size, the per-particle
alpha-mask cutoff, and the ribbon sort's columns (``ribbon_id``, ``age``,
``counter``), which :func:`~.ribbon.build_ribbon_segments` turns into
segment quads; :func:`~.mesh.expand_mesh_draw` expands a mesh effect's draw
into its quad and triangle entries. :func:`concat_painter_draws` merges
draw sets without textures or meshes into one painter draw set (the
painter's texture atlas and its mesh and Lambert merge raise).
Local-space effects raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

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
    roundness: Any = None  # [N] 0=quad .. 1=ellipse, or None when no RoundModifier
    # int32[N] flipbook frame; None where the layout has no SPRITE_INDEX
    # (the JAX package's zeros: the rasterizer reads frame 0 then)
    sprite_index: Any = None
    # static draw state
    sprite_grid_size: Tuple[int, int] = (1, 1)
    texture_layers: tuple = ()  # ((slot, ImageSampleMapping), ...)
    needs_uv: bool = False
    alpha_cutoff: Any = None  # [N] per-particle mask cutoff (AlphaMode::Mask)
    # [N] 1.0 where the entry is a TRIANGLE (axis_x/axis_y are then the
    # edges A->B / A->C times 2 and position the midpoint of B and C; the
    # inside test is barycentric). None = all quads. Set by mesh expansion.
    tri: Any = None
    # Per-entry vertex-attribute triplets, interpolated barycentrically per
    # fragment (the reference's mesh vertex buffers). Set by mesh expansion.
    uv_abc: Any = None  # [N,6] (ua,va, ub,vb, uc,vc)
    nrm_abc: Any = None  # [N,9] world-space unit normals at A,B,C
    vcol_abc: Any = None  # [N,12] RGBA vertex colors at A,B,C
    # ((lx,ly,lz), band) Lambert params when a lighting render modifier
    # deferred shading to the rasterizer (per-fragment mesh normals)
    lighting: Any = None
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

    ``textures`` keeps the JAX package's signature: the rasterizer samples
    them (no ported expression reads a texture), and a ``transform`` only
    matters for local-space effects, which raise."""
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

    # ---- render modifiers ----
    ctx.mesh_has_normals = (
        asset.mesh is not None
        and getattr(asset.mesh, "normals", None) is not None
        and asset.mesh.num_triangles > 0
    )
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

    # None (not zeros) when no RoundModifier ran: the rasterizer then reads
    # no roundness column and runs no squircle pow()
    roundness = ctx.roundness
    if roundness is not None:
        roundness = torch.as_tensor(roundness, dtype=torch.float32, device=dev).expand(n).contiguous()
    sprite_index = particle.get("sprite_index")
    if sprite_index is not None:
        sprite_index = sprite_index.to(torch.int32)

    return ParticleDrawData(
        position=position,
        axis_x=ctx.axis_x * sz[:, 0:1],
        axis_y=ctx.axis_y * sz[:, 1:2],
        color=ctx.color,
        alive=pool.alive,
        roundness=roundness,
        sprite_index=sprite_index,
        sprite_grid_size=ctx.sprite_grid_size or (1, 1),
        texture_layers=tuple(ctx.texture_layers),
        needs_uv=ctx.needs_uv,
        alpha_cutoff=alpha_cutoff,
        ribbon_id=particle.get("ribbon_id"),
        age=particle.get("age"),
        counter=particle.get("particle_counter"),
        lighting=ctx.mesh_lighting,
    )


def _cat_or(draws, field: str, fill: float):
    """An optional [n] column of ``draws`` concatenated, ``fill`` where a
    draw lacks it; None where none has it (extract.py:418-430)."""
    if all(getattr(d, field) is None for d in draws):
        return None
    return torch.cat([
        getattr(d, field)
        if getattr(d, field) is not None
        else torch.full(d.alive.shape, fill, dtype=torch.float32, device=d.alive.device)
        for d in draws
    ])


def concat_draws(draws) -> ParticleDrawData:
    """The required quad columns of ``draws`` and their roundness
    concatenated into one draw set (the scene's batch pass,
    scene.py:2605-2636; no texture, mesh or mask effect is ever batched).
    The painter columns are :func:`concat_painter_draws`'."""
    return ParticleDrawData(
        **{f: torch.cat([getattr(d, f) for d in draws])
           for f in ("position", "axis_x", "axis_y", "color", "alive")},
        roundness=_cat_or(draws, "roundness", 0.0),
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
    """Concatenate per-effect draw sets into ONE painter draw set
    (extract.py:394-619, without textures or meshes).

    ``kinds`` are the effects' alpha-mode kinds, becoming the per-entry
    ``mode_id`` column; mask effects contribute their per-particle
    ``alpha_cutoff`` (others pad 0, never read), round effects their
    roundness (others pad 0: a plain quad). Ribbon segments join as the
    quads :func:`~.ribbon.build_ribbon_segments` makes, their appearance
    already in segment order. The JAX package also merges textured draw
    sets through a stacked texture atlas, and mesh triangles with their
    Lambert lighting; neither is ported, and both raise."""
    if (textures_per_draw is not None and any(textures_per_draw)) or any(
        d.texture_layers for d in draws
    ):
        raise NotImplementedError(
            "concat_painter_draws: the painter texture atlas (textured effects in the painter "
            "pass) is not ported; render with pipeline='split'"
        )
    if any(d.tri is not None or d.lighting is not None for d in draws):
        raise NotImplementedError(
            "concat_painter_draws: the painter texture atlas and mesh/Lambert merge (mesh "
            "effects in the painter pass) is not ported; render with pipeline='split'"
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
