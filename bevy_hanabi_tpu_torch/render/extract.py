"""Render extraction: pool → per-particle draw data
(port of ``bevy_hanabi_tpu/render/extract.py``).

Global-space draws: default colour, size and camera-facing axes, the render
modifiers (with the roundness, flipbook, texture-layer and mesh-lighting
state they record for the rasterizer), screen-space size, the per-particle
alpha-mask cutoff, and the ribbon sort's columns (``ribbon_id``, ``age``,
``counter``), which :func:`~.ribbon.build_ribbon_segments` turns into
segment quads; :func:`~.mesh.expand_mesh_draw` expands a mesh effect's draw
into its quad and triangle entries. :func:`concat_painter_draws` merges
draw sets into one painter draw set: plain, round and mask quads, ribbon
segments, mesh triangles with their Lambert lighting, and textured draws
through a stacked texture atlas. LOCAL-space effects extract in emitter
space and their frame goes to world through the emitter transform.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch

from ..asset import EffectAsset, SimulationSpace
from ..compiler import RenderContext, SimParams
from ..ops.linalg import affine3, mat4_mul, mvp_w, rotate3
from ..runtime.pool import ParticlePool
from ..utils.profiling import profile_span
from .camera import CameraParams

__all__ = [
    "ParticleDrawData",
    "extract_draw_data",
    "concat_draws",
    "flatten_instance_axis",
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
    # [N, 4] per-entry Lambert params (lx, ly, lz, band) where a painter
    # merge carries several distinct lighting setups (concat_painter_draws;
    # unlit entries band 1.0, so their shade is exactly 1). None elsewhere:
    # one setup stays per draw in ``lighting``.
    light_entry: Any = None
    # [N] per-entry blend mode id for the painter pass (alpha_mode="scene"):
    # PAINTER_MODE_IDS. None everywhere else.
    mode_id: Any = None
    # the ribbon sort's columns, from the pool where the layout has them:
    # RIBBON_ID and PARTICLE_COUNTER as int64 tensors holding the uint32
    # values (ops/rng.py), AGE as f32. None on a segment draw.
    ribbon_id: Any = None
    age: Any = None
    counter: Any = None
    # Painter texture merging (concat_painter_draws): every merged effect's
    # texture layers zero-padded to the largest extent and stacked,
    # [L, Hmax, Wmax, 4], and per entry [N, 2 + 4 * Lmax]: (grid cols, grid
    # rows), then per texture layer (atlas layer, true width, true height,
    # map code), map code 0 an absent layer (factor 1), 1 modulate, 2
    # modulate_rgb, 3 modulate_opacity_from_r. None outside merged draws.
    atlas: Any = None
    tex_entry: Any = None


def extract_draw_data(
    asset: EffectAsset,
    pool: ParticlePool,
    camera: CameraParams,
    sim: SimParams = None,
    properties=None,
    textures: Optional[List[Any]] = None,
    transform: Optional[Any] = None,
    instances: int = 0,
) -> ParticleDrawData:
    """Run render modifiers over the pool and build draw data.

    ``textures`` ([H, W, 4] tensors by slot) are what ``texture_sample``
    expressions read (the rasterizer samples the texture layers itself).
    ``transform`` (the [3, 4] emitter transform) places a LOCAL-space
    effect in the world each frame; GLOBAL pools are already there.
    ``instances`` > 0 marks ``pool`` as the flat ``[I*N]`` view of an
    instanced group (:meth:`~..runtime.pool.ParticlePool.flatten`) whose
    ``properties`` are per lane, each lane its instance's value: one pass
    computes what the JAX package's extraction vmapped over the instances
    computes (instanced.py:236-258), ``PARTICLE_INDEX`` the lane's index in
    its instance."""
    with profile_span("hanabi:extract"):
        n = pool.alive.shape[-1]
        dev = pool.device
        particle = dict(pool.attrs)
        # LOCAL-space effects run the whole vertex stage in emitter space, like
        # the reference (vfx_render.wgsl:60-90, 117-124): the camera goes INTO
        # effect space for the orient modes, the modifiers compute axes there,
        # and the expanded frame goes back to world at the end (extract.py:213-240).
        is_local = asset.simulation_space is SimulationSpace.LOCAL and transform is not None
        ctx_camera = camera
        if is_local:
            tf = torch.as_tensor(transform, dtype=torch.float32)
            m4 = torch.cat([tf.cpu(), torch.tensor([[0.0, 0.0, 0.0, 1.0]])], dim=0)
            # view_local = world->view . local->world: every derived camera
            # quantity (rotation, position, up) lands in effect space
            ctx_camera = CameraParams(
                view=mat4_mul(torch.as_tensor(camera.view, dtype=torch.float32), m4),
                proj=camera.proj,
                viewport=camera.viewport,
            )
            tf = tf.to(dev)
        particle_index = torch.arange(n, dtype=torch.int64, device=dev)
        if instances:
            particle_index = particle_index % (n // instances)

        ctx = RenderContext(
            asset.module,
            particle,
            pool.seed,
            sim=sim if sim is not None else SimParams(),
            properties=properties or {},
            particle_index=particle_index,
            alive=pool.alive,
            camera=ctx_camera,
            alpha_cutoff=0.0,
            textures=list(textures or []),
            lane_properties=bool(instances),
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

        rot = ctx_camera.rotation.to(dev)
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
        if is_local:
            # the whole particle frame to world: position affine, axes through
            # the 3x3 (scale included, vfx_render.wgsl:293-295), broadcast math
            rot3 = tf[:, :3]
            position = affine3(position, rot3, tf[:, 3])
            ctx.axis_x = rotate3(ctx.axis_x, rot3)
            ctx.axis_y = rotate3(ctx.axis_y, rot3)
            ctx.axis_z = rotate3(ctx.axis_z, rot3)

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


def flatten_instance_axis(tree):
    """Merge a leading instance axis: ``[I, N, ...]`` tensors -> ``[I*N,
    ...]`` (extract.py:99-106). ``tree`` is a tensor, a dict of them, or a
    dataclass such as :class:`ParticleDrawData`, whose tensor fields are
    merged and whose other fields are kept."""
    if isinstance(tree, torch.Tensor):
        return tree.reshape((-1,) + tuple(tree.shape[2:]))
    if isinstance(tree, dict):
        return {k: flatten_instance_axis(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: flatten_instance_axis(getattr(tree, f.name))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)
        })
    return tree


def _cat_or(draws, field: str, fill: float, width=None):
    """An optional [n] (or [n, width]) column of ``draws`` concatenated,
    ``fill`` where a draw lacks it; None where none has it
    (extract.py:418-430)."""
    if all(getattr(d, field) is None for d in draws):
        return None
    parts = []
    for d in draws:
        v = getattr(d, field)
        if v is None:
            n = d.alive.shape[0]
            shape = (n,) if width is None else (n, width)
            v = torch.full(shape, fill, dtype=torch.float32, device=d.alive.device)
        parts.append(v)
    return torch.cat(parts)


def concat_draws(draws) -> ParticleDrawData:
    """The required quad columns of ``draws`` and their roundness
    concatenated into one draw set (the scene's batch pass,
    scene.py:2605-2636; no texture, mesh or mask effect is ever batched).
    The painter columns are :func:`concat_painter_draws`'."""
    with profile_span("hanabi:extract"):
        return _concat_quads(draws)


def _concat_quads(draws) -> ParticleDrawData:
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

# the painter's per-layer map codes (tex_entry); 0 is an absent layer
MAP_CODES = {"modulate": 1.0, "modulate_rgb": 2.0, "modulate_opacity_from_r": 3.0}


def _rows(values, n: int, device) -> torch.Tensor:
    """One f32 row of ``values`` repeated ``n`` times."""
    return torch.tensor(values, dtype=torch.float32, device=device).expand(n, len(values))


def _merge_lighting(draws):
    """``(lighting, nrm_abc, light_entry)`` of a painter merge
    (extract.py:463-526): one distinct Lambert setup stays per draw, the
    unlit entries' normals padded with its light direction (the raster
    normalises them: shade exactly 1 for a unit direction); several ride
    per-entry (lx, ly, lz, band) columns, unlit entries at band 1 with
    normals (0, 0, 1)."""
    lit = [d.lighting is not None and d.nrm_abc is not None for d in draws]
    setups = {(tuple(d.lighting[0]), d.lighting[1]) for d, x in zip(draws, lit) if x}
    if not setups:
        return None, None, None
    if len(setups) == 1:
        lighting = next(d.lighting for d, x in zip(draws, lit) if x)
        ldir = [float(x) for x in lighting[0]] * 3
        nrm = [d.nrm_abc if x else _rows(ldir, d.alive.shape[0], d.alive.device)
               for d, x in zip(draws, lit)]
        return lighting, torch.cat(nrm), None
    nrm, light = [], []
    for d, x in zip(draws, lit):
        n, dev = d.alive.shape[0], d.alive.device
        if x:
            (lx, ly, lz), band = d.lighting
            nrm.append(d.nrm_abc)
            light.append(_rows([float(lx), float(ly), float(lz), float(band)], n, dev))
        else:
            nrm.append(_rows([0.0, 0.0, 1.0] * 3, n, dev))
            light.append(_rows([0.0, 0.0, 1.0, 1.0], n, dev))
    return None, torch.cat(nrm), torch.cat(light)


def _merge_textures(draws, textures_per_draw):
    """``(atlas, tex_entry)`` of a painter merge (extract.py:530-593):
    each distinct texture (by object identity) one atlas layer, in the
    order the draws first reference them."""
    if textures_per_draw is None:
        raise ValueError("textured draw sets need textures_per_draw to merge into the painter pass")
    lmax = max(len(d.texture_layers) for d in draws)
    uniq = {}  # id(texture) -> (atlas layer, texture)
    parts = []
    for d, texs in zip(draws, textures_per_draw):
        gc, gr = d.sprite_grid_size
        row = [float(gc), float(gr)]
        for slot, mapping in d.texture_layers:
            if slot >= len(texs):
                raise ValueError(
                    f"texture slot {slot} is referenced but only {len(texs)} texture(s) were "
                    "provided for the effect — pass textures=[...] when adding it"
                )
            tex = torch.as_tensor(texs[slot], dtype=torch.float32, device=d.alive.device)
            if tex.dim() != 3 or tex.shape[2] != 4:
                raise ValueError(
                    f"painter texture merging needs [H, W, 4] RGBA textures, got shape "
                    f"{tuple(tex.shape)} — render with pipeline='split'"
                )
            tid = uniq.setdefault(id(tex), (len(uniq), tex))[0]
            row += [float(tid), float(tex.shape[1]), float(tex.shape[0]),
                    MAP_CODES[getattr(mapping, "value", mapping)]]
        row += [0.0, 1.0, 1.0, 0.0] * (lmax - len(d.texture_layers))
        parts.append(_rows(row, d.alive.shape[0], d.alive.device))
    texs = [t for _, t in sorted(uniq.values(), key=lambda p: p[0])]
    hm = max(t.shape[0] for t in texs)
    wm = max(t.shape[1] for t in texs)
    atlas = torch.stack([
        torch.nn.functional.pad(t, (0, 0, 0, wm - t.shape[1], 0, hm - t.shape[0])) for t in texs
    ])
    return atlas.contiguous(), torch.cat(parts)


def concat_painter_draws(draws, kinds, textures_per_draw=None) -> ParticleDrawData:
    """Concatenate per-effect draw sets into ONE painter draw set
    (extract.py:394-619).

    ``kinds`` are the effects' alpha-mode kinds, becoming the per-entry
    ``mode_id`` column; mask effects contribute their per-particle
    ``alpha_cutoff`` (others pad 0, never read), round effects their
    roundness (others pad 0: a plain quad). Ribbon segments join as the
    quads :func:`~.ribbon.build_ribbon_segments` makes, their appearance
    already in segment order; expanded meshes join as their quad and
    triangle entries (``tri`` padded 0, vertex colours 1, and the Lambert
    merge of :func:`_merge_lighting`). Textured draw sets merge through a
    stacked atlas (:func:`_merge_textures`): ``textures_per_draw`` aligns
    with ``draws``, each effect's textures by slot; a textured mesh's
    vertex UVs ride ``uv_abc``, NaN on quads and on meshes without UVs,
    which keep the quad parameterisation. A ``hanabi:painter`` span."""
    with profile_span("hanabi:painter"):
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
        lighting, nrm_abc, light_entry = _merge_lighting(draws)
        atlas = tex_entry = uv_abc = sprite = None
        if any(d.texture_layers for d in draws):
            atlas, tex_entry = _merge_textures(draws, textures_per_draw)
            uv_abc = _cat_or(draws, "uv_abc", float("nan"), width=6)
        if any(d.sprite_index is not None for d in draws):
            sprite = torch.cat([
                d.sprite_index if d.sprite_index is not None
                else torch.zeros(d.alive.shape, dtype=torch.int32, device=d.alive.device)
                for d in draws
            ])
        return dataclasses.replace(
            _concat_quads(draws),
            sprite_index=sprite,
            alpha_cutoff=cutoff,
            mode_id=mode_id,
            tri=_cat_or(draws, "tri", 0.0),
            uv_abc=uv_abc,
            nrm_abc=nrm_abc,
            vcol_abc=_cat_or(draws, "vcol_abc", 1.0, width=12),
            lighting=lighting,
            light_entry=light_entry,
            atlas=atlas,
            tex_entry=tex_entry,
        )
