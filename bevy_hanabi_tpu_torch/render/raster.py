"""Tile-binned particle splat rasterizer (port of ``bevy_hanabi_tpu/render/raster.py``).

The same **bin → sort → bounded per-tile blend** pipeline as the JAX
package, for every binning of ``RasterConfig.tile_slots`` (0: the
``tile_span``-square, exact; 1: the centre tile; 2: the corner and the
dominant spill), with the ``blend``, ``premultiply``, ``add``,
``multiply``, ``opaque``, ``mask`` and painter (``scene``) equations, the
depth test against a scene depth plane, the depth plane written by opaque
and mask passes, a seeded framebuffer, and the appearance of round,
flipbook, textured and mesh draws (triangle entries, squircles, barycentric
UVs, normals and vertex colours, the Lambert shade, flipbook cells and
bilinear texture layers, and the painter's per-entry atlas layers and
Lambert setups), with analytic antialiasing (``RasterConfig.antialias``):

1. :func:`project_bin` (CUDA kernel) projects every quad, tests it against
   the screen (a triangle entry at half its quad's radii), bins it into
   ``S`` entries (:func:`entry_slots`, entry ``s * N + p``: a tile id and a
   depth each) and packs its one row ``[cx, cy, h1x, h1y, h2x, h2y, r, g,
   b, a]``, with ``[depth, cutoff, mode]`` appended where the pass's blend
   variant reads them (:func:`row_width`) and then the draw's appearance
   columns (:func:`draw_appearance`), and reduces the binned depths'
   range (a triangle entry at half its quad's radii, with or without
   antialiasing, as JAX bins);
2. :func:`sort_tiles` packs the JAX package's 32-bit keys with
   :func:`bin_keys` (CUDA kernel) — ``(tile | far-first depth)`` on the
   ordered path, one of the three fast variants of :func:`fast_mode` for
   ``add`` and ``multiply`` — as int32, and sorts them (plain torch: CUB's
   radix sort); ``searchsorted`` of the tile bounds gives each tile's run;
3. :func:`~..ops.gather.gather_window` (CUDA kernel, the port of the TPU
   row gather) builds every tile's window of ``M`` rows in blend order,
   its ``has`` flags and its rows (entry ``e`` reads row ``e mod N``) in
   one launch;
4. :func:`tile_blend` (CUDA kernel) blends each tile in one CTA, one thread
   per pixel, its depth plane in registers, and culls the entries that
   cover no pixel of a warp's block before the exact per-pixel test; a
   draw's appearance reaches it as a per-call :class:`Appearance`; under
   antialiasing each pair's fractional coverage scales its alpha.

Every kernel wrapper has a plain PyTorch version beside it, used only for
tensors on the CPU; for CUDA tensors the wrapper launches its kernel (or
raises) and adds one to its ``launches`` counter. Slice rendering
(``rasterize(y_offset=)``, the sharded renderer's slice mode) shifts the
projected centres in :func:`project_bin`; nothing after it reads
full-viewport coordinates.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Any, Sequence, Tuple

import numpy as np
import torch

from .. import cuda_build
from ..cuda_build import Kernel
from ..cuda_build import check_tensor as _check
from ..cuda_build import current_stream as _stream
from ..ops.gather import gather_window, window_index
from ..ops.linalg import mat4_mul, sqrt_f32
from .camera import CameraParams
from .extract import ParticleDrawData

__all__ = [
    "RasterConfig",
    "rasterize",
    "row_width",
    "Appearance",
    "draw_appearance",
    "bilinear_wrap",
    "entry_slots",
    "bin_entries_plain",
    "project_bin",
    "project_bin_plain",
    "depth_range_plain",
    "bin_keys",
    "bin_keys_plain",
    "tile_blend",
    "tile_blend_plain",
    "fast_mode",
    "sort_tiles",
    "window_index",
    "untile",
    "to_tiles",
    "KERNELS",
]

# floats per window row: cx, cy, h1x, h1y, h2x, h2y, r, g, b, a (ROW_QUAD),
# then depth, cutoff, mode (ROW) for the variants that read them
ROW_QUAD, ROW = 10, 13
COL_DEPTH, COL_CUTOFF, COL_MODE = 10, 11, 12
# the largest |centre| coordinate of an entry that tile_blend's antialiased
# warp-block cull may skip (csrc/tile_blend.cu's header: past it a lane's
# coverage may be NaN, which must be written)
AA_CULL_CENTRE = 2.0**32
# the appearance columns a draw may append to its rows, in the JAX package's
# order (raster.py:530-577), and their widths: the painter's per-entry
# texture state ``tex`` is 2 + 4 * its layer count wide (None here)
APPEARANCE_COLUMNS = (("roundness", 1), ("tri", 1), ("sprite", 1), ("tex", None), ("uv", 6),
                      ("nrm", 9), ("light", 4), ("vcol", 12))
# texture layers one tile_blend call samples (the kernel's descriptor), and
# the painter's atlas layers an entry samples
MAX_LAYERS = 4
# ImageSampleMapping values by the id the kernel takes
MAPPINGS = ("modulate", "modulate_rgb", "modulate_opacity_from_r")
# ints of tile_blend's appearance descriptor: the six column offsets, the
# grid, lit and the layer count, (tw, th, mapping) a layer, then the
# painter's tex offset, atlas layers an entry, light offset and the atlas's
# [L, H, W]
AP_INTS = 10 + 3 * MAX_LAYERS + 6


@dataclass(frozen=True)
class RasterConfig:
    """Static rasterizer configuration (the JAX package's, unchanged)."""

    width: int = 512
    height: int = 512
    tile_size: int = 16
    tile_span: int = 2
    tile_slots: int = 0
    max_entries_per_tile: int = 64
    blend_unroll: int = 8
    antialias: bool = False
    order_independent_fast: bool = True
    overflow_policy: str = "nearest"
    background: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)

    def __post_init__(self):
        if self.tile_slots not in (0, 1, 2):
            raise ValueError(
                "tile_slots must be 0 (exact span^2 binning), 1 "
                "(center-tile-only fast binning), or 2 (corner + "
                "dominant-spill fast binning); got "
                f"{self.tile_slots}"
            )
        if self.overflow_policy not in ("nearest", "first"):
            raise ValueError(
                "overflow_policy must be 'nearest' or 'first'; got "
                f"{self.overflow_policy!r}"
            )

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_size)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_size)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _project_params(view, proj, viewport, raster_size, T, y_offset=0.0):
    """(mvp, view) as f32 CPU tensors and the 26 f32 kernel parameters."""
    view_t = torch.as_tensor(np.asarray(view, np.float32))
    mvp = mat4_mul(torch.as_tensor(np.asarray(proj, np.float32)), view_t)
    w, h = raster_size
    params = np.concatenate(
        [
            mvp.numpy().reshape(16),
            view_t.numpy()[2],
            np.asarray([viewport[0], viewport[1], w, h, T, y_offset], np.float32),
        ]
    ).astype(np.float32)
    return mvp, view_t, params


def _check_row(row, extra):
    if row not in (ROW_QUAD, ROW):
        raise ValueError(f"project_bin: rows are {ROW_QUAD} or {ROW} floats wide, got {row}")
    if extra is not None and row != ROW:
        raise ValueError(f"project_bin: the cutoff and mode columns need {ROW}-float rows")


def depth_range_plain(depth: torch.Tensor) -> torch.Tensor:
    """(min, max) of the binned depths (those above ``-inf``) as f32 [2],
    NaN where nothing is binned: the range :func:`project_bin` reduces and
    :func:`bin_keys` reads (raster.py:363-365)."""
    if depth.numel() == 0:
        return torch.full((2,), torch.nan, dtype=torch.float32, device=depth.device)
    binned = depth > -torch.inf
    lo = torch.where(binned, depth, torch.inf).min()
    hi = torch.where(binned, depth, -torch.inf).max()
    return torch.where(binned.any(), torch.stack([lo, hi]), torch.nan)


def entry_slots(tile_slots: int, tile_span: int) -> int:
    """Bin entries per particle, ``S``: 1 (centre tile), 2 (corner and
    dominant spill) or ``tile_span ** 2`` (``tile_slots=0``, exact)."""
    if tile_slots not in (0, 1, 2):
        raise ValueError(f"tile_slots must be 0, 1 or 2, got {tile_slots}")
    if tile_slots == 0 and tile_span < 1:
        raise ValueError(f"tile_span must be at least 1, got {tile_span}")
    return tile_span * tile_span if tile_slots == 0 else tile_slots


def _tile_floor(x, lo: int, hi: int) -> torch.Tensor:
    """``floor(x)`` as int32, clamped to ``[lo, hi]`` in float first (NaN
    to 0): JAX's saturating ``astype(int32)`` (raster.py:268-271) wherever
    the binning reads it, with no out-of-range conversion."""
    return torch.clamp(torch.floor(x), lo, hi).nan_to_num(0.0).to(torch.int32)


def bin_entries_plain(cx, cy, rx, ry, valid, dist, T, ntx, nty, tile_slots=1, tile_span=2):
    """The bin entries of raster.py:260-333 from each particle's projected
    centre, screen radii, validity and view distance: ``(tile int32
    [S * N], depth f32 [S * N])``, slot-major (entry ``s * N + p``), with
    ``ntx * nty`` and ``-inf`` where the slot bins nothing.

    ``tile_slots=1`` bins the centre tile; ``2`` the screen-clamped bbox
    corner and the neighbour of the larger spill; ``0`` every tile of the
    ``tile_span``-square from the bbox corner that the bbox touches and the
    screen holds (a larger quad is cropped). The bbox floors are clamped in
    float (``tx0`` to ``[-span, ntx]``, ``tx1`` to ``[-1, ntx]``), which
    leaves every test of the JAX package's unchanged."""
    nt = ntx * nty
    Tf = float(T)
    if tile_slots == 1:
        tcx = _tile_floor(cx / Tf, 0, ntx - 1)
        tcy = _tile_floor(cy / Tf, 0, nty - 1)
        tiles, oks = [torch.where(valid, tcy * ntx + tcx, nt)], [valid]
    else:
        span = tile_span if tile_slots == 0 else 1
        tx0 = _tile_floor((cx - rx) / Tf, -span, ntx)
        ty0 = _tile_floor((cy - ry) / Tf, -span, nty)
        tx1 = _tile_floor((cx + rx) / Tf, -1, ntx)
        ty1 = _tile_floor((cy + ry) / Tf, -1, nty)
        if tile_slots == 2:  # raster.py:297-326
            tcx = torch.clamp(tx0, 0, ntx - 1)
            tcy = torch.clamp(ty0, 0, nty - 1)
            ok0 = valid & (tcx <= tx1) & (tcy <= ty1)
            tile0 = torch.where(ok0, tcy * ntx + tcx, nt)
            sx = (tx1 > tcx) & (tcx + 1 < ntx)
            sy = (ty1 > tcy) & (tcy + 1 < nty)
            spill_x = (cx + rx) - (tcx + 1).to(torch.float32) * Tf
            spill_y = (cy + ry) - (tcy + 1).to(torch.float32) * Tf
            use_x = sx & (~sy | (spill_x >= spill_y))
            ok1 = valid & (sx | sy)
            tile1 = torch.where(ok1, torch.where(use_x, tile0 + 1, tile0 + ntx), nt)
            tiles, oks = [tile0, tile1], [ok0, ok1]
        else:  # raster.py:318-330
            tiles, oks = [], []
            for dy in range(span):
                for dx in range(span):
                    tx, ty = tx0 + dx, ty0 + dy
                    ok = valid & (tx <= tx1) & (ty <= ty1)
                    ok &= (tx >= 0) & (tx < ntx) & (ty >= 0) & (ty < nty)
                    tiles.append(torch.where(ok, ty * ntx + tx, nt))
                    oks.append(ok)
    tile = torch.cat([t.to(torch.int32) for t in tiles])
    depth = torch.cat([torch.where(ok, dist, -torch.inf) for ok in oks])
    return tile, depth


def _appearance_width(appearance) -> int:
    if appearance is None:
        return 0
    return sum(1 if t.dim() == 1 else t.shape[1] for t in appearance if t is not None)


def _tex_layers(width: int) -> int:
    """The layers of a ``tex`` column ``width`` floats wide (2 + 4 a layer)."""
    if width < 6 or (width - 2) % 4 or (width - 2) // 4 > MAX_LAYERS:
        raise ValueError(f"tex columns are 2 + 4 * layers wide, 1 to {MAX_LAYERS} layers; "
                         f"got {width}")
    return (width - 2) // 4


def project_bin_plain(position, axis_x, axis_y, alive, color, view, proj, viewport,
                      T, ntx, nty, raster_size=None, extra=None, row=ROW, tile_slots=1,
                      tile_span=2, appearance=None, y_offset=0.0):
    """Plain version of :func:`project_bin`: raster.py:241-333 + 516-586."""
    _check_row(row, extra)
    entry_slots(tile_slots, tile_span)
    mvp, view_t, params = _project_params(view, proj, viewport, raster_size or viewport, T,
                                          y_offset)
    mvp, view_t = mvp.to(position.device), view_t.to(position.device)
    width, height = (float(v) for v in params[22:24])
    vp_w, vp_h = (float(v) for v in params[20:22])

    def project(p):
        px, py, pz = p[:, 0], p[:, 1], p[:, 2]

        def row(m, i):
            return m[i, 0] * px + m[i, 1] * py + m[i, 2] * pz + m[i, 3]

        view_z = row(view_t, 2)
        cx = row(mvp, 0)
        cy = row(mvp, 1)
        w = row(mvp, 3)
        safe_w = torch.where(torch.abs(w) < 1e-6, 1e-6, w)
        x = (cx / safe_w * 0.5 + 0.5) * vp_w
        y = (1.0 - (cy / safe_w * 0.5 + 0.5)) * vp_h
        return x, y, -view_z

    cx, cy, dist = project(position)
    x1, y1, _ = project(position + 0.5 * axis_x)
    x2, y2, _ = project(position + 0.5 * axis_y)
    h1x, h1y = x1 - cx, y1 - cy
    h2x, h2y = x2 - cx, y2 - cy
    # a slice's raster starts at viewport row y_offset: the centre moves,
    # the half-extents (differences) do not (raster.py:247-252)
    cy = cy - float(params[25])
    valid = alive & (dist > 1e-4)
    rx = torch.abs(h1x) + torch.abs(h2x)
    ry = torch.abs(h1y) + torch.abs(h2y)
    tri = None if appearance is None else appearance[1]
    if tri is not None:  # raster.py:259-263: a triangle spans half the quad
        half = torch.where(tri > 0.5, 0.5, 1.0)
        rx = rx * half
        ry = ry * half
    valid &= (cx + rx > 0) & (cx - rx < width)
    valid &= (cy + ry > 0) & (cy - ry < height)
    valid &= (rx > 1e-6) & (ry > 1e-6)
    tile, depth = bin_entries_plain(cx, cy, rx, ry, valid, dist, T, ntx, nty, tile_slots, tile_span)
    cols = [torch.stack([cx, cy, h1x, h1y, h2x, h2y], dim=1), color]
    if row == ROW:
        if extra is None:
            extra = torch.zeros((position.shape[0], 2), dtype=torch.float32, device=position.device)
        cols += [dist[:, None], extra]
    if appearance is not None:
        cols += [t.to(torch.float32).reshape(t.shape[0], -1) for t in appearance if t is not None]
    rows = torch.cat(cols, dim=1).contiguous()
    return tile, depth, rows, depth_range_plain(depth)


@cuda_build.on_tensor_device
def project_bin(position, axis_x, axis_y, alive, color, view, proj, viewport,
                T, ntx, nty, raster_size=None, extra=None, row=ROW, tile_slots=1, tile_span=2,
                appearance=None, y_offset=0.0):
    """Project, screen-test and bin N particle quads into ``S`` entries each.

    ``position``/``axis_x``/``axis_y`` f32 [N, 3], ``alive`` bool [N],
    ``color`` f32 [N, 4]; ``view``/``proj`` host 4x4 matrices;
    ``viewport`` the camera's (width, height) and ``raster_size`` the
    raster's (defaults to the viewport); ``row`` the floats per row:
    :data:`ROW` (13, with the depth, cutoff and mode columns) or
    :data:`ROW_QUAD` (10, without); ``extra`` an optional f32 [N, 2] of
    (mask cutoff, painter mode id) per particle for 13-float rows, zeros
    without it; ``tile_slots`` and ``tile_span`` the binning of
    :class:`RasterConfig` (:func:`bin_entries_plain`), ``S`` =
    :func:`entry_slots`; ``appearance`` the draw's appearance columns
    (:func:`draw_appearance`: roundness, tri, sprite, tex, uv, nrm, light,
    vcol, each None where absent), appended to each row after its ``row``
    floats; a triangle entry (tri > 0.5) takes half its quad's screen radii
    (raster.py:259-263). ``y_offset`` (pixels) makes the raster a
    horizontal slice of the viewport starting at that row: the projected
    centres move up by it, their half-extents do not. Returns ``tile``
    int32 [S * N] (``ntx * nty``
    where a slot bins nothing), ``depth`` f32 [S * N] (view distance,
    ``-inf`` there), both slot-major (entry ``s * N + p``), ``rows`` f32
    [N, row + A], one a particle, and the binned entries' depth (min, max)
    as f32 [2] (:func:`depth_range_plain`), which :func:`bin_keys` reads."""
    dev = position.device
    n = position.shape[0]
    _check(position, "position", torch.float32, (n, 3), dev)
    _check(axis_x, "axis_x", torch.float32, (n, 3), dev)
    _check(axis_y, "axis_y", torch.float32, (n, 3), dev)
    _check(alive, "alive", torch.bool, (n,), dev)
    _check(color, "color", torch.float32, (n, 4), dev)
    if extra is not None:
        _check(extra, "extra", torch.float32, (n, 2), dev)
    _check_row(row, extra)
    if appearance is not None:
        if len(appearance) != len(APPEARANCE_COLUMNS):
            raise ValueError(f"appearance holds {len(APPEARANCE_COLUMNS)} columns or None")
        for (name, width), t in zip(APPEARANCE_COLUMNS, appearance):
            if t is not None:
                if name == "tex":
                    width = t.shape[-1] if t.dim() == 2 else 0
                    _tex_layers(width)
                shape = (n,) if width == 1 else (n, width)
                _check(t, name, torch.int32 if name == "sprite" else torch.float32, shape, dev)
    slots = entry_slots(tile_slots, tile_span)
    if not position.is_cuda:
        return project_bin_plain(position, axis_x, axis_y, alive, color, view, proj, viewport,
                                 T, ntx, nty, raster_size, extra, row, tile_slots, tile_span,
                                 appearance, y_offset)
    _, _, params = _project_params(view, proj, viewport, raster_size or viewport, T, y_offset)
    width = row + _appearance_width(appearance)
    tile = torch.empty((slots * n,), dtype=torch.int32, device=dev)
    depth = torch.empty((slots * n,), dtype=torch.float32, device=dev)
    rows = torch.empty((n, width), dtype=torch.float32, device=dev)
    rng = torch.empty((2,), dtype=torch.float32, device=dev)
    cols = [None if t is None else t.data_ptr()
            for t in (appearance or (None,) * len(APPEARANCE_COLUMNS))]
    tex = None if appearance is None else appearance[3]
    code = cuda_build.library().hanabi_project_bin(
        position.data_ptr(), axis_x.data_ptr(), axis_y.data_ptr(), alive.data_ptr(), color.data_ptr(),
        None if extra is None else extra.data_ptr(),
        tile.data_ptr(), depth.data_ptr(), rows.data_ptr(), rng.data_ptr(),
        n, width, params.ctypes.data_as(ctypes.c_void_p), ntx, nty, tile_slots, tile_span, row,
        *cols, 0 if tex is None else tex.shape[1], _stream(),
    )
    cuda_build.check(code, "project_bin")
    project_bin.launches += 1
    return tile, depth, rows, rng


project_bin.launches = 0


def _key_layout(n: int, nt: int, mode):
    """``(tile_shift, q_bits, idx_bits, far_first)`` of the JAX package's
    uint32 key for ``n`` entries and :func:`fast_mode`'s ``mode``
    (raster.py:373-423): ``key = tile << tile_shift | q << idx_bits | i``
    with ``q`` the depth quantised to ``q_bits`` (far first where
    ``far_first``) and the entry index ``i`` only where ``idx_bits``."""
    tile_bits = max(1, int(np.ceil(np.log2(nt + 2))))
    if mode in ("first", "depth"):
        idx_bits = max(1, int(np.ceil(np.log2(max(n, 2)))))
        slack = 32 - tile_bits - idx_bits
        if slack < (4 if mode == "depth" else 0):
            raise ValueError(f"sort_tiles: {n} entries and {nt} tiles leave no room for {mode!r} keys")
        db = min(slack, 8) if mode == "depth" else 0
        return db + idx_bits, db, idx_bits, False
    if mode in (None, "payload"):
        shift = min(22, 32 - tile_bits)  # raster.py:403: f32 quantisation stays exact
        return shift, shift, 0, mode is None
    raise ValueError(f"sort_tiles: unknown mode {mode!r}")


def bin_keys_plain(tile, depth, depth_range, nt: int, mode=None):
    """Plain version of :func:`bin_keys`: the JAX package's uint32 keys
    (raster.py:361-423), XOR 0x80000000 as int32."""
    n = tile.shape[0]
    tile_shift, q_bits, idx_bits, far_first = _key_layout(n, nt, mode)
    key = tile.to(torch.int64) << tile_shift
    if q_bits:
        lo, hi = depth_range[0], depth_range[1]
        dmin = torch.where(lo.isnan(), torch.inf, lo)  # NaN: nothing binned (raster.py:364-365)
        dmax = torch.where(hi.isnan(), -torch.inf, hi)
        span = torch.fmax(dmax - dmin, depth.new_tensor(1e-9))
        # fmax maps a NaN quotient to 0, as the kernel's fmaxf
        x = torch.clamp(torch.fmax((depth - dmin) / span, depth.new_zeros(())), max=1.0)
        q = (x * float((1 << q_bits) - 1)).to(torch.int64)
        if far_first:
            q = ((1 << q_bits) - 1) - q
        key = key | (q << idx_bits)
    if idx_bits:
        key = key | torch.arange(n, dtype=torch.int64, device=tile.device)
    return (key - (1 << 31)).to(torch.int32)


@cuda_build.on_tensor_device
def bin_keys(tile, depth, depth_range, nt: int, mode=None):
    """The sort key of every entry: the JAX package's uint32 key for
    :func:`fast_mode`'s ``mode`` (``None`` the ordered path, far first;
    ``"payload"`` near first; ``"first"`` / ``"depth"`` ending in the entry
    index), XOR 0x80000000 as int32 so that a signed sort orders it as the
    unsigned key. ``tile`` int32 [N], ``depth`` f32 [N] (``-inf`` where not
    binned), ``depth_range`` f32 [2] (:func:`depth_range_plain`; may be
    ``None`` for ``"first"``, which quantises no depth). Returns int32 [N]."""
    n = tile.shape[0]
    dev = tile.device
    _check(tile, "tile", torch.int32, (n,), dev)
    _check(depth, "depth", torch.float32, (n,), dev)
    tile_shift, q_bits, idx_bits, far_first = _key_layout(n, nt, mode)
    if depth_range is not None:
        _check(depth_range, "depth_range", torch.float32, (2,), dev)
    elif q_bits:
        raise ValueError(f"bin_keys: the {mode!r} key quantises depth and needs depth_range")
    if not tile.is_cuda:
        return bin_keys_plain(tile, depth, depth_range, nt, mode)
    key = torch.empty((n,), dtype=torch.int32, device=dev)
    code = cuda_build.library().hanabi_bin_keys(
        tile.data_ptr(), depth.data_ptr(), None if depth_range is None else depth_range.data_ptr(),
        key.data_ptr(), n, tile_shift, q_bits, idx_bits, int(far_first), _stream(),
    )
    cuda_build.check(code, "bin_keys")
    bin_keys.launches += 1
    return key


bin_keys.launches = 0


# the equations of tile_blend, by the id its kernel takes
BLEND_MODES = ("blend", "add", "opaque", "mask", "scene", "premultiply", "multiply")


def row_width(mode: str, depth_test: bool) -> int:
    """Floats per window row that ``tile_blend``'s variant reads:
    :data:`ROW` where it reads the depth, cutoff or mode column (a depth
    test, ``mask``, ``scene``), else :data:`ROW_QUAD`."""
    return ROW if depth_test or mode in ("mask", "scene") else ROW_QUAD


@dataclass(frozen=True)
class Appearance:
    """A draw's appearance as :func:`tile_blend` reads it, uniform over a
    call: ``row`` the window's floats per row; ``offsets`` the row column of
    each of :data:`APPEARANCE_COLUMNS` (roundness, tri, sprite, tex, uv,
    nrm, light, vcol), -1 where absent; ``grid`` the flipbook's (cols,
    rows); ``lighting`` ``((lx, ly, lz), band)`` where the draw is lit per
    fragment with one setup (a ``light`` column instead carries each
    entry's); ``layers`` the texture layers ``(slot, mapping)`` in
    modifier order, ``slot`` indexing the textures passed beside it and
    ``mapping`` one of :data:`MAPPINGS`; ``atlas_layers`` the layers of the
    painter's per-entry ``tex`` column (0: none), which sample the atlas
    passed as the one texture instead."""

    row: int
    offsets: Tuple[int, ...]
    grid: Tuple[int, int] = (1, 1)
    lighting: Any = None
    layers: Tuple[Tuple[int, str], ...] = ()
    atlas_layers: int = 0

    def offset(self, name: str) -> int:
        return self.offsets[[c for c, _ in APPEARANCE_COLUMNS].index(name)]

    @property
    def lit(self) -> bool:
        return self.lighting is not None or self.offset("light") >= 0


def draw_appearance(draw, base_row: int):
    """The appearance of ``draw`` for a pass whose rows start with
    ``base_row`` floats: ``(Appearance, columns)``, ``columns`` the
    appearance columns the draw carries into its rows on JAX's conditions
    (raster.py:530-577) as ``(roundness, tri, sprite, tex, uv, nrm, light,
    vcol)``, each a contiguous tensor or None. The flipbook frame is there
    for a textured draw with a grid other than (1, 1) and for a painter
    draw with an atlas (frame 0 where the draw has none), the per-entry
    texture state and the UVs for a textured one, the normals for a lit
    one and the per-entry Lambert setups where the painter merged several.
    ``(None, None)`` for a draw with no appearance column and no texture
    layer (the plain quad variants)."""
    n = draw.position.shape[0]
    textured = bool(draw.texture_layers)
    ptex = draw.atlas is not None and draw.tex_entry is not None
    sprite = None
    if (textured and tuple(draw.sprite_grid_size) != (1, 1)) or ptex:
        sprite = draw.sprite_index
        if sprite is None:
            sprite = torch.zeros((n,), dtype=torch.int32, device=draw.position.device)
    uv = draw.uv_abc if textured or ptex else None
    lit = draw.nrm_abc is not None and (draw.lighting is not None or draw.light_entry is not None)
    nrm = draw.nrm_abc if lit else None
    light = draw.light_entry if lit else None
    columns = tuple(None if t is None else t.contiguous()
                    for t in (draw.roundness, draw.tri, sprite, draw.tex_entry if ptex else None,
                              uv, nrm, light, draw.vcol_abc))
    if all(t is None for t in columns) and not textured:
        return None, None
    offsets, o = [], base_row
    for t in columns:
        offsets.append(o if t is not None else -1)
        o += 0 if t is None else 1 if t.dim() == 1 else t.shape[1]
    layers = tuple((int(slot), getattr(m, "value", m)) for slot, m in draw.texture_layers)
    lighting = draw.lighting if lit and light is None else None
    atlas_layers = _tex_layers(draw.tex_entry.shape[1]) if ptex else 0
    return Appearance(o, tuple(offsets), tuple(draw.sprite_grid_size), lighting, layers,
                      atlas_layers), columns


def _index(x) -> torch.Tensor:
    """A float index as JAX's ``astype(int32)`` gives it where the value is
    in range: NaN to 0 (XLA's conversion saturates), as int64."""
    return torch.where(x.isnan(), 0.0, x).to(torch.int64)


def bilinear_wrap(tex, u, v):
    """``_bilinear_wrap`` (raster.py:121-146) of a [th, tw, C] texture at
    ``u``, ``v``: 4-tap bilinear filtering with wrap addressing,
    half-texel centred, JAX's op order, indices by floored remainder
    (``jnp.mod``, as ``torch.remainder``)."""
    return _bilinear(lambda vi, ui: tex[vi, ui], tex.shape[1], tex.shape[0], u, v)


def _bilinear(lookup, tw, th, u, v):
    """``_bilinear_wrap`` through ``lookup(vi, ui)`` at the true size ``tw``
    x ``th`` (ints, or per-entry f32 tensors: the painter's atlas layers)."""
    uu = u * tw - 0.5
    vv = v * th - 0.5
    u0 = torch.floor(uu)
    v0 = torch.floor(vv)
    fu = (uu - u0)[..., None]
    fv = (vv - v0)[..., None]
    u0i = _index(torch.remainder(u0, tw))
    v0i = _index(torch.remainder(v0, th))
    u1i = _index(torch.remainder(u0 + 1.0, tw))
    v1i = _index(torch.remainder(v0 + 1.0, th))
    t00, t01 = lookup(v0i, u0i), lookup(v0i, u1i)
    t10, t11 = lookup(v1i, u0i), lookup(v1i, u1i)
    top = t00 + (t01 - t00) * fu
    bot = t10 + (t11 - t10) * fu
    return top + (bot - top) * fv


def _at_least(x, lo):
    """``jnp.maximum(x, lo)``: NaN stays NaN."""
    return torch.where(x < lo, lo, x)


def _at_most(x, hi):
    """``jnp.minimum(x, hi)``: NaN stays NaN."""
    return torch.where(x > hi, hi, x)


def _atlas_src(r, src, u01, v01, ap: Appearance, atlas):
    """The painter's texture layers (raster.py:777-813): each entry's
    flipbook grid and, per layer, its atlas layer at its true size and its
    map code as neutral-by-default factors. The grid is a per-entry float,
    so the cell and the UVs take true divisions."""
    o = ap.offset("tex")
    gc, gr = r[:, o, None, None], r[:, o + 1, None, None]
    sprite = _index(r[:, ap.offset("sprite")]).to(torch.float32)[:, None, None]
    cell_c = torch.remainder(sprite, gc)
    cell_r = torch.floor(sprite / gc)
    tu = (u01 + cell_c) / gc
    tv = (v01 + cell_r) / gr
    for layer in range(ap.atlas_layers):
        k = o + 2 + 4 * layer
        tid = torch.clamp(_index(r[:, k]), 0, atlas.shape[0] - 1)[:, None, None]
        # indices clamped into the atlas, as JAX's gather clamps them
        h, w = atlas.shape[1] - 1, atlas.shape[2] - 1
        texel = _bilinear(lambda vi, ui: atlas[tid, vi.clamp(0, h), ui.clamp(0, w)],
                          r[:, k + 1, None, None], r[:, k + 2, None, None], tu, tv)
        mm = r[:, k + 3, None, None]
        rgbf = torch.where(((mm == 1.0) | (mm == 2.0))[..., None], texel[..., :3], 1.0)
        af = torch.where(mm == 1.0, texel[..., 3], torch.where(mm == 3.0, texel[..., 0], 1.0))
        src = src * torch.cat([rgbf, af[..., None]], dim=-1)
    return src


def _appearance_src(r, col, u, v, u01, v01, is_tri, ap: Appearance, textures):
    """The source colour of every (entry, pixel) pair of one window slot
    with the draw's appearance (raster.py:702-776): vertex colours,
    Lambert, then the texture layers at the (flipbook) UVs."""
    nt = r.shape[0]
    T = u.shape[1]
    s_, t_ = u + 0.5, v + 0.5

    def bary(j0, nc):
        out = []
        for c in range(nc):
            va = r[:, j0 + c, None, None]
            vb = r[:, j0 + nc + c, None, None]
            vc = r[:, j0 + 2 * nc + c, None, None]
            out.append(va + s_ * (vb - va) + t_ * (vc - va))
        return torch.stack(out, dim=-1)

    src = col[:, None, None, :].expand(nt, T, T, 4)
    if ap.offset("vcol") >= 0:
        src = src * bary(ap.offset("vcol"), 4)
    if ap.lit:
        if ap.offset("light") >= 0:  # per entry (raster.py:724-733)
            lx, ly, lz, band = (r[:, ap.offset("light") + k, None, None] for k in range(4))
        else:
            (lx, ly, lz), band = ap.lighting
            lx, ly, lz, band = (float(np.float32(x)) for x in (lx, ly, lz, band))
        nvec = bary(ap.offset("nrm"), 3)
        length = sqrt_f32(nvec[..., 0] * nvec[..., 0] + nvec[..., 1] * nvec[..., 1]
                          + nvec[..., 2] * nvec[..., 2])
        nn = nvec / _at_least(length, 1e-9)[..., None]
        ndotl = nn[..., 0] * lx + nn[..., 1] * ly + nn[..., 2] * lz
        shade = _at_most(_at_least(ndotl, band), 1.0)  # jnp.clip: a NaN stays NaN
        src = torch.cat([src[..., :3] * shade[..., None], src[..., 3:]], dim=-1)
    if (ap.layers or ap.atlas_layers) and ap.offset("uv") >= 0 and is_tri is not None:
        o = ap.offset("uv")
        muv = bary(o, 2)
        sel = is_tri & torch.isfinite(r[:, o])[:, None, None]
        u01 = torch.where(sel, muv[..., 0], u01)
        v01 = torch.where(sel, muv[..., 1], v01)
    if ap.atlas_layers:  # raster.py:777-813
        return _atlas_src(r, src, u01, v01, ap, textures[0])
    if ap.layers:
        gc, gr = ap.grid
        if (gc, gr) != (1, 1):
            sprite = _index(r[:, ap.offset("sprite")]).to(torch.float32)  # astype(int32)
            cell_c = torch.remainder(sprite, gc)[:, None, None]
            cell_r = torch.div(sprite, gc, rounding_mode="floor")[:, None, None]
            # XLA compiles JAX's division by the grid constant into a product
            # with its f32 reciprocal (raster.py:756-757)
            tu = (u01 + cell_c) * float(np.float32(1.0) / np.float32(gc))
            tv = (v01 + cell_r) * float(np.float32(1.0) / np.float32(gr))
        else:
            tu, tv = u01, v01
        for slot, mapping in ap.layers:
            texel = bilinear_wrap(textures[slot], tu, tv)
            if mapping == "modulate":
                src = src * texel
            elif mapping == "modulate_rgb":
                src = torch.cat([src[..., :3] * texel[..., :3], src[..., 3:]], dim=-1)
            else:  # modulate_opacity_from_r
                src = torch.cat([src[..., :3], src[..., 3:] * texel[..., 0:1]], dim=-1)
    return src


def _blend_flags(mode, depth_test, write_depth):
    """Validate an equation and its depth flags (the kernel's variants)."""
    if mode not in BLEND_MODES:
        raise ValueError(f"tile_blend: mode must be one of {BLEND_MODES}, got {mode!r}")
    if mode == "scene" and not (depth_test and write_depth):
        raise ValueError("tile_blend: the scene equation always tests and writes depth")
    if write_depth and not (depth_test and mode in ("opaque", "mask", "scene")):
        raise ValueError("tile_blend: only a depth-tested opaque, mask or scene pass writes depth")


def _coverage(u, v, det_f, a1x, a1y, a2x, a2y, has, is_tri):
    """JAX's antialiased coverage (raster.py:644-671): a one-pixel ramp at
    a quad's edges, and at a triangle's three half-planes (their uv slack
    over the gradients' pixel lengths), times ``has``."""
    has_f = has.to(torch.float32)
    eu = sqrt_f32(a1x * a1x + a1y * a1y)[:, None, None]
    ev = sqrt_f32(a2x * a2x + a2y * a2y)[:, None, None]
    cov_u = torch.clamp((1.0 - torch.abs(u)) * eu + 0.5, 0.0, 1.0)
    cov_v = torch.clamp((1.0 - torch.abs(v)) * ev + 0.5, 0.0, 1.0)
    coverage = cov_u * cov_v * has_f
    if is_tri is None:
        return coverage
    absdet = torch.abs(det_f)[:, None, None]
    e12x, e12y = a2x - a1x, a2y - a1y
    e12 = sqrt_f32(e12x * e12x + e12y * e12y)[:, None, None]
    eps = 1e-9
    d1 = (u + 0.5) * absdet / _at_least(ev, eps)
    d2 = (v + 0.5) * absdet / _at_least(eu, eps)
    d3 = -(u + v) * absdet / _at_least(e12, eps)
    cov_tri = (torch.clamp(d1 + 0.5, 0.0, 1.0) * torch.clamp(d2 + 0.5, 0.0, 1.0)
               * torch.clamp(d3 + 0.5, 0.0, 1.0)) * has_f
    return torch.where(is_tri, cov_tri, coverage)


def tile_blend_plain(window, has, T, ntx, nty, background, mode="blend", framebuffer=None,
                     scene_depth=None, depth_test=False, write_depth=False, appearance=None,
                     textures=(), antialias=False):
    """Plain version of :func:`tile_blend`: raster.py:616-911 on the
    columns of :data:`ROW` and the draw's :class:`Appearance`, in the JAX
    package's form (every lane through the equation, zero coverage as
    ``where``). Without appearance it reads only the columns the variant
    reads, so the window may be :func:`row_width` wide or wider."""
    _blend_flags(mode, depth_test, write_depth)
    ap = appearance
    nt, M, _ = window.shape
    dev = window.device
    ar = torch.arange(T, dtype=torch.int32, device=dev)
    tiles = torch.arange(nt, dtype=torch.int32, device=dev)
    py = ((tiles // ntx)[:, None, None] * T + ar[None, :, None]).to(torch.float32) + 0.5
    px = ((tiles % ntx)[:, None, None] * T + ar[None, None, :]).to(torch.float32) + 0.5
    if framebuffer is not None:
        fb = framebuffer
    else:
        fb = torch.tensor(background, dtype=torch.float32, device=dev).expand(nt, T, T, 4)
    if scene_depth is None:
        scene_depth = torch.full((nt, T, T), torch.inf, dtype=torch.float32, device=dev)
    dbuf = scene_depth if write_depth else None
    for m in range(M):
        r = window[:, m, :]
        col = r[:, 6:10]
        dx = px - r[:, 0, None, None]
        dy = py - r[:, 1, None, None]
        a1x, a1y, a2x, a2y = r[:, 2], r[:, 3], r[:, 4], r[:, 5]
        det_f = a1x * a2y - a1y * a2x
        det_f = torch.where(torch.abs(det_f) < 1e-9, 1e-9, det_f)
        det = det_f[:, None, None]
        u = (a2y[:, None, None] * dx - a2x[:, None, None] * dy) / det
        v = ((-a1y)[:, None, None] * dx + a1x[:, None, None] * dy) / det
        inside = (torch.abs(u) <= 1.0) & (torch.abs(v) <= 1.0)
        is_tri = None
        if ap is not None and ap.offset("tri") >= 0:  # raster.py:635-642
            is_tri = (r[:, ap.offset("tri")] > 0.5)[:, None, None]
            tri_inside = (u >= -0.5) & (v >= -0.5) & (u + v <= 0.0)
            inside = torch.where(is_tri, tri_inside, inside)
        inside &= has[:, m, None, None]
        if antialias:
            coverage = _coverage(u, v, det_f, a1x, a1y, a2x, a2y, has[:, m, None, None], is_tri)
            inside = coverage > 0.0
        else:
            coverage = inside.to(torch.float32)
        if depth_test:
            frag_d = r[:, COL_DEPTH, None, None]
            vis = frag_d <= (dbuf if dbuf is not None else scene_depth)
            inside &= vis
            coverage = coverage * vis.to(torch.float32)
        if ap is None:
            src = col[:, None, None, :]
        else:
            u01 = u * 0.5 + 0.5
            v01 = v * 0.5 + 0.5
            if ap.offset("roundness") >= 0:  # raster.py:686-700
                rnd = r[:, ap.offset("roundness")]
                nexp = (2.0 / _at_least(rnd, 1e-6))[:, None, None]
                squircle = (torch.pow(torch.abs(1.0 - 2.0 * u01), nexp)
                            + torch.pow(torch.abs(1.0 - 2.0 * v01), nexp))
                sq_ok = (rnd <= 0.0)[:, None, None] | (squircle <= 1.0)
                if is_tri is not None:
                    sq_ok = sq_ok | is_tri
                inside &= sq_ok
                coverage = coverage * sq_ok.to(torch.float32)
            src = _appearance_src(r, col, u, v, u01, v01, is_tri, ap, textures)
        # Zero-coverage lanes contribute EXACTLY zero even when the row is
        # non-finite (raster.py:822-828).
        covered = coverage[..., None] > 0.0
        src_a = src[..., 3]
        a = torch.where(covered, (src_a * coverage)[..., None], 0.0)
        rgb_s = torch.where(covered, src[..., :3], 0.0)
        rgb_d, a_d = fb[..., :3], fb[..., 3:4]
        cutoff = r[:, COL_CUTOFF, None, None] if mode in ("mask", "scene") else None
        if mode == "blend":
            rgb = rgb_s * a + rgb_d * (1.0 - a)
            alpha = a + a_d * (1.0 - a)
        elif mode == "premultiply":
            rgb = rgb_s * coverage[..., None] + rgb_d * (1.0 - a)
            alpha = a + a_d * (1.0 - a)
        elif mode == "multiply":
            rgb = rgb_s * rgb_d * a + rgb_d * (1.0 - a)
            alpha = a_d
        elif mode == "add":
            rgb = rgb_s * a + rgb_d
            alpha = torch.clamp(a + a_d, max=1.0)
        elif mode in ("opaque", "mask"):
            write = inside
            if mode == "mask":
                write = write & (src_a >= cutoff)
            wr = write[..., None]
            rgb = torch.where(wr, rgb_s, rgb_d)
            alpha = torch.where(wr, 1.0, a_d)
            if dbuf is not None:
                dbuf = torch.where(write, frag_d, dbuf)
        else:  # scene: raster.py:856-895
            mid = r[:, COL_MODE]
            b_, p_, a_, m_ = ((mid == float(k))[:, None, None, None] for k in range(4))
            is_o = (mid == 4.0)[:, None, None]
            is_k = (mid == 5.0)[:, None, None]
            cov1 = coverage[..., None]
            one_m_a = 1.0 - a
            cs = torch.where(b_ | a_, a, 0.0) + torch.where(p_, cov1, 0.0)
            cd = torch.where(b_ | p_ | m_, one_m_a, 0.0) + torch.where(a_, 1.0, 0.0)
            cm = torch.where(m_, a, 0.0)
            rgb_t = rgb_s * cs + rgb_d * cd + rgb_s * rgb_d * cm
            al_t = (
                torch.where(b_ | p_, a + a_d * one_m_a, 0.0)
                + torch.where(a_, torch.clamp(a + a_d, max=1.0), 0.0)
                + torch.where(m_, a_d, 0.0)
            )
            write = inside & (is_o | (is_k & (src_a >= cutoff)))
            wr = write[..., None]
            opq4 = (is_o | is_k)[..., None]
            rgb = torch.where(opq4, torch.where(wr, rgb_s, rgb_d), rgb_t)
            alpha = torch.where(opq4, torch.where(wr, 1.0, a_d), al_t)
            dbuf = torch.where(write, frag_d, dbuf)
        fb = torch.cat([rgb, alpha], dim=-1)
    fb = fb.contiguous()
    return (fb, dbuf.contiguous()) if write_depth else fb


def warp_blocks(T: int, ntx: int, nt: int, device) -> torch.Tensor:
    """The pixel-centre bounds ``(x0, x1, y0, y1)`` f64 [nt, W, 4] of each
    warp's block of ``tile_blend``'s tiles (W = ceil(T*T / 32) warps a
    tile): 8x4 pixels where T is a multiple of 8, else 32 pixels of the
    row-major order (a padding lane repeating the last pixel)."""
    lanes = (T * T + 31) // 32 * 32
    t = torch.arange(lanes, device=device)
    if T % 8 == 0:
        warp, lane = t // 32, t % 32
        pi = (warp // (T // 8)) * 4 + lane // 8
        pj = (warp % (T // 8)) * 8 + lane % 8
    else:
        lin = torch.clamp(t, max=T * T - 1)
        pi, pj = lin // T, lin % T
    tiles = torch.arange(nt, device=device)[:, None]
    px = ((tiles % ntx) * T + pj[None]).to(torch.float64) + 0.5
    py = ((tiles // ntx) * T + pi[None]).to(torch.float64) + 0.5
    px, py = px.reshape(nt, -1, 32), py.reshape(nt, -1, 32)
    return torch.stack([px.amin(-1), px.amax(-1), py.amin(-1), py.amax(-1)], dim=-1)


def warp_entries_plain(window, has, T: int, ntx: int, tri_col: int = -1,
                       triangle_bound: bool = True, antialias: bool = False) -> torch.Tensor:
    """The (warp, entry) iterations of ``tile_blend``'s blend loop, bool
    [nt, W, M]: a real entry whose bound does not cull the warp's block
    (:func:`warp_blocks`). The bounds of ``csrc/tile_blend.cu`` on whole
    tensors, in float64 at the block's corners with the kernel's margins
    (m = 2^-20), for entries with a finite det that was not clamped and
    finite quad columns (the others are never culled): a quad entry is
    culled where its numerator N_u or N_v lies beyond +-(|det| (1 + m) +
    m S) over the block; a triangle entry (``tri_col``'s value above 0.5)
    where sg N_u or sg N_v (sg the det's sign) lies below -(|det|/2 (1 + m)
    + m S) or above its negative, or sg (N_u + N_v) above m (|det| + S_u +
    S_v). ``triangle_bound=False`` takes the quad bound for triangles too
    (the first appearance kernel's). ``antialias`` takes the kernel's
    fringe bounds (only for entries whose edge lengths in f32 lie in
    [2^-40, 2^60] and whose centre lies in [-2^32, 2^32]^2): a quad's |N_u| beyond (|det| + |det| / (2 |h1|)) (1 +
    2 m) + m S_u (N_v likewise with |h2|); a triangle's sg N_u below
    -((|det| + max(|h2|, 1e-9)) / 2 (1 + 2 m) + m S_u), sg N_v below the same
    with |h1|, or sg (N_u + N_v) above max(|h2 - h1|, 1e-9) / 2 (1 + 2 m) +
    m (|det| + S_u + S_v). Counts only: no kernel or main path calls it."""
    nt, M, _ = window.shape
    r = window[..., :6]
    det = r[..., 2] * r[..., 5] - r[..., 3] * r[..., 4]
    clamped = det.abs() < 1e-9
    det = torch.where(clamped, 1e-9, det)
    cullable = torch.isfinite(r).all(-1) & torch.isfinite(det) & ~clamped
    if antialias:  # the kernel's entry_test: the edge lengths as the lane computes them
        for x, y in ((r[..., 2], r[..., 3]), (r[..., 4], r[..., 5]),
                     (r[..., 4] - r[..., 2], r[..., 5] - r[..., 3])):
            e = sqrt_f32(x * x + y * y)
            cullable &= (e >= 2.0**-40) & (e <= 2.0**60)
        cullable &= (r[..., :2].abs() <= AA_CULL_CENTRE).all(-1)
    blocks = warp_blocks(T, ntx, nt, window.device)[:, :, None, :]  # [nt, W, 1, 4]
    cx, cy, a1x, a1y, a2x, a2y = (r[..., k].to(torch.float64)[:, None, :] for k in range(6))
    ad = det.abs().to(torch.float64)[:, None, :]
    sg = torch.where(det < 0, -1.0, 1.0).to(torch.float64)[:, None, :]
    dx0, dx1 = blocks[..., 0] - cx, blocks[..., 1] - cx
    dy0, dy1 = blocks[..., 2] - cy, blocks[..., 3] - cy
    mx = torch.maximum(dx0.abs(), dx1.abs())
    my = torch.maximum(dy0.abs(), dy1.abs())
    rel = 2.0**-20

    def lo(p, q):
        return torch.minimum(p * dx0, p * dx1) + torch.minimum(q * dy0, q * dy1)

    def hi(p, q):
        return torch.maximum(p * dx0, p * dx1) + torch.maximum(q * dy0, q * dy1)

    su = rel * (a2y.abs() * mx + a2x.abs() * my)
    sv = rel * (a1y.abs() * mx + a1x.abs() * my)
    if antialias:  # the edge lengths in float64, the fringe's margin k
        eu, ev = torch.sqrt(a1x * a1x + a1y * a1y), torch.sqrt(a2x * a2x + a2y * a2y)
        e12 = torch.sqrt((a2x - a1x) * (a2x - a1x) + (a2y - a1y) * (a2y - a1y))
        k = 1.0 + 2.0 * rel
        bu, bv = (ad + 0.5 * ad / eu) * k + su, (ad + 0.5 * ad / ev) * k + sv
    else:
        bu, bv = ad * (1.0 + rel) + su, ad * (1.0 + rel) + sv
    culled = ((lo(a2y, -a2x) > bu) | (hi(a2y, -a2x) < -bu)
              | (lo(-a1y, a1x) > bv) | (hi(-a1y, a1x) < -bv))
    if tri_col >= 0 and triangle_bound:
        pu, qu, pv, qv = sg * a2y, -sg * a2x, -sg * a1y, sg * a1x
        if antialias:
            eps = float(np.float32(1e-9))
            tri = ((hi(pu, qu) < -(0.5 * (ad + ev.clamp(min=eps)) * k + su))
                   | (hi(pv, qv) < -(0.5 * (ad + eu.clamp(min=eps)) * k + sv))
                   | (lo(pu + pv, qu + qv) > 0.5 * e12.clamp(min=eps) * k + rel * ad + su + sv))
        else:
            h = 0.5 * ad * (1.0 + rel)
            tri = ((hi(pu, qu) < -(h + su)) | (lo(pu, qu) > h + su)
                   | (hi(pv, qv) < -(h + sv)) | (lo(pv, qv) > h + sv)
                   | (lo(pu + pv, qu + qv) > rel * ad + su + sv))
        culled = torch.where((window[..., tri_col] > 0.5)[:, None, :], tri, culled)
    return has[:, None, :] & ~(cullable[:, None, :] & culled)


def texture_tensor(tex, device) -> torch.Tensor:
    """A texture image (array or tensor, [H, W, 4]) as a contiguous f32
    tensor on ``device``; no copy where it already is one."""
    return torch.as_tensor(np.asarray(tex, np.float32) if not torch.is_tensor(tex) else tex,
                           dtype=torch.float32, device=device).contiguous()


def _check_textures(appearance, textures, dev):
    """Each layer's texture: an f32 [th, tw, 4] contiguous tensor on
    ``dev``; the painter's atlas: one f32 [L, H, W, 4]."""
    if appearance.atlas_layers:
        if appearance.layers or len(textures) != 1 or textures[0].dim() != 4:
            raise ValueError("tile_blend: an atlas draw takes one [L, H, W, 4] texture, no layers")
        atlas = textures[0]
        if atlas.shape[3] != 4 or 0 in atlas.shape:
            raise ValueError(f"the atlas must be [L, H, W, 4] RGBA, got {tuple(atlas.shape)}")
        _check(atlas, "atlas", torch.float32, atlas.shape, dev)
        if appearance.offset("tex") < 0 or appearance.offset("sprite") < 0:
            raise ValueError("tile_blend: an atlas draw needs its tex and sprite columns")
    for slot, mapping in appearance.layers:
        if mapping not in MAPPINGS:
            raise ValueError(f"tile_blend: unknown sample mapping {mapping!r}")
        if not 0 <= slot < len(textures):
            raise ValueError(f"tile_blend: texture slot {slot}, but {len(textures)} texture(s)")
        tex = textures[slot]
        if tex.dim() != 3 or tex.shape[2] != 4:
            raise ValueError(f"textures[{slot}] must be [H, W, 4] RGBA, got {tuple(tex.shape)}")
        _check(tex, f"textures[{slot}]", torch.float32, tex.shape, dev)


def tile_blend(window, has, T, ntx, nty, background, mode="blend", framebuffer=None,
               scene_depth=None, depth_test=False, write_depth=False, appearance=None,
               textures=(), antialias=False):
    """Blend each tile's window, entry m = 0 first, into ``fb`` [nt, T, T, 4].

    ``window`` f32 [nt, M, W] rows, ``W = row_width(mode, depth_test)``
    (:data:`ROW`), or ``appearance.row`` for a draw with an
    :class:`Appearance` (its columns after those; back to front on the
    ordered path, in the fast paths' order for ``add`` and ``multiply``),
    ``has`` bool [nt, M] marks real entries. ``mode`` is the equation
    (``"blend"``, ``"premultiply"``, ``"add"``, ``"multiply"``,
    ``"opaque"``, ``"mask"``, or ``"scene"``: per entry by its mode
    column). The target starts as ``framebuffer`` (tiled f32
    [nt, T, T, 4]) or else ``background`` (RGBA). ``depth_test`` discards
    fragments behind the depth plane, which starts as ``scene_depth``
    (tiled f32 [nt, T, T]) or else +inf; ``write_depth`` lets opaque and
    mask writes move it and returns ``(fb, depth)``. ``textures``: the
    draw's textures by slot, f32 [th, tw, 4] each, which the appearance's
    layers sample, or the painter's one atlas [L, H, W, 4] for an
    appearance with ``atlas_layers``. ``antialias``: JAX's fractional
    coverage (``RasterConfig.antialias``), in every variant."""
    _blend_flags(mode, depth_test, write_depth)
    dev = window.device
    nt = ntx * nty
    width = row_width(mode, depth_test)
    if appearance is not None:
        if appearance.row < width:
            raise ValueError(f"tile_blend: appearance rows of {appearance.row} floats under {width}")
        width = appearance.row
        _check_textures(appearance, textures, dev)
    if window.dim() != 3:
        raise ValueError(f"window must be [nt, M, {width}], got shape {tuple(window.shape)}")
    M = window.shape[1]
    _check(window, "window", torch.float32, (nt, M, width), dev)
    _check(has, "has", torch.bool, (nt, M), dev)
    if framebuffer is not None:
        _check(framebuffer, "framebuffer", torch.float32, (nt, T, T, 4), dev)
    if scene_depth is not None:
        _check(scene_depth, "scene_depth", torch.float32, (nt, T, T), dev)
    if len(background) != 4:
        raise ValueError("background must be RGBA")
    if not window.is_cuda:
        return tile_blend_plain(window, has, T, ntx, nty, background, mode, framebuffer,
                                scene_depth, depth_test, write_depth, appearance, textures,
                                antialias)
    if appearance is not None and mode != "scene" and (
            appearance.atlas_layers or appearance.offset("light") >= 0):
        raise NotImplementedError("tile_blend: the painter's atlas and per-entry Lambert "
                                  "setups are in the scene equation's variants only")
    if not 1 <= T * T <= 1024:
        raise ValueError(f"tile_blend runs one thread per pixel: T*T must be <= 1024, got T={T}")
    if appearance is not None and len(appearance.layers) > MAX_LAYERS:
        raise ValueError(f"tile_blend samples at most {MAX_LAYERS} texture layers a call, "
                         f"got {len(appearance.layers)}")
    out = tile_blend_launch(cuda_build.library(), window, has, T, ntx, background, mode,
                            framebuffer, scene_depth, depth_test, write_depth, appearance,
                            textures, antialias)
    tile_blend.launches += 1
    tile_blend.launches_by_mode[mode] += 1
    if appearance is not None:
        tile_blend.launches_appearance[mode] += 1
    if antialias:
        tile_blend.launches_antialias[mode] += 1
    return out


@cuda_build.on_tensor_device
def tile_blend_launch(lib, window, has, T, ntx, background, mode="blend", framebuffer=None,
                      scene_depth=None, depth_test=False, write_depth=False, appearance=None,
                      textures=(), antialias=False):
    """One launch of ``lib``'s ``tile_blend`` on arguments that
    :func:`tile_blend` has checked, counted nowhere: the wrapper's launch,
    and the one scripts use to time another build of the kernel (a library
    with the same C entry point) on the same inputs. The descriptor's
    painter fields (atlas, per-entry light) follow the first version's and
    the antialias flag rides the equation id (``eq + 8``), so an earlier
    build reads what it knows and refuses what it does not."""
    dev = window.device
    nt, M, width = window.shape
    fb = torch.empty((nt, T, T, 4), dtype=torch.float32, device=dev)
    depth = torch.empty((nt, T, T), dtype=torch.float32, device=dev) if write_depth else None
    bg = np.asarray(background, np.float32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    ap_i = ap_f = tex = None
    if appearance is not None:
        static = appearance.lighting is not None
        (lx, ly, lz), band = appearance.lighting if static else ((0.0, 0.0, 0.0), 0.0)
        ap_i = np.zeros(AP_INTS, np.int32)
        ap_i[:6] = [appearance.offset(c) for c in ("roundness", "tri", "sprite", "uv", "nrm",
                                                    "vcol")]
        ap_i[6:10] = (*appearance.grid, int(appearance.lit), len(appearance.layers))
        tex = (ctypes.c_void_p * (MAX_LAYERS + 1))()
        for k, (slot, mapping) in enumerate(appearance.layers):
            t = textures[slot]
            ap_i[10 + 3 * k: 13 + 3 * k] = (t.shape[1], t.shape[0], MAPPINGS.index(mapping))
            tex[k] = t.data_ptr()
        ap_i[22:25] = (appearance.offset("tex"), appearance.atlas_layers,
                       appearance.offset("light"))
        if appearance.atlas_layers:
            atlas = textures[0]
            ap_i[25:28] = atlas.shape[:3]
            tex[MAX_LAYERS] = atlas.data_ptr()
        ap_f = np.asarray([lx, ly, lz, band], np.float32)
    code = lib.hanabi_tile_blend_appearance(
        window.data_ptr(), has.data_ptr(), ptr(framebuffer), ptr(scene_depth), fb.data_ptr(),
        ptr(depth), nt, M, T, ntx, bg.ctypes.data_as(ctypes.c_void_p),
        BLEND_MODES.index(mode) + (8 if antialias else 0), int(depth_test), int(write_depth), width,
        None if ap_i is None else ap_i.ctypes.data_as(ctypes.c_void_p),
        None if ap_f is None else ap_f.ctypes.data_as(ctypes.c_void_p), tex, _stream())
    cuda_build.check(code, "tile_blend")
    return (fb, depth) if write_depth else fb


tile_blend.launches = 0
# the launches of each equation, counted among ``launches``
tile_blend.launches_by_mode = dict.fromkeys(BLEND_MODES, 0)
# the launches of each equation's appearance variants, counted among both
tile_blend.launches_appearance = dict.fromkeys(BLEND_MODES, 0)
# the launches of each equation's antialiased variants (quad and
# appearance), counted among ``launches`` and ``launches_by_mode``
tile_blend.launches_antialias = dict.fromkeys(BLEND_MODES, 0)

KERNELS = {
    "project_bin": Kernel(
        project_bin,
        project_bin_plain,
        "bevy_hanabi_tpu_torch/csrc/project_bin.cu",
        "bevy_hanabi_tpu/render/raster.py:241",
    ),
    "bin_keys": Kernel(
        bin_keys,
        bin_keys_plain,
        "bevy_hanabi_tpu_torch/csrc/project_bin.cu",
        "bevy_hanabi_tpu/render/raster.py:361",
    ),
    "tile_blend": Kernel(
        tile_blend,
        tile_blend_plain,
        "bevy_hanabi_tpu_torch/csrc/tile_blend.cu",
        "bevy_hanabi_tpu/render/raster.py:620",
    ),
}


# ---------------------------------------------------------------------------
# sort and window (plain torch)
# ---------------------------------------------------------------------------


def fast_mode(config: RasterConfig, alpha_mode: str, num_entries: int):
    """The variant the JAX package picks statically (raster.py:336-358):
    ``None`` for the ordered path, else the order-independent fast path
    ``"first"`` (key = tile | entry index), ``"depth"`` (key = tile |
    coarse near-first depth | entry index, when >= 4 slack bits fit) or
    ``"payload"`` (key = tile | exact near-first depth, particle index
    carried beside it)."""
    if not (config.order_independent_fast and alpha_mode in ("add", "multiply")):
        return None
    tile_bits = max(1, int(np.ceil(np.log2(config.num_tiles + 2))))
    idx_bits = max(1, int(np.ceil(np.log2(max(num_entries, 2)))))
    slack = 32 - tile_bits - idx_bits
    if config.overflow_policy == "first" and slack >= 0:
        return "first"
    if slack >= 4:
        return "depth"
    return "payload"


@functools.lru_cache(maxsize=64)
def _tile_bounds(nt: int, tile_shift: int, device: torch.device) -> torch.Tensor:
    """The biased int32 keys ``t << tile_shift`` of ``t = 0..nt``: all keys
    of tile ``t`` lie in ``[bound[t], bound[t + 1])`` (raster.py:386-392,
    417-422). Built once per layout and device."""
    b = (np.arange(nt + 1, dtype=np.int64) << tile_shift) - (1 << 31)
    return torch.from_numpy(b.astype(np.int32)).to(device)


def sort_tiles(tile: torch.Tensor, depth: torch.Tensor, nt: int, mode=None, depth_range=None):
    """Order entries by tile and, per tile, as ``mode`` wants (raster.py:361-423).

    ``mode`` is :func:`fast_mode`'s: ``None`` orders each tile far-first
    (the ordered path), ``"payload"`` near-first, and ``"first"`` /
    ``"depth"`` sort one packed key that ends in the entry index. The keys
    are the JAX package's 32-bit keys from :func:`bin_keys`, as int32, so
    the same entries survive an overflowing tile. ``depth_range`` is
    :func:`project_bin`'s; on the CPU it may be ``None``, and then
    :func:`depth_range_plain` of ``depth`` computes it. Returns
    ``(entry_sorted [E]`` (the sorted entries' indices: int64 from the
    stable sort, or int32 decoded from the key; entry ``e`` is particle
    ``e mod N`` of :func:`project_bin`'s slot-major entries), ``starts
    [nt], ends [nt])``."""
    n = tile.shape[0]
    tile_shift, q_bits, idx_bits, _ = _key_layout(n, nt, mode)
    if depth_range is None and q_bits:
        if tile.is_cuda:
            raise ValueError("sort_tiles: CUDA entries need project_bin's depth_range")
        depth_range = depth_range_plain(depth)
    key = bin_keys(tile, depth, depth_range, nt, mode)
    if idx_bits:
        key_sorted = torch.sort(key).values  # unique keys: the order is fixed
        pidx_sorted = key_sorted & ((1 << idx_bits) - 1)  # the entry index
    else:
        # Stable, unlike lax.sort: equal (tile | depth) keys may blend in
        # another order than the JAX package's, which the checksum
        # tolerance absorbs.
        key_sorted, pidx_sorted = torch.sort(key, stable=True)
    r = torch.searchsorted(key_sorted, _tile_bounds(nt, tile_shift, tile.device))
    return pidx_sorted, r[:-1], r[1:]


def untile(fb: torch.Tensor, config: RasterConfig) -> torch.Tensor:
    """[nt, T, T, C] or [nt, T, T] tiles -> [height, width, C] or [height, width] image."""
    T, ntx, nty = config.tile_size, config.tiles_x, config.tiles_y
    c = fb.shape[3:]
    img = fb.reshape((nty, ntx, T, T) + c).transpose(1, 2).reshape((nty * T, ntx * T) + c)
    return img[: config.height, : config.width]


def to_tiles(img, config: RasterConfig, pad: float) -> torch.Tensor:
    """[height, width, C] or [height, width] image -> contiguous [nt, T, T, C]
    or [nt, T, T] tiles, padded to whole tiles with ``pad`` (raster.py:437-470)."""
    T, ntx, nty = config.tile_size, config.tiles_x, config.tiles_y
    img = torch.as_tensor(img, dtype=torch.float32)
    c = img.shape[2:]
    widths = (0, 0) * len(c) + (0, ntx * T - config.width, 0, nty * T - config.height)
    img = torch.nn.functional.pad(img, widths, value=pad)
    return img.reshape((nty, T, ntx, T) + c).transpose(1, 2).reshape((ntx * nty, T, T) + c).contiguous()


def rasterize(
    draw: ParticleDrawData,
    camera: CameraParams,
    config: RasterConfig,
    alpha_mode: str = "blend",
    textures: Sequence[Any] = (),
    alpha_cutoff: Any = 0.5,
    scene_depth: Any = None,
    return_depth: bool = False,
    y_offset: Any = None,
    framebuffer: Any = None,
):
    """Render particles to a [height, width, 4] float32 image on the draw's device.

    Ported: every binning (``tile_slots`` 0, 1 and 2, any ``tile_span``
    and ``tile_size``) with the ``blend``, ``premultiply``, ``opaque``,
    ``mask`` and painter (``"scene"``, per-entry ``draw.mode_id``)
    equations on the ordered path, and ``add`` and ``multiply`` on the
    three order-independent fast variants of :func:`fast_mode` (or the
    ordered path with ``order_independent_fast=False``); the appearance of
    round, flipbook, textured and mesh draws (``textures``: the draw's
    textures by slot, [H, W, 4] RGBA each; a painter draw's own atlas), with
    ``config.antialias``'s fractional coverage. ``scene_depth`` ([height,
    width] view distances, +inf where empty) discards fragments behind it;
    ``return_depth`` (opaque, mask, scene) also returns the [height, width]
    depth of the nearest written fragment, seeded from ``scene_depth``;
    ``framebuffer`` ([height, width, 4]) seeds the target instead of
    ``config.background``. The mask cutoff is ``draw.alpha_cutoff`` per
    particle, else ``alpha_cutoff``. ``y_offset`` (pixels) renders a
    horizontal SLICE of a taller viewport: the raster grid covers viewport
    rows ``[y_offset, y_offset + height)`` (``camera.viewport`` stays the
    full one; ``scene_depth`` and ``framebuffer`` are then the slice's),
    as the sharded renderer's slice mode draws one slice a shard
    (raster.py:188-201).
    """
    if alpha_mode not in BLEND_MODES:
        raise ValueError(f"unknown alpha mode {alpha_mode!r}")
    painter = alpha_mode == "scene"
    if painter and draw.mode_id is None:
        raise ValueError(
            'alpha_mode="scene" needs per-entry blend modes: populate draw.mode_id '
            "(0=blend 1=premultiply 2=add 3=multiply 4=opaque 5=mask)"
        )
    if return_depth and alpha_mode not in ("opaque", "mask", "scene"):
        raise ValueError(
            "return_depth requires an opaque or mask alpha mode (transparent modes are "
            "read-only depth clients, like the reference's Transparent3d phase)"
        )
    # the painter pass always threads a depth plane: its opaque and mask
    # entries write depth mid-loop for the transparent entries after them
    depth_test = scene_depth is not None or return_depth or painter
    write_depth = return_depth or painter

    T, ntx, nty, nt = config.tile_size, config.tiles_x, config.tiles_y, config.num_tiles
    n = draw.position.shape[0]
    dev = draw.position.device
    extra = None
    if alpha_mode in ("mask", "scene"):
        cutoff = draw.alpha_cutoff
        if cutoff is None:
            cutoff = torch.full((n,), float(alpha_cutoff), dtype=torch.float32, device=dev)
        mode_col = (
            draw.mode_id.to(torch.float32)
            if painter
            else torch.zeros((n,), dtype=torch.float32, device=dev)
        )
        extra = torch.stack([cutoff.to(torch.float32), mode_col], dim=1)
    row = row_width(alpha_mode, depth_test)
    appearance, columns = draw_appearance(draw, row)
    texs = ()
    if appearance is not None and appearance.atlas_layers:
        texs = (texture_tensor(draw.atlas, dev),)
    if appearance is not None and appearance.layers:
        for slot, _ in appearance.layers:
            if slot >= len(textures):
                raise ValueError(
                    f"texture slot {slot} is referenced by a ParticleTextureModifier but only "
                    f"{len(textures)} texture(s) were provided — pass textures=[...] when "
                    "creating the renderer / adding the effect"
                )
        texs = [texture_tensor(t, dev) for t in textures]
    tile_ids, depth, rows, depth_range = project_bin(
        draw.position, draw.axis_x, draw.axis_y, draw.alive, draw.color.contiguous(),
        camera.view, camera.proj, camera.viewport, T, ntx, nty,
        raster_size=(config.width, config.height), extra=extra, row=row,
        tile_slots=config.tile_slots, tile_span=config.tile_span, appearance=columns,
        y_offset=0.0 if y_offset is None else float(y_offset),
    )
    mode = fast_mode(config, alpha_mode, tile_ids.shape[0])
    pidx_sorted, starts, ends = sort_tiles(tile_ids, depth, nt, mode, depth_range)
    M = config.max_entries_per_tile
    window, has = gather_window(rows, pidx_sorted, starts, ends, M, from_start=mode is not None)
    out = tile_blend(
        window, has, T, ntx, nty, config.background, alpha_mode,
        framebuffer=None if framebuffer is None else to_tiles(framebuffer, config, 0.0).to(dev),
        scene_depth=None if scene_depth is None else to_tiles(scene_depth, config, torch.inf).to(dev),
        depth_test=depth_test, write_depth=write_depth, appearance=appearance, textures=texs,
        antialias=config.antialias,
    )
    fb, dbuf = out if write_depth else (out, None)
    if return_depth:
        return untile(fb, config), untile(dbuf, config)
    return untile(fb, config)
