"""Tile-binned particle splat rasterizer (port of ``bevy_hanabi_tpu/render/raster.py``).

The same **bin → sort → bounded per-tile blend** pipeline as the JAX
package, for ``tile_slots=1`` and the ordered ``blend`` path:

1. :func:`project_bin` (CUDA kernel) projects every quad, tests it against
   the screen, bins it into the tile holding its centre and packs its blend
   row ``[cx, cy, h1x, h1y, h2x, h2y, r, g, b, a]``;
2. :func:`sort_tiles` packs ``(tile << depth_bits) | far-first depth`` keys
   and sorts them (plain torch: CUB's radix sort); ``searchsorted`` of the
   tile bounds gives each tile's run;
3. :func:`gather_rows` (CUDA kernel, the port of the TPU row gather) fetches
   the nearest ``M`` rows of every tile, back to front;
4. :func:`tile_blend` (CUDA kernel) blends each tile in one CTA, one thread
   per pixel.

Every kernel wrapper has a plain PyTorch version beside it, used only for
tensors on the CPU; for CUDA tensors the wrapper launches its kernel (or
raises) and adds one to its ``launches`` counter. Every other branch of the
JAX rasterizer raises ``NotImplementedError`` naming the branch.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import cuda_build
from ..ops.linalg import mat4_mul
from .camera import CameraParams
from .extract import ParticleDrawData

__all__ = [
    "RasterConfig",
    "rasterize",
    "gather_rows",
    "gather_rows_plain",
    "project_bin",
    "project_bin_plain",
    "tile_blend",
    "tile_blend_plain",
    "sort_tiles",
    "window_index",
    "untile",
    "KERNELS",
]

ROW = 10  # floats per blend row: cx, cy, h1x, h1y, h2x, h2y, r, g, b, a


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


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` row gather (plain version of :func:`gather_rows`)."""
    return table.index_select(0, idx)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[j] = table[idx[j]]`` for an f32 ``[N, F]`` table and int32 ``[M]``
    indices in ``[0, N)``. Port of the TPU kernel ``pallas_gather``."""
    if table.dim() != 2:
        raise ValueError(f"table must be [N, F], got shape {tuple(table.shape)}")
    _check(table, "table", torch.float32, table.shape, table.device)
    if idx.dim() != 1:
        raise ValueError(f"idx must be [M], got shape {tuple(idx.shape)}")
    _check(idx, "idx", torch.int32, idx.shape, table.device)
    if not table.is_cuda:
        return gather_rows_plain(table, idx)
    n, f = table.shape
    out = torch.empty((idx.shape[0], f), dtype=torch.float32, device=table.device)
    code = cuda_build.library().hanabi_gather_rows(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0], n, f, _stream()
    )
    cuda_build.check(code, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def _project_params(view, proj, viewport, raster_size, T):
    """(mvp, view) as f32 CPU tensors and the 25 f32 kernel parameters."""
    view_t = torch.as_tensor(np.asarray(view, np.float32))
    mvp = mat4_mul(torch.as_tensor(np.asarray(proj, np.float32)), view_t)
    w, h = raster_size
    params = np.concatenate(
        [
            mvp.numpy().reshape(16),
            view_t.numpy()[2],
            np.asarray([viewport[0], viewport[1], w, h, T], np.float32),
        ]
    ).astype(np.float32)
    return mvp, view_t, params


def project_bin_plain(position, axis_x, axis_y, alive, color, view, proj, viewport,
                      T, ntx, nty, raster_size=None):
    """Plain version of :func:`project_bin`: raster.py:241-292 + 516-529."""
    mvp, view_t, params = _project_params(view, proj, viewport, raster_size or viewport, T)
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
    valid = alive & (dist > 1e-4)
    rx = torch.abs(h1x) + torch.abs(h2x)
    ry = torch.abs(h1y) + torch.abs(h2y)
    valid &= (cx + rx > 0) & (cx - rx < width)
    valid &= (cy + ry > 0) & (cy - ry < height)
    valid &= (rx > 1e-6) & (ry > 1e-6)
    # clamp in float before the conversion (exact for every on-screen tile)
    tcx = torch.clamp(torch.floor(cx / float(T)), 0, ntx - 1).nan_to_num(0).to(torch.int32)
    tcy = torch.clamp(torch.floor(cy / float(T)), 0, nty - 1).nan_to_num(0).to(torch.int32)
    nt = ntx * nty
    tile = torch.where(valid, tcy * ntx + tcx, nt).to(torch.int32)
    depth = torch.where(valid, dist, -torch.inf)
    rows = torch.stack([cx, cy, h1x, h1y, h2x, h2y], dim=1)
    rows = torch.cat([rows, color], dim=1).contiguous()
    return tile, depth, rows


def project_bin(position, axis_x, axis_y, alive, color, view, proj, viewport,
                T, ntx, nty, raster_size=None):
    """Project, screen-test and centre-tile-bin N particle quads.

    ``position``/``axis_x``/``axis_y`` f32 [N, 3], ``alive`` bool [N],
    ``color`` f32 [N, 4]; ``view``/``proj`` host 4x4 matrices;
    ``viewport`` the camera's (width, height) and ``raster_size`` the
    raster's (defaults to the viewport). Returns ``tile`` int32 [N]
    (``ntx * nty`` where invalid), ``depth`` f32 [N] (view distance,
    ``-inf`` where invalid) and ``rows`` f32 [N, 10]."""
    dev = position.device
    n = position.shape[0]
    _check(position, "position", torch.float32, (n, 3), dev)
    _check(axis_x, "axis_x", torch.float32, (n, 3), dev)
    _check(axis_y, "axis_y", torch.float32, (n, 3), dev)
    _check(alive, "alive", torch.bool, (n,), dev)
    _check(color, "color", torch.float32, (n, 4), dev)
    if not position.is_cuda:
        return project_bin_plain(position, axis_x, axis_y, alive, color, view, proj,
                                 viewport, T, ntx, nty, raster_size)
    _, _, params = _project_params(view, proj, viewport, raster_size or viewport, T)
    tile = torch.empty((n,), dtype=torch.int32, device=dev)
    depth = torch.empty((n,), dtype=torch.float32, device=dev)
    rows = torch.empty((n, ROW), dtype=torch.float32, device=dev)
    code = cuda_build.library().hanabi_project_bin(
        position.data_ptr(), axis_x.data_ptr(), axis_y.data_ptr(), alive.data_ptr(), color.data_ptr(),
        tile.data_ptr(), depth.data_ptr(), rows.data_ptr(), n,
        params.ctypes.data_as(ctypes.c_void_p), ntx, nty, _stream(),
    )
    cuda_build.check(code, "project_bin")
    project_bin.launches += 1
    return tile, depth, rows


project_bin.launches = 0


def tile_blend_plain(window, has, T, ntx, nty, background):
    """Plain version of :func:`tile_blend`: raster.py:620-911, blend only."""
    nt, M, _ = window.shape
    dev = window.device
    ar = torch.arange(T, dtype=torch.int32, device=dev)
    tiles = torch.arange(nt, dtype=torch.int32, device=dev)
    py = ((tiles // ntx)[:, None, None] * T + ar[None, :, None]).to(torch.float32) + 0.5
    px = ((tiles % ntx)[:, None, None] * T + ar[None, None, :]).to(torch.float32) + 0.5
    fb = torch.tensor(background, dtype=torch.float32, device=dev).expand(nt, T, T, 4)
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
        inside &= has[:, m, None, None]
        coverage = inside.to(torch.float32)
        # Zero-coverage lanes contribute EXACTLY zero even when the row is
        # non-finite (raster.py:822-828).
        covered = coverage[..., None] > 0.0
        a = torch.where(covered, (col[:, None, None, 3] * coverage)[..., None], 0.0)
        rgb_s = torch.where(covered, col[:, None, None, :3], 0.0)
        rgb = rgb_s * a + fb[..., :3] * (1.0 - a)
        alpha = a + fb[..., 3:4] * (1.0 - a)
        fb = torch.cat([rgb, alpha], dim=-1)
    return fb.contiguous()


def tile_blend(window, has, T, ntx, nty, background):
    """Blend each tile's window back to front into ``fb`` [nt, T, T, 4].

    ``window`` f32 [nt, M, 10] blend rows (entry m = 0 is the farthest),
    ``has`` bool [nt, M] marks real entries; ``background`` RGBA."""
    dev = window.device
    nt = ntx * nty
    if window.dim() != 3:
        raise ValueError(f"window must be [nt, M, {ROW}], got shape {tuple(window.shape)}")
    M = window.shape[1]
    _check(window, "window", torch.float32, (nt, M, ROW), dev)
    _check(has, "has", torch.bool, (nt, M), dev)
    if len(background) != 4:
        raise ValueError("background must be RGBA")
    if not window.is_cuda:
        return tile_blend_plain(window, has, T, ntx, nty, background)
    if not 1 <= T * T <= 1024:
        raise ValueError(f"tile_blend runs one thread per pixel: T*T must be <= 1024, got T={T}")
    fb = torch.empty((nt, T, T, 4), dtype=torch.float32, device=dev)
    bg = np.asarray(background, np.float32)
    code = cuda_build.library().hanabi_tile_blend(
        window.data_ptr(), has.data_ptr(), fb.data_ptr(), nt, M, T, ntx,
        bg.ctypes.data_as(ctypes.c_void_p), _stream(),
    )
    cuda_build.check(code, "tile_blend")
    tile_blend.launches += 1
    return fb


tile_blend.launches = 0

class Kernel(NamedTuple):
    """A CUDA kernel of the raster path: its wrapper, plain version, source,
    and the TPU kernel (or XLA region of the JAX package) it replaces."""

    wrapper: Callable
    plain: Callable
    source: str
    replaces: str


KERNELS = {
    "gather_rows": Kernel(
        gather_rows,
        gather_rows_plain,
        "bevy_hanabi_tpu_torch/csrc/gather_rows.cu",
        "experiments/pallas_gather_bench.py:64",
    ),
    "project_bin": Kernel(
        project_bin,
        project_bin_plain,
        "bevy_hanabi_tpu_torch/csrc/project_bin.cu",
        "bevy_hanabi_tpu/render/raster.py:241",
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


def sort_tiles(tile: torch.Tensor, depth: torch.Tensor, nt: int):
    """Order entries by (tile ascending, depth far-first): raster.py:361-423.

    Depth quantizes to the bits left under the tile id; the packed key
    needs ``tile_bits + depth_bits`` = 32 bits and the sentinel tile ``nt``
    sets bit 31, so keys are int64. Returns ``(pidx_sorted int64 [N],
    starts [nt], ends [nt])``."""
    tile_bits = max(1, int(np.ceil(np.log2(nt + 2))))
    depth_bits = min(22, 32 - tile_bits)
    finite = depth > -torch.inf
    dmin = torch.where(finite, depth, torch.inf).min()
    dmax = torch.where(finite, depth, -torch.inf).max()
    span_d = torch.clamp(dmax - dmin, min=1e-9)
    scale = (1 << depth_bits) - 1
    dq = (torch.clamp((depth - dmin) / span_d, 0.0, 1.0) * float(scale)).to(torch.int64)
    key = (tile.to(torch.int64) << depth_bits) | (scale - dq)
    # Stable, unlike lax.sort: equal (tile | depth) keys may blend in another
    # order than the JAX package's, which the checksum tolerance absorbs.
    key_sorted, pidx_sorted = torch.sort(key, stable=True)
    bound = torch.arange(nt + 1, dtype=torch.int64, device=tile.device) << depth_bits
    r = torch.searchsorted(key_sorted, bound)
    return pidx_sorted, r[:-1], r[1:]


def window_index(pidx_sorted, starts, ends, M: int):
    """The nearest ``M`` entries of every tile, back to front (raster.py:488-506):
    ``(pidx int32 [nt, M], has bool [nt, M])``."""
    n = pidx_sorted.shape[0]
    base = torch.maximum(ends - M, starts)
    raw = base[:, None] + torch.arange(M, dtype=base.dtype, device=base.device)[None, :]
    has = raw < ends[:, None]
    idx = torch.clamp(raw, max=n - 1)
    return pidx_sorted[idx].to(torch.int32), has


def untile(fb: torch.Tensor, config: RasterConfig) -> torch.Tensor:
    """[nt, T, T, 4] tiles -> [height, width, 4] image."""
    T, ntx, nty = config.tile_size, config.tiles_x, config.tiles_y
    img = fb.reshape(nty, ntx, T, T, 4).permute(0, 2, 1, 3, 4).reshape(nty * T, ntx * T, 4)
    return img[: config.height, : config.width]


def _unported(branch: str):
    return NotImplementedError(f"rasterize: {branch} is not ported")


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
) -> torch.Tensor:
    """Render particles to a [height, width, 4] float32 image on the draw's device.

    Ported: ``tile_slots=1`` with ``alpha_mode="blend"`` (the ordered path).
    Every other branch of the JAX rasterizer raises ``NotImplementedError``.
    """
    if config.tile_slots != 1:
        raise _unported(f"tile_slots={config.tile_slots} binning")
    if alpha_mode != "blend":
        raise _unported(f"alpha_mode={alpha_mode!r}")
    if config.antialias:
        raise _unported("antialias")
    if textures:
        raise _unported("texture sampling")
    if scene_depth is not None or return_depth:
        raise _unported("the depth test (scene_depth / return_depth)")
    if y_offset is not None:
        raise _unported("slice rendering (y_offset)")
    if framebuffer is not None:
        raise _unported("a seeded framebuffer")

    T, ntx, nty, nt = config.tile_size, config.tiles_x, config.tiles_y, config.num_tiles
    tile, depth, rows = project_bin(
        draw.position, draw.axis_x, draw.axis_y, draw.alive, draw.color.contiguous(),
        camera.view, camera.proj, camera.viewport, T, ntx, nty,
        raster_size=(config.width, config.height),
    )
    pidx_sorted, starts, ends = sort_tiles(tile, depth, nt)
    M = config.max_entries_per_tile
    pidx, has = window_index(pidx_sorted, starts, ends, M)
    window = gather_rows(rows, pidx.reshape(-1)).reshape(nt, M, ROW)
    fb = tile_blend(window, has, T, ntx, nty, config.background)
    return untile(fb, config)
