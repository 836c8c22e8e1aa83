"""The port's rasterizer and its three kernels against the JAX package.

On the CPU every kernel wrapper takes its plain PyTorch version; these
tests hold those plain versions against the JAX package (the Pallas row
gather in interpret mode, the rasterizer's internals and its image). The
CUDA kernels against their plain versions are in ``test_torch_cuda.py``.
"""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bevy_hanabi_tpu.render.camera import CameraParams as CamJ
from bevy_hanabi_tpu.render.extract import ParticleDrawData as DrawJ
from bevy_hanabi_tpu.render.raster import RasterConfig as CfgJ
from bevy_hanabi_tpu.render.raster import _project
from bevy_hanabi_tpu.render.raster import rasterize as rasterize_j
from bevy_hanabi_tpu_torch.ops import gather
from bevy_hanabi_tpu_torch.render import raster
from bevy_hanabi_tpu_torch.render.camera import CameraParams as CamT
from bevy_hanabi_tpu_torch.render.camera import look_at, perspective
from bevy_hanabi_tpu_torch.render.extract import ParticleDrawData as DrawT

EXPERIMENTS = Path(__file__).resolve().parent.parent / "experiments"
N = 8192
SIZE = 128


def _load_experiment(name):
    spec = importlib.util.spec_from_file_location(f"_exp_{name}", EXPERIMENTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- (c) gather_rows against the TPU kernel ----------------------------------


@pytest.mark.parametrize(
    "experiment,F",
    [("pallas_gather_bench", 10), ("pallas_gather_bench", 9), ("pallas_gather2", 128)],
)
def test_gather_rows_matches_pallas_gather(monkeypatch, experiment, F):
    # The TPU kernel runs in Pallas interpret mode; the experiment is not edited.
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    mod = _load_experiment(experiment)
    r = np.random.default_rng(F)
    table = r.standard_normal((4096, F)).astype(np.float32)
    idx = r.integers(0, 4096, 1024).astype(np.int32)
    want = np.asarray(mod.pallas_gather(jnp.asarray(table), jnp.asarray(idx), block=256, depth=4))
    got = gather.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)  # bit for bit


# ---- (d) project_bin / tile_blend against the JAX rasterizer -----------------


def _scene(seed=0, n=N, size_px=SIZE):
    """A hand-built n-entry draw: camera-facing quads of random size,
    some dead, some behind the camera or off screen, some with NaN colour."""
    r = np.random.default_rng(seed)
    view = look_at((0.5, 1.0, 6.0), (0.0, 0.0, 0.0))
    proj = perspective(0.9, 1.0, 0.1, 100.0)
    rot = CamT(view, proj, (size_px, size_px)).rotation.numpy()
    pos = r.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    pos[:64, 2] = 8.0  # behind the camera
    pos[64:128, 0] = 40.0  # off screen
    size = r.uniform(0.02, 0.4, (n, 2)).astype(np.float32)
    draw = {
        "position": pos,
        "axis_x": (rot[:, 0][None, :] * size[:, :1]).astype(np.float32),
        "axis_y": (rot[:, 1][None, :] * size[:, 1:]).astype(np.float32),
        "color": r.uniform(0.0, 1.0, (n, 4)).astype(np.float32),
        "alive": r.random(n) < 0.9,
    }
    draw["color"][128:136] = np.nan
    draw["alive"][128:136] = False  # NaN rows that must never reach a pixel
    return view, proj, draw


def _jax_tiles(view, proj, d, cfg):
    """Tile ids of the JAX rasterizer's tile_slots=1 binning (raster.py:241-292)."""
    cam = CamJ(view, proj, (SIZE, SIZE))
    T = cfg.tile_size
    p, ax, ay = (jnp.asarray(d[k]) for k in ("position", "axis_x", "axis_y"))
    center, w, _ = _project(cam, p)
    h1 = _project(cam, p + 0.5 * ax)[0] - center
    h2 = _project(cam, p + 0.5 * ay)[0] - center
    valid = jnp.logical_and(jnp.asarray(d["alive"]), w > 1e-4)
    rx = jnp.abs(h1[:, 0]) + jnp.abs(h2[:, 0])
    ry = jnp.abs(h1[:, 1]) + jnp.abs(h2[:, 1])
    valid &= (center[:, 0] + rx > 0) & (center[:, 0] - rx < cfg.width)
    valid &= (center[:, 1] + ry > 0) & (center[:, 1] - ry < cfg.height)
    valid &= (rx > 1e-6) & (ry > 1e-6)
    tcx = jnp.clip(jnp.floor(center[:, 0] / T).astype(jnp.int32), 0, cfg.tiles_x - 1)
    tcy = jnp.clip(jnp.floor(center[:, 1] / T).astype(jnp.int32), 0, cfg.tiles_y - 1)
    tile = jnp.where(valid, tcy * cfg.tiles_x + tcx, cfg.num_tiles)
    rows = jnp.concatenate([center, h1, h2, jnp.asarray(d["color"])], axis=1)
    return np.asarray(tile), np.asarray(jnp.where(valid, w, -jnp.inf)), np.asarray(rows), np.asarray(w)


def _torch_draw(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}


def test_project_bin_matches_jax_binning():
    view, proj, d = _scene()
    cfg = raster.RasterConfig(SIZE, SIZE, tile_slots=1)
    t = _torch_draw(d)
    tile, depth, rows, rng = raster.project_bin(
        t["position"], t["axis_x"], t["axis_y"], t["alive"], t["color"],
        view, proj, (SIZE, SIZE), cfg.tile_size, cfg.tiles_x, cfg.tiles_y,
    )
    tile_j, depth_j, rows_j, dist_j = _jax_tiles(view, proj, d, cfg)
    assert tile.dtype == torch.int32 and rows.shape == (N, raster.ROW)
    np.testing.assert_array_equal(tile.numpy(), tile_j)  # integer bins: exact
    assert 0 < int((tile < cfg.num_tiles).sum()) < N  # some binned, some culled
    # f32 projections in the same op order; 1e-4 px covers ULPs of XLA's
    # fused CPU loops
    np.testing.assert_allclose(depth.numpy(), depth_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rows[:, :10].numpy(), rows_j, rtol=1e-6, atol=1e-4)
    # the depth column is the unmasked view distance (raster.py:578-580);
    # without ``extra`` the cutoff and mode columns are zero
    np.testing.assert_allclose(rows[:, raster.COL_DEPTH].numpy(), dist_j, rtol=1e-6, atol=1e-6)
    assert not rows[:, raster.COL_CUTOFF:].any()
    # the range of the binned depths, which the sort keys quantise against
    binned = depth[tile < cfg.num_tiles]
    assert torch.equal(rng, torch.stack([binned.min(), binned.max()]))
    # the rows of a pass that reads no column past alpha stop there
    narrow = raster.project_bin(
        t["position"], t["axis_x"], t["axis_y"], t["alive"], t["color"],
        view, proj, (SIZE, SIZE), cfg.tile_size, cfg.tiles_x, cfg.tiles_y, row=raster.ROW_QUAD,
    )
    assert torch.equal(narrow[0], tile) and torch.equal(narrow[1], depth) and torch.equal(narrow[3], rng)
    torch.testing.assert_close(narrow[2], rows[:, : raster.ROW_QUAD], rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize(
    "mode,depth_test,width",
    [("blend", False, 10), ("add", False, 10), ("opaque", False, 10), ("blend", True, 13),
     ("add", True, 13), ("opaque", True, 13), ("mask", False, 13), ("scene", True, 13)],
)
def test_row_width_follows_the_columns_the_variant_reads(mode, depth_test, width):
    assert raster.row_width(mode, depth_test) == width
    nt, M = 4, 3
    has = torch.zeros((nt, M), dtype=torch.bool)
    write = mode == "scene"
    out = raster.tile_blend(torch.zeros((nt, M, width)), has, 16, 2, 2, (0, 0, 0, 0), mode,
                            depth_test=depth_test, write_depth=write)
    assert (out[0] if write else out).shape == (nt, 16, 16, 4)
    other = raster.ROW + raster.ROW_QUAD - width
    with pytest.raises(ValueError, match="shape"):
        raster.tile_blend(torch.zeros((nt, M, other)), has, 16, 2, 2, (0, 0, 0, 0), mode,
                          depth_test=depth_test, write_depth=write)


def _images(seed, background=(0.0, 0.0, 0.0, 0.0), M=64, alpha_mode="blend", n=N, size_px=SIZE,
            **config):
    view, proj, d = _scene(seed, n, size_px)
    kw = dict(tile_slots=1, background=background, max_entries_per_tile=M)
    kw.update(config)
    cfg_t = raster.RasterConfig(size_px, size_px, **kw)
    cfg_j = CfgJ(size_px, size_px, **kw)
    t = _torch_draw(d)
    img_t = raster.rasterize(
        DrawT(t["position"], t["axis_x"], t["axis_y"], t["color"], t["alive"]),
        CamT(view, proj, (size_px, size_px)), cfg_t, alpha_mode=alpha_mode,
    )
    draw_j = DrawJ(
        position=jnp.asarray(d["position"]), axis_x=jnp.asarray(d["axis_x"]),
        axis_y=jnp.asarray(d["axis_y"]), color=jnp.asarray(d["color"]),
        alive=jnp.asarray(d["alive"]), roundness=None,
        sprite_index=jnp.zeros((n,), jnp.int32), sprite_grid_size=(1, 1),
        texture_layers=(), needs_uv=False,
    )
    img_j = np.asarray(
        rasterize_j(draw_j, CamJ(view, proj, (size_px, size_px)), cfg_j, alpha_mode=alpha_mode)
    )
    return img_t.numpy(), img_j


@pytest.mark.parametrize(
    "seed,background,M",
    [(0, (0.0, 0.0, 0.0, 0.0), 64), (1, (0.1, 0.2, 0.3, 1.0), 64), (2, (0.0, 0.0, 0.0, 0.0), 8)],
)
def test_rasterize_matches_jax_image(seed, background, M):
    img_t, img_j = _images(seed, background, M)
    assert img_t.shape == (SIZE, SIZE, 4) and np.isfinite(img_t).all()
    # Keys are integers and equal (tile|depth) ties are rare at 21 depth
    # bits, so the images agree to f32 blend rounding; 0.5% on the checksum
    # is the repo's device-gate tolerance (bench.py:155-161).
    np.testing.assert_allclose(img_t, img_j, atol=1e-5)
    assert abs(img_t.sum() - img_j.sum()) <= 0.005 * abs(img_j.sum())


def test_sort_and_window_keep_the_nearest_m_back_to_front():
    tile = torch.tensor([0, 1, 0, 0, 2, 0, 1], dtype=torch.int32)
    depth = torch.tensor([5.0, 1.0, 3.0, 9.0, -torch.inf, 1.0, 2.0])
    tile[4] = 3  # sentinel: nt = 3
    pidx_sorted, starts, ends = raster.sort_tiles(tile, depth, 3)
    pidx, has = raster.window_index(pidx_sorted, starts, ends, 3)
    # tile 0 holds depths 5, 3, 9, 1: the nearest three, far first
    assert pidx[0].tolist() == [0, 2, 5] and has[0].tolist() == [True] * 3
    assert pidx[1].tolist()[:2] == [6, 1] and has[1].tolist() == [True, True, False]
    assert has[2].tolist() == [False] * 3


# ---- ADD: the three fast variants and the ordered path ----------------------

ADD_CASES = {
    # variant: (n, size_px, config) — the variant follows from the entry count
    "first": (N, SIZE, dict(overflow_policy="first")),
    "depth": (N, SIZE, {}),
    # 150k entries at 512^2: 11 tile bits + 18 index bits leave 3 slack bits
    "payload": (150_000, 512, {}),
    "ordered": (N, SIZE, dict(order_independent_fast=False)),
}


@pytest.mark.parametrize("variant", sorted(ADD_CASES))
def test_rasterize_add_matches_jax_image(variant):
    n, size_px, config = ADD_CASES[variant]
    cfg = raster.RasterConfig(size_px, size_px, tile_slots=1, **config)
    assert raster.fast_mode(cfg, "add", n) == (None if variant == "ordered" else variant)
    img_t, img_j = _images(4, alpha_mode="add", n=n, size_px=size_px, **config)
    assert img_t.shape == (size_px, size_px, 4) and np.isfinite(img_t).all()
    # Every variant keeps the JAX package's key layout, so overflowing tiles
    # keep the same entries and blend them in the same order: the images
    # differ by f32 rounding only: max abs pixel error measured <= 2.9e-6
    # (the 512^2 payload case, sums of up to 64 splats), bound 1e-5; the
    # checksum is the device gate's 0.5% (bench.py:155-161).
    np.testing.assert_allclose(img_t, img_j, atol=1e-5)
    assert abs(img_t.sum() - img_j.sum()) <= 0.005 * abs(img_j.sum())


def test_fast_variants_keep_the_nearest_entries_of_an_overflowing_tile():
    # one tile, five entries, M = 2: "depth"/"payload" keep the two nearest
    # (window from the start, near first), the ordered path the two nearest
    # far-first, and "first" the first two in entry order
    tile = torch.zeros(5, dtype=torch.int32)
    depth = torch.tensor([5.0, 1.0, 3.0, 9.0, 2.0])
    picks = {}
    for mode in (None, "first", "depth", "payload"):
        pidx_sorted, starts, ends = raster.sort_tiles(tile, depth, 1, mode)
        pidx, has = raster.window_index(pidx_sorted, starts, ends, 2, from_start=mode is not None)
        assert has.tolist() == [[True, True]]
        picks[mode] = pidx[0].tolist()
    assert picks == {None: [4, 1], "first": [0, 1], "depth": [1, 4], "payload": [1, 4]}


@pytest.mark.parametrize("mode", ["add", "multiply", "blend", "premultiply", "opaque", "mask"])
def test_composite_by_mode_matches_jax(mode):
    from bevy_hanabi_tpu.render.renderer import composite_by_mode as comp_j
    from bevy_hanabi_tpu_torch.render.renderer import composite_by_mode as comp_t

    r = np.random.default_rng(5)
    img = r.uniform(0.0, 1.5, (32, 48, 4)).astype(np.float32)
    fb = r.uniform(0.0, 1.0, (32, 48, 4)).astype(np.float32)
    got = comp_t(torch.from_numpy(img), torch.from_numpy(fb), mode).numpy()
    np.testing.assert_array_equal(got, np.asarray(comp_j(jnp.asarray(img), jnp.asarray(fb), mode)))


# ---- wrapper contract --------------------------------------------------------


def test_wrappers_reject_what_the_kernels_do_not_take():
    table = torch.zeros((8, 10))
    with pytest.raises(TypeError):
        gather.gather_rows(table, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(TypeError):
        gather.gather_rows(table.double(), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_rows(torch.zeros((10, 8)).t(), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        raster.tile_blend(torch.zeros((3, 4, 10)), torch.zeros((4, 4), dtype=torch.bool), 16, 2, 2, (0, 0, 0, 0))
    p = torch.zeros((5, 3))
    with pytest.raises(ValueError, match="shape"):
        raster.project_bin(p, p, p, torch.ones(5, dtype=torch.bool), torch.zeros((5, 3)),
                           np.eye(4), np.eye(4), (16, 16), 16, 1, 1)
    alive, color = torch.ones(5, dtype=torch.bool), torch.zeros((5, 4))
    with pytest.raises(ValueError, match="10 or 13"):
        raster.project_bin(p, p, p, alive, color, np.eye(4), np.eye(4), (16, 16), 16, 1, 1, row=12)
    with pytest.raises(ValueError, match="13-float rows"):
        raster.project_bin(p, p, p, alive, color, np.eye(4), np.eye(4), (16, 16), 16, 1, 1,
                           extra=torch.zeros((5, 2)), row=raster.ROW_QUAD)


@pytest.mark.parametrize(
    "kwargs,config",
    [
        ({}, dict(tile_slots=1, antialias=True)),
        ({"y_offset": 4.0}, dict(tile_slots=1)),
    ],
)
def test_unported_raster_branches_raise(kwargs, config):
    """The two branches this test once held to ``NotImplementedError`` now
    render the same draw as the JAX package's ``rasterize`` (within 1e-5,
    as the other images): antialiasing, and slice rendering (``y_offset``,
    the sharded renderer's slice mode: a half-height raster starting at
    viewport row ``y_offset``)."""
    if "y_offset" not in kwargs:
        img_t, img_j = _images(0, **config)
        np.testing.assert_allclose(img_t, img_j, atol=1e-5)
        assert not np.array_equal(img_t, _images(0, tile_slots=1)[0])  # the fringe is drawn
        return
    view, proj, d = _scene()
    t = _torch_draw(d)
    draw = DrawT(t["position"], t["axis_x"], t["axis_y"], t["color"], t["alive"])
    img_t = raster.rasterize(draw, CamT(view, proj, (SIZE, SIZE)),
                             raster.RasterConfig(SIZE, SIZE // 2, **config), **kwargs).numpy()
    draw_j = DrawJ(
        position=jnp.asarray(d["position"]), axis_x=jnp.asarray(d["axis_x"]),
        axis_y=jnp.asarray(d["axis_y"]), color=jnp.asarray(d["color"]),
        alive=jnp.asarray(d["alive"]), roundness=None,
        sprite_index=jnp.zeros((N,), jnp.int32), sprite_grid_size=(1, 1),
        texture_layers=(), needs_uv=False,
    )
    img_j = np.asarray(rasterize_j(draw_j, CamJ(view, proj, (SIZE, SIZE)),
                                   CfgJ(SIZE, SIZE // 2, **config), **kwargs))
    assert img_t.shape == (SIZE // 2, SIZE, 4) and np.abs(img_j).max() > 0.05
    np.testing.assert_allclose(img_t, img_j, atol=1e-5)


# ---- (e) tile_blend's triangle bounds against JAX's triangle test -----------
#
# csrc/tile_blend.cu culls a triangle entry for a warp's block by five
# half-planes in float64 (raster.warp_entries_plain states the bound on whole
# tensors), decides a lane's u >= -1/2, v >= -1/2 without dividing and
# u + v <= 0 by the sign of num_u + num_v beyond a margin, and wraps texture
# indices without fmodf where u0 lies in [-tw, 2 tw). Each is held here
# against JAX's own float test (bevy_hanabi_tpu/render/raster.py:635-642 and
# _bilinear_wrap's jnp.mod), run eagerly through jax.numpy on the CPU.

TRI_T = (16, 12)  # 8x4 warp blocks, and the row-major lanes of a T that 8 does not divide
TRI_NT = 4  # 2x2 tiles


def _tri_row(a, b, c):
    """A triangle entry's quad columns as mesh.py builds them: centre (B + C)
    / 2, h1 = B - A, h2 = C - A (f32), then an opaque white colour and the
    tri flag."""
    a, b, c = (np.asarray(p, np.float32) for p in (a, b, c))
    centre = (b + c) * np.float32(0.5)
    return np.asarray([*centre, *(b - a), *(c - a), 1.0, 1.0, 1.0, 1.0, 1.0], np.float32)


def _jax_tri_inside(row, T):
    """raster.py:620-642's triangle coverage of one entry over the 2x2-tile
    grid, jnp eagerly (op by op, as the reference rounds): bool [nt, T, T]."""
    ar = jnp.arange(T, dtype=jnp.int32)
    tiles = jnp.arange(TRI_NT, dtype=jnp.int32)
    py = ((tiles // 2)[:, None, None] * T + ar[None, :, None]).astype(jnp.float32) + 0.5
    px = ((tiles % 2)[:, None, None] * T + ar[None, None, :]).astype(jnp.float32) + 0.5
    cx, cy, a1x, a1y, a2x, a2y = (jnp.float32(v) for v in row[:6])
    dx, dy = px - cx, py - cy
    det_f = a1x * a2y - a1y * a2x
    det_f = jnp.where(jnp.abs(det_f) < 1e-9, 1e-9, det_f)
    u = (a2y * dx - a2x * dy) / det_f
    v = (-a1y * dx + a1x * dy) / det_f
    return np.asarray((u >= -0.5) & (v >= -0.5) & (u + v <= 0.0))


def _tri_covers(row, T):
    """csrc/tile_blend.cu's ``covers`` for a triangle entry in numpy f32: the
    half-planes decided without dividing where the margins prove them, the
    reference's divisions and test elsewhere. bool [nt, T, T]."""
    r = np.asarray(row, np.float32)
    ar = np.arange(T)
    tiles = np.arange(TRI_NT)
    py = ((tiles // 2)[:, None, None] * T + ar[None, :, None]).astype(np.float32) + np.float32(0.5)
    px = ((tiles % 2)[:, None, None] * T + ar[None, None, :]).astype(np.float32) + np.float32(0.5)
    with np.errstate(all="ignore"):
        det = r[2] * r[5] - r[3] * r[4]
        det = np.float32(1e-9) if np.abs(det) < np.float32(1e-9) else det
        dx, dy = px - r[0], py - r[1]
        nu = r[5] * dx - r[4] * dy
        nv = -r[3] * dx + r[2] * dy
        u, v = nu / det, nv / det
        test = (u >= -0.5) & (v >= -0.5) & (u + v <= 0.0)
        if not np.isfinite(det):
            return test
        ad = np.abs(det)
        xu, xv = (-nu, -nv) if det < 0 else (nu, nv)
        h = np.float32(-0.5) * ad
        out = ~((xu >= h) & (xv >= h))
        margin = np.float32(2.0**-20) * (np.abs(xu) + np.abs(xv)) + np.float32(2.0**-60) * ad
        out |= xu + xv > margin
    return np.where(out, False, test)


def _warp_of_pixel(T):
    """The warp of each pixel of a tile, [T, T], as tile_blend lays them out."""
    pi, pj = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
    if T % 8 == 0:
        return (pi // 4) * (T // 8) + pj // 8
    return (pi * T + pj) // 32


def _tri_blocks(row, T, triangle_bound=True):
    """warp_entries_plain of one triangle entry in every tile: bool [nt, W]."""
    window = torch.from_numpy(np.tile(row, (TRI_NT, 1, 1)))
    has = torch.ones((TRI_NT, 1), dtype=torch.bool)
    return raster.warp_entries_plain(window, has, T, 2, tri_col=10,
                                     triangle_bound=triangle_bound)[..., 0].numpy()


def _check_triangle(row, T):
    """No culled block holds a pixel JAX covers, and the kernel's per-lane
    test is JAX's coverage; returns the blocks kept by the triangle and the
    quad bound."""
    want = _jax_tri_inside(row, T)
    np.testing.assert_array_equal(_tri_covers(row, T), want, err_msg=f"lane test, {row.tolist()}")
    kept, kept_quad = _tri_blocks(row, T), _tri_blocks(row, T, triangle_bound=False)
    warp = _warp_of_pixel(T)
    for tile in range(TRI_NT):
        for w in range(kept.shape[1]):
            if not kept[tile, w]:
                assert not want[tile][warp == w].any(), f"covered block culled: {row.tolist()}"
    assert not (kept & ~kept_quad).any(), "the triangle bound kept a block the quad bound culls"
    return int(kept.sum()), int(kept_quad.sum())


def _triangles(st):
    """Adversarial triangle rows over the 2x2-tile grid, from ``hypothesis``'s
    ``strategies`` module ``st``: random, thin, collinear, degenerate around
    the 1e-9 det clamp, vertices on pixel centres (edges through them: u =
    -1/2, v = -1/2, u + v = 0 in float), huge and non-finite."""
    coord = st.floats(-8.0, 40.0, width=32)
    special = st.sampled_from([np.nan, np.inf, -np.inf, 3e38, -3e38, 1e-45])

    @st.composite
    def triangles(draw):
        kind = draw(st.sampled_from(["random", "thin", "collinear", "degenerate", "lattice",
                                     "huge", "nonfinite"]))
        a = [draw(coord), draw(coord)]
        b = [draw(coord), draw(coord)]
        c = [draw(coord), draw(coord)]
        if kind == "thin":
            eps = st.floats(-0.015625, 0.015625, width=32)
            c = [b[0] + draw(eps), b[1] + draw(eps)]
        elif kind == "collinear":
            k = draw(st.floats(-3.0, 3.0, width=32))
            c = [a[0] + k * (b[0] - a[0]), a[1] + k * (b[1] - a[1])]
        elif kind == "degenerate":
            # |det| a few ulps either side of the clamp
            s = draw(st.sampled_from([1e-5, 3.1622776e-5, 3.2e-5, 1e-4]))
            a, b = [a[0], a[1]], [a[0] + s, a[1]]
            k = draw(st.sampled_from([0.999, 1.0, 1.001]))
            c = [a[0] + draw(st.sampled_from([0.0, 0.3])), a[1] + s * k]
        elif kind == "lattice":
            ints = st.integers(-2, 34)
            a = [draw(ints) + 0.5, draw(ints) + 0.5]
            b = [a[0] + draw(st.integers(-12, 12)), a[1] + draw(st.integers(-12, 12))]
            c = [a[0] + draw(st.integers(-12, 12)), a[1] + draw(st.integers(-12, 12))]
        elif kind == "huge":
            m = draw(st.sampled_from([1e6, 1e15, 1e30]))
            b = [b[0] * m, b[1]]
        row = _tri_row(a, b, c)
        if kind == "nonfinite":
            row[draw(st.integers(0, 5))] = draw(special)
        return row

    return triangles()


@pytest.mark.parametrize("T", TRI_T)
def test_triangle_bounds_cull_no_pixel_that_jax_covers(T):
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import strategies as st

    @hypothesis.settings(max_examples=250, deadline=None, derandomize=True,
                         suppress_health_check=[hypothesis.HealthCheck.too_slow])
    @hypothesis.given(_triangles(st))
    def check(row):
        _check_triangle(row, T)

    check()


@pytest.mark.parametrize("T", TRI_T)
def test_triangle_bound_culls_more_than_the_quad_bound(T):
    """On ordinary triangles (a mesh's, 2-20 px a side) the triangle bound
    keeps strictly fewer (warp, entry) iterations than the quad bound, and
    no more on any triangle."""
    r = np.random.default_rng(T)
    tri, quad = 0, 0
    for _ in range(60):
        a = r.uniform(0.0, 2.0 * T, 2)
        b = a + r.uniform(-20.0, 20.0, 2)
        c = a + r.uniform(-20.0, 20.0, 2)
        k, kq = _check_triangle(_tri_row(a, b, c), T)
        tri, quad = tri + k, quad + kq
    assert tri < 0.8 * quad, (tri, quad)


def _wrap_np(x, n):
    """csrc/tile_blend.cu's ``wrap`` in numpy f32: jnp.mod(x, n) and
    jnp.mod(x + 1, n) of an integer-valued float as indices, by compares in
    [-n, 2 n) and by the floored remainder elsewhere (NaN to index 0)."""
    x, nf = np.float32(x), np.float32(n)
    if x >= -nf and x < np.float32(2.0) * nf and nf <= np.float32(2.0**22):
        i0 = int(x + nf if x < 0 else (x - nf if x >= nf else x))
        return i0, 0 if i0 + 1 == n else i0 + 1
    with np.errstate(invalid="ignore"):
        m0 = np.fmod(x, nf)
        m1 = np.fmod(np.float32(x + np.float32(1.0)), nf)
    m0 = m0 + nf if m0 != 0 and (m0 < 0) != (nf < 0) else m0
    m1 = m1 + nf if m1 != 0 and (m1 < 0) != (nf < 0) else m1
    return tuple(0 if np.isnan(m) else int(m) for m in (m0, m1))


@pytest.mark.parametrize("n", [1, 8, 17, 24, 32])
def test_wrap_without_fmod_is_jnp_mod(n):
    """The texture wrap's fast path and its fallback give jnp.mod's index of
    u0 and u0 + 1 (JAX's _bilinear_wrap, astype(int32) after the mod) for
    integer-valued u0 in and far outside [-n, 2 n), at +-2^24 and beyond,
    and NaN (index 0)."""
    xs = [float(k) for k in range(-3 * n - 2, 3 * n + 3)]
    xs += [2.0**24, -2.0**24, 2.0**24 + 2.0, -(2.0**24) - 2.0, 2.0**30, -3e9, float("nan")]
    x = jnp.asarray(np.asarray(xs, np.float32))
    want0 = np.asarray(jnp.mod(x, jnp.float32(n)).astype(jnp.int32))
    want1 = np.asarray(jnp.mod(x + 1.0, jnp.float32(n)).astype(jnp.int32))
    for k, v in enumerate(xs):
        assert _wrap_np(v, n) == (int(want0[k]), int(want1[k])), (v, n)
