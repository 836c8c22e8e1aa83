"""The port's antialiased rasterizer (``RasterConfig.antialias``) against the
JAX package's ``rasterize(antialias=True)``, on the CPU, where
``tile_blend`` takes its plain version: quads and triangles in every
equation (the painter's SCENE included), the JAX package's own antialias
cases (tests/test_render.py:310-346, tests/test_mesh.py:132), a random
sweep of draws, binnings and budgets (as tests/test_fuzz.py:318 draws
them), and a plain mirror of ``csrc/tile_blend.cu``'s widened warp-block
bounds, which must never cull a pixel of coverage > 0 (``hypothesis``
quads and triangles).

Inputs are numpy-seeded draws handed to both packages (triangles expanded by
each package's own ``expand_mesh_draw``). Tolerance: images within 1e-5
absolute (XLA's CPU backend contracts multiplies and adds of the coverage
and the blend into fused ops where PyTorch rounds twice, test_torch_mesh.py
measures ~1e-6; a pixel whose coverage is a few ulps above 0 in one and 0 in
the other differs by that coverage times its colour).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_hanabi_tpu.render import camera as camera_j
from bevy_hanabi_tpu.render.extract import ParticleDrawData as DrawJ
from bevy_hanabi_tpu.render.mesh import ParticleMesh as MeshJ
from bevy_hanabi_tpu.render.mesh import expand_mesh_draw as expand_j
from bevy_hanabi_tpu.render.raster import RasterConfig as CfgJ
from bevy_hanabi_tpu.render.raster import rasterize as rasterize_j
from bevy_hanabi_tpu_torch.render import camera as camera_t
from bevy_hanabi_tpu_torch.render import raster
from bevy_hanabi_tpu_torch.render.extract import ParticleDrawData as DrawT
from bevy_hanabi_tpu_torch.render.mesh import ParticleMesh as MeshT
from bevy_hanabi_tpu_torch.render.mesh import expand_mesh_draw as expand_t

ATOL = 1e-5  # module docstring
SIZE = 64
MODES = ("blend", "premultiply", "add", "multiply", "opaque", "mask", "scene")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain raster path calls small vectorised ops thousands of times,
    each of which wakes OpenMP: run PyTorch single-threaded here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _camera(mod, ortho=False, size=SIZE):
    if ortho:
        return mod.CameraParams(view=mod.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0)),
                                proj=mod.orthographic(-1, 1, -1, 1, 0.1, 10.0),
                                viewport=(size, size))
    return mod.CameraParams(mod.look_at((0.5, 1.0, 6.0), (0.0, 0.0, 0.0)),
                            mod.perspective(0.9, 1.0, 0.1, 100.0), (size, size))


def _mesh(M):
    """Two quads and three triangles (a mesh's quad and triangle entries)."""
    r = np.random.default_rng(4)
    return M([[0.0, 0.0, 0.2], [0.1, 0.0, 0.0]], [[1, 0, 0], [0, 0, 1]], [[0, 1, 0], [0, 1, 0]],
             vertices=r.normal(size=(5, 3)) * 0.4, indices=[[0, 1, 2], [2, 3, 4], [4, 0, 1]])


def _draws(seed, n, shape, mode, size_range=(0.02, 0.6)):
    """The same numpy-seeded draw in both packages: camera-facing quads of
    random size (some sub-pixel), or a mesh's quads and triangles; per-entry
    mode ids and cutoffs for the painter's SCENE."""
    r = np.random.default_rng(seed)
    rot = _camera(camera_t).rotation.numpy()
    s = r.uniform(*size_range, (n, 2)).astype(np.float32)
    cols = {
        "position": r.uniform(-2.0, 2.0, (n, 3)).astype(np.float32),
        "axis_x": (rot[:, 0][None, :] * s[:, :1]).astype(np.float32),
        "axis_y": (rot[:, 1][None, :] * s[:, 1:]).astype(np.float32),
        "color": r.uniform(0.1, 1.0, (n, 4)).astype(np.float32),
        "alive": r.random(n) < 0.9,
    }
    extra = {}
    if mode in ("mask", "scene"):
        extra["alpha_cutoff"] = r.uniform(0.0, 0.8, n).astype(np.float32)
    if mode == "scene":
        extra["mode_id"] = r.integers(0, 6, n).astype(np.int32)
    dj = DrawJ(**{k: jnp.asarray(v) for k, v in cols.items()}, roundness=None,
               sprite_index=jnp.zeros(n, jnp.int32), sprite_grid_size=(1, 1), texture_layers=(),
               needs_uv=False)
    dt = DrawT(**{k: torch.from_numpy(v) for k, v in cols.items()})
    if shape == "triangles":
        dj, dt = expand_j(dj, _mesh(MeshJ)), expand_t(dt, _mesh(MeshT))
        k = _mesh(MeshT).num_quads + _mesh(MeshT).num_triangles
        extra = {f: np.tile(v, k) for f, v in extra.items()}
    dj = dataclasses.replace(dj, **{f: jnp.asarray(v) for f, v in extra.items()})
    dt = dataclasses.replace(dt, **{f: torch.from_numpy(v) for f, v in extra.items()})
    return dj, dt


def _render_both(dj, dt, mode, cfg, ortho=False, size=SIZE):
    img_j = np.asarray(rasterize_j(dj, _camera(camera_j, ortho, size), CfgJ(**cfg), mode))
    img_t = raster.rasterize(dt, _camera(camera_t, ortho, size), raster.RasterConfig(**cfg),
                             mode).numpy()
    return img_j, img_t


@pytest.mark.parametrize("shape", ["quads", "triangles"])
@pytest.mark.parametrize("mode", MODES)
def test_antialias_matches_jax_in_every_equation(mode, shape):
    dj, dt = _draws(3, 400 if shape == "quads" else 80, shape, mode)
    bg = (0.3, 0.4, 0.5, 0.5)  # a coloured target, which MULTIPLY modulates
    cfg = dict(width=SIZE, height=SIZE, antialias=True, tile_slots=0, background=bg)
    img_j, img_t = _render_both(dj, dt, mode, cfg)
    assert np.abs(img_j - np.float32(bg)).sum() > 1.0
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=ATOL)
    # the fringe really changes the image
    plain = raster.rasterize(dt, _camera(camera_t),
                             raster.RasterConfig(SIZE, SIZE, tile_slots=0, background=bg),
                             mode).numpy()
    assert not np.array_equal(plain, img_t)


def _quad(mod_draw, pos, color, size):
    """One camera-facing square particle of ``size`` world units."""
    n = len(pos)
    cols = dict(position=np.asarray(pos, np.float32),
                axis_x=np.tile(np.float32([size, 0, 0]), (n, 1)),
                axis_y=np.tile(np.float32([0, size, 0]), (n, 1)),
                color=np.asarray(color, np.float32), alive=np.ones(n, bool))
    if mod_draw is DrawJ:
        return DrawJ(**{k: jnp.asarray(v) for k, v in cols.items()}, roundness=None,
                     sprite_index=jnp.zeros(n, jnp.int32), sprite_grid_size=(1, 1),
                     texture_layers=(), needs_uv=False)
    return DrawT(**{k: torch.from_numpy(v) for k, v in cols.items()})


CASES = {
    # test_render.py:310: a 0.5-px particle: fractional footprint, no hard pixel
    "subpixel": ([[0.01, 0.01, 0.0]], [[1.0, 1.0, 1.0, 1.0]], 0.015, "add"),
    # test_render.py:326: the interior stays solid, the outside empty
    "interior": ([[0.0, 0.0, 0.0]], [[1.0, 0.0, 0.0, 1.0]], 0.5, "blend"),
    # test_render.py:335: premultiplied edges scale RGB by coverage
    "premultiply_edge": ([[0.013, 0.0, 0.0]], [[1.0, 0.0, 0.0, 1.0]], 0.5, "premultiply"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_jax_antialias_cases_match(case):
    pos, color, size, mode = CASES[case]
    cfg = dict(width=SIZE, height=SIZE, antialias=True)
    img_j, img_t = _render_both(_quad(DrawJ, pos, color, size),
                                _quad(DrawT, pos, color, size), mode, cfg, ortho=True)
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=ATOL)
    if case == "subpixel":
        assert 0.05 < img_t[..., 0].sum() < 0.8 and img_t[..., 0].max() < 1.0
    elif case == "interior":
        np.testing.assert_allclose(img_t[32, 32], [1, 0, 0, 1], atol=1e-5)
        assert img_t[32, 32 - 9, 0] < 0.05
    else:
        np.testing.assert_allclose(img_t[..., 0], img_t[..., 3], atol=1e-5)
        assert ((img_t[..., 3] > 0.0) & (img_t[..., 3] < 1.0)).any()


@pytest.mark.parametrize("tiny", [False, True])
def test_triangle_antialias_matches_jax(tiny):
    """test_mesh.py:132: a right triangle's one-pixel ramp (solid interior,
    fractional hypotenuse), and a sub-pixel triangle's fractional energy."""
    h = 0.01 if tiny else 0.5
    verts = [[-h, -h, 0.0], [h, -h, 0.0], [-h, h, 0.0]]
    pair = [M.from_triangles(verts, [[0, 1, 2]]) for M in (MeshJ, MeshT)]
    dj = expand_j(_quad(DrawJ, [[0.0, 0.0, 0.0]], [[1.0, 1.0, 1.0, 1.0]], 1.0), pair[0])
    dt = expand_t(_quad(DrawT, [[0.0, 0.0, 0.0]], [[1.0, 1.0, 1.0, 1.0]], 1.0), pair[1])
    cfg = dict(width=SIZE, height=SIZE, antialias=True)
    img_j, img_t = _render_both(dj, dt, "blend", cfg, ortho=True)
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=ATOL)
    a = img_t[..., 3]
    if tiny:
        assert 0.02 < a.sum() < 0.8 and a.max() < 1.0
    else:
        assert a[40, 20] > 0.999 and a[10, 10] < 1e-4
        assert ((a > 0.02) & (a < 0.98)).sum() >= 10


@pytest.mark.parametrize("seed", range(6))
def test_random_antialias_sweep_matches_jax(seed):
    """Random draws (quads or a mesh's triangles, sizes from sub-pixel to
    tens of pixels), equations, binnings and budgets, as test_fuzz.py:318
    sweeps the JAX package's."""
    r = np.random.default_rng(seed + 900)
    mode = str(r.choice(MODES))
    shape = str(r.choice(["quads", "triangles"]))
    lo = float(r.choice([0.005, 0.05]))
    dj, dt = _draws(seed, int(r.integers(50, 300)), shape, mode, (lo, lo * 20))
    cfg = dict(width=96, height=96, antialias=True, tile_slots=int(r.choice([0, 1, 2])),
               max_entries_per_tile=int(r.choice([8, 64])))
    img_j, img_t = _render_both(dj, dt, mode, cfg, size=96)
    assert np.isfinite(img_t).all()
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=ATOL)


# ---- the widened warp-block bounds against the coverage they must keep ------

NTX = 2  # a 2x2-tile grid


def _coverage_grid(row, T):
    """The plain coverage (raster._coverage, tile_blend_plain's ops) of one
    entry at every pixel of the 2x2-tile grid: f32 [nt, T, T]."""
    nt = NTX * NTX
    r = torch.from_numpy(np.tile(np.asarray(row, np.float32), (nt, 1)))
    ar = torch.arange(T, dtype=torch.int32)
    tiles = torch.arange(nt, dtype=torch.int32)
    py = ((tiles // NTX)[:, None, None] * T + ar[None, :, None]).to(torch.float32) + 0.5
    px = ((tiles % NTX)[:, None, None] * T + ar[None, None, :]).to(torch.float32) + 0.5
    return _coverage_at(r, px, py)


def _coverage_at(r, px, py):
    """The plain coverage of entries ``r`` (f32 [n, 11]) at pixel centres
    ``px``, ``py`` (f32 [n, h, w]): f32 [n, h, w]."""
    a1x, a1y, a2x, a2y = r[:, 2], r[:, 3], r[:, 4], r[:, 5]
    det_f = a1x * a2y - a1y * a2x
    det_f = torch.where(torch.abs(det_f) < 1e-9, 1e-9, det_f)
    det = det_f[:, None, None]
    dx, dy = px - r[:, 0, None, None], py - r[:, 1, None, None]
    u = (a2y[:, None, None] * dx - a2x[:, None, None] * dy) / det
    v = ((-a1y)[:, None, None] * dx + a1x[:, None, None] * dy) / det
    is_tri = (r[:, 10] > 0.5)[:, None, None]
    has = torch.ones((r.shape[0], 1, 1), dtype=torch.bool)
    return raster._coverage(u, v, det_f, a1x, a1y, a2x, a2y, has, is_tri)


def _warp_of_pixel(T):
    pi, pj = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
    if T % 8 == 0:
        return (pi // 4) * (T // 8) + pj // 8
    return (pi * T + pj) // 32


def _check_bound(row, T):
    """No block that the antialiased bound culls holds a pixel of coverage
    > 0 or NaN (which PREMULTIPLY writes); returns the blocks kept and the
    blocks holding such pixels."""
    with np.errstate(all="ignore"):
        c = _coverage_grid(row, T)
        cov = ((c > 0.0) | torch.isnan(c)).numpy()
    window = torch.from_numpy(np.tile(np.asarray(row, np.float32), (NTX * NTX, 1, 1)))
    has = torch.ones((NTX * NTX, 1), dtype=torch.bool)
    kept = raster.warp_entries_plain(window, has, T, NTX, tri_col=10, antialias=True)[..., 0]
    kept = kept.numpy()
    warp = _warp_of_pixel(T)
    covered_blocks = 0
    for tile in range(NTX * NTX):
        for w in range(kept.shape[1]):
            hit = cov[tile][warp == w].any()
            covered_blocks += int(hit)
            assert kept[tile, w] or not hit, f"a block with coverage > 0 or NaN was culled: {row.tolist()}"
    return int(kept.sum()), covered_blocks


def _row(a, b, c, tri):
    """An entry's columns as mesh.py builds a triangle (centre (B + C) / 2,
    h1 = B - A, h2 = C - A) or as a quad (centre a, half axes b, c), then a
    white colour and the tri flag."""
    a, b, c = (np.asarray(p, np.float32) for p in (a, b, c))
    if tri:
        centre, h1, h2 = (b + c) * np.float32(0.5), b - a, c - a
    else:
        centre, h1, h2 = a, b, c
    return np.asarray([*centre, *h1, *h2, 1.0, 1.0, 1.0, 1.0, 1.0 if tri else 0.0], np.float32)


def _entries(st):
    """Adversarial quads and triangles over the grid: random, sub-pixel,
    thin, near the det clamp, edges on pixel centres, huge, tiny edges
    (below the 2^-40 lengths the bound accepts), non-finite."""
    coord = st.floats(-8.0, 40.0, width=32)
    special = st.sampled_from([np.nan, np.inf, -np.inf, 3e38, -3e38, 1e-45])

    @st.composite
    def entries(draw):
        tri = draw(st.booleans())
        kind = draw(st.sampled_from(["random", "subpixel", "thin", "degenerate", "lattice",
                                     "huge", "tiny", "nonfinite"]))
        a = [draw(coord), draw(coord)]
        b = [draw(st.floats(-20.0, 20.0, width=32)), draw(st.floats(-20.0, 20.0, width=32))]
        c = [draw(st.floats(-20.0, 20.0, width=32)), draw(st.floats(-20.0, 20.0, width=32))]
        if tri:
            b, c = [a[0] + b[0], a[1] + b[1]], [a[0] + c[0], a[1] + c[1]]
        if kind == "subpixel":
            k = draw(st.sampled_from([1e-3, 0.05, 0.3, 0.7]))
            if tri:
                b = [a[0] + (b[0] - a[0]) * k, a[1] + (b[1] - a[1]) * k]
                c = [a[0] + (c[0] - a[0]) * k, a[1] + (c[1] - a[1]) * k]
            else:
                b, c = [b[0] * k, b[1] * k], [c[0] * k, c[1] * k]
        elif kind == "thin":
            eps = draw(st.floats(-0.015625, 0.015625, width=32))
            c = [b[0] + eps, b[1]] if tri else [b[0] * 0.999 + eps, b[1]]
        elif kind == "degenerate":
            s = draw(st.sampled_from([1e-5, 3.1622776e-5, 3.2e-5]))
            b = [a[0] + s, a[1]] if tri else [s, 0.0]
            c = [a[0], a[1] + s * draw(st.sampled_from([0.999, 1.0, 1.001]))] if tri else [
                0.0, s * draw(st.sampled_from([0.999, 1.0, 1.001]))]
        elif kind == "lattice":
            ints = st.integers(-2, 34)
            a = [draw(ints) + 0.5, draw(ints) + 0.5]
            d1 = [draw(st.integers(-12, 12)), draw(st.integers(-12, 12))]
            d2 = [draw(st.integers(-12, 12)), draw(st.integers(-12, 12))]
            b, c = ([a[0] + d1[0], a[1] + d1[1]], [a[0] + d2[0], a[1] + d2[1]]) if tri else (
                d1, d2)
        elif kind == "huge":
            m = draw(st.sampled_from([1e6, 1e15, 1e30]))
            b = [b[0] * m, b[1]]
        elif kind == "tiny":
            m = draw(st.sampled_from([1e-15, 1e-12, 2.0**-41]))
            b, c = ([a[0] + m, a[1]], [a[0], a[1] + m]) if tri else ([m, 0.0], [0.0, m])
        row = _row(a, b, c, tri)
        if kind == "nonfinite":
            row[draw(st.integers(0, 5))] = draw(special)
        return row

    return entries()


@pytest.mark.parametrize("T", [16, 12])
def test_antialias_bounds_cull_no_pixel_with_coverage(T):
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import strategies as st

    @hypothesis.settings(max_examples=300, deadline=None, derandomize=True,
                         suppress_health_check=[hypothesis.HealthCheck.too_slow])
    @hypothesis.given(_entries(st))
    def check(row):
        _check_bound(row, T)

    check()


@pytest.mark.parametrize("tri", [False, True])
def test_antialias_bounds_still_cull_small_entries(tri):
    """On ordinary entries (2-20 px) the widened bound still culls most of
    the blocks that hold no covered pixel."""
    r = np.random.default_rng(7 + tri)
    kept, hit, blocks = 0, 0, 0
    for _ in range(60):
        a = r.uniform(0.0, 32.0, 2)
        b = (a + r.uniform(-10.0, 10.0, 2)) if tri else r.uniform(-6.0, 6.0, 2)
        c = (a + r.uniform(-10.0, 10.0, 2)) if tri else r.uniform(-6.0, 6.0, 2)
        k, h = _check_bound(_row(a, b, c, tri), 16)
        kept, hit, blocks = kept + k, hit + h, blocks + NTX * NTX * 8
    assert kept < hit + 0.5 * (blocks - hit), (kept, hit, blocks)


def _cullable_but_for_centre(rows):
    """Whether each row (f32 [n, 11]) passes the kernel's antialiased cull
    conditions other than the centre's: finite columns, a finite det above
    the clamp, and edge lengths in f32 within [2^-40, 2^60]."""
    r = torch.from_numpy(np.asarray(rows, np.float32))
    det = r[:, 2] * r[:, 5] - r[:, 3] * r[:, 4]
    ok = torch.isfinite(r[:, :6]).all(-1) & torch.isfinite(det) & (det.abs() >= 1e-9)
    for x, y in ((r[:, 2], r[:, 3]), (r[:, 4], r[:, 5]), (r[:, 4] - r[:, 2], r[:, 5] - r[:, 3])):
        e = raster.sqrt_f32(x * x + y * y)
        ok &= (e >= 2.0**-40) & (e <= 2.0**60)
    return ok.numpy()


# finite entries that the fringe's edge and det conditions accept but whose
# coverage is NaN: a quad whose num_u is inf - inf at every pixel (centre
# 2^69 away, h2 = (2^59, 2^59)), the same with h1 = (2^58, -2^58), h2 =
# (2^58, 2^59) at 2^71, and triangles whose u and v overflow with opposite
# signs (u + v NaN in d3): one at 2^115 with edges of 2^-14, one at 2^40
# with h1 = (2^59, 0), h2 = (2^59 + 2^36, 2^-88) (det 2^-29 just above the
# clamp, so v = 2^59 2^40 / 2^-29 overflows)
FAR_ROWS = {
    "quad": [-2.0**69, -2.0**69, 2.0**59, -2.0**59, 2.0**59, 2.0**59, 1, 1, 1, 1, 0],
    "quad71": [-2.0**71, -2.0**71, 2.0**58, -2.0**58, 2.0**58, 2.0**59, 1, 1, 1, 1, 0],
    "tri": [-2.0**115, 2.0**115, 2.0**-14, 0.0, 0.0, 2.0**-14, 1, 1, 1, 1, 1],
    "tri40": [0.0, -2.0**40, 2.0**59, 0.0, 2.0**59 + 2.0**36, 2.0**-88, 1, 1, 1, 1, 1],
}


@pytest.mark.parametrize("name", sorted(FAR_ROWS))
def test_antialias_bounds_keep_nan_coverage(name):
    """The fringe cull keeps every block where a far entry's coverage is
    NaN (the kernel leaves such an entry to its lanes, which write JAX's NaN
    in PREMULTIPLY): its centre lies past raster.AA_CULL_CENTRE."""
    row = np.asarray(FAR_ROWS[name], np.float32)
    assert _cullable_but_for_centre(row[None])[0]
    with np.errstate(all="ignore"):
        assert bool(torch.isnan(_coverage_grid(row, 16)).any())  # the case this test is for
    kept, hit = _check_bound(row, 16)
    assert hit > 0 and kept >= hit


def test_antialias_cullable_coverage_is_a_number():
    """The header's claim behind the centre condition: an entry the fringe
    cull may skip (every condition, |centre| <= raster.AA_CULL_CENTRE) has
    a coverage that is a number at every pixel centre of any frame (they
    lie in [0.5, 2^31]), so a lane it skips has coverage 0, never JAX's
    NaN. Rows: every combination of centres at the bound's corners with
    edges of 2^59 and 2^-14 in eight directions (products and quotients at
    their largest), and 4 000 seeded rows of log-uniform magnitudes up to
    the bound and to 2^59, quads and triangles."""
    c = raster.AA_CULL_CENTRE
    dirs = [(1, 1), (1, -1), (-1, 1), (-1, -1), (1, 0), (0, 1), (-1, 0), (0, -1)]
    edges = [(s * a, s * b) for s in (2.0**59, 2.0**-14) for a, b in dirs]
    rows = [[cx, cy, *h1, *h2, 1, 1, 1, 1, tri] for cx in (-c, c) for cy in (-c, c)
            for h1 in edges for h2 in edges for tri in (0, 1)]
    r = np.random.default_rng(41)
    n = 4000
    mag = lambda lo, hi: np.exp2(r.uniform(lo, hi, n)) * r.choice([-1.0, 1.0], n)
    rand = np.zeros((n, 11))
    rand[:, 0] = mag(0.0, np.log2(c))
    rand[:, 1] = mag(0.0, np.log2(c))
    for k in range(2, 6):
        rand[:, k] = mag(-40.0, 59.0)
    rand[:, 6:10] = 1.0
    rand[:, 10] = r.integers(0, 2, n)
    rows = np.concatenate([np.asarray(rows, np.float64), rand]).astype(np.float32)
    rows = rows[_cullable_but_for_centre(rows) & (np.abs(rows[:, :2]) <= c).all(-1)]
    assert len(rows) > 4000
    p = torch.tensor([0.5, 2.0**20 + 0.5, 2.0**31], dtype=torch.float32)
    px = p[None, None, :].expand(len(rows), 3, 3)
    py = p[None, :, None].expand(len(rows), 3, 3)
    with np.errstate(all="ignore"):
        cov = _coverage_at(torch.from_numpy(rows), px, py)
    bad = torch.isnan(cov).flatten(1).any(-1)
    assert not bool(bad.any()), rows[bad.numpy()][:4].tolist()
