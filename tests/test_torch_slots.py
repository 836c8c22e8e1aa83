"""The port's slot binnings (``tile_slots`` 0 and 2) against the JAX package, on the CPU.

``tile_slots=0`` bins a quad into every tile of the ``tile_span``-square
from its bbox corner that it touches (exact, the JAX package's default);
``tile_slots=2`` into the bbox-corner tile and the neighbour of the larger
spill (the headline's ``slots2`` and ``hifi`` companions). Held against the
JAX package:

* the plain binning (``bin_entries_plain``, ``project_bin_plain``) against
  a jnp transcription of raster.py:267-333: tile ids and depths exactly,
  the binned entries' depth range equal, on hand-made screen quads (cropped
  by the span, off the left and top edges, floors outside int32, NaN
  centres, centres on tile boundaries, valid quads with no binned slot) and
  on a projected draw;
* the key layout at the entry counts the slots give (raster.py:336-403);
* the window gather's entry -> row map, ``entry mod n`` (raster.py:493-500);
* ``rasterize`` images at ``tile_slots`` 0 and 2 (T 16) and 2 (T 8) in
  BLEND, the four ADD variants, OPAQUE and MASK with a depth plane, and
  the painter's SCENE: pixels within 1e-5 absolute (f32 blend rounding) and
  checksums within 0.5% (bench.py:155-161, the repo's device-gate
  tolerance).

The stepped paths at these binnings are in ``test_torch_default_config.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_hanabi_tpu.render import camera as camera_j
from bevy_hanabi_tpu.render.extract import ParticleDrawData as DrawJ
from bevy_hanabi_tpu.render.raster import RasterConfig as CfgJ
from bevy_hanabi_tpu.render.raster import rasterize as rasterize_j
from bevy_hanabi_tpu_torch import RasterConfig
from bevy_hanabi_tpu_torch.ops import gather
from bevy_hanabi_tpu_torch.render import camera as camera_t
from bevy_hanabi_tpu_torch.render import raster
from bevy_hanabi_tpu_torch.render.extract import ParticleDrawData as DrawT

REL = 0.005  # checksum tolerance (bench.py:155-161)

# (tile_slots, tile_span, tile_size): the binnings under test
BINNINGS = [(0, 1, 16), (0, 2, 16), (0, 3, 16), (0, 4, 8), (2, 2, 16), (2, 2, 8)]
# the headline's three companions (bench.py:470-472, 550)
COMPANIONS = {
    "slots2": dict(tile_slots=2),
    "hifi": dict(tile_slots=2, tile_size=8),
    "exact": dict(tile_slots=0),
}


def _close_sum(got, want):
    got, want = float(np.asarray(got).sum()), float(np.asarray(want).sum())
    assert abs(got - want) <= REL * max(abs(want), 1.0), (got, want)


# ---- the binning against a jnp transcription of raster.py:267-333 ------------


def _jax_bin(cx, cy, rx, ry, valid, depth, cfg):
    """raster.py:267-333 as the JAX package runs it (jnp on the CPU, its
    saturating float -> int32 casts included): ``(tile_ids, depths)``,
    slot-concatenated, as numpy."""
    cx, cy, rx, ry, depth = (jnp.asarray(a, jnp.float32) for a in (cx, cy, rx, ry, depth))
    valid = jnp.asarray(valid)
    T, span = cfg.tile_size, cfg.tile_span
    ntx, nty, nt = cfg.tiles_x, cfg.tiles_y, cfg.num_tiles
    tx0 = jnp.floor((cx - rx) / T).astype(jnp.int32)
    ty0 = jnp.floor((cy - ry) / T).astype(jnp.int32)
    tx1 = jnp.floor((cx + rx) / T).astype(jnp.int32)
    ty1 = jnp.floor((cy + ry) / T).astype(jnp.int32)
    tiles, depths = [], []
    if cfg.tile_slots == 1:
        tcx = jnp.clip(jnp.floor(cx / T).astype(jnp.int32), 0, ntx - 1)
        tcy = jnp.clip(jnp.floor(cy / T).astype(jnp.int32), 0, nty - 1)
        tiles = [jnp.where(valid, tcy * ntx + tcx, nt)]
        depths = [jnp.where(valid, depth, -jnp.inf)]
    elif cfg.tile_slots == 2:
        tcx = jnp.clip(tx0, 0, ntx - 1)
        tcy = jnp.clip(ty0, 0, nty - 1)
        ok0 = valid & (tcx <= tx1) & (tcy <= ty1)
        tile0 = jnp.where(ok0, tcy * ntx + tcx, nt)
        sx = (tx1 > tcx) & (tcx + 1 < ntx)
        sy = (ty1 > tcy) & (tcy + 1 < nty)
        spill_x = (cx + rx) - (tcx + 1).astype(jnp.float32) * T
        spill_y = (cy + ry) - (tcy + 1).astype(jnp.float32) * T
        use_x = sx & (jnp.logical_not(sy) | (spill_x >= spill_y))
        ok1 = valid & (sx | sy)
        tile1 = jnp.where(ok1, jnp.where(use_x, tile0 + 1, tile0 + ntx), nt)
        tiles = [tile0, tile1]
        depths = [jnp.where(ok0, depth, -jnp.inf), jnp.where(ok1, depth, -jnp.inf)]
    else:
        for dy in range(span):
            for dx in range(span):
                tx = tx0 + dx
                ty = ty0 + dy
                ok = valid & (tx <= tx1) & (ty <= ty1)
                ok &= (tx >= 0) & (tx < ntx) & (ty >= 0) & (ty < nty)
                tiles.append(jnp.where(ok, ty * ntx + tx, nt))
                depths.append(jnp.where(ok, depth, -jnp.inf))
    return np.asarray(jnp.concatenate(tiles)), np.asarray(jnp.concatenate(depths))


def _jax_range(depths):
    """quant_depth's dmin and dmax (raster.py:363-366)."""
    finite = depths > -np.inf
    return np.min(np.where(finite, depths, np.inf)), np.max(np.where(finite, depths, -np.inf))


def _valid(cx, cy, rx, ry, alive, dist, cfg):
    """raster.py:247-265's screen and size tests (f32 comparisons, numpy)."""
    with np.errstate(invalid="ignore"):
        v = alive & (dist > 1e-4)
        v &= (cx + rx > 0) & (cx - rx < cfg.width)
        v &= (cy + ry > 0) & (cy - ry < cfg.height)
        v &= (rx > 1e-6) & (ry > 1e-6)
    return v


def _screen_quads(cfg, seed):
    """Screen-space quads (centre, radii, view distance) of every edge case
    of the binning, in f32: random quads up to 2.5 span widths (cropped by
    the span), quads off the left and top edges, floors beyond int32 (radii
    of 1e12 and inf), NaN centres and radii, centres and bbox edges on tile
    boundaries, and two valid quads no slot of which bins (at span^2: wider
    than the span, their first span tiles left of and above the screen),
    at a view distance nearer and farther than all the others."""
    r = np.random.default_rng(seed)
    T, W, H = cfg.tile_size, cfg.width, cfg.height
    span = cfg.tile_span
    n = 2048
    cx = r.uniform(-2 * T, W + 2 * T, n)
    cy = r.uniform(-2 * T, H + 2 * T, n)
    rx = r.uniform(0.05, 2.5 * span * T, n) * (r.random(n) < 0.5) + r.uniform(0.05, T, n)
    ry = r.uniform(0.05, 2.5 * span * T, n) * (r.random(n) < 0.5) + r.uniform(0.05, T, n)
    dist = r.uniform(1.0, 50.0, n)
    # off the left and the top edge, reaching in
    cx[:64] = r.uniform(-3 * T, 0.0, 64)
    rx[:64] = -cx[:64] + r.uniform(0.5, 2 * T, 64)
    cy[64:128] = r.uniform(-3 * T, 0.0, 64)
    ry[64:128] = -cy[64:128] + r.uniform(0.5, 2 * T, 64)
    # floors outside int32, on screen
    cx[128:152] = r.uniform(0.0, W, 24)
    cy[128:152] = r.uniform(0.0, H, 24)
    rx[128:136] = 1e12
    ry[136:144] = 1e12
    rx[144:148] = np.inf
    ry[148:152] = np.inf
    cx[152:156] = -1e12  # off screen: invalid
    # NaN centres and radii
    cx[156:160] = np.nan
    ry[160:164] = np.nan
    # centres and bbox edges on tile boundaries
    k = np.arange(164, 228)
    cx[k] = T * r.integers(0, W // T + 1, k.size)
    cy[k] = T * r.integers(0, H // T + 1, k.size)
    rx[k] = T * r.choice([0.5, 1.0, 2.0], k.size)
    ry[k] = T * r.choice([0.5, 1.0, 2.0], k.size)
    # valid, but no slot bins at span^2: the first span tiles lie off screen
    cx[228:230] = 2.5 * T
    rx[228:230] = (span + 3) * T
    cy[230:232] = 2.5 * T
    ry[230:232] = (span + 3) * T
    dist[[228, 230]] = 1e-3
    dist[[229, 231]] = 1e6
    alive = r.random(n) < 0.95
    alive[128:160] = alive[228:232] = True
    f32 = [np.asarray(a, np.float32) for a in (cx, cy, rx, ry, dist)]
    return (*f32, alive)


@pytest.mark.parametrize("slots,span,T", BINNINGS)
def test_bin_entries_match_jax_on_edge_cases(slots, span, T):
    cfg = CfgJ(128, 96, tile_size=T, tile_span=span, tile_slots=slots)
    cx, cy, rx, ry, dist, alive = _screen_quads(cfg, seed=slots * 10 + span + T)
    valid = _valid(cx, cy, rx, ry, alive, dist, cfg)
    tile_j, depth_j = _jax_bin(cx, cy, rx, ry, valid, dist, cfg)
    tile_t, depth_t = raster.bin_entries_plain(
        *(torch.from_numpy(a) for a in (cx, cy, rx, ry)), torch.from_numpy(valid),
        torch.from_numpy(dist), T, cfg.tiles_x, cfg.tiles_y, slots, span)
    S = raster.entry_slots(slots, span)
    assert tile_t.dtype == torch.int32 and tile_t.shape == (S * cx.shape[0],)
    np.testing.assert_array_equal(tile_t.numpy(), tile_j)  # integer bins: exact
    np.testing.assert_array_equal(depth_t.numpy(), depth_j)
    # every case is present: floors past int32 on valid quads, and binned
    # slots of several kinds
    assert valid[128:152].all() and not valid[152:160].any()
    binned = tile_j < cfg.num_tiles
    assert 0 < binned.sum() < binned.size
    # the range is over the binned entries; a valid quad no slot of which
    # bins (span^2 crops it) stays out of it
    lo, hi = raster.depth_range_plain(depth_t).tolist()
    assert (lo, hi) == tuple(float(v) for v in _jax_range(depth_j))
    if slots == 0:
        assert valid[228:232].all() and not binned.reshape(S, -1)[:, 228:232].any()
        assert 1e-3 < lo and hi < 1e6


@pytest.mark.parametrize("slots,span,T", BINNINGS)
def test_project_bin_plain_matches_jax_binning(slots, span, T):
    """On a projected draw: the port's own projection (held against JAX's
    in test_torch_raster.py), binned by both."""
    r = np.random.default_rng(span + 5 * slots)
    n = 4096
    cam = camera_t.CameraParams(camera_t.look_at((0.5, 1.0, 6.0), (0.0, 0.0, 0.0)),
                                camera_t.perspective(0.9, 1.0, 0.1, 100.0), (128, 128))
    rot = cam.rotation.numpy()
    size = r.uniform(0.02, 1.5, (n, 2)).astype(np.float32)  # up to ~4 tiles wide
    pos = r.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    pos[:32, 2] = 8.0  # behind the camera
    pos[32:40] = np.nan
    d = {
        "position": pos,
        "axis_x": (rot[:, 0][None, :] * size[:, :1]).astype(np.float32),
        "axis_y": (rot[:, 1][None, :] * size[:, 1:]).astype(np.float32),
        "alive": r.random(n) < 0.9,
        "color": r.uniform(0.0, 1.0, (n, 4)).astype(np.float32),
    }
    cfg = CfgJ(128, 128, tile_size=T, tile_span=span, tile_slots=slots)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    tile, depth, rows, rng = raster.project_bin(
        t["position"], t["axis_x"], t["axis_y"], t["alive"], t["color"], cam.view, cam.proj,
        (128, 128), T, cfg.tiles_x, cfg.tiles_y, tile_slots=slots, tile_span=span)
    S = raster.entry_slots(slots, span)
    assert tile.shape == (S * n,) and depth.shape == (S * n,) and rows.shape == (n, raster.ROW)
    rw = rows.numpy()
    cx, cy, dist = rw[:, 0], rw[:, 1], rw[:, raster.COL_DEPTH]
    rx = np.abs(rw[:, 2]) + np.abs(rw[:, 4])
    ry = np.abs(rw[:, 3]) + np.abs(rw[:, 5])
    valid = _valid(cx, cy, rx, ry, d["alive"], dist, cfg)
    tile_j, depth_j = _jax_bin(cx, cy, rx, ry, valid, dist, cfg)
    np.testing.assert_array_equal(tile.numpy(), tile_j)
    np.testing.assert_array_equal(depth.numpy(), depth_j)
    assert rng.tolist() == [float(v) for v in _jax_range(depth_j)]
    assert S == 1 or (tile_j.reshape(S, n)[1:] < cfg.num_tiles).any()  # some quads span tiles


# ---- the key layout at the slots' entry counts (raster.py:336-403) ----------


def _jax_layout(num_entries, nt, fast, policy):
    """raster.py:336-358 and the shifts of :373-403, transcribed: (fast
    mode, tile shift, depth bits, index bits, far first)."""
    tile_bits = max(1, int(np.ceil(np.log2(nt + 2))))
    idx_bits = max(1, int(np.ceil(np.log2(max(num_entries, 2)))))
    slack = 32 - tile_bits - idx_bits
    if not fast:
        mode = None
    elif policy == "first" and slack >= 0:
        mode = "first"
    elif slack >= 4:
        mode = "depth"
    else:
        mode = "payload"
    if mode in ("first", "depth"):
        db = min(slack, 8) if mode == "depth" else 0
        return mode, db + idx_bits, db, idx_bits, False
    depth_bits = min(22, 32 - tile_bits)
    return mode, depth_bits, depth_bits, 0, mode is None


@pytest.mark.parametrize(
    "name,n,size,config,alpha_mode,want",
    [
        # 1M exact: 4 194 304 entries (22 index bits) and 1024 tiles (11 bits)
        ("exact 1M add", 1 << 20, 512, dict(tile_slots=0), "add", "payload"),
        ("exact 1M blend", 1 << 20, 512, dict(tile_slots=0), "blend", None),
        ("exact 1M first", 1 << 20, 512, dict(tile_slots=0, overflow_policy="first"), "add", "payload"),
        # hi-fi: 2M entries and 4096 tiles (13 bits); the ordered path keeps 19 depth bits
        ("hifi 1M add", 1 << 20, 512, dict(tile_slots=2, tile_size=8), "add", "payload"),
        ("hifi 1M blend", 1 << 20, 512, dict(tile_slots=2, tile_size=8), "blend", None),
        ("slots2 1M add", 1 << 20, 512, dict(tile_slots=2), "add", "payload"),
        # the 128x128 gates: 32 768 entries and 64 tiles stay on "depth"
        ("gate exact add", 8192, 128, dict(tile_slots=0), "add", "depth"),
        ("gate exact first", 8192, 128, dict(tile_slots=0, overflow_policy="first"), "add", "first"),
        ("gate hifi add", 8192, 128, dict(tile_slots=2, tile_size=8), "add", "depth"),
    ],
)
def test_key_layout_at_the_slot_entry_counts_matches_jax(name, n, size, config, alpha_mode, want):
    cfg = RasterConfig(size, size, **config)
    entries = raster.entry_slots(cfg.tile_slots, cfg.tile_span) * n
    mode = raster.fast_mode(cfg, alpha_mode, entries)
    j_mode, *j_layout = _jax_layout(entries, cfg.num_tiles, alpha_mode == "add", cfg.overflow_policy)
    assert mode == j_mode == want
    assert raster._key_layout(entries, cfg.num_tiles, mode) == tuple(j_layout)
    if name == "hifi 1M blend":
        assert j_layout[1] == 19


# ---- the window gather maps an entry to its row (raster.py:493-500) ---------


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("from_start", [False, True])
@pytest.mark.parametrize("S", [2, 4, 9])
def test_gather_window_reads_entry_mod_n_like_jax(S, from_start, index_dtype):
    r = np.random.default_rng(S + 2 * from_start)
    n, nt, M = 300, 24, 8
    rows = r.standard_normal((n, raster.ROW)).astype(np.float32)
    rows[r.random(rows.shape) < 0.02] = np.nan
    lengths = r.choice([0, 1, M - 1, M, M + 1, 3 * M], size=nt)
    ends = np.cumsum(lengths).astype(np.int64)
    starts = ends - lengths
    entries = r.permutation(S * n)[: max(int(ends[-1]), 1)]  # sorted entry ids, up to S * n
    # JAX: t_p = entry mod n of the window's clamped slot (raster.py:488-500)
    base = starts if from_start else np.maximum(ends - M, starts)
    raw = base[:, None] + np.arange(M)[None, :]
    has = raw < ends[:, None]
    t_p = np.remainder(entries[np.minimum(raw, entries.shape[0] - 1)], n)
    want = np.where(has[..., None], rows[t_p], np.float32(0.0))
    window, got_has = gather.gather_window(
        torch.from_numpy(rows), torch.from_numpy(entries).to(index_dtype), torch.from_numpy(starts),
        torch.from_numpy(ends), M, from_start=from_start)
    np.testing.assert_array_equal(got_has.numpy(), has)
    np.testing.assert_array_equal(window.numpy().view(np.uint32), want.view(np.uint32))
    assert (entries[np.minimum(raw, entries.shape[0] - 1)][has] >= n).any()


def test_gather_window_refuses_entries_without_rows():
    se = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="rows"):
        gather.gather_window(torch.zeros((0, 10)), torch.zeros(3, dtype=torch.int32), se, se, 4)


# ---- rasterize at the slot binnings against JAX -----------------------------


def _cam(mod, size, eye=(0.5, 1.0, 6.0)):
    return mod.CameraParams(mod.look_at(eye, (0.0, 0.0, 0.0)), mod.perspective(0.9, 1.0, 0.1, 100.0),
                            (size, size))


def _draw(seed, n, size, painter=False):
    """Camera-facing quads of random size (up to ~3 tiles at 128x128),
    some dead, behind the camera or off screen, with per-particle cutoffs
    and, for the painter, mode ids."""
    r = np.random.default_rng(seed)
    rot = _cam(camera_t, size).rotation.numpy()
    sz = r.uniform(0.02, 0.6, (n, 2)).astype(np.float32)
    pos = r.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    pos[:64, 2] = 8.0
    pos[64:128, 0] = 40.0
    d = {
        "position": pos,
        "axis_x": (rot[:, 0][None, :] * sz[:, :1]).astype(np.float32),
        "axis_y": (rot[:, 1][None, :] * sz[:, 1:]).astype(np.float32),
        "color": r.uniform(0.0, 1.0, (n, 4)).astype(np.float32),
        "alive": r.random(n) < 0.9,
        "alpha_cutoff": r.uniform(0.0, 1.0, n).astype(np.float32),
    }
    if painter:
        d["mode_id"] = r.integers(0, 6, n).astype(np.int32)
    opt = {k: d.get(k) for k in ("alpha_cutoff", "mode_id")}
    draw_t = DrawT(*(torch.from_numpy(d[k]) for k in ("position", "axis_x", "axis_y", "color", "alive")),
                   **{k: None if v is None else torch.from_numpy(v) for k, v in opt.items()})
    draw_j = DrawJ(
        position=jnp.asarray(d["position"]), axis_x=jnp.asarray(d["axis_x"]),
        axis_y=jnp.asarray(d["axis_y"]), color=jnp.asarray(d["color"]),
        alive=jnp.asarray(d["alive"]), roundness=None,
        sprite_index=jnp.zeros((n,), jnp.int32), sprite_grid_size=(1, 1),
        texture_layers=(), needs_uv=False,
        **{k: None if v is None else jnp.asarray(v) for k, v in opt.items()},
    )
    return draw_t, draw_j


# variant: (alpha mode, extra config, the fast mode it must take, with a depth plane)
VARIANTS = {
    "blend": ("blend", {}, None, False),
    "add first": ("add", dict(overflow_policy="first"), "first", False),
    "add depth": ("add", {}, "depth", False),
    "add payload": ("add", {}, "payload", False),  # drawn at 512x512, 70 000 quads
    "add ordered": ("add", dict(order_independent_fast=False), None, False),
    "opaque depth": ("opaque", {}, None, True),
    "mask depth": ("mask", {}, None, True),
    "scene": ("scene", {}, None, False),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("companion", list(COMPANIONS))
def test_rasterize_at_slot_binnings_matches_jax(companion, variant):
    alpha_mode, extra, want_mode, depth_plane = VARIANTS[variant]
    n, size = (70_000, 512) if variant == "add payload" else (6000, 128)
    config = dict(COMPANIONS[companion], **extra, background=(0.1, 0.2, 0.3, 1.0))
    cfg_t, cfg_j = RasterConfig(size, size, **config), CfgJ(size, size, **config)
    entries = raster.entry_slots(cfg_t.tile_slots, cfg_t.tile_span) * n
    assert raster.fast_mode(cfg_t, alpha_mode, entries) == want_mode
    draw_t, draw_j = _draw(11, n, size, painter=alpha_mode == "scene")
    kw = {}
    if depth_plane:  # a wall over the left third, and read back
        wall = np.full((size, size), np.inf, np.float32)
        wall[:, : size // 3] = 5.5
        kw_t = dict(scene_depth=torch.from_numpy(wall), return_depth=True)
        kw_j = dict(scene_depth=jnp.asarray(wall), return_depth=True)
    else:
        kw_t = kw_j = kw
    out_t = raster.rasterize(draw_t, _cam(camera_t, size), cfg_t, alpha_mode, **kw_t)
    out_j = rasterize_j(draw_j, _cam(camera_j, size), cfg_j, alpha_mode, **kw_j)
    if depth_plane:
        (out_t, d_t), (out_j, d_j) = out_t, out_j
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))  # selects only: exact
    img_t, img_j = out_t.numpy(), np.asarray(out_j)
    assert img_t.shape == (size, size, 4) and np.isfinite(img_t).all()
    np.testing.assert_allclose(img_t, img_j, atol=1e-5)
    _close_sum(img_t, img_j)
