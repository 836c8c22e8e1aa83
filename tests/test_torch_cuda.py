"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device: a CUDA
kernel has no CPU or interpret mode. The file imports no JAX, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` because ``tests/conftest.py`` configures JAX.)
Tolerances: the gather, ``event_compact`` and ``bin_keys`` must be
bit-exact; ``project_bin`` must give equal tiles, depths and depth range
(both versions round op for op, the library is built with ``-fmad=false``);
``tile_blend`` (every equation and depth variant) within 1e-5 absolute on
real windows, exactly (max abs err 0, NaN where the plain version is NaN) on
the adversarial ones, and its depth plane exactly; the mixed scene card
against CPU with alive masks and PCG seeds bit for bit and checksums within
0.5%. ``mesh_expand``, ``project_bin``'s appearance columns and
``tile_blend``'s appearance variants exactly (max abs err 0), except a
round draw's squircle, where the card's ``powf`` and PyTorch's ``pow`` may
differ in the last ulp: at most 0.2% of its pixels differ and its checksum
within 0.5%.
"""

import numpy as np
import pytest
import torch

from bevy_hanabi_tpu_torch import CompiledEffect, HanabiScene, RasterConfig, SimParams, StepInputs
from bevy_hanabi_tpu_torch.models import firework_effect, firework_trail_effect, gradient_effect
from bevy_hanabi_tpu_torch.ops import gather
from bevy_hanabi_tpu_torch.render import raster
from bevy_hanabi_tpu_torch.runtime import events
from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _draw(n, device, seed=0):
    r = np.random.default_rng(seed)
    view = look_at((0.5, 1.0, 6.0), (0.0, 0.0, 0.0))
    proj = perspective(0.9, 1.0, 0.1, 100.0)
    rot = CameraParams(view, proj, (128, 128)).rotation.numpy()
    size = r.uniform(0.02, 0.4, (n, 2)).astype(np.float32)
    d = {
        "position": r.uniform(-2.5, 2.5, (n, 3)).astype(np.float32),
        "axis_x": rot[:, 0][None, :] * size[:, :1],
        "axis_y": rot[:, 1][None, :] * size[:, 1:],
        "color": r.uniform(0.0, 1.0, (n, 4)).astype(np.float32),
        "alive": r.random(n) < 0.9,
    }
    return view, proj, {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in d.items()}


def test_gather_rows_is_bit_exact(cuda):
    r = np.random.default_rng(0)
    table = torch.from_numpy(r.standard_normal((1 << 20, 10)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(r.integers(0, 1 << 20, 65536).astype(np.int32)).to(cuda)
    before = gather.gather_rows.launches
    out = gather.gather_rows(table, idx)
    assert gather.gather_rows.launches == before + 1
    assert torch.equal(out, gather.gather_rows_plain(table, idx))


def test_project_bin_and_tile_blend_match_plain(cuda):
    view, proj, t = _draw(8192, cuda)
    cfg = raster.RasterConfig(128, 128, tile_slots=1)
    args = (t["position"], t["axis_x"], t["axis_y"], t["alive"], t["color"],
            view, proj, (128, 128), cfg.tile_size, cfg.tiles_x, cfg.tiles_y)
    # the BLEND pass's rows: the quad and the colour only
    got = raster.project_bin(*args, row=raster.ROW_QUAD)
    want = raster.project_bin_plain(*args, row=raster.ROW_QUAD)
    assert got[2].shape == (8192, raster.ROW_QUAD)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float((got[2] - want[2]).abs().max()) <= 1e-3
    pidx_sorted, starts, ends = raster.sort_tiles(want[0], want[1], cfg.num_tiles, None, want[3])
    pidx, has = raster.window_index(pidx_sorted, starts, ends, cfg.max_entries_per_tile)
    window = gather.gather_rows_plain(want[2], pidx.reshape(-1)).reshape(cfg.num_tiles, -1, raster.ROW_QUAD)
    bg = (0.1, 0.0, 0.0, 1.0)
    fb = raster.tile_blend(window, has, cfg.tile_size, cfg.tiles_x, cfg.tiles_y, bg)
    fb_p = raster.tile_blend_plain(window, has, cfg.tile_size, cfg.tiles_x, cfg.tiles_y, bg)
    assert float((fb - fb_p).abs().max()) <= 1e-5


def test_wrappers_refuse_mixed_devices(cuda):
    with pytest.raises(ValueError, match="cuda"):
        gather.gather_rows(torch.zeros((4, 10), device=cuda), torch.zeros(2, dtype=torch.int32))


def test_small_frame_on_the_card_matches_the_cpu(cuda):
    """8192 particles at 128x128 through the kernels vs the CPU's plain path;
    checksums within 0.5% (the repo's device-gate tolerance)."""

    def run(device):
        fx = CompiledEffect(gradient_effect(8192), device=device)
        ins = [StepInputs.make(s, 7 + 31 * i) for i, s in enumerate([4096, 1024, 2048])]
        sims = [SimParams(time=2.0 * i, delta_time=2.0) for i in range(3)]
        cam = CameraParams(look_at((0, 0, 6), (0, 0, 0)), perspective(0.9, 1.0, 0.1, 100.0), (128, 128))
        return fx.step_render_chunk(
            fx.create_pool(), *fx.stack_frames(ins, sims), cam, RasterConfig(128, 128, tile_slots=1)
        )

    pool_g, img_g, sums_g = run(cuda)
    pool_c, img_c, sums_c = run("cpu")
    assert torch.isfinite(img_g).all()
    np.testing.assert_array_equal(pool_g.to_numpy()[1], pool_c.to_numpy()[1])
    np.testing.assert_array_equal(pool_g.to_numpy()[2], pool_c.to_numpy()[2])
    for a, b in zip(sums_g.cpu().tolist(), sums_c.tolist()):
        assert abs(a - b) <= 0.005 * abs(b)


@pytest.mark.parametrize("n,active_share", [(65536, 0.03), (5000, 0.5), (1_500_000, 0.2)])
def test_event_compact_is_bit_exact(cuda, n, active_share):
    # 65536 is the rocket pool; at 1.5M lanes each CTA of the one resident
    # grid walks several chunks
    r = np.random.default_rng(n)
    mask = torch.from_numpy(r.random(n) < active_share).to(cuda)
    count = torch.from_numpy(r.integers(0, 5, n).astype(np.int64)).to(cuda)
    payload = torch.from_numpy(r.integers(-(2**31), 2**31, (n, 3)).astype(np.int32)).to(cuda)
    before = events.event_compact.launches
    got = events.event_compact(mask, count, payload)
    assert events.event_compact.launches == before + 1
    want = events.event_compact_plain(mask, count, payload)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bg", [(0.0, 0.0, 0.0, 0.0), (0.1, 0.0, 0.2, 1.5)])
def test_tile_blend_add_matches_plain(cuda, bg):
    view, proj, t = _draw(8192, cuda, seed=3)
    cfg = raster.RasterConfig(128, 128, tile_slots=1)
    tile, depth, rows, rng = raster.project_bin_plain(
        t["position"], t["axis_x"], t["axis_y"], t["alive"], t["color"],
        view, proj, (128, 128), cfg.tile_size, cfg.tiles_x, cfg.tiles_y, row=raster.ROW_QUAD,
    )
    mode = raster.fast_mode(cfg, "add", tile.shape[0])
    pidx_sorted, starts, ends = raster.sort_tiles(tile, depth, cfg.num_tiles, mode, rng)
    pidx, has = raster.window_index(pidx_sorted, starts, ends, cfg.max_entries_per_tile, from_start=True)
    window = gather.gather_rows_plain(rows, pidx.reshape(-1)).reshape(cfg.num_tiles, -1, raster.ROW_QUAD)
    args = (window, has, cfg.tile_size, cfg.tiles_x, cfg.tiles_y, bg, "add")
    before = (raster.tile_blend.launches, raster.tile_blend.launches_by_mode["add"])
    fb = raster.tile_blend(*args)
    assert (raster.tile_blend.launches, raster.tile_blend.launches_by_mode["add"]) == (
        before[0] + 1, before[1] + 1
    )
    fb_p = raster.tile_blend_plain(*args)
    assert float((fb - fb_p).abs().max()) <= 1e-5


def test_firework_tree_on_the_card_matches_the_cpu(cuda):
    """The 2k -> 8k firework tree, 30 updates of 1/20 s (rockets die and
    trails spawn from their events): alive masks and PCG seeds bit for bit,
    positions and velocities of the alive lanes rtol 1e-2 / atol 1e-3, and
    the rendered ADD frame's checksum within 0.5%."""

    def run(device):
        s = HanabiScene(seed=17, device=device)
        s.add(firework_effect(2048), "rocket")
        s.add(firework_trail_effect(8192), "trail", parent="rocket")
        for _ in range(30):
            s.update(1.0 / 20.0)
        cam = CameraParams(look_at((0, 2, 8), (0, 2, 0)), perspective(0.9, 1.0, 0.1, 100.0), (128, 128))
        return s, s.render(cam, RasterConfig(128, 128, tile_slots=1))

    s_g, img_g = run(cuda)
    s_c, img_c = run("cpu")
    assert s_c["trail"].alive_count() > 0
    for name in ("rocket", "trail"):
        attrs_g, alive_g, seed_g, _ = s_g[name].pool.to_numpy()
        attrs_c, alive_c, seed_c, _ = s_c[name].pool.to_numpy()
        np.testing.assert_array_equal(alive_g, alive_c)
        np.testing.assert_array_equal(seed_g, seed_c)
        # a trail inherits its rocket's position through the payload gather
        for attr in ("position", "velocity"):
            np.testing.assert_allclose(attrs_g[attr][alive_c], attrs_c[attr][alive_c], rtol=1e-2, atol=1e-3)
    assert torch.isfinite(img_g).all()
    a, b = float(img_g.sum()), float(img_c.sum())
    assert abs(a - b) <= 0.005 * abs(b)


def _window(cuda, mode, depth_test, seed=5, M=64):
    """A real 128x128 window of ``mode`` from a random draw with cutoffs
    and painter mode ids, in the variant's row width, plus a tiled scene
    depth plane and framebuffer."""
    view, proj, t = _draw(8192, cuda, seed=seed)
    cfg = raster.RasterConfig(128, 128, tile_slots=1, max_entries_per_tile=M)
    r = np.random.default_rng(seed)
    extra = torch.from_numpy(np.stack([r.uniform(0, 1, 8192), r.integers(0, 6, 8192)], 1)
                             .astype(np.float32)).to(cuda)
    width = raster.row_width(mode, depth_test)
    tile, depth, rows, rng = raster.project_bin_plain(
        t["position"], t["axis_x"], t["axis_y"], t["alive"], t["color"],
        view, proj, (128, 128), cfg.tile_size, cfg.tiles_x, cfg.tiles_y,
        extra=extra if width == raster.ROW else None, row=width,
    )
    pidx_sorted, starts, ends = raster.sort_tiles(tile, depth, cfg.num_tiles, raster.fast_mode(cfg, mode, 8192),
                                                  rng)
    pidx, has = raster.window_index(pidx_sorted, starts, ends, M, from_start=mode == "add")
    window = gather.gather_rows_plain(rows, pidx.reshape(-1)).reshape(cfg.num_tiles, M, width)
    sd = torch.from_numpy(np.where(r.random((128, 128)) < 0.5, r.uniform(4, 8, (128, 128)), np.inf)
                          .astype(np.float32))
    fb = torch.from_numpy(r.uniform(0, 1, (128, 128, 4)).astype(np.float32))
    return (window, has, cfg.tile_size, cfg.tiles_x, cfg.tiles_y), (
        raster.to_tiles(sd, cfg, np.inf).to(cuda), raster.to_tiles(fb, cfg, 0.0).to(cuda))


@pytest.mark.parametrize(
    "mode,depth_test,write_depth,seeded",
    [
        ("blend", False, False, True),
        ("blend", True, False, True),
        ("add", True, False, False),
        ("opaque", False, False, False),
        ("opaque", True, True, False),
        ("mask", True, False, True),
        ("mask", True, True, False),
        ("scene", True, True, True),
        ("scene", True, True, False),
    ],
)
def test_tile_blend_variants_match_plain(cuda, mode, depth_test, write_depth, seeded):
    args, (sd, fb) = _window(cuda, mode, depth_test)
    kw = dict(framebuffer=fb if seeded else None, scene_depth=sd if depth_test else None,
              depth_test=depth_test, write_depth=write_depth)
    bg = (0.1, 0.0, 0.2, 1.0)
    before = raster.tile_blend.launches_by_mode[mode]
    got = raster.tile_blend(*args, bg, mode, **kw)
    assert raster.tile_blend.launches_by_mode[mode] == before + 1
    want = raster.tile_blend_plain(*args, bg, mode, **kw)
    if write_depth:
        assert torch.equal(got[1], want[1])
        got, want = got[0], want[0]
    assert float((got - want).abs().max()) <= 1e-5


def test_project_bin_extra_columns_match_plain(cuda):
    view, proj, t = _draw(8192, cuda, seed=2)
    extra = torch.rand((8192, 2), device=cuda)
    args = (t["position"], t["axis_x"], t["axis_y"], t["alive"], t["color"],
            view, proj, (128, 128), 16, 8, 8)
    got = raster.project_bin(*args, extra=extra)
    want = raster.project_bin_plain(*args, extra=extra)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2][:, raster.COL_CUTOFF:], extra)
    assert float((got[2] - want[2]).abs().max()) <= 1e-3
    # the 10-float rows are the 13-float rows without the last three columns
    narrow = raster.project_bin(*args, row=raster.ROW_QUAD)
    assert torch.equal(narrow[0], got[0]) and torch.equal(narrow[1], got[1])
    torch.testing.assert_close(narrow[2], got[2][:, : raster.ROW_QUAD], rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("pipeline", ["auto", "split"])
def test_mixed_scene_chunk_on_the_card_matches_the_cpu(cuda, pipeline):
    """A small mixed scene (opaque debris 1024, gradient 4096, rockets 512 ->
    trails 2048) through ``update_render_chunk(8, 1/10)`` twice."""
    import math

    from bevy_hanabi_tpu_torch import (AlphaMode, EffectAsset, ExprWriter, SetAttributeModifier,
                                       SetPositionSphereModifier, SetSizeModifier,
                                       SetVelocitySphereModifier, ShapeDimension, SpawnerSettings)
    from bevy_hanabi_tpu_torch import attributes as A

    def run(device):
        w = ExprWriter()
        debris = (
            EffectAsset("debris", 1024, SpawnerSettings.rate(256.0), w.finish())
            .init(SetPositionSphereModifier(w.module.lit((0.0, 0.0, 0.0)), w.module.lit(3.0),
                                            ShapeDimension.VOLUME))
            .init(SetVelocitySphereModifier(w.module.lit((0.0, 0.0, 0.0)), w.module.lit(1.0)))
            .init(SetAttributeModifier(A.LIFETIME, w.lit(4.0).expr()))
            .init(SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
            .init(SetAttributeModifier(A.HDR_COLOR, w.lit((0.9, 0.6, 0.2, 1.0)).expr()))
            .render(SetSizeModifier((0.05,) * 3))
            .with_alpha_mode(AlphaMode.OPAQUE)
        )
        s = HanabiScene(seed=3, device=device)
        s.add(debris, "debris")
        s.add(gradient_effect(4096), "grad")
        s.add(firework_effect(512), "rocket")
        s.add(firework_trail_effect(2048), "trail", parent="rocket")
        cam = CameraParams(look_at((0, 0, 26), (0, 0, 0)), perspective(math.radians(60.0), 1.0, 0.1, 200.0),
                           (128, 128))
        sums = [s.update_render_chunk(8, 0.1, cam, RasterConfig(128, 128, tile_slots=1), pipeline=pipeline)[1]
                for _ in range(2)]
        return s, torch.cat(sums).cpu().tolist()

    s_g, sums_g = run(cuda)
    s_c, sums_c = run("cpu")
    for name in ("debris", "grad", "rocket", "trail"):
        np.testing.assert_array_equal(s_g[name].pool.to_numpy()[1], s_c[name].pool.to_numpy()[1])
        np.testing.assert_array_equal(s_g[name].pool.to_numpy()[2], s_c[name].pool.to_numpy()[2])
    for a, b in zip(sums_g, sums_c):
        assert abs(a - b) <= 0.005 * max(abs(b), 1.0)


# ---- the binning keys and the redesigned kernels' edge cases ------------------


def _entries(n, nt, case, device, seed=0):
    """(tile int32, depth f32) of ``n`` entries: binned ones on tiles
    0..nt-1 with depths > 1e-4, the rest on the sentinel tile nt at -inf."""
    r = np.random.default_rng(seed)
    tile = r.integers(0, nt, n).astype(np.int32)
    depth = r.uniform(0.5, 60.0, n).astype(np.float32)
    binned = r.random(n) < 0.8
    if case == "nothing binned":
        binned[:] = False
    elif case == "one binned":
        binned[:] = False
        binned[n // 3] = True
    elif case == "equal depths":
        depth[:] = np.float32(7.25)
    tile[~binned] = nt
    depth[~binned] = -np.inf
    return torch.from_numpy(tile).to(device), torch.from_numpy(depth).to(device)


@pytest.mark.parametrize("offset", [0, 1])  # 1: inputs off 16-byte alignment, the scalar path
@pytest.mark.parametrize("case", ["random", "nothing binned", "one binned", "equal depths"])
@pytest.mark.parametrize("mode", [None, "payload", "first", "depth"])
def test_bin_keys_is_bit_exact(cuda, mode, case, offset):
    # 512^2 at T=16: the sentinel tile 1024 sets bit 31 of the ordered key;
    # n is no multiple of 4, so the last thread takes the ragged tail, and
    # leaves the "depth" key its 4 depth bits (11 tile bits, 17 index bits)
    nt, n = 1024, 100_003
    tile, depth = _entries(n + offset, nt, case, cuda, seed=n)
    tile, depth = tile[offset:], depth[offset:]
    rng = raster.depth_range_plain(depth)
    before = raster.bin_keys.launches
    got = raster.bin_keys(tile, depth, rng, nt, mode)
    assert raster.bin_keys.launches == before + 1
    want = raster.bin_keys_plain(tile, depth, rng, nt, mode)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)
    # sort_tiles on the card decodes and bounds the same keys as on the CPU
    for a, b in zip(raster.sort_tiles(tile, depth, nt, mode, rng),
                    raster.sort_tiles(tile.cpu(), depth.cpu(), nt, mode)):
        assert torch.equal(a.cpu(), b)
    if mode != "first":  # the other keys quantise depth: on the card the range is project_bin's
        with pytest.raises(ValueError, match="depth_range"):
            raster.sort_tiles(tile, depth, nt, mode)


@pytest.mark.parametrize("alive_share", [0.9, 0.001, 0.0])
def test_project_bin_depth_range_is_min_and_max(cuda, alive_share):
    view, proj, t = _draw(70_000, cuda, seed=4)
    alive = torch.from_numpy(np.random.default_rng(4).random(70_000) < alive_share).to(cuda)
    args = (t["position"], t["axis_x"], t["axis_y"], alive, t["color"],
            view, proj, (128, 128), 16, 8, 8)
    tile, depth, _, rng = raster.project_bin(*args, row=raster.ROW_QUAD)
    binned = depth[tile < 64]
    if binned.numel() == 0:
        assert rng.isnan().all()
    else:
        assert torch.equal(rng, torch.stack([torch.min(binned), torch.max(binned)]))
    assert torch.equal(rng.isnan(), raster.depth_range_plain(depth).isnan())


@pytest.mark.parametrize("n", [1000, 256 * 37 + 1, 65536])
@pytest.mark.parametrize("row", [raster.ROW_QUAD, raster.ROW])
@pytest.mark.parametrize("offset", [0, 1])  # 1: every input off 16-byte alignment
def test_project_bin_ragged_and_unaligned_slices_match_plain(cuda, n, row, offset):
    view, proj, t = _draw(n + offset, cuda, seed=n)
    extra = torch.rand((n + offset, 2), device=cuda) if row == raster.ROW else None
    cut = {k: v[offset:] for k, v in t.items()}
    args = (cut["position"], cut["axis_x"], cut["axis_y"], cut["alive"], cut["color"],
            view, proj, (128, 128), 16, 8, 8)
    kw = dict(row=row, extra=None if extra is None else extra[offset:])
    got = raster.project_bin(*args, **kw)
    want = raster.project_bin_plain(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=0, equal_nan=True)


def _adversarial_window(nt, M, width, T, ntx, seed):
    """A window of quads that stress the culling: tiny (0.3-2 px), huge
    (covering tiles), straddling the 8x4 warp blocks, degenerate (|det| <
    1e-9), with NaN or inf quad columns or NaN colour columns, and off
    screen. Alphas and the framebuffer's stay <= 1 and colours finite or
    NaN, modes are 0..5: the kernel's contract (a pixel it leaves untouched
    is the reference's while the pixel is finite with alpha <= 1)."""
    r = np.random.default_rng(seed)
    n = nt * M
    kind = r.integers(0, 6, n)
    w = np.zeros((n, raster.ROW), np.float32)
    tiles = np.repeat(np.arange(nt), M)
    ox, oy = (tiles % ntx) * T, (tiles // ntx) * T
    w[:, 0] = ox + r.uniform(-2, T + 2, n)
    w[:, 1] = oy + r.uniform(-2, T + 2, n)
    size = np.where(kind == 1, r.uniform(8, 80, n), r.uniform(0.3, 2.0, n))
    ang = r.uniform(0, np.pi, n)
    w[:, 2], w[:, 3] = size * np.cos(ang), size * np.sin(ang)
    w[:, 4], w[:, 5] = -size * np.sin(ang) * r.uniform(0.3, 1.5, n), size * np.cos(ang)
    straddle = kind == 2  # centres on the warp blocks' edges
    w[straddle, 0] = ox[straddle] + 8 * r.integers(0, T // 8 + 1, straddle.sum())
    w[straddle, 1] = oy[straddle] + 4 * r.integers(0, T // 4 + 1, straddle.sum())
    degen = kind == 3  # collinear axes, |det| below the 1e-9 clamp
    w[degen, 4], w[degen, 5] = w[degen, 2] * 0.5, w[degen, 3] * 0.5 + 1e-12
    w[kind == 5, 0] += r.choice([-1e4, 1e7, 1e30], (kind == 5).sum())
    w[:, 6:10] = r.uniform(0, 1, (n, 4))
    bad = kind == 4
    cols = r.integers(0, 10, n)
    w[bad, cols[bad]] = np.where(cols[bad] < 6, r.choice([np.nan, np.inf, -np.inf], bad.sum()), np.nan)
    w[:, raster.COL_DEPTH] = r.uniform(1, 10, n)
    w[:, raster.COL_CUTOFF] = r.uniform(0, 1, n)
    w[:, raster.COL_MODE] = r.integers(0, 6, n)
    has = r.random((nt, M)) < 0.85
    sd = np.where(r.random((nt, T, T)) < 0.5, r.uniform(2, 9, (nt, T, T)), np.inf).astype(np.float32)
    fb = r.uniform(0, 1, (nt, T, T, 4)).astype(np.float32)
    return (np.ascontiguousarray(w.reshape(nt, M, raster.ROW)[:, :, :width]), has, sd, fb)


# 16 and 8: 8x4 warp blocks; 37: rows off 16 B; 12: row-major pixels
@pytest.mark.parametrize("T,M", [(16, 64), (16, 37), (8, 64), (12, 40)])
@pytest.mark.parametrize(
    "mode,depth_test,write_depth,seeded",
    [
        ("blend", False, False, False),
        ("blend", True, False, True),
        ("add", False, False, True),
        ("add", True, False, False),
        ("opaque", False, False, False),
        ("opaque", True, True, False),
        ("mask", True, True, True),
        ("scene", True, True, True),
    ],
)
def test_tile_blend_adversarial_windows_are_exact(cuda, T, M, mode, depth_test, write_depth, seeded):
    ntx, nty = 4, 3
    nt = ntx * nty
    w, has, sd, fb = _adversarial_window(nt, M, raster.row_width(mode, depth_test), T, ntx, seed=T * M)
    dev = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    args = (dev(w), dev(has), T, ntx, nty, (0.1, 0.0, 0.2, 1.0), mode)
    kw = dict(framebuffer=dev(fb) if seeded else None, scene_depth=dev(sd) if depth_test else None,
              depth_test=depth_test, write_depth=write_depth)
    got = raster.tile_blend(*args, **kw)
    want = raster.tile_blend_plain(*args, **kw)
    if write_depth:
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0, equal_nan=True)
        got, want = got[0], want[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


# ---- the window gather, the payload gather and the one-launch compaction ----


def _window_entries(nt, M, F, index_dtype, seed):
    """A sorted entry list over nt tiles whose runs are empty, short, exactly
    M, or longer than M (ragged), a row table with NaN values, and ids past
    the runs (the sentinel tile's)."""
    r = np.random.default_rng(seed)
    lengths = r.choice([0, 0, 1, M // 2, M - 1, M, M + 1, 3 * M], size=nt)
    ends = np.cumsum(lengths).astype(np.int64)
    starts = ends - lengths
    n = int(ends[-1]) + 100
    table = r.standard_normal((n, F)).astype(np.float32)
    table[r.random(table.shape) < 0.01] = np.nan
    pidx = r.permutation(n)
    return (torch.from_numpy(table), torch.from_numpy(pidx).to(index_dtype),
            torch.from_numpy(starts), torch.from_numpy(ends))


@pytest.mark.parametrize("from_start", [False, True])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
# 37: 301 * 37 * F floats, not a multiple of 4: the last CTA's scalar tail
@pytest.mark.parametrize("M", [64, 128, 37])
@pytest.mark.parametrize("F", [10, 11, 13, 17, 26])  # quads, flipbook, mask, mesh, lit mesh
def test_gather_window_is_bit_exact(cuda, F, M, index_dtype, from_start):
    entries = _window_entries(301, M, F, index_dtype, seed=F * M)
    rows, pidx, starts, ends = (t.to(cuda) for t in entries)
    before = gather.gather_window.launches
    window, has = gather.gather_window(rows, pidx, starts, ends, M, from_start)
    assert gather.gather_window.launches == before + 1
    want_w, want_has = gather.gather_window_plain(rows, pidx, starts, ends, M, from_start)
    assert has.dtype == torch.bool and torch.equal(has, want_has)
    assert bool(has.any()) and not bool(has.all())
    assert torch.equal(window.view(torch.int32), want_w.view(torch.int32))


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("M,F", [(512, 26), (1024, 13)])  # M * F above 12 288 floats
def test_gather_window_of_wide_tiles_is_bit_exact(cuda, M, F, index_dtype):
    """Tiles of many slots, runs ragged up to 3 M: no cap on M * F."""
    rows, pidx, starts, ends = (t.to(cuda) for t in _window_entries(48, M, F, index_dtype, seed=M))
    for from_start in (False, True):
        window, has = gather.gather_window(rows, pidx, starts, ends, M, from_start)
        want_w, want_has = gather.gather_window_plain(rows, pidx, starts, ends, M, from_start)
        assert torch.equal(has, want_has) and bool(has.any()) and not bool(has.all())
        assert torch.equal(window.view(torch.int32), want_w.view(torch.int32))


def test_gather_window_on_a_rasterized_frame_is_bit_exact(cuda):
    view, proj, t = _draw(8192, cuda, seed=6)
    cfg = raster.RasterConfig(128, 128, tile_slots=1)
    tile, depth, rows, rng = raster.project_bin(
        t["position"], t["axis_x"], t["axis_y"], t["alive"], t["color"],
        view, proj, (128, 128), cfg.tile_size, cfg.tiles_x, cfg.tiles_y, row=raster.ROW_QUAD)
    for mode in (None, raster.fast_mode(cfg, "add", 8192)):
        sorted_ = raster.sort_tiles(tile, depth, cfg.num_tiles, mode, rng)
        got = gather.gather_window(rows, *sorted_, cfg.max_entries_per_tile, mode is not None)
        want = gather.gather_window_plain(rows, *sorted_, cfg.max_entries_per_tile, mode is not None)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


@pytest.mark.parametrize("F", [1, 3, 10, 13, 50, 400])  # 50, 400: the general row width, shorter runs
def test_gather_rows_is_bit_exact_and_nan_outside_the_table(cuda, F):
    r = np.random.default_rng(F)
    n_table, n_out = 5000, 70_001  # a ragged last run
    table = torch.from_numpy(r.standard_normal((n_table, F)).astype(np.float32)).to(cuda)
    idx = r.integers(0, n_table, n_out).astype(np.int32)
    bad = r.random(n_out) < 0.01
    idx[bad] = r.choice([-1, n_table, 2**31 - 1, -(2**31)], bad.sum())
    before = gather.gather_rows.launches
    got = gather.gather_rows(table, torch.from_numpy(idx).to(cuda))
    assert gather.gather_rows.launches == before + 1
    good = torch.from_numpy(~bad).to(cuda)
    want = gather.gather_rows_plain(table, torch.from_numpy(np.where(bad, 0, idx)).to(cuda))
    assert torch.equal(got[good], want[good])
    assert bool(got[~good].isnan().all())


def _compact_inputs(n, W, active, seed, device, offset=0):
    r = np.random.default_rng(seed)
    m = n + offset
    mask = {"random": r.random(m) < 0.3, "all": np.ones(m, bool), "none": np.zeros(m, bool)}[active]
    count = r.integers(0 if active == "random" else 1, 5, m).astype(np.int64)
    payload = r.integers(-(2**31), 2**31, (m, W)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device)[offset:] for a in (mask, count, payload))


@pytest.mark.parametrize("W", [0, 3, 13])
@pytest.mark.parametrize("n", [0, 1, 1023, 1025, 65536, 4_194_304])  # 4M: a CTA loops over chunks
def test_event_compact_one_launch_is_bit_exact(cuda, n, W):
    mask, count, payload = _compact_inputs(n, W, "random", n + W, cuda)
    before = events.event_compact.launches
    got = events.event_compact(mask, count, payload)
    assert events.event_compact.launches == before + 1
    for a, b in zip(got, events.event_compact_plain(mask, count, payload)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# (I, N, W): one and many segments, N below, at and past a 512-lane chunk and
# not a multiple of 4 (a segment's mask and count off the wide-load
# alignment), W staged (<= 20 words) and read from memory (21-24)
@pytest.mark.parametrize("i,n,W", [(1, 0, 3), (2, 1, 0), (3, 1023, 13), (64, 1024, 3),
                                   (256, 4096, 13), (4096, 1024, 24), (1, 65536, 21),
                                   (5, 513, 22)])
def test_event_compact_segmented_is_bit_exact(cuda, i, n, W):
    """One launch for all I segments, equal to the plain version's rows
    (segment 0 all inactive, segment 1 all active)."""
    r = np.random.default_rng(i * 7 + n + W)
    mask = r.random((i, n)) < r.uniform(0.02, 0.6, (i, 1))
    count = r.integers(0, 5, (i, n)).astype(np.int64)
    mask[0] = False
    if i > 1:
        mask[1], count[1] = True, r.integers(1, 5, n)
    payload = r.integers(-(2**31), 2**31, (i, n, W)).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in (mask, count, payload)]
    before = events.event_compact_segmented.launches
    got = events.event_compact_segmented(*args)
    assert events.event_compact_segmented.launches == before + 1
    for a, b in zip(got, events.event_compact_segmented_plain(*args)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("offset", [0, 1])  # 1: mask and count off their wide-load alignment
@pytest.mark.parametrize("active", ["all", "none"])
@pytest.mark.parametrize("n", [1025, 65536])
def test_event_compact_all_or_no_lane_active(cuda, n, active, offset):
    mask, count, payload = _compact_inputs(n, 3, active, n, cuda, offset)
    got = events.event_compact(mask, count, payload)
    assert int(got[2]) == (n if active == "all" else 0)
    for a, b in zip(got, events.event_compact_plain(mask, count, payload)):
        assert torch.equal(a, b)


# ---- ribbons: ribbon_keys and ribbon_segments -------------------------------

# ages that stress the sort key: ties (bursts), signed zeros, subnormals,
# infinities and NaNs (lax.sort's float order, render/ribbon.py)
_RIBBON_AGES = np.asarray([0.0, -0.0, 1e-40, -1e-40, 1e-45, np.inf, -np.inf, np.nan, -np.nan, 0.5,
                           0.25, 1.0], np.float32)


def _ribbon_inputs(n, device, counter=True, cutoff=False, seed=0):
    """A numpy-seeded draw as the ribbon sort sees it: 64 ribbons (and a few
    alive lanes with the sentinel id), dead lanes, bursts of equal ages and
    the special ages above."""
    r = np.random.default_rng(seed)
    rid = r.integers(0, 64, n).astype(np.int64)
    rid[r.random(n) < 0.01] = 0xFFFFFFFF
    age = r.choice(np.asarray([0.1, 0.2, 0.3], np.float32), n)
    special = r.random(n) < 0.05
    age[special] = r.choice(_RIBBON_AGES, int(special.sum()))
    cols = {
        "alive": r.random(n) < 0.8,
        "ribbon_id": rid,
        "age": age.astype(np.float32),
        "counter": r.permutation(np.arange(n, dtype=np.int64) * 7919 % (1 << 32)) if counter else None,
        "position": r.uniform(-3.0, 3.0, (n, 3)).astype(np.float32),
        "axis_y": r.uniform(-0.1, 0.1, (n, 3)).astype(np.float32),
        "color": r.uniform(0.0, 1.0, (n, 4)).astype(np.float32),
        "alpha_cutoff": r.uniform(0.0, 1.0, n).astype(np.float32) if cutoff else None,
    }
    return {k: None if v is None else torch.from_numpy(v).to(device) for k, v in cols.items()}


def _bits_equal(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("counter", [True, False])
@pytest.mark.parametrize("n", [0, 1, 2, 4096, 1 << 20])
def test_ribbon_keys_are_bit_exact(cuda, n, counter):
    from bevy_hanabi_tpu_torch.render import ribbon

    t = _ribbon_inputs(n, cuda, counter=counter, seed=n)
    before = ribbon.ribbon_keys.launches
    perm = None
    if counter:
        key1 = ribbon.ribbon_keys(t["alive"], counter=t["counter"])
        assert key1.dtype == torch.int32
        assert torch.equal(key1, ribbon.ribbon_keys_plain(t["alive"], counter=t["counter"]))
        perm = torch.sort(key1, stable=True).indices
    args = dict(ribbon_id=t["ribbon_id"], age=t["age"], perm=perm)
    key2 = ribbon.ribbon_keys(t["alive"], **args)
    assert key2.dtype == torch.int64
    assert torch.equal(key2, ribbon.ribbon_keys_plain(t["alive"], **args))
    assert ribbon.ribbon_keys.launches == before + 1 + int(counter)


def _segments_on_card(t):
    """``ribbon_segments`` of the draw ``t`` (``_ribbon_inputs``' columns)
    by the kernel, launched once, and by the plain version, bit-equal."""
    from bevy_hanabi_tpu_torch.render import ribbon
    from bevy_hanabi_tpu_torch.render.extract import ParticleDrawData

    draw = ParticleDrawData(t["position"], t["axis_y"], t["axis_y"], t["color"], t["alive"],
                            alpha_cutoff=t["alpha_cutoff"], ribbon_id=t["ribbon_id"], age=t["age"],
                            counter=t["counter"])
    order = ribbon.ribbon_sort(draw)
    # a camera's position is a strided column of its matrix
    cam = CameraParams(look_at((0.5, 1.0, 6.0), (0.0, 0.0, 0.0)), perspective(0.9, 1.0, 0.1, 100.0),
                       (128, 128))
    args = (t["position"], t["axis_y"], t["color"], t["alpha_cutoff"], order.perm1, order.perm2,
            order.key, cam.position, t.get("sprite"))
    before = ribbon.ribbon_segments.launches
    got = ribbon.ribbon_segments(*args)
    assert ribbon.ribbon_segments.launches == before + 1
    want = ribbon.ribbon_segments_plain(*args)
    for a, b in zip(got, want):
        assert _bits_equal(a, b)
    return got


# The kernel gives a lane 4 consecutive sorted rows, a warp a tile of 128
# and a CTA 512 (csrc/ribbon.cu): sizes at the warp tile's edges (T - 1, T,
# T + 1, 2T + 1), past a CTA's, and a ragged lane (5).
@pytest.mark.parametrize("cutoff", [False, True])
@pytest.mark.parametrize("counter", [True, False])
@pytest.mark.parametrize("n", [0, 1, 2, 5, 127, 128, 129, 257, 513, 4096, 1 << 20])
def test_ribbon_segments_are_bit_exact(cuda, n, counter, cutoff):
    got = _segments_on_card(_ribbon_inputs(n, cuda, counter=counter, cutoff=cutoff, seed=n + 1))
    if n > 64:  # more lanes than ribbons
        assert 0 < int(got[3].sum()) < n  # valid segments and ribbon heads


# A textured ribbon's flipbook frame: one more int32 column gathered into
# segment order through the same chain, at the warp tile's and a CTA's edges.
@pytest.mark.parametrize("counter", [True, False])
@pytest.mark.parametrize("n", [0, 1, 5, 127, 128, 129, 513, 4096, 1 << 20])
def test_ribbon_segments_gather_the_sprite_column(cuda, n, counter):
    t = _ribbon_inputs(n, cuda, counter=counter, cutoff=counter, seed=n + 3)
    t["sprite"] = torch.from_numpy(
        np.random.default_rng(n).integers(-5, 1 << 20, n).astype(np.int32)).to(cuda)
    got = _segments_on_card(t)
    assert got[6] is not None and got[6].dtype == torch.int32


def test_instanced_firework_events_card_against_cpu(cuda):
    """An emitting asset's instanced step, card against CPU: 8 instances
    of firework_effect(1024), 60 frames; every frame's per-instance event
    buffers (slots, counts, num_events bit for bit, the payload of each
    instance's events within rtol 1e-2 / atol 1e-3), the pools' alive
    masks, seeds and counters bit for bit, and one segmented compaction a
    frame on the card."""
    from bevy_hanabi_tpu_torch import InstancedEffect

    r = np.random.default_rng(4)
    frames = [(r.integers(0, 4, 8), r.integers(0, 2**32, 8, dtype=np.uint32)) for _ in range(60)]
    runs = []
    for device in (cuda, "cpu"):
        fx = InstancedEffect(firework_effect(1024), 8, device=device)
        pools, bufs = fx.create_pools(), []
        before = events.event_compact_segmented.launches
        for j, (counts, seeds) in enumerate(frames):
            pools, ev = fx.step(pools, fx.make_inputs(counts, seeds),
                                SimParams(time=j / 60.0, delta_time=1 / 60.0))
            bufs.append(ev[0].to("cpu"))
        launched = events.event_compact_segmented.launches - before
        runs.append((pools.to_numpy(), bufs, launched))
    (card, bufs_g, n_g), (cpu, bufs_c, n_c) = runs
    assert n_g == 60 and n_c == 0
    for a, b in zip(card[1:], cpu[1:]):
        np.testing.assert_array_equal(a, b)
    emitted = 0
    for g, c in zip(bufs_g, bufs_c):
        assert torch.equal(g.num_events, c.num_events) and torch.equal(g.parent_slot, c.parent_slot)
        assert torch.equal(g.count, c.count)
        for k in c.payload:
            for i, ne in enumerate(c.num_events.tolist()):
                torch.testing.assert_close(g.payload[k][i, :ne], c.payload[k][i, :ne], rtol=1e-2,
                                           atol=1e-3)
        emitted += int(c.num_events.sum())
    assert emitted > 0


def test_instanced_firework_sharded_on_the_card(cuda):
    """An emitting ShardedEffect on a (dp=4, sp=2) mesh of cuda:0: each
    frame's per-instance buffers (the shards' lanes joined, one segmented
    compaction) and the pools equal InstancedEffect's on the card bit for
    bit, 60 frames of 8 x 1024 firework lanes."""
    from bevy_hanabi_tpu_torch import InstancedEffect
    from bevy_hanabi_tpu_torch.parallel import ShardedEffect, make_mesh

    sharded = ShardedEffect(firework_effect(1024), 8, make_mesh([cuda] * 8, dp=4, sp=2))
    plain = InstancedEffect(firework_effect(1024), 8, device=cuda)
    ps, pp = sharded.create_pools(), plain.create_pools()
    r = np.random.default_rng(5)
    emitted = 0
    for j in range(60):
        counts, seeds = r.integers(0, 4, 8), r.integers(0, 2**32, 8, dtype=np.uint32)
        sim = SimParams(time=j / 60.0, delta_time=1 / 60.0)
        before = events.event_compact_segmented.launches
        ps, es = sharded.step(ps, sharded.shard_inputs(sharded.make_inputs(counts, seeds)), sim)
        assert events.event_compact_segmented.launches == before + 1
        pp, ep = plain.step(pp, plain.make_inputs(counts, seeds), sim)
        a, b = es[0], ep[0]
        for x, y in ((a.parent_slot, b.parent_slot), (a.count, b.count),
                     (a.num_events, b.num_events), *((a.payload[k], b.payload[k]) for k in b.payload)):
            assert torch.equal(x, y)
        emitted += int(b.num_events.sum())
    assert emitted > 0
    for x, y in zip(sharded.assemble(ps).to_numpy()[1:], pp.to_numpy()[1:]):
        np.testing.assert_array_equal(x, y)


def test_instanced_groups_card_against_cpu(cuda):
    """InstancedEffect and a HanabiScene group, card against CPU: 30
    frames of 6 x 512 instances with per-instance transforms through
    step_render_chunk (every instance's alive mask, seeds and counter bit
    for bit, checksums within 0.5%), then a scene with a group rendered
    under both pipelines."""
    from bevy_hanabi_tpu_torch import InstancedEffect
    from bevy_hanabi_tpu_torch.models import instancing_effect

    def run(device):
        fx = InstancedEffect(instancing_effect(512), 6, device=device)
        tfs = np.tile(np.eye(3, 4, dtype=np.float32), (6, 1, 1))
        tfs[:, 0, 3] = np.linspace(-2.0, 2.0, 6)
        r = np.random.default_rng(0)
        ins = [fx.make_inputs(r.integers(0, 12, 6), r.integers(0, 2**32, 6, dtype=np.uint32), tfs)
               for _ in range(30)]
        sims = [SimParams(time=j / 60.0, delta_time=1 / 60.0) for j in range(30)]
        cam = CameraParams(look_at((0, 0, 8), (0, 0, 0)), perspective(0.9, 1.0, 0.1, 100.0),
                           (128, 128))
        pools, _, sums = fx.step_render_chunk(fx.create_pools(), *fx.effect.stack_frames(ins, sims),
                                              cam, RasterConfig(128, 128))
        scene = HanabiScene(seed=2, device=device)
        scene.add(gradient_effect(1024), "g")
        scene.add_group(instancing_effect(256), 4, "grp", transforms=tfs[:4])
        for _ in range(20):
            scene.update(1 / 60.0)
        images = [float(scene.render(cam, RasterConfig(128, 128), pipeline=p).sum())
                  for p in ("split", "painter")]
        return pools.to_numpy(), sums.cpu().tolist(), images, scene.group_alive("grp")

    (pg, sums_g, img_g, alive_g), (pc, sums_c, img_c, alive_c) = run(cuda), run("cpu")
    for a, b in zip(pg[1:], pc[1:]):
        assert np.array_equal(a, b)
    assert alive_g == alive_c > 0
    for a, b in zip(sums_g + img_g, sums_c + img_c):
        assert abs(a - b) <= 0.005 * max(abs(b), 1.0)


def _one_age_per_row(t, ribbon_of_rank):
    """Every lane alive, with a distinct age, and ribbon ``ribbon_of_rank``
    of its rank from the oldest: sorted row i is the rank-i lane's."""
    n = t["alive"].shape[0]
    rank = torch.from_numpy(np.random.default_rng(n).permutation(n))
    t["alive"] = torch.ones_like(t["alive"])
    t["age"] = (1.0 + (n - rank).to(torch.float32) / n).to(t["age"].device)
    t["ribbon_id"] = ribbon_of_rank(rank).to(torch.int64).to(t["ribbon_id"].device)
    return t


@pytest.mark.parametrize("counter", [True, False])
def test_ribbon_segments_join_rows_across_tile_edges(cuda, counter):
    """Ribbons of 200 rows span the edges of the warp tiles (rows 128, 256)
    and of the CTAs (rows 512, 1024, 2048); each such row joins its
    predecessor in the tile before."""
    n = 2100
    t = _one_age_per_row(_ribbon_inputs(n, cuda, counter=counter, cutoff=True, seed=7),
                         lambda rank: rank // 200)
    valid = _segments_on_card(t)[3].cpu()
    heads = torch.arange(n) % 200 == 0
    assert torch.equal(valid, ~heads)
    assert bool(valid[[128, 256, 512, 1024, 2048]].all())


@pytest.mark.parametrize("n", [5, 129, 1025])
def test_ribbon_segments_row_zero_starts_no_segment(cuda, n):
    """One ribbon holds every lane, so rows n - 1 and 0 are alive rows of one
    ribbon: row 0 (whose predecessor is row n - 1, the roll) stays invalid."""
    t = _one_age_per_row(_ribbon_inputs(n, cuda, counter=True, seed=n), lambda rank: 0 * rank)
    valid = _segments_on_card(t)[3].cpu()
    assert not bool(valid[0]) and bool(valid[1:].all())


def test_ribbon_segments_refuse_unaligned_vectors(cuda):
    """The kernel reads colour rows, perm2 and the sorted key in 16-byte
    vectors: a view that starts inside a row is refused."""
    from bevy_hanabi_tpu_torch.render import ribbon
    from bevy_hanabi_tpu_torch.render.extract import ParticleDrawData

    n = 256
    t = _ribbon_inputs(n, cuda, counter=False)
    order = ribbon.ribbon_sort(ParticleDrawData(t["position"], t["axis_y"], t["axis_y"], t["color"],
                                                t["alive"], ribbon_id=t["ribbon_id"], age=t["age"]))
    color = torch.zeros(4 * n + 1, device=cuda)[1:].view(n, 4)
    with pytest.raises(ValueError, match="aligned"):
        ribbon.ribbon_segments(t["position"], t["axis_y"], color, None, order.perm1, order.perm2,
                               order.key, (0.0, 0.0, 5.0))


def test_ribbon_gate_on_the_card_matches_the_cpu(cuda):
    """The ribbon gate (bench.py:221-251) at tile_slots=1: alive masks and
    PCG seeds bit for bit, every frame's checksum within 0.5%, the valid
    segments' order equal."""
    from bevy_hanabi_tpu_torch.models import ribbon_order_check_effect
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data
    from bevy_hanabi_tpu_torch.render.ribbon import build_ribbon_segments, ribbon_sort

    cam = CameraParams(look_at((0, 0, 6), (0, 0, 0)), perspective(0.9, 1.0, 0.1, 100.0), (128, 128))

    def run(device):
        fx = CompiledEffect(ribbon_order_check_effect(8192, 64), device=device)
        ins = [StepInputs.make(256, 7 * i + 1) for i in range(30)]
        sims = [SimParams(time=i / 60.0, delta_time=1 / 60.0) for i in range(30)]
        pool, _, sums = fx.step_render_chunk(fx.create_pool(), *fx.stack_frames(ins, sims), cam,
                                             RasterConfig(128, 128, tile_slots=1))
        draw = extract_draw_data(fx.asset, pool, cam)
        valid = build_ribbon_segments(draw, cam).alive
        return pool, sums, valid.cpu(), ribbon_sort(draw).order.cpu()

    (pool_g, sums_g, valid_g, order_g), (pool_c, sums_c, valid_c, order_c) = run(cuda), run("cpu")
    np.testing.assert_array_equal(pool_g.to_numpy()[1], pool_c.to_numpy()[1])
    np.testing.assert_array_equal(pool_g.to_numpy()[2], pool_c.to_numpy()[2])
    for a, b in zip(sums_g.cpu().tolist(), sums_c.tolist()):
        assert abs(a - b) <= 0.005 * abs(b)
    assert torch.equal(valid_g, valid_c) and int(valid_c.sum()) > 0
    assert torch.equal(order_g[valid_c], order_c[valid_c])


# ---- the slot binnings (tile_slots 0 and 2) and the force field ------------

# (tile_slots, tile_span, tile_size): every template instance of project_bin's
# slot binnings, and a span past them (the run-time loop)
SLOT_BINNINGS = [(2, 2, 16), (2, 2, 8), (0, 1, 16), (0, 2, 16), (0, 3, 16), (0, 4, 8), (0, 5, 16)]


@pytest.mark.parametrize("offset", [0, 1])  # 1: every input off 16-byte alignment
@pytest.mark.parametrize("n", [1000, 65536])
@pytest.mark.parametrize("slots,span,T", SLOT_BINNINGS)
def test_project_bin_slots_match_plain(cuda, slots, span, T, n, offset):
    """Quads up to ~4 tiles wide, some behind the camera, off screen, NaN or
    with radii past int32: tiles, depths and the range equal, rows exact."""
    r = np.random.default_rng(n + 10 * span + slots)
    view, proj, t = _draw(n + offset, cuda, seed=span)
    scale = torch.from_numpy(r.uniform(0.5, 6.0, (n + offset, 1)).astype(np.float32)).to(cuda)
    t["axis_x"], t["axis_y"] = t["axis_x"] * scale, t["axis_y"] * scale
    t["position"][:16, 2] = 8.0
    t["position"][16:24] = torch.nan
    t["axis_x"][24:32] = 1e30
    t = {k: v[offset:] for k, v in t.items()}
    cfg = raster.RasterConfig(128, 128, tile_size=T, tile_span=span, tile_slots=slots)
    args = (t["position"], t["axis_x"], t["axis_y"], t["alive"], t["color"],
            view, proj, (128, 128), T, cfg.tiles_x, cfg.tiles_y)
    kw = dict(row=raster.ROW_QUAD, tile_slots=slots, tile_span=span)
    before = raster.project_bin.launches
    got = raster.project_bin(*args, **kw)
    assert raster.project_bin.launches == before + 1
    want = raster.project_bin_plain(*args, **kw)
    S = raster.entry_slots(slots, span)
    assert got[0].shape == (S * n,) and got[2].shape == (n, raster.ROW_QUAD)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=0, equal_nan=True)
    assert bool((want[0].view(S, n)[-1] < cfg.num_tiles).any())  # the last slot bins too


@pytest.mark.parametrize("from_start", [False, True])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("S", [2, 4, 9])
def test_gather_window_maps_entries_mod_n_like_plain(cuda, S, index_dtype, from_start):
    """Entry ids up to S * N read row id mod N, bit for bit; none reads
    outside the table."""
    rows, pidx, starts, ends = _window_entries(300, 64, 10, torch.int64, seed=S)
    n = rows.shape[0] // S  # the table holds every S-th part of the entries' rows
    rows = rows[:n].contiguous()
    args = (rows.to(cuda), pidx.to(index_dtype).to(cuda), starts.to(cuda), ends.to(cuda), 64,
            from_start)
    window, has = gather.gather_window(*args)
    want_w, want_has = gather.gather_window_plain(*args)
    assert torch.equal(has, want_has) and bool(has.any())
    assert torch.equal(window.view(torch.int32), want_w.view(torch.int32))
    assert not bool(window[has].isnan().all(dim=-1).any())  # no slot read past the table


COMPANION_CONFIGS = {
    "slots2": dict(tile_slots=2),
    "hifi": dict(tile_slots=2, tile_size=8),
    "exact": dict(tile_slots=0),
}


@pytest.mark.parametrize("mode", ["blend", "add", "add first", "add ordered", "opaque", "mask",
                                  "scene"])
@pytest.mark.parametrize("companion", list(COMPANION_CONFIGS))
def test_rasterize_at_slot_binnings_on_the_card_matches_the_cpu(cuda, companion, mode):
    """Every kernel at the slot binnings: the card's image against the CPU's
    plain path, within 1e-5 (each kernel is exact against its plain version;
    the bound allows for the sort's ties)."""
    from bevy_hanabi_tpu_torch.render.extract import ParticleDrawData

    alpha_mode, _, variant = mode.partition(" ")
    extra = {"first": dict(overflow_policy="first"), "ordered": dict(order_independent_fast=False)}
    cfg = RasterConfig(128, 128, **COMPANION_CONFIGS[companion], **extra.get(variant, {}))
    view, proj, t = _draw(8192, "cpu", seed=9)
    r = np.random.default_rng(9)
    cutoff = torch.from_numpy(r.uniform(0, 1, 8192).astype(np.float32))
    mode_id = torch.from_numpy(r.integers(0, 6, 8192).astype(np.int32)) if alpha_mode == "scene" else None
    cam = CameraParams(view, proj, (128, 128))
    images = []
    for device in (cuda, "cpu"):
        d = ParticleDrawData(*(t[k].to(device) for k in ("position", "axis_x", "axis_y", "color", "alive")),
                             alpha_cutoff=cutoff.to(device),
                             mode_id=None if mode_id is None else mode_id.to(device))
        images.append(raster.rasterize(d, cam, cfg, alpha_mode).cpu())
    torch.testing.assert_close(images[0], images[1], rtol=0, atol=1e-5)
    assert float(images[1].abs().sum()) > 0


def test_companion_frames_on_the_card_match_the_cpu(cuda):
    """The headline's three companions (bench.py:470-563) on the 8192-lane
    small frame: masks and seeds equal, checksums within 0.5%."""

    def run(device, cfg):
        fx = CompiledEffect(gradient_effect(8192), device=device)
        ins = [StepInputs.make(s, 7 + 31 * i) for i, s in enumerate([4096, 1024, 2048])]
        sims = [SimParams(time=2.0 * i, delta_time=2.0) for i in range(3)]
        cam = CameraParams(look_at((0, 0, 6), (0, 0, 0)), perspective(0.9, 1.0, 0.1, 100.0), (128, 128))
        return fx.step_render_chunk(fx.create_pool(), *fx.stack_frames(ins, sims), cam, cfg)

    for config in COMPANION_CONFIGS.values():
        cfg = RasterConfig(128, 128, **config)
        (pool_g, img_g, sums_g), (pool_c, _, sums_c) = run(cuda, cfg), run("cpu", cfg)
        assert torch.isfinite(img_g).all()
        np.testing.assert_array_equal(pool_g.to_numpy()[1], pool_c.to_numpy()[1])
        for a, b in zip(sums_g.cpu().tolist(), sums_c.tolist()):
            assert abs(a - b) <= 0.005 * abs(b)


def test_ribbon_gate_at_exact_binning_on_the_card_matches_the_cpu(cuda):
    """The ribbon gate at the JAX package's own config, RasterConfig(128,
    128) (tile_slots=0): masks and seeds equal, checksums within 0.5%."""
    from bevy_hanabi_tpu_torch.models import ribbon_order_check_effect

    cam = CameraParams(look_at((0, 0, 6), (0, 0, 0)), perspective(0.9, 1.0, 0.1, 100.0), (128, 128))

    def run(device):
        fx = CompiledEffect(ribbon_order_check_effect(8192, 64), device=device)
        ins = [StepInputs.make(256, 7 * i + 1) for i in range(30)]
        sims = [SimParams(time=i / 60.0, delta_time=1 / 60.0) for i in range(30)]
        return fx.step_render_chunk(fx.create_pool(), *fx.stack_frames(ins, sims), cam,
                                    RasterConfig(128, 128))

    (pool_g, _, sums_g), (pool_c, _, sums_c) = run(cuda), run("cpu")
    np.testing.assert_array_equal(pool_g.to_numpy()[1], pool_c.to_numpy()[1])
    np.testing.assert_array_equal(pool_g.to_numpy()[2], pool_c.to_numpy()[2])
    for a, b in zip(sums_g.cpu().tolist(), sums_c.tolist()):
        assert abs(a - b) <= 0.005 * abs(b) and b > 0


def test_force_field_on_the_card_matches_the_cpu(cuda):
    """force_field_effect(4096) for 5 s, the attractor moved at 3 s so that
    lanes die by the kill box: masks and seeds equal, positions within
    rtol 1e-2 / atol 1e-3."""
    from bevy_hanabi_tpu_torch import EffectSpawner
    from bevy_hanabi_tpu_torch.models import force_field_effect

    spawner = EffectSpawner(force_field_effect(4096).spawner, rng=np.random.default_rng(0))
    counts = [spawner.tick(1 / 60.0) for _ in range(300)]

    def run(device):
        fx = CompiledEffect(force_field_effect(4096), device=device)
        pool = fx.create_pool()
        for k in range(0, 300, 60):
            ins = [StepInputs.make(counts[j], 7 * j, properties={
                "attractor": (9.0, 1.0, 0.0) if j >= 180 else (0.0, 1.0, 0.0)}) for j in range(k, k + 60)]
            sims = [SimParams(time=j / 60.0, delta_time=1 / 60.0) for j in range(k, k + 60)]
            pool = fx.step_chunk(pool, *fx.stack_frames(ins, sims))
        return pool.to_numpy()

    (attrs_g, alive_g, seed_g, _), (attrs_c, alive_c, seed_c, _) = run(cuda), run("cpu")
    np.testing.assert_array_equal(alive_g, alive_c)
    np.testing.assert_array_equal(seed_g, seed_c)
    np.testing.assert_allclose(attrs_g["position"][alive_c], attrs_c["position"][alive_c],
                               rtol=1e-2, atol=1e-3)
    assert 0 < alive_c.sum() < 3000  # the box killed lanes before their lifetime


# ---- textured and mesh particles -------------------------------------------


def _test_mesh(name):
    """A stock mesh, or a quad + triangle union with vertex UVs (some
    outside [0, 1]), normals and colours."""
    from bevy_hanabi_tpu_torch.render.mesh import ParticleMesh

    if name != "union":
        return getattr(ParticleMesh, name)()
    r = np.random.default_rng(4)
    verts = r.normal(size=(5, 3)).astype(np.float32)
    normals = r.normal(size=(5, 3)).astype(np.float32)
    return ParticleMesh([[0.0, 0.0, 0.2], [0.1, 0.0, 0.0]], [[1, 0, 0], [0, 0, 1]], [[0, 1, 0], [0, 1, 0]],
                        vertices=verts, indices=[[0, 1, 2], [2, 3, 4], [4, 0, 1]],
                        uvs=r.uniform(-1.5, 2.5, (5, 2)), normals=normals / np.linalg.norm(normals, axis=1)[:, None],
                        colors=r.uniform(0, 1, (5, 4)))


@pytest.mark.parametrize("lit", [False, True])
@pytest.mark.parametrize("mesh_name", ["cross", "cube", "tetrahedron", "icosphere", "union"])
@pytest.mark.parametrize("n", [0, 1, 255, 257, 4096])
def test_mesh_expand_is_bit_exact(cuda, n, mesh_name, lit):
    """Every output of the kernel equal to the plain version's (max abs err
    0, NaN where it is NaN; zero-length axes and NaN positions among the
    particles)."""
    from bevy_hanabi_tpu_torch.render import mesh as mesh_mod

    m = _test_mesh(mesh_name)
    _, _, t = _draw(n, cuda, seed=n)
    if n > 8:
        t["axis_x"][:4] = 0.0
        t["position"][4:8] = torch.nan
    tables = mesh_mod.mesh_tables(m, cuda)
    tri = m.num_triangles > 0
    kw = dict(want_uv=m.uvs is not None and tri, want_nrm=lit and m.normals is not None and tri,
              want_vcol=m.colors is not None and tri)
    args = (t["position"], t["axis_x"].contiguous(), t["axis_y"].contiguous(), t["color"], t["alive"],
            tables)
    before = mesh_mod.mesh_expand.launches
    got = mesh_mod.mesh_expand(*args, **kw)
    assert mesh_mod.mesh_expand.launches == before + 1
    want = mesh_mod.mesh_expand_plain(*args, **kw)
    for key, w in want.items():
        g = got[key]
        assert (g is None) == (w is None), key
        if w is not None:
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True, msg=key)


# appearance columns of the tile_blend / project_bin cases
APPEARANCE_CASES = {
    # texture layers and no column: a textured billboard's rows stay 10 (13) floats
    "textured quads": dict(layers=(("modulate", "circle"),)),
    "textured triangles": dict(tri=True, uv=True, layers=(("modulate", "circle"),)),
    "lit triangles": dict(tri=True, uv=True, nrm=True,
                          layers=(("modulate_rgb", "sheet"), ("modulate_opacity_from_r", "circle"))),
    "vertex colours": dict(tri=True, vcol=True),
    "flipbook": dict(sprite=True, grid=(4, 2), layers=(("modulate", "sheet"),)),
    "round": dict(round=True),
    "everything": dict(round=True, tri=True, sprite=True, uv=True, nrm=True, vcol=True, grid=(3, 2),
                       layers=(("modulate", "circle"),)),
}


def _appearance_draw(n, device, case, seed=3):
    """A random draw with ``case``'s appearance columns (UVs outside
    [0, 1] and some NaN-padded, negative and large flipbook frames) and its
    textures (a 32x32 circle and a non-square 8x32 sprite sheet)."""
    from bevy_hanabi_tpu_torch.models import make_anim_sprite_sheet, make_circle_texture
    from bevy_hanabi_tpu_torch.render.extract import ParticleDrawData

    spec = APPEARANCE_CASES[case]
    view, proj, t = _draw(n, device, seed)
    r = np.random.default_rng(seed)

    def col(*shape, lo=-1.5, hi=2.5):
        return torch.from_numpy(r.uniform(lo, hi, shape).astype(np.float32)).to(device)

    uv = col(n, 6)
    uv[: n // 8, 0] = torch.nan
    textures = {"circle": make_circle_texture(32), "sheet": make_anim_sprite_sheet(4, 8)}
    names = sorted({name for _, name in spec.get("layers", ())})
    draw = ParticleDrawData(
        **t,
        roundness=col(n, lo=-0.2, hi=1.0) if spec.get("round") else None,
        tri=(col(n, lo=0, hi=1) > 0.5).to(torch.float32) if spec.get("tri") else None,
        sprite_index=torch.from_numpy(r.integers(-9, 40, n).astype(np.int32)).to(device)
        if spec.get("sprite") else None,
        sprite_grid_size=spec.get("grid", (1, 1)),
        texture_layers=tuple((names.index(name), mapping) for mapping, name in spec.get("layers", ())),
        uv_abc=uv if spec.get("uv") else None,
        nrm_abc=col(n, 9) if spec.get("nrm") else None,
        vcol_abc=col(n, 12, lo=0, hi=1) if spec.get("vcol") else None,
        lighting=((0.577, 0.577, 0.577), 0.3) if spec.get("nrm") else None,
    )
    texs = [torch.from_numpy(textures[name]).to(device) for name in names]
    return view, proj, draw, texs


@pytest.mark.parametrize("base", [raster.ROW_QUAD, raster.ROW])
@pytest.mark.parametrize("slots,span", [(1, 2), (2, 2), (0, 2), (0, 3)])
@pytest.mark.parametrize("case", list(APPEARANCE_CASES))
def test_project_bin_appearance_columns_match_plain(cuda, case, slots, span, base):
    """The appearance columns appended in JAX's order and the triangles'
    halved radii: tiles, depths and range equal, rows exact."""
    view, proj, draw, _ = _appearance_draw(5000, cuda, case)
    cfg = raster.RasterConfig(128, 128, tile_slots=slots, tile_span=span)
    ap, inputs = raster.draw_appearance(draw, base)
    args = (draw.position, draw.axis_x, draw.axis_y, draw.alive, draw.color, view, proj, (128, 128),
            cfg.tile_size, cfg.tiles_x, cfg.tiles_y)
    extra = torch.rand((5000, 2), device=cuda) if base == raster.ROW else None
    kw = dict(extra=extra, row=base, tile_slots=slots, tile_span=span, appearance=inputs)
    got = raster.project_bin(*args, **kw)
    want = raster.project_bin_plain(*args, **kw)
    assert got[2].shape == (5000, ap.row)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("case,F", [("textured triangles", 17), ("lit triangles", 26)])
def test_gather_window_on_a_frame_of_triangles_is_bit_exact(cuda, case, F):
    """A ``rasterize`` frame of textured triangles launches the window
    gather at the mesh's row width; that window, built as the frame builds
    it, equals the plain version's bit for bit."""
    view, proj, draw, texs = _appearance_draw(6000, cuda, case)
    cfg = raster.RasterConfig(128, 128, tile_slots=0)
    before = gather.gather_window.launches
    img = raster.rasterize(draw, CameraParams(view, proj, (128, 128)), cfg, textures=texs)
    assert gather.gather_window.launches > before and bool(img.isfinite().all())
    ap, inputs = raster.draw_appearance(draw, raster.ROW_QUAD)
    tile, depth, rows, rng = raster.project_bin(
        draw.position, draw.axis_x, draw.axis_y, draw.alive, draw.color, view, proj, (128, 128),
        cfg.tile_size, cfg.tiles_x, cfg.tiles_y, row=raster.ROW_QUAD, tile_slots=0,
        appearance=inputs)
    assert ap.row == F and rows.shape[1] == F
    args = (rows, *raster.sort_tiles(tile, depth, cfg.num_tiles, None, rng),
            cfg.max_entries_per_tile, False)
    got, want = gather.gather_window(*args), gather.gather_window_plain(*args)
    assert torch.equal(got[1], want[1]) and bool(want[1].any())
    assert _bits_equal(got[0], want[0])


@pytest.mark.parametrize("from_start", [False, True])
@pytest.mark.parametrize("F", [11, 17, 20, 26, 43])  # flipbook / round, textured mesh, lit, all
def test_gather_window_at_appearance_widths_is_bit_exact(cuda, F, from_start):
    rows, pidx, starts, ends = _window_entries(1024, 64, F, torch.int64, seed=F)
    args = (rows.to(cuda), pidx.to(cuda), starts.to(cuda), ends.to(cuda), 64, from_start)
    got = gather.gather_window(*args)
    want = gather.gather_window_plain(*args)
    assert torch.equal(got[1], want[1]) and _bits_equal(got[0], want[0])


# (mode, depth_test, write_depth)
APPEARANCE_VARIANTS = [("blend", False, False), ("premultiply", False, False), ("add", False, False),
                       ("multiply", False, False), ("blend", True, False), ("opaque", True, True),
                       ("mask", True, True), ("multiply", True, False)]


def _appearance_window(cuda, case, mode, depth_test, seed=3):
    view, proj, draw, texs = _appearance_draw(6000, cuda, case, seed)
    cfg = raster.RasterConfig(128, 128, tile_slots=0)
    row = raster.row_width(mode, depth_test)
    ap, inputs = raster.draw_appearance(draw, row)
    extra = None
    if row == raster.ROW:
        extra = torch.stack([torch.rand(6000, device=cuda), torch.zeros(6000, device=cuda)], dim=1)
    projected = raster.project_bin(draw.position, draw.axis_x, draw.axis_y, draw.alive, draw.color,
                                   view, proj, (128, 128), cfg.tile_size, cfg.tiles_x, cfg.tiles_y,
                                   extra=extra, row=row, tile_slots=0, appearance=inputs)
    fmode = raster.fast_mode(cfg, mode, projected[0].shape[0])
    pidx_sorted, starts, ends = raster.sort_tiles(projected[0], projected[1], cfg.num_tiles, fmode,
                                                  projected[3])
    window, has = gather.gather_window(projected[2], pidx_sorted, starts, ends, 64,
                                       from_start=fmode is not None)
    return cfg, ap, texs, window, has


@pytest.mark.parametrize("mode,depth_test,write_depth", APPEARANCE_VARIANTS)
@pytest.mark.parametrize("case", list(APPEARANCE_CASES))
def test_tile_blend_appearance_variants_match_plain(cuda, case, mode, depth_test, write_depth):
    """Each appearance variant against the plain version on a real window:
    exact (max abs err 0, depth planes equal), except the squircle, whose
    powf may differ from PyTorch's pow in the last ulp: there at most 0.2%
    of the pixels differ and the checksums agree within 0.5%."""
    cfg, ap, texs, window, has = _appearance_window(cuda, case, mode, depth_test)
    nt, T = cfg.num_tiles, cfg.tile_size
    kw = dict(depth_test=depth_test, write_depth=write_depth, appearance=ap, textures=texs)
    if depth_test:
        kw["scene_depth"] = torch.rand((nt, T, T), device=cuda) * 8.0
    fb0 = torch.rand((nt, T, T, 4), device=cuda)
    before = dict(raster.tile_blend.launches_appearance)
    got = raster.tile_blend(window, has, T, cfg.tiles_x, cfg.tiles_y, (0.0, 0.0, 0.0, 0.0), mode,
                            framebuffer=fb0, **kw)
    assert raster.tile_blend.launches_appearance[mode] == before[mode] + 1
    want = raster.tile_blend_plain(window, has, T, cfg.tiles_x, cfg.tiles_y, (0.0, 0.0, 0.0, 0.0),
                                   mode, framebuffer=fb0, **kw)
    (fb_g, d_g), (fb_p, d_p) = (got, want) if write_depth else ((got, None), (want, None))
    changed = int(((fb_p - fb0).abs() > 0).any(-1).sum())
    assert changed > 0
    if ap.offset("roundness") >= 0:
        differ = int(((fb_g - fb_p).abs() > 0).any(-1).sum())
        assert differ <= 0.002 * nt * T * T
        assert abs(float(fb_g.sum()) - float(fb_p.sum())) <= 0.005 * abs(float(fb_p.sum()))
    else:
        torch.testing.assert_close(fb_g, fb_p, rtol=0, atol=0, equal_nan=True)
        if write_depth:
            assert torch.equal(d_g, d_p)


# the equations and depth flags of the adversarial appearance windows: those of
# APPEARANCE_VARIANTS and the painter's scene equation (depth tested and written)
ADVERSARIAL_VARIANTS = APPEARANCE_VARIANTS + [("scene", True, True)]
ADVERSARIAL_KINDS = ["lattice", "clamp", "uv", "sprite", "overflow", "compact", "round"]


def _appearance_adversarial_window(device, kind, mode, depth_test, seed=0):
    """A 2x2-tile window (T = 16, M = 64) of triangle and quad entries with
    every appearance column (the squircle's only for ``compact`` and
    ``round``), lit, a 3x2
    flipbook and three texture layers (the 32x32 circle, the 8x32 sheet and
    a 24x17 noise texture), and of ``kind``:

    * ``lattice``: triangle vertices and quad centres on pixel centres with
      integer edges (u = -1/2, v = -1/2, u + v = 0, |u| = 1 in float);
    * ``clamp``: dets at, just below and just above the 1e-9 clamp, and
      infinite and NaN quad columns on triangle entries;
    * ``uv``: UVs at +-2^24, +-(2^24 + 2), +-1e30, infinite, NaN and far
      outside [0, 1];
    * ``sprite``: negative and large flipbook sprites, and NaN;
    * ``overflow``: 48 triangles each covering its whole tile (more covered
      pairs in one run of 32 entries than a warp's pair buffer holds);
    * ``compact``: ``overflow``'s 48 triangles at random places among
      random triangles and quads, with the squircle column at roundness <= 0
      (-0.5, -0.0, 0.0: no ``powf``, so exact), so that the draw is shaded
      on compacted pairs and the buffer overflows within one run of 32;
    * ``round``: quads with the squircle column (roundness <= 0, tiny, 1).

    Returns (window, has, appearance, textures)."""
    from bevy_hanabi_tpu_torch.models import make_anim_sprite_sheet, make_circle_texture

    r = np.random.default_rng(seed)
    T, M, nt = 16, 64, 4
    base = raster.row_width(mode, depth_test)
    present = {"tri", "sprite", "uv", "nrm", "vcol"} | (
        {"roundness"} if kind in ("compact", "round") else set())
    offsets, o = [], base
    for name, width in raster.APPEARANCE_COLUMNS:
        offsets.append(o if name in present else -1)
        o += width if name in present else 0
    ap = raster.Appearance(o, tuple(offsets), (3, 2), ((0.577, 0.577, 0.577), 0.3),
                           ((0, "modulate"), (1, "modulate_rgb"), (2, "modulate_opacity_from_r")))
    w = np.zeros((nt, M, o), np.float32)
    origin = np.stack([np.arange(nt) % 2, np.arange(nt) // 2], -1).astype(np.float32) * T
    tri = r.random((nt, M)) < (0.0 if kind == "round" else 0.6)
    full = np.zeros((nt, M), bool)  # the stacked full-tile triangles
    if kind == "overflow":
        full[:] = True
    elif kind == "compact":
        for tile in range(nt):
            full[tile, r.choice(M, 48, replace=False)] = True
    tri |= full
    for tile in range(nt):
        for m in range(M):
            o0 = origin[tile]
            if tri[tile, m]:
                if full[tile, m]:
                    a = o0 - r.uniform(0.5, 3.0, 2)
                    b, c = a + [40.0, 0.0], a + [0.0, 40.0]
                elif kind == "lattice":
                    a = o0 + r.integers(-2, T + 2, 2) + 0.5
                    b, c = a + r.integers(-12, 13, 2), a + r.integers(-12, 13, 2)
                else:
                    a = o0 + r.uniform(-4.0, T + 4.0, 2)
                    b, c = a + r.uniform(-12.0, 12.0, 2), a + r.uniform(-12.0, 12.0, 2)
                a, b, c = (np.asarray(p, np.float32) for p in (a, b, c))
                w[tile, m, :6] = [*((b + c) * np.float32(0.5)), *(b - a), *(c - a)]
            elif kind == "lattice":
                w[tile, m, :6] = [*(o0 + r.integers(-2, T + 2, 2) + 0.5), r.integers(1, 6), 0.0,
                                  0.0, r.integers(1, 6)]
            else:
                w[tile, m, :2] = o0 + r.uniform(-4.0, T + 4.0, 2)
                w[tile, m, 2:6] = r.uniform(-8.0, 8.0, 4)
    if kind == "clamp":
        s = np.float32(3.1622776e-5)
        k = r.choice(np.asarray([0.999, 1.0, 1.0000001, 1.001, 1.01], np.float32), (nt, M))
        near = r.random((nt, M)) < 0.5
        w[..., 2:6] = np.where(near[..., None], np.stack(
            [np.full((nt, M), s), np.zeros((nt, M)), np.zeros((nt, M)), s * k], -1), w[..., 2:6])
        bad = r.random((nt, M)) < 0.15
        col = r.integers(0, 6, (nt, M))
        val = r.choice(np.asarray([np.inf, -np.inf, np.nan], np.float32), (nt, M))
        w[bad, col[bad]] = val[bad]
    w[..., 6:9] = r.uniform(0.0, 1.0, (nt, M, 3))
    w[..., 9] = r.uniform(0.1, 1.0, (nt, M))
    if base == raster.ROW:
        w[..., 10] = r.uniform(0.0, 8.0, (nt, M))
        w[..., 11] = r.uniform(0.0, 1.0, (nt, M))
        w[..., 12] = r.integers(0, 6, (nt, M))
    if kind == "round":
        w[..., ap.offset("roundness")] = r.choice(
            np.asarray([-0.5, 0.0, 1e-7, 0.3, 0.5, 1.0], np.float32), (nt, M))
    elif kind == "compact":
        w[..., ap.offset("roundness")] = r.choice(np.asarray([-0.5, -0.0, 0.0], np.float32), (nt, M))
    w[..., ap.offset("tri")] = tri
    sprite = r.integers(-9, 40, (nt, M)).astype(np.float32)
    if kind == "sprite":
        sprite = r.choice(np.asarray([-(2.0**30), -7.0, -6.0, -3.0, -1.0, 0.0, 2.0, 5.0, 6.0,
                                      2.0**24 + 2, 2.0**30, np.nan], np.float32), (nt, M))
    w[..., ap.offset("sprite")] = sprite
    uv = r.uniform(-1.5, 2.5, (nt, M, 6)).astype(np.float32)
    if kind == "uv":
        ext = np.asarray([2.0**24, -(2.0**24), 2.0**24 + 2, -(2.0**24) - 2, 1e30, -1e30, np.inf,
                          np.nan, 40.25, -33.5, 0.5], np.float32)
        pick = r.random((nt, M, 6)) < 0.5
        uv = np.where(pick, r.choice(ext, (nt, M, 6)), uv)
    w[..., ap.offset("uv"): ap.offset("uv") + 6] = uv
    w[..., ap.offset("nrm"): ap.offset("nrm") + 9] = r.uniform(-1.0, 1.0, (nt, M, 9))
    w[..., ap.offset("vcol"): ap.offset("vcol") + 12] = r.uniform(0.0, 1.0, (nt, M, 12))
    has = (r.random((nt, M)) < 0.9) | full
    textures = [make_circle_texture(32), make_anim_sprite_sheet(4, 8),
                r.uniform(0.0, 1.0, (17, 24, 4)).astype(np.float32)]
    return (torch.from_numpy(w).to(device), torch.from_numpy(has).to(device), ap,
            [torch.from_numpy(np.ascontiguousarray(t)).to(device) for t in textures])


@pytest.mark.parametrize("mode,depth_test,write_depth", ADVERSARIAL_VARIANTS)
@pytest.mark.parametrize("kind", ADVERSARIAL_KINDS)
def test_tile_blend_appearance_adversarial_windows_match_plain(cuda, kind, mode, depth_test,
                                                               write_depth):
    """The appearance kernel on :func:`_appearance_adversarial_window`'s windows against
    the plain version: exact (max abs err 0, NaN where it is NaN, depth
    planes equal), the squircle within its allowance (at most 0.2% of the
    pixels differ, checksums within 0.5%)."""
    window, has, ap, texs = _appearance_adversarial_window(cuda, kind, mode, depth_test)
    nt, T = 4, 16
    kw = dict(depth_test=depth_test, write_depth=write_depth, appearance=ap, textures=texs)
    if depth_test:
        kw["scene_depth"] = torch.rand((nt, T, T), device=cuda) * 8.0
    fb0 = torch.rand((nt, T, T, 4), device=cuda)
    got = raster.tile_blend(window, has, T, 2, 2, (0.0, 0.0, 0.0, 0.0), mode, framebuffer=fb0, **kw)
    want = raster.tile_blend_plain(window, has, T, 2, 2, (0.0, 0.0, 0.0, 0.0), mode,
                                   framebuffer=fb0, **kw)
    (fb_g, d_g), (fb_p, d_p) = (got, want) if write_depth else ((got, None), (want, None))
    assert int(((fb_p - fb0).abs() > 0).any(-1).sum()) > 0
    if kind == "round":
        differ = int(((fb_g - fb_p).abs() > 0).any(-1).sum())
        assert differ <= 0.002 * nt * T * T
        s_g, s_p = float(fb_g.nan_to_num(0.0).sum()), float(fb_p.nan_to_num(0.0).sum())
        assert abs(s_g - s_p) <= 0.005 * abs(s_p)
    else:
        torch.testing.assert_close(fb_g, fb_p, rtol=0, atol=0, equal_nan=True)
    if write_depth:
        assert torch.equal(d_g, d_p)


def _antialiased_adversarial(window, has, ap, texs, kernel, mode, depth_test):
    """An adversarial window for the antialiased variants: its empty slots
    zeroed (as gather_window writes them: JAX's coverage of a NaN row is
    NaN even where has is false), cut to the quad kernel's row width for
    ``kernel == "quad"`` (then no appearance)."""
    window = torch.where(has[..., None], window, 0.0)
    if kernel == "quad":
        return window[..., :raster.row_width(mode, depth_test)].contiguous(), None, ()
    return window, ap, texs


@pytest.mark.parametrize("mode,depth_test,write_depth", ADVERSARIAL_VARIANTS)
@pytest.mark.parametrize("kind", ["lattice", "clamp", "uv", "overflow", "compact"])
@pytest.mark.parametrize("kernel", ["quad", "appearance"])
def test_tile_blend_antialiased_adversarial_windows_match_plain(cuda, kernel, kind, mode,
                                                                depth_test, write_depth):
    """The antialiased variants (the per-entry edge lengths and fringe
    bounds) on the adversarial windows: edges through pixel centres
    (coverage exactly 0 or 1 on the fringe's edges), dets at the clamp,
    non-finite columns, whole-tile triangles, the squircle column at
    roundness <= 0; both kernels, exact (NaN where the plain version is
    NaN)."""
    window, has, ap, texs = _appearance_adversarial_window(cuda, kind, mode, depth_test)
    window, ap, texs = _antialiased_adversarial(window, has, ap, texs, kernel, mode, depth_test)
    nt, T = 4, 16
    kw = dict(depth_test=depth_test, write_depth=write_depth, appearance=ap, textures=texs,
              antialias=True)
    if depth_test:
        kw["scene_depth"] = torch.rand((nt, T, T), device=cuda) * 8.0
    fb0 = torch.rand((nt, T, T, 4), device=cuda)
    args = (window, has, T, 2, 2, (0.0, 0.0, 0.0, 0.0), mode)
    got = raster.tile_blend(*args, framebuffer=fb0, **kw)
    want = raster.tile_blend_plain(*args, framebuffer=fb0, **kw)
    (fb_g, d_g), (fb_p, d_p) = (got, want) if write_depth else ((got, None), (want, None))
    assert int(((fb_p - fb0).abs() > 0).any(-1).sum()) > 0
    torch.testing.assert_close(fb_g, fb_p, rtol=0, atol=0, equal_nan=True)
    if write_depth:
        assert torch.equal(d_g, d_p)


@pytest.mark.parametrize("mode,depth_test,write_depth", [("premultiply", False, False),
                                                         ("premultiply", True, False),
                                                         ("scene", True, True)])
@pytest.mark.parametrize("kernel", ["quad", "appearance"])
def test_tile_blend_nan_coverage_matches_plain(cuda, kernel, mode, depth_test, write_depth):
    """Antialiased lanes whose coverage is NaN: rows with NaN and infinite
    quad columns, and finite ones past the float range (num_u = inf - inf),
    straight into tile_blend. JAX's PREMULTIPLY term rgb_s * coverage (and
    SCENE's premultiply entries', cs = coverage) writes NaN RGB there,
    depth test or not; the kernel writes the same, NaNs in the same places.
    Among them, finite rows whose edge lengths and det the fringe cull
    accepts but whose centre lies past 2^32: a quad whose num_u is inf - inf
    at every pixel, and (appearance kernel) two triangles whose u and v
    overflow with opposite signs, so that d3's u + v is NaN."""
    window, has, ap, texs = _appearance_adversarial_window(cuda, "clamp", mode, depth_test, seed=17)
    r = np.random.default_rng(17)
    w = window.cpu().numpy()
    nt, M, _ = w.shape
    bad = r.random((nt, M)) < 0.25
    col = r.integers(0, 6, (nt, M))
    val = r.choice(np.asarray([np.nan, np.inf, -np.inf, 3e38, -3e38, 1e30], np.float32), (nt, M))
    w[bad, col[bad]] = val[bad]
    if mode == "scene":  # premultiply entries among the others
        w[..., raster.COL_MODE] = r.choice(np.asarray([1, 1, 1, 0, 2, 3, 4, 5], np.float32), (nt, M))
    # the far rows, in the first three slots of every tile (filled, and
    # premultiply entries in SCENE)
    far = np.asarray([[-2.0**69, -2.0**69, 2.0**59, -2.0**59, 2.0**59, 2.0**59],
                      [-2.0**115, 2.0**115, 2.0**-14, 0.0, 0.0, 2.0**-14],
                      [0.0, -2.0**40, 2.0**59, 0.0, 2.0**59 + 2.0**36, 2.0**-88]], np.float32)
    w[:, :3, :6] = far
    w[:, :3, ap.offset("tri")] = [0.0, 1.0, 1.0]
    if mode == "scene":
        w[:, :3, raster.COL_MODE] = 1.0
    has[:, :3] = True
    window = torch.from_numpy(w).to(cuda)
    window, ap, texs = _antialiased_adversarial(window, has, ap, texs, kernel, mode, depth_test)
    T = 16
    kw = dict(depth_test=depth_test, write_depth=write_depth, appearance=ap, textures=texs,
              antialias=True)
    if depth_test:
        kw["scene_depth"] = torch.rand((nt, T, T), device=cuda) * 8.0
    fb0 = torch.rand((nt, T, T, 4), device=cuda)
    args = (window, has, T, 2, 2, (0.0, 0.0, 0.0, 0.0), mode)
    got = raster.tile_blend(*args, framebuffer=fb0, **kw)
    want = raster.tile_blend_plain(*args, framebuffer=fb0, **kw)
    (fb_g, d_g), (fb_p, d_p) = (got, want) if write_depth else ((got, None), (want, None))
    assert bool(torch.isnan(fb_p).any())  # the case this test is for
    torch.testing.assert_close(fb_g, fb_p, rtol=0, atol=0, equal_nan=True)
    if write_depth:
        assert torch.equal(d_g, d_p)


@pytest.mark.parametrize("mode", ["premultiply", "multiply", "multiply first", "multiply ordered"])
def test_premultiply_and_multiply_quads_match_plain(cuda, mode):
    """The standalone premultiply and multiply equations (multiply on each
    fast path and the ordered one) without appearance: the card's image
    against the CPU's plain path within 1e-5 (the sort's ties)."""
    from bevy_hanabi_tpu_torch.render.extract import ParticleDrawData

    alpha_mode, _, variant = mode.partition(" ")
    extra = {"first": dict(overflow_policy="first"), "ordered": dict(order_independent_fast=False)}
    cfg = RasterConfig(128, 128, background=(0.9, 0.8, 0.7, 0.5), **extra.get(variant, {}))
    view, proj, t = _draw(8192, "cpu", seed=11)
    cam = CameraParams(view, proj, (128, 128))
    images = [raster.rasterize(ParticleDrawData(**{k: v.to(d) for k, v in t.items()}), cam, cfg,
                               alpha_mode).cpu() for d in (cuda, "cpu")]
    torch.testing.assert_close(images[0], images[1], rtol=0, atol=1e-5)


def _mesh_gate(device, capacity=2048, frames=3):
    """The JAX package's textured_mesh_2k check (bench.py:295-327)."""
    from bevy_hanabi_tpu_torch import ParticleTextureModifier
    from bevy_hanabi_tpu_torch.models import make_circle_texture, textured_mesh_check_effect
    from bevy_hanabi_tpu_torch.render.mesh import ParticleMesh

    s = HanabiScene(seed=5, device=device)
    asset = (textured_mesh_check_effect(capacity).render(ParticleTextureModifier(0))
             .with_mesh(ParticleMesh.icosphere(0.4, 1)))
    s.add(asset, "mesh", textures=[make_circle_texture(32)])
    for _ in range(frames):
        s.update(1 / 60.0)
    cam = CameraParams(look_at((0, 0, 6), (0, 0, 0)), perspective(0.9, 1.0, 0.1, 100.0), (128, 128))
    return s, s.render(cam, RasterConfig(128, 128))


def test_textured_mesh_gate_on_the_card_matches_the_cpu(cuda):
    (s_g, img_g), (s_c, img_c) = _mesh_gate(cuda), _mesh_gate("cpu")
    np.testing.assert_array_equal(s_g["mesh"].pool.to_numpy()[1], s_c["mesh"].pool.to_numpy()[1])
    assert torch.isfinite(img_g).all() and float(img_c.sum()) > 0
    assert abs(float(img_g.sum()) - float(img_c.sum())) <= 0.005 * float(img_c.sum())


@pytest.mark.parametrize("alpha_mode", ["BLEND", "ADD", "PREMULTIPLY", "MULTIPLY"])
@pytest.mark.parametrize("mesh", ["billboard", "cross"])
def test_textured_quads_on_the_card_match_the_cpu(cuda, mesh, alpha_mode):
    """A textured billboard (texture layers and no appearance column, so
    its rows are the 10 quad floats) and a textured quad-only mesh
    (ParticleMesh.cross(): no triangle, so no UV column), 20 frames through
    step_render_chunk, card against CPU: masks equal, every frame's
    checksum within 0.5%; then the card's last pool through rasterize on
    both devices, within 1e-5 (the sort's ties)."""
    from bevy_hanabi_tpu_torch import AlphaMode, ParticlePool, ParticleTextureModifier
    from bevy_hanabi_tpu_torch.models import make_circle_texture, textured_mesh_check_effect
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data
    from bevy_hanabi_tpu_torch.render.mesh import ParticleMesh, expand_mesh_draw

    asset = (textured_mesh_check_effect(2048).render(ParticleTextureModifier(0))
             .with_alpha_mode(getattr(AlphaMode, alpha_mode)))
    if mesh == "cross":
        asset = asset.with_mesh(ParticleMesh.cross())
    textures = [make_circle_texture(32)]
    cam = CameraParams(look_at((0, 0, 6), (0, 0, 0)), perspective(0.9, 1.0, 0.1, 100.0), (128, 128))
    cfg = RasterConfig(128, 128, background=(0.9, 0.8, 0.7, 0.5))  # not black: multiply shows
    mode = asset.alpha_mode.kind

    def run(device):
        fx = CompiledEffect(asset, device=device)
        ins = [StepInputs.make(64, 7 * i + 1) for i in range(20)]
        sims = [SimParams(time=i / 60.0, delta_time=1 / 60.0) for i in range(20)]
        return fx.step_render_chunk(fx.create_pool(), *fx.stack_frames(ins, sims), cam, cfg,
                                    textures)

    before = raster.tile_blend.launches_appearance[mode]
    pool_g, _, sums_g = run(cuda)
    assert raster.tile_blend.launches_appearance[mode] > before
    pool_c, _, sums_c = run("cpu")
    np.testing.assert_array_equal(pool_g.to_numpy()[1], pool_c.to_numpy()[1])
    assert float(sums_c[-1]) > 0
    for a, b in zip(sums_g.cpu().tolist(), sums_c.tolist()):
        assert abs(a - b) <= 0.005 * max(abs(b), 1.0)

    images = []
    for device in (cuda, "cpu"):
        pool = ParticlePool.from_numpy(*pool_g.to_numpy(), device=device)
        texs = [torch.from_numpy(t).to(device) for t in textures]
        draw = extract_draw_data(asset, pool, cam, textures=texs)
        if asset.mesh is not None:
            draw = expand_mesh_draw(draw, asset.mesh)
        images.append(raster.rasterize(draw, cam, cfg, mode, textures=texs).cpu())
    assert float(images[1].sum()) > 0
    torch.testing.assert_close(images[0], images[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("example", ["example_puffs", "example_circle", "example_2d"])
def test_examples_on_the_card_match_the_cpu(cuda, example):
    """30 frames through step_render_chunk: masks and seeds equal, every
    frame's checksum within 0.5%."""
    from bevy_hanabi_tpu_torch.models import examples, make_anim_sprite_sheet

    textures = [make_anim_sprite_sheet(8, 16)] if example == "example_circle" else []
    cam = CameraParams(look_at((0, 0, 3), (0, 0, 0)), perspective(0.9, 1.0, 0.1, 100.0), (128, 128))

    def run(device):
        fx = CompiledEffect(getattr(examples, example)(), device=device)
        ins = [StepInputs.make(32, 7 * i + 1) for i in range(30)]
        sims = [SimParams(time=i / 60.0, delta_time=1 / 60.0) for i in range(30)]
        return fx.step_render_chunk(fx.create_pool(), *fx.stack_frames(ins, sims), cam,
                                    RasterConfig(128, 128), textures)

    (pool_g, _, sums_g), (pool_c, _, sums_c) = run(cuda), run("cpu")
    np.testing.assert_array_equal(pool_g.to_numpy()[1], pool_c.to_numpy()[1])
    np.testing.assert_array_equal(pool_g.to_numpy()[2], pool_c.to_numpy()[2])
    assert float(sums_c[-1]) > 0
    for a, b in zip(sums_g.cpu().tolist(), sums_c.tolist()):
        assert abs(a - b) <= 0.005 * max(abs(b), 1.0)


# ---- the expression evaluator's integer edge cases --------------------------


def test_saturating_casts_and_integer_rem_by_zero_on_the_card_match_the_cpu(cuda):
    """f32 -> INT / UINT casts out of range (NaN, +-inf, -1, 2^31, 2^32 and
    their neighbours) and integer ``%`` by zero, the same on the card as on
    the CPU, bit for bit (the CPU's are held against JAX in
    ``test_torch_modifiers.py``)."""
    import bevy_hanabi_tpu_torch as bt
    from bevy_hanabi_tpu_torch import compiler

    r = np.random.default_rng(11)
    age = r.uniform(0.0, 6.0, 2048).astype(np.float32)
    age[:14] = [np.nan, np.inf, -np.inf, -1.0, -0.5, 2.0**31, 2.0**32, 2147483520.0, 4294967040.0,
                -(2.0**31), -2147483904.0, 3e9, -3e9, 1.5]
    w = bt.ExprWriter()
    a = w.attr(bt.attributes.AGE)
    exprs = [a.cast(bt.INT), a.cast(bt.UINT), ((a - 3.0) * 2e9).cast(bt.INT),
             ((a - 3.0) * 2e9).cast(bt.UINT),
             (a * 100.0 - 300.0).cast(bt.INT) % w.prop(w.add_property("divisor", 0)),
             (a * 1e9).cast(bt.UINT) % w.attr(bt.attributes.ID)]
    handles = [e.expr() for e in exprs]
    module = w.finish()
    out = []
    for dev in ("cpu", cuda):
        ctx = compiler.InitContext(module, {"age": torch.from_numpy(age).to(dev)},
                                   torch.zeros(2048, dtype=torch.int64, device=dev),
                                   particle_index=torch.arange(2048, device=dev))
        out.append([ctx.eval(h).cpu() for h in handles])
    for got, want in zip(out[1], out[0]):
        assert got.dtype == want.dtype and torch.equal(got, want)


# ---- the painter's atlas and Lambert merge, and antialiasing ----------------


def _painter_draw(n, device, layers=4, seed=5):
    """A painter draw (``concat_painter_draws``' columns) with every
    appearance column: round and triangle entries, sprites, per-entry texture
    state of ``layers`` atlas layers (random layer ids, true sizes below the
    atlas's extent, every map code, grids of 1-3 by 1-2), NaN-padded UVs,
    normals with per-entry Lambert setups (unlit entries at band 1), vertex
    colours, mode ids and cutoffs; and its [3, 24, 32, 4] atlas."""
    from bevy_hanabi_tpu_torch.render.extract import ParticleDrawData

    view, proj, t = _draw(n, device, seed)
    r = np.random.default_rng(seed)

    def col(*shape, lo=-1.5, hi=2.5):
        return torch.from_numpy(r.uniform(lo, hi, shape).astype(np.float32)).to(device)

    sizes = np.asarray([[32, 24], [17, 9], [8, 24]], np.float32)  # (w, h) of each layer
    tex = np.zeros((n, 2 + 4 * layers), np.float32)
    tex[:, 0] = r.integers(1, 4, n)
    tex[:, 1] = r.integers(1, 3, n)
    for k in range(layers):
        tid = r.integers(0, 3, n)
        tex[:, 2 + 4 * k] = tid
        tex[:, 3 + 4 * k: 5 + 4 * k] = sizes[tid]
        tex[:, 5 + 4 * k] = r.integers(0, 4, n)
    uv = col(n, 6)
    uv[: n // 3] = torch.nan
    light = col(n, 4, lo=-1.0, hi=1.0)
    light[: n // 4, 3] = 1.0
    tri = (col(n, lo=0, hi=1) > 0.4).to(torch.float32)
    # vertex colours on quads too, which extrapolate past 1 there: alpha
    # above 1, which a later ADD entry's unwritten lanes clamp
    vcol = col(n, 12, lo=0.0, hi=1.0)
    draw = ParticleDrawData(
        **t,
        roundness=col(n, lo=-0.5, hi=0.0),  # <= 0: no powf, so exact
        tri=tri,
        sprite_index=torch.from_numpy(r.integers(-9, 40, n).astype(np.int32)).to(device),
        uv_abc=uv, nrm_abc=col(n, 9), light_entry=light, vcol_abc=vcol,
        mode_id=torch.from_numpy(r.integers(0, 6, n).astype(np.int32)).to(device),
        alpha_cutoff=col(n, lo=0.0, hi=0.8),
        atlas=torch.from_numpy(r.uniform(0, 1, (3, 24, 32, 4)).astype(np.float32)).to(device),
        tex_entry=torch.from_numpy(tex).to(device),
    )
    return view, proj, draw


@pytest.mark.parametrize("slots,span", [(1, 2), (0, 2)])
@pytest.mark.parametrize("layers", [1, 4])
def test_project_bin_painter_columns_match_plain(cuda, layers, slots, span):
    """The painter's widest rows (13 + 53 = 65 floats at four atlas layers):
    tiles, depths and range equal, rows exact."""
    view, proj, draw = _painter_draw(5000, cuda, layers)
    cfg = raster.RasterConfig(128, 128, tile_slots=slots, tile_span=span)
    ap, inputs = raster.draw_appearance(draw, raster.ROW)
    assert ap.row == 49 + 4 * layers and ap.atlas_layers == layers
    extra = torch.stack([draw.alpha_cutoff, draw.mode_id.to(torch.float32)], dim=1)
    args = (draw.position, draw.axis_x, draw.axis_y, draw.alive, draw.color, view, proj, (128, 128),
            cfg.tile_size, cfg.tiles_x, cfg.tiles_y)
    kw = dict(extra=extra, row=raster.ROW, tile_slots=slots, tile_span=span, appearance=inputs)
    got = raster.project_bin(*args, **kw)
    want = raster.project_bin_plain(*args, **kw)
    assert got[2].shape == (5000, ap.row)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("from_start", [False, True])
@pytest.mark.parametrize("F", [36, 65])  # the painter frame's rows, the widest painter row
def test_gather_window_at_painter_widths_is_bit_exact(cuda, F, from_start):
    rows, pidx, starts, ends = _window_entries(1024, 64, F, torch.int64, seed=F)
    args = (rows.to(cuda), pidx.to(cuda), starts.to(cuda), ends.to(cuda), 64, from_start)
    got = gather.gather_window(*args)
    want = gather.gather_window_plain(*args)
    assert torch.equal(got[1], want[1]) and _bits_equal(got[0], want[0])


def _painter_window(cuda, layers, antialias=False, tile_size=16):
    view, proj, draw = _painter_draw(6000, cuda, layers)
    cfg = raster.RasterConfig(128, 128, tile_size=tile_size, tile_slots=0, antialias=antialias)
    ap, inputs = raster.draw_appearance(draw, raster.ROW)
    extra = torch.stack([draw.alpha_cutoff, draw.mode_id.to(torch.float32)], dim=1)
    projected = raster.project_bin(draw.position, draw.axis_x, draw.axis_y, draw.alive, draw.color,
                                   view, proj, (128, 128), cfg.tile_size, cfg.tiles_x, cfg.tiles_y,
                                   extra=extra, row=raster.ROW, tile_slots=0, appearance=inputs)
    sorted_ = raster.sort_tiles(projected[0], projected[1], cfg.num_tiles, None, projected[3])
    window, has = gather.gather_window(projected[2], *sorted_, 64, False)
    return cfg, ap, (draw.atlas,), window, has


def _check_blend(cfg, window, has, mode, depth_test, write_depth, **kw):
    """tile_blend against its plain version over a random seeded target:
    exact (max abs err 0, NaN where it is NaN), depth planes equal."""
    nt, T = cfg.num_tiles, cfg.tile_size
    kw.update(depth_test=depth_test, write_depth=write_depth)
    if depth_test:
        kw["scene_depth"] = torch.rand((nt, T, T), device=window.device) * 8.0
    fb0 = torch.rand((nt, T, T, 4), device=window.device)
    got = raster.tile_blend(window, has, T, cfg.tiles_x, cfg.tiles_y, (0.0, 0.0, 0.0, 0.0), mode,
                            framebuffer=fb0, **kw)
    want = raster.tile_blend_plain(window, has, T, cfg.tiles_x, cfg.tiles_y, (0.0, 0.0, 0.0, 0.0),
                                   mode, framebuffer=fb0, **kw)
    (fb_g, d_g), (fb_p, d_p) = (got, want) if write_depth else ((got, None), (want, None))
    assert int(((fb_p - fb0).abs() > 0).any(-1).sum()) > 0
    torch.testing.assert_close(fb_g, fb_p, rtol=0, atol=0, equal_nan=True)
    if write_depth:
        assert torch.equal(d_g, d_p)


def _painter_branches(window, has, ap, seed=9):
    """The binned painter window with its per-entry texture state and modes
    edited so that every branch of the kernel's per-entry layer terms runs:
    layer ids out of range, NaN and huge; true sizes non-integer, zero,
    negative, NaN, past the atlas's extent and past 2^22; map codes 0-3,
    NaN and others; grids of fractional columns and rows; and SCENE's
    ADD entries (mode 2) among them. Empty slots stay zero."""
    r = np.random.default_rng(seed)
    w = window.cpu().numpy().copy()
    nt, M, _ = w.shape
    o = ap.offset("tex")

    def pick(values, p_special=0.35, normal=None):
        vals = np.asarray(values, np.float32)
        out = r.choice(vals, (nt, M))
        return out if normal is None else np.where(r.random((nt, M)) < p_special, out, normal)

    w[..., o] = pick([1.0, 2.0, 3.0, 0.5, 2.5], normal=w[..., o])
    w[..., o + 1] = pick([1.0, 2.0, 1.5], normal=w[..., o + 1])
    for layer in range(ap.atlas_layers):
        e = o + 2 + 4 * layer
        w[..., e] = pick([-2.0, 0.0, 1.0, 2.0, 3.0, 7.0, np.nan, 1e10], normal=w[..., e])
        for k in (1, 2):
            w[..., e + k] = pick([32.0, 24.0, 17.0, 16.5, 0.0, -3.0, np.nan, 40.0, 2.0**23, 1e30,
                                  0.25], normal=w[..., e + k])
        w[..., e + 3] = r.choice(np.asarray([0.0, 1.0, 2.0, 3.0, np.nan, 1.5, 4.0, -1.0],
                                            np.float32), (nt, M))
    w[..., raster.COL_MODE] = r.choice(np.asarray([0, 1, 2, 2, 2, 3, 4, 5], np.float32), (nt, M))
    hv = has.cpu().numpy()
    w = np.where(hv[..., None], w, np.float32(0.0))
    return torch.from_numpy(w).to(window.device)


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("layers", [1, 4])
@pytest.mark.parametrize("case", ["binned", "per-entry branches", "32x32 tiles"])
def test_tile_blend_atlas_variant_matches_plain(cuda, case, layers, antialias):
    """SCENE with the painter's atlas and per-entry Lambert setups, plain
    and antialiased, exactly: on the binned window (16x16 tiles: the
    painter's compacted pass where not antialiased), on it with every
    per-entry branch edited in (:func:`_painter_branches`), and on 32x32
    tiles (the 1024-thread launch, pairs on their own lanes)."""
    cfg, ap, texs, window, has = _painter_window(cuda, layers, antialias,
                                                 32 if case == "32x32 tiles" else 16)
    if case == "per-entry branches":
        window = _painter_branches(window, has, ap)
    before = dict(raster.tile_blend.launches_antialias)
    _check_blend(cfg, window, has, "scene", True, True, appearance=ap, textures=texs,
                 antialias=antialias)
    assert raster.tile_blend.launches_antialias["scene"] == before["scene"] + int(antialias)


# every variant of tile_blend, each also antialiased: (mode, depth_test, write_depth)
BLEND_VARIANTS = [("blend", False, False), ("blend", True, False), ("add", False, False),
                 ("add", True, False), ("opaque", False, False), ("opaque", True, False),
                 ("opaque", True, True), ("mask", False, False), ("mask", True, False),
                 ("mask", True, True), ("scene", True, True), ("premultiply", False, False),
                 ("premultiply", True, False), ("multiply", False, False),
                 ("multiply", True, False)]


@pytest.mark.parametrize("mode,depth_test,write_depth", BLEND_VARIANTS)
def test_tile_blend_antialias_quad_variants_match_plain(cuda, mode, depth_test, write_depth):
    """Each antialiased quad variant on a real window (quads from sub-pixel
    to tens of pixels, random cutoffs and mode ids), exactly."""
    view, proj, t = _draw(8192, cuda, seed=21)
    cfg = raster.RasterConfig(128, 128, tile_slots=0, antialias=True)
    row = raster.row_width(mode, depth_test)
    extra = None
    if row == raster.ROW:
        extra = torch.stack([torch.rand(8192, device=cuda),
                             torch.randint(0, 6, (8192,), device=cuda).to(torch.float32)], dim=1)
    projected = raster.project_bin(t["position"], t["axis_x"], t["axis_y"], t["alive"], t["color"],
                                   view, proj, (128, 128), cfg.tile_size, cfg.tiles_x, cfg.tiles_y,
                                   extra=extra, row=row, tile_slots=0)
    sorted_ = raster.sort_tiles(projected[0], projected[1], cfg.num_tiles, None, projected[3])
    window, has = gather.gather_window(projected[2], *sorted_, 64, False)
    _check_blend(cfg, window, has, mode, depth_test, write_depth, antialias=True)


@pytest.mark.parametrize("mode,depth_test,write_depth", BLEND_VARIANTS)
@pytest.mark.parametrize("case", ["textured triangles", "lit triangles", "everything"])
def test_tile_blend_antialias_appearance_variants_match_plain(cuda, case, mode, depth_test,
                                                              write_depth):
    """Each of the fifteen antialiased appearance variants (the painter's
    SCENE on its atlas window) on a real window of textured, lit, round
    (roundness in [-0.2, 1], the squircle's powf: at most 0.2% of the
    pixels may differ) and flipbook entries; exact otherwise."""
    if mode == "scene":
        cfg, ap, texs, window, has = _painter_window(cuda, 2, True)
    else:
        cfg, ap, texs, window, has = _appearance_window(cuda, case, mode, depth_test)
        cfg = raster.RasterConfig(128, 128, tile_slots=0, antialias=True)
    if ap.offset("roundness") >= 0 and mode != "scene":
        nt, T = cfg.num_tiles, cfg.tile_size
        kw = dict(depth_test=depth_test, write_depth=write_depth, appearance=ap, textures=texs,
                  antialias=True)
        if depth_test:
            kw["scene_depth"] = torch.rand((nt, T, T), device=cuda) * 8.0
        fb0 = torch.rand((nt, T, T, 4), device=cuda)
        args = (window, has, T, cfg.tiles_x, cfg.tiles_y, (0.0, 0.0, 0.0, 0.0), mode)
        got = raster.tile_blend(*args, framebuffer=fb0, **kw)
        want = raster.tile_blend_plain(*args, framebuffer=fb0, **kw)
        fb_g, fb_p = (got[0], want[0]) if write_depth else (got, want)
        assert int(((fb_g - fb_p).abs() > 0).any(-1).sum()) <= 0.002 * nt * T * T
        return
    _check_blend(cfg, window, has, mode, depth_test, write_depth, appearance=ap, textures=texs,
                 antialias=True)


@pytest.mark.parametrize("antialias", [False, True])
def test_painter_add_entries_clamp_alpha_like_plain(cuda, antialias):
    """SCENE quads of HDR alpha (up to 1.6) among ADD entries: an ADD
    entry's uncovered, depth-failed or culled lanes clamp the pixel's alpha
    to 1 in its place, as JAX's (and the plain version's) zero-coverage
    lanes do; exactly."""
    view, proj, t = _draw(8192, cuda, seed=33)
    t["color"] = t["color"] * torch.tensor([1.0, 1.0, 1.0, 1.6], device=cuda)
    cfg = raster.RasterConfig(128, 128, tile_slots=0, antialias=antialias)
    extra = torch.stack([torch.rand(8192, device=cuda),
                         torch.randint(0, 6, (8192,), device=cuda).to(torch.float32)], dim=1)
    projected = raster.project_bin(t["position"], t["axis_x"], t["axis_y"], t["alive"], t["color"],
                                   view, proj, (128, 128), cfg.tile_size, cfg.tiles_x, cfg.tiles_y,
                                   extra=extra, row=raster.ROW, tile_slots=0)
    sorted_ = raster.sort_tiles(projected[0], projected[1], cfg.num_tiles, None, projected[3])
    window, has = gather.gather_window(projected[2], *sorted_, 64, False)
    nt, T = cfg.num_tiles, cfg.tile_size
    fb0 = torch.rand((nt, T, T, 4), device=cuda)
    kw = dict(framebuffer=fb0, depth_test=True, write_depth=True, antialias=antialias,
              scene_depth=torch.rand((nt, T, T), device=cuda) * 8.0)
    args = (window, has, T, cfg.tiles_x, cfg.tiles_y, (0.0, 0.0, 0.0, 0.0), "scene")
    (fb_g, d_g), (fb_p, d_p) = raster.tile_blend(*args, **kw), raster.tile_blend_plain(*args, **kw)
    assert bool((fb_p != fb0).any())
    torch.testing.assert_close(fb_g, fb_p, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(d_g, d_p)


def test_antialiased_additive_textured_flipbook_matches_plain(cuda):
    """An additive textured flipbook antialiased, which the JAX package
    renders: the kernel's ADD appearance variant launches (no refusal, no
    fallback to the plain version) and matches the plain version exactly."""
    cfg, ap, texs, window, has = _appearance_window(cuda, "flipbook", "add", False)
    cfg = raster.RasterConfig(128, 128, tile_slots=0, antialias=True)
    before = dict(raster.tile_blend.launches_antialias)
    _check_blend(cfg, window, has, "add", False, False, appearance=ap, textures=texs,
                 antialias=True)
    assert raster.tile_blend.launches_antialias["add"] == before["add"] + 1


def _painter_scene(device):
    """A painter scene of the port alone: a two-layer textured flipbook
    quad, an opaque lit icosphere, a differently lit textured icosphere
    sharing a texture object, a UV-less textured triangle and an additive
    quad (the compositions of test_torch_painter_atlas.py), stepped."""
    import bevy_hanabi_tpu_torch as bt
    from bevy_hanabi_tpu_torch.models import LambertianLightingModifier, make_circle_texture
    from bevy_hanabi_tpu_torch.render.mesh import ParticleMesh

    def phase(name, pos, mode, color):
        A = bt.attributes
        w = bt.ExprWriter()
        return (bt.EffectAsset(name, 4, bt.SpawnerSettings.once(1.0), w.finish())
                .init(bt.SetAttributeModifier(A.POSITION, w.lit(pos).expr()))
                .init(bt.SetAttributeModifier(A.LIFETIME, w.lit(100.0).expr()))
                .init(bt.SetAttributeModifier(A.HDR_COLOR, w.lit(color).expr()))
                .init(bt.SetAttributeModifier(A.SPRITE_INDEX, w.lit(3, None).expr()))
                .render(bt.SetSizeModifier((0.5, 0.5, 0.5)))
                .with_alpha_mode(getattr(bt.AlphaMode, mode.upper())))

    circle = make_circle_texture(16)
    ch = np.indices((8, 8)).sum(0) % 2
    checker = np.stack([ch, 1 - ch, np.zeros_like(ch), np.ones_like(ch)], -1).astype(np.float32)
    M = bt.ImageSampleMapping
    s = HanabiScene(seed=3, device=device)
    flip = phase("flip", (-0.5, 0.4, -0.5), "blend", (1, 1, 1, 0.9))
    flip.render(bt.FlipbookModifier((2, 2)))
    flip.render(bt.ParticleTextureModifier(0, M.MODULATE))
    flip.render(bt.ParticleTextureModifier(1, M.MODULATE_OPACITY_FROM_R))
    s.add(flip, "flip", textures=[checker, circle])
    ico = phase("ico", (0.0, 0.0, -0.5), "opaque", (0.8, 0.8, 0.8, 1.0)).with_mesh(
        ParticleMesh.icosphere(0.5, 1))
    s.add(ico.render(LambertianLightingModifier((1.0, 0.0, 0.0), 0.2)), "ico")
    tico = phase("tico", (0.5, -0.4, 0.0), "blend", (1, 1, 1, 0.8)).with_mesh(
        ParticleMesh.icosphere(0.4, 1))
    tico.render(bt.ParticleTextureModifier(0)).render(LambertianLightingModifier((0.0, 1.0, 0.0), 0.3))
    s.add(tico, "tico", textures=[circle])
    tri = phase("tri", (-0.4, -0.4, 0.3), "blend", (1, 1, 1, 0.8)).with_mesh(
        ParticleMesh(vertices=[[-0.5, -0.4, 0.0], [0.5, -0.4, 0.0], [0.0, 0.6, 0.0]],
                     indices=[[0, 1, 2]]))
    s.add(tri.render(bt.ParticleTextureModifier(0)), "tri", textures=[checker])
    s.add(phase("plain", (0.3, 0.5, 0.5), "add", (0.3, 0.3, 0.1, 1.0)), "plain")
    s.update(1 / 60.0)
    return s


@pytest.mark.parametrize("antialias", [False, True])
def test_painter_atlas_scene_on_the_card_matches_the_cpu(cuda, antialias):
    """The painter scene's frame (the atlas, two Lambert setups, meshes and
    quads) card against CPU within 1e-6 (every kernel rounds as its plain
    version; the stable sort orders ties alike on both)."""
    from bevy_hanabi_tpu_torch.render.camera import orthographic

    cam = CameraParams(look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0)),
                       orthographic(-1, 1, -1, 1, 0.1, 10.0), (64, 64))
    cfg = RasterConfig(64, 64, antialias=antialias)
    images = [_painter_scene(device).render(cam, cfg, background=(0, 0, 0, 0),
                                            pipeline="painter").cpu() for device in (cuda, "cpu")]
    assert float(images[1].sum()) > 0
    torch.testing.assert_close(images[0], images[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("slots", [1, 2, 0])
@pytest.mark.parametrize("y_offset", [0.0, 48.0, 96.0])
def test_project_bin_y_offset_matches_plain(cuda, slots, y_offset):
    """A slice's projection (``rasterize(y_offset=)``): the kernel moves the
    centres by the offset after the half-extents, as the plain version does;
    tiles, depths, range and rows equal."""
    view, proj, t = _draw(8192, cuda, seed=3)
    cfg = raster.RasterConfig(128, 32, tile_slots=slots)
    args = (t["position"], t["axis_x"], t["axis_y"], t["alive"], t["color"],
            view, proj, (128, 128), cfg.tile_size, cfg.tiles_x, cfg.tiles_y)
    kw = dict(raster_size=(128, 32), tile_slots=slots, y_offset=y_offset)
    got = raster.project_bin(*args, **kw)
    want = raster.project_bin_plain(*args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))
    base = raster.project_bin(*args, raster_size=(128, 32), tile_slots=slots)
    assert torch.equal(got[2][:, 1], base[2][:, 1] - y_offset)


@pytest.mark.parametrize("cards", ["one", "every"])
@pytest.mark.parametrize("mode", ["slice", "psum"])
def test_sharded_render_on_the_card_matches_the_cpu(cuda, mode, cards):
    """A (dp=2, sp=2) group on ``cuda:0`` (four shards on one card) or spread
    over every card (their kernels launched on each shard's card, the counts,
    routes and images copied between cards), stepped and rendered in slice
    and psum mode: pools equal to the same group stepped on the CPU, the
    image within 0.5% of the CPU's checksum and equal to the card's
    unsharded render (no tile overflows M)."""
    n = torch.cuda.device_count()
    if cards == "every" and n < 2:
        pytest.skip("needs two or more CUDA devices")
    from bevy_hanabi_tpu_torch import AlphaMode, EffectRenderer
    from bevy_hanabi_tpu_torch.models import spawn_gravity_effect
    from bevy_hanabi_tpu_torch.parallel import ShardedEffect, ShardedRenderer, make_mesh

    asset = spawn_gravity_effect(capacity=256, rate=0.0)
    if mode == "psum":
        asset = asset.with_alpha_mode(AlphaMode.ADD)
    cam = CameraParams(look_at((0.0, 0.0, 6.0), (0.0, 0.0, 0.0)), perspective(1.05, 1.0, 0.1, 100.0),
                       (128, 128))
    cfg = RasterConfig(128, 128, max_entries_per_tile=1024)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        devices = [dev] * 4
        if cards == "every" and dev.type == "cuda":
            devices = [torch.device("cuda", i % n) for i in range(4)]
        fx = ShardedEffect(asset, 4, make_mesh(devices, dp=2, sp=2), device=dev)
        pools = fx.create_pools()
        for f in range(4):
            ins = fx.make_inputs(np.asarray([40, 7, 90, 13], np.int32),
                                 np.arange(4, dtype=np.uint32) * 31 + f)
            pools, _ = fx.step(pools, fx.shard_inputs(ins), SimParams(time=f / 60, delta_time=1 / 60))
        r = ShardedRenderer(fx, cfg, mode=mode)
        out[dev.type] = (fx.assemble(pools), r.render(pools, cam),
                         EffectRenderer(asset, cfg).render(fx.assemble(pools).flatten(), cam))
    (pool_g, img_g, flat_g), (pool_c, img_c, _) = out["cuda"], out["cpu"]
    for a, b in zip(pool_g.to_numpy()[1:], pool_c.to_numpy()[1:]):
        np.testing.assert_array_equal(a, b)
    s_g, s_c = float(img_g.sum()), float(img_c.sum())
    assert s_g > 0 and abs(s_g - s_c) <= 0.005 * abs(s_c)
    torch.testing.assert_close(img_g, flat_g, rtol=0, atol=1e-5 if mode == "psum" else 0.0)
