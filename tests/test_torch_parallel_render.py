"""The port's sharded rendering (``ShardedRenderer``: psum, gather, slice)
and slice rasterization (``rasterize(y_offset=)``) against the JAX
package's, on the CPU.

The JAX side renders on ``make_mesh(jax.devices()[:8], dp, sp)`` over
conftest.py's 8 virtual CPU devices, the port on the same factors over
``[torch.device("cpu")] * 8``; the pools are stepped in both from the same
numpy inputs. Mirrors tests/test_parallel.py's render cases. Tolerances:
where tests/test_parallel.py holds a sharded render to the single-device
render (no tile overflowing M), the port's sharded render equals its own
single-device render exactly; the port's psum image is within the JAX
psum test's atol 1e-4 of the JAX package's; every other image within 0.5%
of the JAX package's checksum (f32 blend arithmetic on positions a few
ULPs apart, the repo's device gate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_hanabi_tpu as bj
from bevy_hanabi_tpu.models import ribbon_bench_effect as ribbon_j
from bevy_hanabi_tpu.models import spawn_gravity_effect as gravity_j
from bevy_hanabi_tpu.parallel import ShardedEffect as ShardedJ
from bevy_hanabi_tpu.parallel import ShardedRenderer as RendererJ
from bevy_hanabi_tpu.parallel import make_mesh as make_mesh_j
from bevy_hanabi_tpu.render import raster as raster_j
from bevy_hanabi_tpu.render.camera import CameraParams as CamJ
from bevy_hanabi_tpu.render.mesh import ParticleMesh as MeshJ
from bevy_hanabi_tpu.runtime.effect import CompiledEffect as CompiledEffectJ
from bevy_hanabi_tpu_torch import EffectAsset, EffectRenderer, RasterConfig, SimParams
from bevy_hanabi_tpu_torch.parallel import ShardedEffect, ShardedRenderer, make_mesh
from bevy_hanabi_tpu_torch.parallel import render as prender
from bevy_hanabi_tpu_torch.render import raster
from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective
from bevy_hanabi_tpu_torch.render.extract import extract_draw_data
from torch_jax_cache import jax_cache_of_the_module  # noqa: F401

DT = 1.0 / 60.0
CPUS = [torch.device("cpu")] * 8
CHECKSUM_REL = 0.005


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_jax_cache(monkeypatch):
    """JAX effects here live in an empty ``CompiledEffect._CACHE``, the old
    dict put back after each test (see test_torch_utils.py)."""
    monkeypatch.setattr(CompiledEffectJ, "_CACHE", {})


def _port(asset_j) -> EffectAsset:
    return EffectAsset.from_json(asset_j.to_json())


def _camera(Cam, size=128):
    return Cam(look_at((0.0, 0.0, 6.0), (0.0, 0.0, 0.0)), perspective(1.05, 1.0, 0.1, 100.0),
               (size, size))


def _cfg(Cfg, **kw):
    return Cfg(**{"width": 128, "height": 128, "background": (0.0, 0.0, 0.0, 1.0),
                  "max_entries_per_tile": M, **kw})


# tests/test_parallel.py's populated pools at a quarter of their lanes and
# spawns (128 a pool; the fullest tile then holds 121 entries, so M = 128
# overflows no tile, where the JAX tests take 512 lanes and M = 512)
CAP = 128
SPAWN = np.asarray([10, 2, 0, 128, 3, 1, 25, 65], np.int32)
M = 128
OVERFLOW_M = 8  # the overflow cases' slots a tile


def _small(asset_j):
    """tests/test_parallel.py:109: particles small enough that no tile
    overflows M, the regime where every mode equals one device."""
    from bevy_hanabi_tpu.gradient import Gradient
    from bevy_hanabi_tpu.modifiers import SizeOverLifetimeModifier

    return asset_j.render(SizeOverLifetimeModifier(Gradient.linear((0.05,), (0.05,))))


def _populated(asset_j, dp, sp, ninst=8, cap=CAP, frames=4, spawn=None, seeds=None):
    """The JAX package's and the port's ShardedEffect stepped on the same
    inputs (tests/test_parallel.py:120-129)."""
    fx_j = ShardedJ(asset_j, ninst, make_mesh_j(jax.devices()[:8], dp=dp, sp=sp), capacity=cap)
    fx_t = ShardedEffect(_port(asset_j), ninst, make_mesh(CPUS, dp=dp, sp=sp), capacity=cap)
    spawn = SPAWN[:ninst] if spawn is None else spawn
    seeds = np.arange(ninst, dtype=np.uint32) * 31 + 2 if seeds is None else seeds
    pj, pt = fx_j.create_pools(), fx_t.create_pools()
    for f in range(frames):
        pj, _ = fx_j.step(pj, fx_j.shard_inputs(fx_j.make_inputs(spawn, seeds + f)),
                          bj.SimParams(time=f * DT, delta_time=DT))
        pt, _ = fx_t.step(pt, fx_t.shard_inputs(fx_t.make_inputs(spawn, seeds + f)),
                          SimParams(time=f * DT, delta_time=DT))
    np.testing.assert_array_equal(pt.to_numpy()[1], np.asarray(pj.alive))
    return fx_j, pj, fx_t, pt


def _single(fx_t, pools_t, cam, cfg, **kw):
    """The port's single-device render of the assembled pools."""
    return EffectRenderer(fx_t.asset, cfg).render(fx_t.assemble(pools_t).flatten(), cam, **kw)


def _checksum_close(got, want):
    got, want = float(np.sum(got)), float(np.sum(want))
    assert abs(got - want) <= CHECKSUM_REL * max(abs(want), 1.0), (got, want)


@pytest.mark.parametrize("dp,sp", [(4, 2), (2, 4), (8, 1)])
def test_sharded_render_psum_matches_single_device(dp, sp):
    """tests/test_parallel.py:132: additive compositing summed over the shards."""
    asset_j = _small(gravity_j(capacity=CAP, rate=0.0).with_alpha_mode(bj.AlphaMode.ADD))
    fx_j, pj, fx_t, pt = _populated(asset_j, dp, sp)
    bg = (0.02, 0.0, 0.1, 1.0)
    cfg_t = RasterConfig(background=bg, max_entries_per_tile=M)
    r = ShardedRenderer(fx_t, cfg_t)
    assert r.mode == "psum"
    img = r.render(pt, _camera(CameraParams)).numpy()
    img_j = np.asarray(RendererJ(fx_j, raster_j.RasterConfig(background=bg, max_entries_per_tile=M))
                       .render(pj, _camera(CamJ)))
    assert np.abs(img_j).max() > 0.05, "reference image is empty"
    np.testing.assert_allclose(img, img_j, atol=1e-4)
    np.testing.assert_allclose(img, _single(fx_t, pt, _camera(CameraParams), cfg_t).numpy(),
                               atol=1e-4)


def test_sharded_render_gather_matches_single_device():
    """tests/test_parallel.py:156: the draw data reassembled in natural order."""
    asset_j = _small(gravity_j(capacity=CAP, rate=0.0))
    fx_j, pj, fx_t, pt = _populated(asset_j, 4, 2)
    cam = _camera(CameraParams)
    cfg_t = _cfg(RasterConfig)
    img = ShardedRenderer(fx_t, cfg_t, mode="gather").render(pt, cam).numpy()
    img_j = np.asarray(RendererJ(fx_j, _cfg(raster_j.RasterConfig), mode="gather")
                       .render(pj, _camera(CamJ)))
    assert np.abs(img_j).max() > 0.05, "reference image is empty"
    _checksum_close(img, img_j)
    np.testing.assert_array_equal(img, _single(fx_t, pt, cam, cfg_t).numpy())


@pytest.mark.parametrize("dp,sp", [(4, 2), (1, 8)])
def test_sharded_render_slice_matches_single_device(dp, sp):
    """tests/test_parallel.py:175: one framebuffer slice a device from the
    routed entries, exact for order-dependent blending."""
    asset_j = _small(gravity_j(capacity=CAP, rate=0.0))
    fx_j, pj, fx_t, pt = _populated(asset_j, dp, sp)
    cam = _camera(CameraParams)
    cfg_t = _cfg(RasterConfig)
    r = ShardedRenderer(fx_t, cfg_t, slice_capacity_factor=8.0)
    assert r.mode == "slice"
    img = r.render(pt, cam).numpy()
    img_j = np.asarray(RendererJ(fx_j, _cfg(raster_j.RasterConfig), slice_capacity_factor=8.0)
                       .render(pj, _camera(CamJ)))
    assert np.abs(img_j).max() > 0.05, "reference image is empty"
    _checksum_close(img, img_j)
    np.testing.assert_array_equal(img, _single(fx_t, pt, cam, cfg_t).numpy())


def test_sharded_render_slice_opaque_writes_depth():
    """tests/test_parallel.py:203: the slices' depth planes stacked."""
    asset_j = _small(gravity_j(capacity=CAP, rate=0.0).with_alpha_mode(bj.AlphaMode.OPAQUE))
    fx_j, pj, fx_t, pt = _populated(asset_j, 4, 2)
    cam = _camera(CameraParams)
    cfg_t = _cfg(RasterConfig)
    img, dep = ShardedRenderer(fx_t, cfg_t, mode="slice", slice_capacity_factor=8.0).render(
        pt, cam, return_depth=True)
    img_j, dep_j = RendererJ(fx_j, _cfg(raster_j.RasterConfig), mode="slice",
                             slice_capacity_factor=8.0).render(pj, _camera(CamJ), return_depth=True)
    img_f, dep_f = _single(fx_t, pt, cam, cfg_t, return_depth=True)
    np.testing.assert_array_equal(img.numpy(), img_f.numpy())
    np.testing.assert_array_equal(dep.numpy(), dep_f.numpy())
    _checksum_close(img.numpy(), np.asarray(img_j))
    dj, dt = np.asarray(dep_j), dep.numpy()
    finite = np.isfinite(dj)
    assert finite.sum() > 10
    np.testing.assert_array_equal(np.isfinite(dt), finite)
    np.testing.assert_allclose(dt[finite], dj[finite], rtol=1e-4, atol=1e-4)


def test_sharded_render_slice_ribbons_match_single_device():
    """tests/test_parallel.py:233: particles route by composite ribbon id,
    each device connects whole trails, the segments route by slice."""
    asset_j = ribbon_j(capacity=512, num_ribbons=16).with_alpha_mode(bj.AlphaMode.ADD)
    fx_j, pj, fx_t, pt = _populated(asset_j, 1, 8, ninst=1, cap=512, frames=6,
                                    spawn=np.asarray([80], np.int32), seeds=np.asarray([1], np.uint32))
    cam = _camera(CameraParams)
    cfg_t = _cfg(RasterConfig, max_entries_per_tile=512)
    r = ShardedRenderer(fx_t, cfg_t, slice_capacity_factor=8.0)
    assert r.mode == "slice"  # ribbons force slice even for ADD
    img = r.render(pt, cam).numpy()
    img_j = np.asarray(RendererJ(fx_j, _cfg(raster_j.RasterConfig, max_entries_per_tile=512),
                                 slice_capacity_factor=8.0).render(pj, _camera(CamJ)))
    assert np.abs(img_j[..., :3]).max() > 0.05, "reference image is empty"
    _checksum_close(img, img_j)
    np.testing.assert_array_equal(img, _single(fx_t, pt, cam, cfg_t).numpy())


def test_sharded_render_slice_ribbons_of_instances():
    """Ribbons of 4 instances over (dp=2, sp=4): the composite id keeps each
    instance's trails apart, as the flat pool's composite ids do."""
    asset_j = ribbon_j(capacity=128, num_ribbons=8).with_alpha_mode(bj.AlphaMode.ADD)
    fx_j, pj, fx_t, pt = _populated(asset_j, 2, 4, ninst=4, frames=5,
                                    spawn=np.asarray([20, 10, 30, 15], np.int32))
    cam = _camera(CameraParams)
    cfg_t = _cfg(RasterConfig)
    img = ShardedRenderer(fx_t, cfg_t, slice_capacity_factor=8.0).render(pt, cam).numpy()
    img_j = np.asarray(RendererJ(fx_j, _cfg(raster_j.RasterConfig), slice_capacity_factor=8.0)
                       .render(pj, _camera(CamJ)))
    assert np.abs(img_j[..., :3]).max() > 0.05, "reference image is empty"
    _checksum_close(img, img_j)
    flat = fx_t.assemble(pt).flatten(composite_ribbon_ids=True)
    np.testing.assert_array_equal(img, EffectRenderer(fx_t.asset, cfg_t).render(flat, cam).numpy())


def test_sharded_render_slice_mesh_particles():
    """tests/test_parallel.py:269: triangle meshes expand locally, then route."""
    asset_j = _small(gravity_j(capacity=128, rate=0.0)).with_mesh(MeshJ.tetrahedron())
    fx_j, pj, fx_t, pt = _populated(asset_j, 1, 8, ninst=1, frames=1,
                                    spawn=np.asarray([32], np.int32), seeds=np.asarray([3], np.uint32))
    cam = _camera(CameraParams)
    cfg_t = _cfg(RasterConfig)
    img = ShardedRenderer(fx_t, cfg_t, mode="slice", slice_capacity_factor=8.0).render(pt, cam).numpy()
    img_j = np.asarray(RendererJ(fx_j, _cfg(raster_j.RasterConfig), mode="slice",
                                 slice_capacity_factor=8.0).render(pj, _camera(CamJ)))
    assert np.abs(img_j[..., :3]).max() > 0.01, "reference image is empty"
    _checksum_close(img, img_j)
    np.testing.assert_array_equal(img, _single(fx_t, pt, cam, cfg_t).numpy())


def test_sharded_render_validation():
    """tests/test_parallel.py:297 and the other refusals of render.py:220-256,
    474-489, raised where the JAX package raises them."""
    mesh_j, mesh_t = make_mesh_j(jax.devices()[:8], dp=4, sp=2), make_mesh(CPUS, dp=4, sp=2)
    blend = gravity_j(capacity=512, rate=0.0)
    add = gravity_j(capacity=512, rate=0.0).with_alpha_mode(bj.AlphaMode.ADD)
    ribbons = ribbon_j(capacity=512, num_ribbons=16)
    cases = [
        (blend, {"mode": "psum"}, "additive"),
        (blend, {"mode": "banana"}, "unknown mode"),
        (ribbons, {"mode": "gather"}, "quad effects only"),
        (blend, {"config": {"height": 100}}, "divisible"),
    ]
    for asset_j, kw, match in cases:
        cfg = kw.pop("config", {})
        fx_j = ShardedJ(asset_j, 8, mesh_j, capacity=512)
        fx_t = ShardedEffect(_port(asset_j), 8, mesh_t, capacity=512)
        with pytest.raises(ValueError, match=match):
            RendererJ(fx_j, raster_j.RasterConfig(**cfg), **kw)
        with pytest.raises(ValueError, match=match):
            ShardedRenderer(fx_t, RasterConfig(**cfg), **kw)
    fx_j, fx_t = ShardedJ(add, 8, mesh_j, capacity=512), ShardedEffect(_port(add), 8, mesh_t,
                                                                     capacity=512)
    with pytest.raises(ValueError, match="return_depth"):
        RendererJ(fx_j, raster_j.RasterConfig()).render(fx_j.create_pools(), _camera(CamJ),
                                                        return_depth=True)
    with pytest.raises(ValueError, match="return_depth"):
        ShardedRenderer(fx_t, RasterConfig()).render(fx_t.create_pools(), _camera(CameraParams),
                                                     return_depth=True)
    fx_t = ShardedEffect(_port(blend), 8, mesh_t, capacity=512)
    cam = CameraParams(look_at((0.0, 0.0, 6.0), (0.0, 0.0, 0.0)), perspective(1.05, 1.0, 0.1, 100.0),
                       (64, 60))
    with pytest.raises(ValueError, match="viewport height"):
        ShardedRenderer(fx_t, RasterConfig(128, 128)).render(fx_t.create_pools(), cam)


def test_sharded_render_scene_depth_matches_single_device():
    """tests/test_parallel.py:373: a scene depth plane occludes on every shard."""
    depth = np.full((128, 128), np.inf, np.float32)
    depth[:, :64] = 1.0  # a near wall over the left half
    for alpha, mode in ((bj.AlphaMode.ADD, "psum"), (bj.AlphaMode.BLEND, "slice")):
        asset_j = _small(gravity_j(capacity=CAP, rate=0.0).with_alpha_mode(alpha))
        fx_j, pj, fx_t, pt = _populated(asset_j, 4, 2)
        cam = _camera(CameraParams)
        cfg_t = RasterConfig(background=(0.0, 0.0, 0.0, 1.0), max_entries_per_tile=M)
        r = ShardedRenderer(fx_t, cfg_t)
        assert r.mode == mode
        img = r.render(pt, cam, scene_depth=torch.from_numpy(depth)).numpy()
        img_j = np.asarray(RendererJ(fx_j, raster_j.RasterConfig(background=(0.0, 0.0, 0.0, 1.0),
                                                                 max_entries_per_tile=M))
                           .render(pj, _camera(CamJ), scene_depth=jnp.asarray(depth)))
        # the open frame of one device (sharded and single-device renders
        # are held equal above and here)
        open_img = _single(fx_t, pt, cam, cfg_t).numpy()
        single = _single(fx_t, pt, cam, cfg_t, scene_depth=torch.from_numpy(depth)).numpy()
        np.testing.assert_allclose(img, single, atol=1e-4)
        if mode == "psum":
            np.testing.assert_allclose(img, img_j, atol=1e-4)
        else:
            _checksum_close(img, img_j)
        assert np.abs(open_img[:, :64] - img[:, :64]).max() > 0.01  # the wall occludes
        np.testing.assert_allclose(img[:, 64:], open_img[:, 64:], atol=1e-4)


def test_sharded_render_slice_capacity_truncation_is_graceful():
    """tests/test_parallel.py:529: past the routing capacity entries drop;
    the image stays finite and keeps at most the full image's energy, and
    the two packages drop the same entries."""
    from bevy_hanabi_tpu.gradient import Gradient
    from bevy_hanabi_tpu.modifiers import SizeOverLifetimeModifier

    asset_j = (gravity_j(capacity=512, rate=0.0).with_alpha_mode(bj.AlphaMode.ADD)
               .render(SizeOverLifetimeModifier(Gradient.linear((0.03,), (0.03,)))))
    fx_j, pj, fx_t, pt = _populated(asset_j, 1, 8, ninst=1, frames=1,
                                    spawn=np.asarray([512], np.int32), seeds=np.asarray([9], np.uint32))
    cam = _camera(CameraParams)
    cfg_t = _cfg(RasterConfig, background=(0.0, 0.0, 0.0, 0.0))
    full = ShardedRenderer(fx_t, cfg_t, mode="slice", slice_capacity_factor=8.0).render(pt, cam)
    tiny = ShardedRenderer(fx_t, cfg_t, mode="slice", slice_capacity_factor=0.01).render(pt, cam)
    tiny_j = RendererJ(fx_j, _cfg(raster_j.RasterConfig, background=(0.0, 0.0, 0.0, 0.0)),
                       mode="slice", slice_capacity_factor=0.01).render(pj, _camera(CamJ))
    full, tiny = full.numpy(), tiny.numpy()
    assert np.isfinite(tiny).all()
    assert 0.0 < tiny[..., :3].sum() <= full[..., :3].sum() + 1e-3
    _checksum_close(tiny, np.asarray(tiny_j))


def _tile_counts(fx_t, pools_t, cam, cfg):
    """Entries a tile of the assembled pools' draw at ``cfg``'s binning."""
    draw = extract_draw_data(fx_t.asset, fx_t.assemble(pools_t).flatten(), cam)
    tile = raster.project_bin_plain(
        draw.position, draw.axis_x, draw.axis_y, draw.alive, draw.color.contiguous(), cam.view,
        cam.proj, cam.viewport, cfg.tile_size, cfg.tiles_x, cfg.tiles_y, row=raster.ROW_QUAD,
        tile_slots=cfg.tile_slots)[0]
    tile = tile[tile < cfg.num_tiles]
    return torch.bincount(tile.long(), minlength=cfg.num_tiles)


@pytest.mark.parametrize("tile_slots", [0, 1])
@pytest.mark.parametrize("mode", ["psum", "slice"])
def test_sharded_render_under_overflow_matches_jax(mode, tile_slots):
    """The regime where the sharded frame is not one device's: full-size
    quads of 8 instances over (dp=4, sp=2) at M = 8, where most covered
    tiles overflow. psum (ADD) keeps M entries of a tile on each shard and
    sums them; slice (BLEND) keeps M of each slice's routed entries, which
    at tile_slots=1 include quads clamped into a slice's edge row and at
    tile_slots=0 are one device's. The port's overflowing frame against
    JAX's overflowing frame: psum within atol 1e-4, slice within 0.5% of
    the checksum, as the tests above."""
    alpha = bj.AlphaMode.ADD if mode == "psum" else bj.AlphaMode.BLEND
    asset_j = gravity_j(capacity=CAP, rate=0.0).with_alpha_mode(alpha)
    fx_j, pj, fx_t, pt = _populated(asset_j, 4, 2)
    cam = _camera(CameraParams)
    kw = dict(max_entries_per_tile=OVERFLOW_M, tile_slots=tile_slots)
    cfg_t = _cfg(RasterConfig, **kw)
    counts = _tile_counts(fx_t, pt, cam, cfg_t)
    covered, over = int((counts > 0).sum()), int((counts > OVERFLOW_M).sum())
    assert over > covered // 2, (over, covered)  # most covered tiles overflow
    img = ShardedRenderer(fx_t, cfg_t, mode=mode, slice_capacity_factor=8.0).render(pt, cam).numpy()
    img_j = np.asarray(RendererJ(fx_j, _cfg(raster_j.RasterConfig, **kw), mode=mode,
                                 slice_capacity_factor=8.0).render(pj, _camera(CamJ)))
    assert np.abs(img_j[..., :3]).max() > 0.05, "reference image is empty"
    single = _single(fx_t, pt, cam, cfg_t).numpy()
    if mode == "slice" and tile_slots == 0:
        # the exact binning has no clamp: each slice keeps one device's M
        np.testing.assert_array_equal(img, single)
    else:  # the overflow shows: the sharded frame is not the single-device one
        assert np.abs(img - single).max() > 1e-3
    if mode == "psum":
        np.testing.assert_allclose(img, img_j, atol=1e-4)
    else:
        _checksum_close(img, img_j)


@pytest.mark.parametrize("tile_slots", [0, 1, 2])
def test_rasterize_y_offset_slices_match_jax(tile_slots):
    """``rasterize(y_offset=)``: four 32-row slices of a 128² viewport, each
    against the JAX package's slice (checksums within 0.5%, pixels within
    1e-4), stitched back together; under the exact binning (``tile_slots=0``)
    the stitched image equals the full render, slice boundaries being tile
    boundaries."""
    from bevy_hanabi_tpu.render.extract import extract_draw_data as extract_j
    from bevy_hanabi_tpu.runtime.effect import CompiledEffect as EffectJ
    from bevy_hanabi_tpu.runtime.effect import StepInputs as InputsJ
    from bevy_hanabi_tpu_torch import CompiledEffect, StepInputs

    asset_j = gravity_j(capacity=2048, rate=0.0)
    fx_j, fx_t = EffectJ(asset_j), CompiledEffect(_port(asset_j), "cpu")
    pj, pt = fx_j.create_pool(), fx_t.create_pool()
    for f in range(4):
        pj, _ = fx_j.step(pj, InputsJ.make(200, f + 1), bj.SimParams(time=f * DT, delta_time=DT))
        pt, _ = fx_t.step(pt, StepInputs.make(200, f + 1), SimParams(time=f * DT, delta_time=DT))
    cam_t, cam_j = _camera(CameraParams), _camera(CamJ)
    draw_t = extract_draw_data(fx_t.asset, pt, cam_t)
    draw_j = extract_j(asset_j, pj, cam_j)
    kw = dict(tile_slots=tile_slots, max_entries_per_tile=256, background=(0.1, 0.0, 0.0, 1.0))
    slices_t = []
    for k in range(4):
        img_t = raster.rasterize(draw_t, cam_t, RasterConfig(128, 32, **kw), y_offset=32.0 * k)
        img_j = raster_j.rasterize(draw_j, cam_j, raster_j.RasterConfig(width=128, height=32, **kw),
                                   y_offset=32.0 * k)
        _checksum_close(img_t.numpy(), np.asarray(img_j))
        np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-4)
        slices_t.append(img_t)
    stitched = torch.cat(slices_t).numpy()
    assert np.abs(stitched[..., :3] - 0.1 * (np.arange(3) == 0)).max() > 0.05, "empty frame"
    if tile_slots == 0:
        full = raster.rasterize(draw_t, cam_t, RasterConfig(128, 128, **kw)).numpy()
        np.testing.assert_array_equal(stitched, full)


@pytest.mark.parametrize("row", [raster.ROW_QUAD, raster.ROW])
def test_project_bin_y_offset_moves_centres_only(row):
    """``project_bin_plain`` at a y offset: the row's centre y moves by it,
    everything else of the row is unchanged, and the bins are those of the
    centres moved (the kernel's card case is in test_torch_cuda.py)."""
    rng = np.random.default_rng(2)
    n = 300
    pos = torch.from_numpy(rng.uniform(-2, 2, (n, 3)).astype(np.float32))
    ax = torch.from_numpy(rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32))
    ay = torch.from_numpy(rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32))
    alive = torch.from_numpy(rng.random(n) < 0.9)
    color = torch.from_numpy(rng.random((n, 4)).astype(np.float32))
    cam = _camera(CameraParams)
    args = (pos, ax, ay, alive, color, cam.view, cam.proj, cam.viewport, 16, 8, 2)
    base = raster.project_bin_plain(*args, raster_size=(128, 32), row=row)
    moved = raster.project_bin_plain(*args, raster_size=(128, 32), row=row, y_offset=48.0)
    np.testing.assert_array_equal(moved[2][:, 1].numpy(), (base[2][:, 1] - 48.0).numpy())
    np.testing.assert_array_equal(moved[2][:, [0] + list(range(2, row))].numpy(),
                                  base[2][:, [0] + list(range(2, row))].numpy())
    assert not torch.equal(moved[0], base[0])


def test_pack_unpack_round_trip():
    """The route's rows carry every bit: floats (NaN, -0.0 and subnormals
    included), bools, int32 flipbook frames and the uint32 ribbon ids and
    counters past 2^31, through the rows and back."""
    rng = np.random.default_rng(5)
    n = 64
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    pos[0] = [np.nan, -0.0, 1e-40]
    draw = prender.ParticleDrawData(
        position=torch.from_numpy(pos), axis_x=torch.ones(n, 3), axis_y=torch.zeros(n, 3),
        color=torch.rand(n, 4), alive=torch.from_numpy(rng.random(n) < 0.5),
        sprite_index=torch.from_numpy(rng.integers(-5, 9, n).astype(np.int32)),
        ribbon_id=torch.from_numpy(rng.integers(0, 2**32, n)),
        counter=torch.from_numpy(rng.integers(2**31, 2**32, n)),
        age=torch.rand(n), sprite_grid_size=(2, 3),
    )
    rows, schema = prender._pack_draw(draw, prender._RIBBON_FIELDS)
    assert rows.dtype == torch.float32 and rows.shape == (n, 3 + 3 + 3 + 4 + 1 + 1 + 1 + 1 + 1)
    back = prender._unpack_draw(rows, schema, {"sprite_grid_size": (2, 3)})
    for name in ("position", "axis_x", "axis_y", "color", "alive", "sprite_index", "ribbon_id",
                 "counter", "age"):
        a, b = getattr(draw, name), getattr(back, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.is_floating_point():
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
        else:
            assert torch.equal(a, b), name
    assert back.sprite_grid_size == (2, 3) and back.roundness is None


@pytest.mark.parametrize("n,n_dev", [(1000, 8), (37, 3), (4096, 1)])
def test_route_keys_and_window_match_jax(n, n_dev):
    """The route's sort and window against a transcription of the JAX
    package's (render.py:163-194, before its ``all_to_all``): every
    destination's rows and validity equal, bit for bit."""
    rng = np.random.default_rng(n)
    dest0 = rng.integers(0, n_dev + 1, n)
    dest1 = np.where(rng.random(n) < 0.3, np.minimum(dest0 + 1, n_dev - 1), n_dev)
    rows = rng.standard_normal((n, 5)).astype(np.float32)
    cap = max(256, min(2 * n, -(-int(np.ceil(2 * n * 4.0 / n_dev)) // 256) * 256))
    entries, starts, ends = prender.route_keys(torch.from_numpy(dest0), torch.from_numpy(dest1), n_dev)
    send = prender.route_window(torch.from_numpy(rows), entries, starts, ends, cap).numpy()
    # the JAX package's lines
    n2 = 2 * n
    dests = jnp.concatenate([jnp.asarray(dest0), jnp.asarray(dest1)]).astype(jnp.uint32)
    idx_bits = max(1, int(np.ceil(np.log2(max(n2, 2)))))
    key = (dests << idx_bits) | jnp.arange(n2, dtype=jnp.uint32)
    (key_sorted,) = jax.lax.sort((key,), num_keys=1)
    r = jnp.searchsorted(key_sorted, jnp.arange(n_dev + 1, dtype=jnp.uint32) << idx_bits)
    raw = r[:-1, None] + jnp.arange(cap)[None, :]
    entry = (key_sorted[jnp.minimum(raw, n2 - 1)] & jnp.uint32((1 << idx_bits) - 1)).astype(jnp.int32)
    valid = np.asarray(raw < r[1:, None])
    want = np.asarray(jnp.take(jnp.asarray(rows), jnp.remainder(entry, n).reshape(-1), axis=0)
                      ).reshape(n_dev, cap, 5)
    np.testing.assert_array_equal(send[..., -1] > 0.5, valid)
    np.testing.assert_array_equal(send[..., :-1][valid], want[valid])
    assert valid.sum() == int(np.sum(dest0 < n_dev) + np.sum(dest1 < n_dev)) or cap < 2 * n
    delivered = prender.deliver([torch.from_numpy(send)] * 2, [torch.device("cpu")] * n_dev)
    assert len(delivered) == n_dev
    np.testing.assert_array_equal(delivered[0][0].numpy(), np.concatenate([send[0, :, :-1]] * 2))
