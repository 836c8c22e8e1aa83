"""The port's mixed-scene path against the JAX package, on the CPU: the
opaque, mask and painter (``scene``) equations, the depth test, the seeded
framebuffer, the painter draw merge, ``HanabiScene.render`` through the
split and painter pipelines, frustum culling, and ``update_render_chunk``
(its three long cases in ``test_torch_painter_chunk_auto.py``,
``test_torch_painter_chunk_split.py`` and ``test_torch_painter_per_frame.py``,
the mixed scene they share in ``torch_painter_mixed.py``).

Every case feeds the same inputs to both packages: hand-built or
numpy-seeded draws, or assets built in the JAX package that cross to the
port as JSON. Tolerances: alive masks, PCG seeds and event counts bit for
bit (the same integer ops); on hand-built quads that involve no
transcendental (an orthographic view at 32 px a unit) pixels that only
select (opaque, mask, the depth planes) exactly equal, and blended pixels
within 1e-6 absolute, because XLA's CPU backend contracts a multiply and an
add into one fused op where PyTorch rounds twice (measured: one f32 ULP);
pixels within 1e-5 on random draws (f32 blend rounding); checksums within
0.5% (bench.py:155-161, the repo's device-gate tolerance).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_hanabi_tpu as bj
import bevy_hanabi_tpu_torch as bt
from bevy_hanabi_tpu.models import gradient_effect as gradient_j
from bevy_hanabi_tpu.models import spawn_gravity_effect as gravity_j
from bevy_hanabi_tpu.render import camera as camera_j
from bevy_hanabi_tpu.render.extract import ParticleDrawData as DrawJ
from bevy_hanabi_tpu.render.extract import concat_painter_draws as concat_j
from bevy_hanabi_tpu.render.raster import RasterConfig as CfgJ
from bevy_hanabi_tpu.render.raster import rasterize as rasterize_j
from bevy_hanabi_tpu_torch import EffectAsset, RasterConfig
from bevy_hanabi_tpu_torch.models import spawn_gravity_effect
from bevy_hanabi_tpu_torch.render import camera as camera_t
from bevy_hanabi_tpu_torch.render import raster
from bevy_hanabi_tpu_torch.render.extract import PAINTER_MODE_IDS, concat_painter_draws
from bevy_hanabi_tpu_torch.render.extract import ParticleDrawData as DrawT
from torch_jax_cache import jax_cache_of_the_module  # noqa: F401
from torch_painter_mixed import one_torch_thread  # noqa: F401
from torch_painter_mixed import REL, _close_sum, _debris, _mixed_pair, _persp, _scene_pair

DT = 1.0 / 60.0


def _ortho(cam_mod, w=64, h=64):
    return cam_mod.CameraParams(
        view=cam_mod.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0)),
        proj=cam_mod.orthographic(-1, 1, -1, 1, 0.1, 10.0),
        viewport=(w, h),
    )


def _draw_pair(d):
    """The same draw in both packages from numpy columns."""
    n = d["position"].shape[0]
    opt = {k: d.get(k) for k in ("alpha_cutoff", "mode_id")}
    draw_t = DrawT(
        *(torch.from_numpy(np.ascontiguousarray(d[k])) for k in ("position", "axis_x", "axis_y", "color", "alive")),
        **{k: None if v is None else torch.from_numpy(v) for k, v in opt.items()},
    )
    draw_j = DrawJ(
        position=jnp.asarray(d["position"]), axis_x=jnp.asarray(d["axis_x"]),
        axis_y=jnp.asarray(d["axis_y"]), color=jnp.asarray(d["color"]),
        alive=jnp.asarray(d["alive"]), roundness=None,
        sprite_index=jnp.zeros((n,), jnp.int32), sprite_grid_size=(1, 1),
        texture_layers=(), needs_uv=False,
        **{k: None if v is None else jnp.asarray(v) for k, v in opt.items()},
    )
    return draw_t, draw_j


def _quads(positions, colors, size=0.4, **extra):
    n = len(positions)
    d = {
        "position": np.asarray(positions, np.float32),
        "axis_x": np.tile(np.asarray([[size, 0.0, 0.0]], np.float32), (n, 1)),
        "axis_y": np.tile(np.asarray([[0.0, size, 0.0]], np.float32), (n, 1)),
        "color": np.asarray(colors, np.float32),
        "alive": np.ones(n, bool),
    }
    d.update({k: np.asarray(v, np.int32 if k == "mode_id" else np.float32) for k, v in extra.items()})
    return d


def _raster_both(d, cam_args=(), w=64, h=64, mode="blend", **kw):
    """``rasterize`` in both packages; ``kw`` numpy arrays are converted."""
    draw_t, draw_j = _draw_pair(d)
    cfg = dict(tile_slots=1, **kw.pop("config", {}))
    conv = {k: v for k, v in kw.items()}
    out_t = raster.rasterize(
        draw_t, _ortho(camera_t, w, h), raster.RasterConfig(w, h, **cfg), mode,
        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in conv.items()},
    )
    out_j = rasterize_j(
        draw_j, _ortho(camera_j, w, h), CfgJ(w, h, **cfg), mode,
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in conv.items()},
    )
    if isinstance(out_t, tuple):
        return tuple(o.numpy() for o in out_t), tuple(np.asarray(o) for o in out_j)
    return out_t.numpy(), np.asarray(out_j)


# ---- rasterize: equations on hand-built quads (test_render.py:115-128) ------


def test_opaque_nearest_wins_like_jax():
    d = _quads([[0.0, 0.0, -0.5], [0.0, 0.0, 0.5]], [[0.0, 0.0, 1.0, 1.0], [1.0, 0.0, 0.0, 1.0]])
    img_t, img_j = _raster_both(d, mode="opaque")
    np.testing.assert_array_equal(img_t, img_j)
    np.testing.assert_array_equal(img_t[32, 32], [1, 0, 0, 1])  # red is nearer


@pytest.mark.parametrize("cutoff,kept", [(0.5, False), (0.2, True)])
def test_mask_scalar_cutoff_like_jax(cutoff, kept):
    d = _quads([[0.0, 0.0, 0.0]], [[1.0, 1.0, 1.0, 0.3]])
    img_t, img_j = _raster_both(d, mode="mask", alpha_cutoff=cutoff)
    np.testing.assert_array_equal(img_t, img_j)
    assert bool(img_t[32, 32, 3] == 1.0) == kept


def test_mask_per_particle_cutoff_like_jax():
    # the same alpha 0.5 on both quads: cutoff 0.2 keeps the left, 0.9 drops the right
    d = _quads([[-0.5, 0.0, 0.0], [0.5, 0.0, 0.0]], [[1.0, 0.0, 0.0, 0.5]] * 2, alpha_cutoff=[0.2, 0.9])
    img_t, img_j = _raster_both(d, mode="mask")
    np.testing.assert_array_equal(img_t, img_j)
    assert img_t[32, 16, 3] == 1.0 and img_t[32, 48, 3] == 0.0


def test_scene_equation_all_six_modes_like_jax():
    # one quad of each painter mode, staggered in depth and overlapping, over
    # a coloured background so every term of the equation is exercised
    pos = [[-0.3 + 0.12 * k, 0.05 * k, -0.5 + 0.2 * k] for k in range(6)]
    col = [[0.9, 0.1, 0.2, 0.5], [0.2, 0.3, 0.1, 0.6], [0.1, 0.5, 0.9, 0.7],
           [0.5, 0.9, 0.4, 0.8], [0.3, 0.2, 0.8, 1.0], [0.7, 0.7, 0.1, 0.4]]
    d = _quads(pos, col, alpha_cutoff=[0.0] * 5 + [0.3], mode_id=list(range(6)))
    kw = dict(config=dict(background=(0.05, 0.1, 0.15, 1.0)))
    img_t, img_j = _raster_both(d, mode="scene", **kw)
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=1e-6)
    (img_t, depth_t), (img_j, depth_j) = _raster_both(d, mode="scene", return_depth=True, **kw)
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(depth_t, depth_j)
    assert np.isfinite(depth_t).any()


def _random_draw(seed, n=8192, modes=False):
    """The hand-built perspective draw of ``test_torch_raster.py`` with
    per-particle cutoffs and, for the painter, random mode ids."""
    r = np.random.default_rng(seed)
    rot = _persp(camera_t, 128, (0.5, 1.0, 6.0)).rotation.numpy()
    size = r.uniform(0.02, 0.4, (n, 2)).astype(np.float32)
    d = {
        "position": r.uniform(-2.5, 2.5, (n, 3)).astype(np.float32),
        "axis_x": (rot[:, 0][None, :] * size[:, :1]).astype(np.float32),
        "axis_y": (rot[:, 1][None, :] * size[:, 1:]).astype(np.float32),
        "color": r.uniform(0.0, 1.0, (n, 4)).astype(np.float32),
        "alive": r.random(n) < 0.9,
        "alpha_cutoff": r.uniform(0.0, 1.0, n).astype(np.float32),
    }
    if modes:
        d["mode_id"] = r.integers(0, 6, n).astype(np.int32)
    return d


@pytest.mark.parametrize("mode,M", [("opaque", 64), ("mask", 64), ("scene", 64), ("scene", 8)])
def test_random_draw_matches_jax(mode, M):
    d = _random_draw(7, modes=mode == "scene")
    draw_t, draw_j = _draw_pair(d)
    cfg = dict(tile_slots=1, max_entries_per_tile=M, background=(0.1, 0.2, 0.3, 1.0))
    cam = (0.5, 1.0, 6.0)
    img_t = raster.rasterize(draw_t, _persp(camera_t, 128, cam), raster.RasterConfig(128, 128, **cfg), mode)
    img_j = np.asarray(rasterize_j(draw_j, _persp(camera_j, 128, cam), CfgJ(128, 128, **cfg), mode))
    assert np.isfinite(img_t.numpy()).all()
    np.testing.assert_allclose(img_t.numpy(), img_j, atol=1e-5)
    _close_sum(img_t.numpy(), img_j)


# ---- rasterize: the depth test (test_render.py:699-752) ----------------------


@pytest.mark.parametrize("mode", ["blend", "add", "opaque"])
def test_scene_depth_occludes_like_jax(mode):
    depth = np.full((64, 64), np.inf, np.float32)
    depth[:, :32] = 4.75  # a wall on the left half, nearer than the quad at 5.0
    d = _quads([[0.0, 0.0, 0.0]], [[0.0, 1.0, 0.0, 1.0]], size=0.9)
    img_t, img_j = _raster_both(d, mode=mode, scene_depth=depth)
    np.testing.assert_array_equal(img_t, img_j)
    assert img_t[32, 20, 3] == 0.0 and img_t[32, 44, 3] > 0.0


def test_return_depth_writes_nearest_opaque_like_jax():
    d = _quads([[0.0, 0.0, 0.5], [0.3, 0.0, -0.5]], [[1.0, 0.0, 0.0, 1.0], [0.0, 0.0, 1.0, 1.0]])
    (img_t, depth_t), (img_j, depth_j) = _raster_both(d, mode="opaque", return_depth=True)
    np.testing.assert_array_equal(img_t, img_j)
    np.testing.assert_array_equal(depth_t, depth_j)
    np.testing.assert_allclose(depth_t[32, 32], 4.5, atol=1e-5)  # the overlap holds the nearest
    np.testing.assert_allclose(depth_t[32, 46], 5.5, atol=1e-5)
    assert np.isinf(depth_t[2, 2])
    with pytest.raises(ValueError, match="return_depth"):
        _raster_both(d, mode="blend", return_depth=True)


def test_return_depth_seeds_from_scene_depth_like_jax():
    wall = np.full((64, 64), 4.0, np.float32)
    d = _quads([[0.0, 0.0, 0.0]], [[1.0, 1.0, 1.0, 1.0]], size=0.5)
    (img_t, depth_t), (img_j, depth_j) = _raster_both(d, mode="opaque", scene_depth=wall, return_depth=True)
    np.testing.assert_array_equal(depth_t, depth_j)
    np.testing.assert_array_equal(depth_t, wall)  # the quad at 5.0 fails everywhere
    assert img_t[32, 32, 3] == 0.0


@pytest.mark.parametrize("mode", ["blend", "scene"])
def test_seeded_framebuffer_on_a_ragged_viewport_like_jax(mode):
    # 72x40 is no multiple of the 16-pixel tile: the seed pads to whole tiles
    w, h = 72, 40
    r = np.random.default_rng(3)
    fb = r.uniform(0.0, 1.0, (h, w, 4)).astype(np.float32)
    sd = np.where(r.random((h, w)) < 0.3, 4.8, np.inf).astype(np.float32)
    d = _quads([[-0.4, 0.1, 0.2], [0.1, -0.2, -0.3], [0.5, 0.3, 0.4]],
               [[0.9, 0.2, 0.1, 0.6], [0.1, 0.8, 0.3, 1.0], [0.3, 0.3, 0.9, 0.5]],
               alpha_cutoff=[0.0] * 3, mode_id=[0, 4, 2])
    img_t, img_j = _raster_both(d, w=w, h=h, mode=mode, framebuffer=fb, scene_depth=sd)
    assert img_t.shape == (h, w, 4)
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=1e-6)
    assert not np.array_equal(img_t, fb)  # the quads landed


def test_tile_round_trip():
    cfg = raster.RasterConfig(72, 40, tile_slots=1)
    img = torch.arange(40 * 72 * 4, dtype=torch.float32).reshape(40, 72, 4)
    tiles = raster.to_tiles(img, cfg, 0.0)
    assert tiles.shape == (cfg.num_tiles, 16, 16, 4) and tiles.is_contiguous()
    assert torch.equal(raster.untile(tiles, cfg), img)
    plane = raster.to_tiles(img[..., 0], cfg, torch.inf)
    assert torch.isinf(plane).sum() == cfg.num_tiles * 256 - 40 * 72


def test_tile_blend_refuses_an_impossible_variant():
    window = torch.zeros((4, 2, raster.ROW))
    has = torch.zeros((4, 2), dtype=torch.bool)
    with pytest.raises(ValueError, match="writes depth"):
        raster.tile_blend(window, has, 16, 2, 2, (0, 0, 0, 0), "blend", depth_test=True, write_depth=True)
    with pytest.raises(ValueError, match="scene"):
        raster.tile_blend(window, has, 16, 2, 2, (0, 0, 0, 0), "scene")


# ---- the painter draw merge (extract.py:384-619) -----------------------------


def test_concat_painter_draws_matches_jax():
    r = np.random.default_rng(1)
    kinds = ["opaque", "blend", "mask", "add"]
    ds = [_quads(r.uniform(-1, 1, (n, 3)), r.uniform(0, 1, (n, 4))) for n in (5, 7, 3, 4)]
    ds[2]["alpha_cutoff"] = r.uniform(0, 1, 3).astype(np.float32)
    pairs = [_draw_pair(d) for d in ds]
    got = concat_painter_draws([p[0] for p in pairs], kinds)
    want = concat_j([p[1] for p in pairs], kinds)
    np.testing.assert_array_equal(got.mode_id.numpy(), np.asarray(want.mode_id))
    np.testing.assert_array_equal(got.alpha_cutoff.numpy(), np.asarray(want.alpha_cutoff))
    for f in ("position", "axis_x", "axis_y", "color", "alive"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert PAINTER_MODE_IDS == {"blend": 0, "premultiply": 1, "add": 2, "multiply": 3, "opaque": 4, "mask": 5}
    # the atlas: the second draw textured (two layers of one 3x2 texture,
    # then a 2x5 one), the others padded with absent layers
    layers = ((0, bj.ImageSampleMapping.MODULATE), (1, bj.ImageSampleMapping.MODULATE_RGB))
    pairs[1] = tuple(dataclasses.replace(d, texture_layers=layers) for d in pairs[1])
    tex = [r.uniform(0, 1, (2, 3, 4)).astype(np.float32), r.uniform(0, 1, (5, 2, 4)).astype(np.float32)]
    texs_t = [[], [torch.from_numpy(t) for t in tex], [], []]
    texs_j = [[], [jnp.asarray(t) for t in tex], [], []]
    got = concat_painter_draws([p[0] for p in pairs], kinds, textures_per_draw=texs_t)
    want = concat_j([p[1] for p in pairs], kinds, textures_per_draw=texs_j)
    for f in ("atlas", "tex_entry"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert got.atlas.shape == (2, 5, 3, 4) and got.uv_abc is None and want.uv_abc is None


# ---- assets in both packages -------------------------------------------------


def _phase_asset(pkg, name, pos, mode, color, cutoff=0.5):
    """A 4-particle effect at one point (test_scene.py:1135-1154) in ``pkg``."""
    A = pkg.attributes
    w = pkg.ExprWriter()
    a = (
        pkg.EffectAsset(name, 4, pkg.SpawnerSettings.once(1.0), w.finish())
        .init(pkg.SetAttributeModifier(A.POSITION, w.lit(pos).expr()))
        .init(pkg.SetAttributeModifier(A.LIFETIME, w.lit(100.0).expr()))
        .init(pkg.SetAttributeModifier(A.HDR_COLOR, w.lit(color).expr()))
        .render(pkg.SetSizeModifier((0.5, 0.5, 0.5)))
    )
    if mode == "mask":
        return a.with_alpha_mode(pkg.AlphaMode.mask(w.lit(cutoff).expr()))
    return a.with_alpha_mode(getattr(pkg.AlphaMode, mode.upper()))


def test_debris_asset_json_is_equal_in_both_packages():
    assert _debris(bt).to_json() == _debris(bj).to_json()
    assert _debris(bt, 1024).signature() == _debris(bj, 1024).signature()
    crossed = EffectAsset.from_json(_debris(bj).to_json())
    assert crossed.to_json() == _debris(bj).to_json()
    # SetColorModifier crosses too, uniform CpuValue and mask included
    w = bj.ExprWriter()
    a = bj.EffectAsset("c", 16, bj.SpawnerSettings.once(4.0), w.finish()).render(
        bj.SetColorModifier(bj.CpuValue.uniform((0.0, 0.1, 0.2, 0.3), (1.0, 0.9, 0.8, 0.7)),
                            bj.ColorBlendMode.MODULATE, bj.ColorBlendMask.RGB)
    )
    assert EffectAsset.from_json(a.to_json()).to_json() == a.to_json()


@pytest.mark.parametrize("uniform", [False, True])
def test_set_color_and_size_render_like_jax(uniform):
    from bevy_hanabi_tpu.render.extract import extract_draw_data as extract_j
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data as extract_t

    w = bj.ExprWriter()
    color = (bj.CpuValue.uniform((0.0, 0.1, 0.2, 0.3), (1.0, 0.9, 0.8, 0.7)) if uniform
             else (0.2, 0.4, 0.6, 0.8))
    size = bj.CpuValue.uniform((0.1, 0.2, 0.3), (0.4, 0.5, 0.6)) if uniform else 0.25
    a = (
        bj.EffectAsset("cs", 64, bj.SpawnerSettings.once(64.0), w.finish())
        .init(bj.SetPositionSphereModifier(w.lit((0.0, 0.0, 0.0)).expr(), w.lit(1.0).expr(),
                                           bj.ShapeDimension.VOLUME))
        .render(bj.SetColorModifier(color, bj.ColorBlendMode.OVERWRITE, bj.ColorBlendMask.RGBA))
        .render(bj.SetSizeModifier(size))
    )
    fx_j = bj.CompiledEffect(a)
    pool_j, _ = fx_j.step(fx_j.create_pool(), bj.StepInputs.make(64, 3), bj.SimParams(delta_time=DT))
    pool_t = bt.ParticlePool.from_numpy(
        {k: np.asarray(v) for k, v in pool_j.attrs.items()}, np.asarray(pool_j.alive),
        np.asarray(pool_j.seed), np.asarray(pool_j.counter), device="cpu",
    )
    dj = extract_j(a, pool_j, _persp(camera_j))
    dt_ = extract_t(EffectAsset.from_json(a.to_json()), pool_t, _persp(camera_t))
    np.testing.assert_allclose(dt_.color.numpy(), np.asarray(dj.color), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dt_.axis_x.numpy(), np.asarray(dj.axis_x), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dt_.axis_y.numpy(), np.asarray(dj.axis_y), rtol=1e-6, atol=1e-6)


# ---- HanabiScene.render through both pipelines -------------------------------


def _pools_from_jax(sj, st):
    """Carry the JAX scene's pools and clock into the port's scene."""
    import copy

    for inst in sj.effects():
        p = inst.pool
        st[inst.name].pool = bt.ParticlePool.from_numpy(
            {k: np.asarray(v) for k, v in p.attrs.items()}, np.asarray(p.alive),
            np.asarray(p.seed), np.asarray(p.counter), device="cpu",
        )
    st.clock = copy.deepcopy(sj.clock)


def _painter_3fx():
    """The JAX package's painter device gate (bench.py:331-357)."""
    return [
        (gradient_j(capacity=2048), "blend", {}),
        (gradient_j(capacity=2048).with_alpha_mode(bj.AlphaMode.ADD), "add", {}),
        (gravity_j(capacity=1024, rate=2000.0).with_alpha_mode(bj.AlphaMode.OPAQUE), "opq", {}),
    ]


@pytest.fixture(scope="module")
def painter_3fx():
    sj, st = _scene_pair(_painter_3fx(), seed=9)
    for _ in range(3):
        sj.update(DT)
        st.update(DT)
    return sj, st


@pytest.mark.parametrize("pipeline", ["split", "painter", "auto"])
def test_painter_3fx_render_matches_jax(painter_3fx, pipeline):
    sj, st = painter_3fx
    for name in ("blend", "add", "opq"):
        np.testing.assert_array_equal(st[name].pool.to_numpy()[1], np.asarray(sj[name].pool.alive))
        np.testing.assert_array_equal(st[name].pool.to_numpy()[2], np.asarray(sj[name].pool.seed))
    cam = (0.0, 0.0, 6.0)
    cfg = dict(tile_slots=1)
    img_j = np.asarray(sj.render(_persp(camera_j, 128, cam), CfgJ(128, 128, **cfg), pipeline=pipeline))
    img_t = st.render(_persp(camera_t, 128, cam), RasterConfig(128, 128, **cfg), pipeline=pipeline)
    assert img_t.shape == (128, 128, 4) and torch.isfinite(img_t).all()
    _close_sum(img_t.numpy(), img_j)


def test_painter_3fx_return_depth_matches_jax(painter_3fx):
    sj, st = painter_3fx
    _pools_from_jax(sj, st)  # the same positions exactly, so the depth planes agree
    for pipeline in ("split", "painter"):
        img_j, d_j = sj.render(_persp(camera_j, 128, (0, 0, 6)), CfgJ(128, 128, tile_slots=1),
                               return_depth=True, pipeline=pipeline)
        img_t, d_t = st.render(_persp(camera_t, 128, (0, 0, 6)), RasterConfig(128, 128, tile_slots=1),
                               return_depth=True, pipeline=pipeline)
        np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-5)
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-6)
        assert np.isfinite(d_t.numpy()).any()


def _render_pair(build, pipeline, bg=(0.0, 0.0, 0.0, 0.0)):
    sj, st = _scene_pair(build)
    sj.update(DT)
    st.update(DT)
    img_j = np.asarray(sj.render(_ortho(camera_j), CfgJ(64, 64, tile_slots=1), background=bg, pipeline=pipeline))
    img_t = st.render(_ortho(camera_t), RasterConfig(64, 64, tile_slots=1), background=bg, pipeline=pipeline)
    return img_t.numpy(), img_j


def _t(z):
    t = np.eye(3, 4, dtype=np.float32)
    t[2, 3] = z
    return t


@pytest.mark.parametrize("pipeline", ["split", "painter"])
def test_transparent_behind_opaque_is_occluded_like_jax(pipeline):
    # test_scene.py:1157: the transparent emitter is nearer, its particles behind
    build = [
        (_phase_asset(bj, "op", (0.0, 0.0, 0.0), "opaque", (1.0, 0.0, 0.0, 1.0)), "op", {}),
        (_phase_asset(bj, "tr", (0.0, 0.0, -4.9), "blend", (0.0, 1.0, 0.0, 1.0)), "tr",
         {"transform": _t(4.0)}),
    ]
    img_t, img_j = _render_pair(build, pipeline)
    np.testing.assert_array_equal(img_t, img_j)
    np.testing.assert_array_equal(img_t[32, 32, :3], [1.0, 0.0, 0.0])


def test_opaque_interleave_and_mask_like_jax():
    # test_scene.py:1191: the nearer PARTICLE wins across an opaque and a mask pass
    build = [
        (_phase_asset(bj, "a", (0.0, 0.0, 0.5), "opaque", (1.0, 0.0, 0.0, 1.0)), "a", {}),
        (_phase_asset(bj, "b", (0.0, 0.0, -2.5), "mask", (0.0, 0.0, 1.0, 1.0)), "b", {"transform": _t(2.0)}),
    ]
    img_t, img_j = _render_pair(build, "split")
    np.testing.assert_array_equal(img_t, img_j)
    np.testing.assert_array_equal(img_t[32, 32, :3], [1.0, 0.0, 0.0])


def test_painter_matches_split_depth_separated_like_jax():
    # test_scene.py:1731: opaque + mask + blend + add over a coloured background
    build = [
        (_phase_asset(bj, "op", (0.0, 0.0, -0.8), "opaque", (0.2, 0.8, 0.2, 1.0)), "op", {}),
        (_phase_asset(bj, "ms", (0.3, 0.3, -0.4), "mask", (0.8, 0.8, 0.2, 0.9)), "ms", {}),
        (_phase_asset(bj, "bl", (0.1, -0.1, 0.2), "blend", (0.9, 0.1, 0.1, 0.5)), "bl", {}),
        (_phase_asset(bj, "ad", (-0.2, 0.1, 0.8), "add", (0.1, 0.1, 0.9, 0.7)), "ad", {}),
    ]
    bg = (0.05, 0.1, 0.15, 1.0)
    imgs = {p: _render_pair(build, p, bg) for p in ("split", "painter", "auto")}
    for img_t, img_j in imgs.values():
        np.testing.assert_allclose(img_t, img_j, atol=1e-6)
    np.testing.assert_allclose(imgs["painter"][0], imgs["split"][0], atol=1e-6)
    np.testing.assert_array_equal(imgs["auto"][0], imgs["painter"][0])


def test_painter_orders_transparents_across_effects_like_jax():
    # test_scene.py:1769: the far particle's emitter is the nearer one
    build = [
        (_phase_asset(bj, "a", (0.0, 0.0, -4.5), "blend", (1.0, 0.0, 0.0, 0.5)), "a", {"transform": _t(4.0)}),
        (_phase_asset(bj, "b", (0.0, 0.0, 0.5), "blend", (0.0, 0.0, 1.0, 0.5)), "b", {}),
    ]
    img_t, img_j = _render_pair(build, "painter")
    np.testing.assert_array_equal(img_t, img_j)
    np.testing.assert_allclose(img_t[32, 32, :3], [0.25, 0.0, 0.5], atol=1e-6)


def test_painter_mask_cutoff_honored_like_jax():
    # test_scene.py:1915
    build = [
        (_phase_asset(bj, "m", (0.0, 0.0, 0.0), "mask", (0.9, 0.9, 0.1, 0.3)), "m", {}),
        (_phase_asset(bj, "bl", (0.6, 0.6, 0.5), "blend", (0.9, 0.1, 0.1, 0.5)), "bl", {}),
    ]
    img_t, img_j = _render_pair(build, "painter")
    np.testing.assert_array_equal(img_t, img_j)
    np.testing.assert_array_equal(img_t[32, 32], [0, 0, 0, 0])


def test_batch_of_two_beside_a_mask_effect_like_jax():
    # two same-kind effects batch into one pass next to a mask effect, whose
    # draw carries the optional cutoff column the batch's draws lack
    build = [
        (_phase_asset(bj, "m", (0.0, 0.2, -0.5), "mask", (0.2, 0.9, 0.2, 0.8)), "m", {}),
        (_phase_asset(bj, "b1", (-0.2, 0.0, 0.0), "blend", (0.9, 0.1, 0.1, 0.5)), "b1", {}),
        (_phase_asset(bj, "b2", (0.2, 0.0, 0.3), "blend", (0.1, 0.1, 0.9, 0.5)), "b2", {}),
    ]
    _, st = _scene_pair(build)
    opaque, transp = st._scene_render_plan(st.effects(), _ortho(camera_t), "split")
    assert opaque == (("eff", 0, "mask"),) and transp == (("batch", (1, 2), "blend"),)
    img_t, img_j = _render_pair(build, "split")
    np.testing.assert_array_equal(img_t, img_j)
    assert img_t[32, 26, 0] > 0.0 and img_t[32, 38, 2] > 0.0


def test_scene_depth_and_return_depth_through_the_scene_like_jax():
    build = [
        (_phase_asset(bj, "op", (0.0, 0.0, 0.2), "opaque", (1.0, 0.5, 0.0, 1.0)), "op", {}),
        (_phase_asset(bj, "bl", (0.3, 0.0, 0.5), "blend", (0.0, 0.5, 1.0, 0.5)), "bl", {}),
    ]
    wall = np.full((64, 64), np.inf, np.float32)
    wall[:, :30] = 4.6
    for pipeline in ("split", "painter"):
        sj, st = _scene_pair(build)
        sj.update(DT)
        st.update(DT)
        img_j, d_j = sj.render(_ortho(camera_j), CfgJ(64, 64, tile_slots=1), scene_depth=jnp.asarray(wall),
                               return_depth=True, pipeline=pipeline)
        img_t, d_t = st.render(_ortho(camera_t), RasterConfig(64, 64, tile_slots=1), scene_depth=wall,
                               return_depth=True, pipeline=pipeline)
        np.testing.assert_array_equal(img_t.numpy(), np.asarray(img_j))
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
        assert d_t[32, 32] == pytest.approx(4.8) and d_t[32, 10] == pytest.approx(4.6)


# ---- frustum culling ---------------------------------------------------------


def test_frustum_helpers_match_jax():
    for cam_t, cam_j in ((_persp(camera_t), _persp(camera_j)), (_ortho(camera_t), _ortho(camera_j))):
        pt, pj = camera_t.frustum_planes(cam_t), camera_j.frustum_planes(cam_j)
        np.testing.assert_array_equal(pt, pj)
        for box in (((-1, -1, -1), (1, 1, 1)), ((0, 0, 30), (1, 1, 31)), ((50, 0, 0), (51, 1, 1))):
            assert camera_t.aabb_in_frustum(pt, *box) == camera_j.aabb_in_frustum(pj, *box)


def _cull_pair():
    # test_visibility.py:295 / test_scene.py:1513: one effect in view, one
    # behind the camera (both WhenVisible, the default condition)
    behind = np.eye(3, 4, dtype=np.float32)
    behind[2, 3] = 30.0
    return _scene_pair(
        [(gravity_j(capacity=256, rate=600.0), "vis", {}),
         (gravity_j(capacity=256, rate=600.0), "hidden", {"transform": behind})]
    )


def test_update_with_cameras_culls_like_jax():
    sj, st = _cull_pair()
    for _ in range(4):
        sj.update(DT, cameras=_persp(camera_j, 64, (0, 0, 6)))
        st.update(DT, cameras=_persp(camera_t, 64, (0, 0, 6)))
    for name in ("vis", "hidden"):
        assert st[name].alive_count() == sj[name].alive_count()
        np.testing.assert_array_equal(st[name].pool.to_numpy()[2], np.asarray(sj[name].pool.seed))
    assert st["vis"].alive_count() > 0 and st["hidden"].alive_count() == 0
    # without cameras the hidden effect steps again
    st.update(DT)
    assert st["hidden"].alive_count() > 0


def test_update_render_chunk_culls_and_pauses_like_jax():
    sj, st = _cull_pair()
    img_j, sums_j = sj.update_render_chunk(4, DT, _persp(camera_j, 64, (0, 0, 6)), CfgJ(64, 64, tile_slots=1))
    img_t, sums_t = st.update_render_chunk(4, DT, _persp(camera_t, 64, (0, 0, 6)), RasterConfig(64, 64, tile_slots=1))
    assert st["vis"].alive_count() == sj["vis"].alive_count() > 0
    assert st["hidden"].alive_count() == sj["hidden"].alive_count() == 0
    for a, b in zip(sums_t.tolist(), np.asarray(sums_j).tolist()):
        assert abs(a - b) <= REL * max(abs(b), 1.0)
    # a hidden WhenVisible effect neither steps nor draws; visible again, it does
    st.set_visible("vis", False)
    img, _ = st.update_render_chunk(4, DT, _ortho(camera_t), RasterConfig(64, 64, tile_slots=1),
                                    background=(0.0, 0.0, 0.0, 0.0))
    assert st["vis"].alive_count() == sj["vis"].alive_count() and float(img.max()) == 0.0
    st.set_visible("vis", True)
    img, _ = st.update_render_chunk(4, DT, _ortho(camera_t), RasterConfig(64, 64, tile_slots=1),
                                    background=(0.0, 0.0, 0.0, 0.0))
    assert float(img.max()) > 0.0


def test_mixed_plan_is_the_painter_under_auto():
    _, st = _mixed_pair()
    cam = _persp(camera_t)
    assert st._scene_render_plan(st.effects(), cam, "auto") == ((), (("painter", (0, 1, 2, 3), ()),))
    assert st._scene_render_plan(st.effects(), cam, "split") == (
        (("eff", 0, "opaque"),),
        (("eff", 1, "blend"), ("batch", (2, 3), "add")),
    )


def test_multi_view_chunk_raises():
    """A camera list through the mixed scene's render chunk (once refused):
    every frame renders both views, as in the JAX package."""
    sj, st = _mixed_pair()
    eye = (18.0, 6.0, 18.0)
    img_j, sums_j = sj.update_render_chunk(
        2, 0.1, [_persp(camera_j, 64), _persp(camera_j, 64, eye)], CfgJ(64, 64, tile_slots=1))
    img_t, sums_t = st.update_render_chunk(
        2, 0.1, [_persp(camera_t, 64), _persp(camera_t, 64, eye)], RasterConfig(64, 64, tile_slots=1))
    assert img_t.shape == (2, 64, 64, 4)
    for v in range(2):
        _close_sum(img_t[v].numpy(), np.asarray(img_j[v]))
    np.testing.assert_allclose(sums_t.numpy(), np.asarray(sums_j), rtol=REL)


def test_spawn_gravity_effect_json_is_equal_in_both_packages():
    assert spawn_gravity_effect(1024, 2000.0).to_json() == gravity_j(1024, 2000.0).to_json()
    assert spawn_gravity_effect().signature() == gravity_j().signature()


def test_config_is_aligned_and_background_defaults_like_jax():
    _, st = _mixed_pair()
    cfg, bg = st._frame_config(_persp(camera_t, 96), RasterConfig(64, 64, tile_slots=1), None)
    assert (cfg.width, cfg.height, bg) == (96, 96, (0.0, 0.0, 0.0, 0.0))
    cfg, bg = st._frame_config(_persp(camera_t, 96), None, None)
    assert dataclasses.astuple(cfg)[:2] == (96, 96) and bg == (0.0, 0.0, 0.0, 1.0)
