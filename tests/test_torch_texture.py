"""The port's textured, flipbook, round and screen-space-size particles and
its standalone premultiply and multiply equations against the JAX package,
on the CPU.

Every case feeds the same inputs to both packages: draws built from a numpy
seed, or assets built in the JAX package that cross to the port as JSON.
The JAX rasterizer runs as its own tests run it (XLA on the CPU; it reaches
no Pallas kernel). Tolerances:
* ``_bilinear_wrap``: exact (both call it eagerly, op for op);
* the render modifiers' JSON and the draw columns they set: equal; the
  screen-space size exactly;
* images: within 1e-5 absolute, because XLA's CPU backend contracts a
  multiply and an add of the blend into one fused op where PyTorch rounds
  twice (measured 1.2e-7 to 4.0e-7 on these draws, 1.7e-6 on the grid of
  3); the squircle within 1e-5 on all but 0.1% of the pixels, whose
  coverage may flip with the last ulp of ``pow`` (measured: none flips);
* stepped examples: alive masks and PCG seeds bit for bit, every frame's
  checksum within 0.5% (bench.py:155-161).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_hanabi_tpu as bj
import bevy_hanabi_tpu_torch as bt
from bevy_hanabi_tpu.models import examples as examples_j
from bevy_hanabi_tpu.models import texutils as texutils_j
from bevy_hanabi_tpu.render import camera as camera_j
from bevy_hanabi_tpu.render.extract import ParticleDrawData as DrawJ
from bevy_hanabi_tpu.render.extract import extract_draw_data as extract_j
from bevy_hanabi_tpu.render.raster import RasterConfig as CfgJ
from bevy_hanabi_tpu.render.raster import _bilinear_wrap
from bevy_hanabi_tpu.render.raster import rasterize as rasterize_j
from bevy_hanabi_tpu.runtime.effect import CompiledEffect as EffectJ
from bevy_hanabi_tpu.runtime.effect import StepInputs as InputsJ
from bevy_hanabi_tpu_torch.models import examples as examples_t
from bevy_hanabi_tpu_torch.models import texutils as texutils_t
from bevy_hanabi_tpu_torch.render import camera as camera_t
from bevy_hanabi_tpu_torch.render import raster
from bevy_hanabi_tpu_torch.render.extract import ParticleDrawData as DrawT
from bevy_hanabi_tpu_torch.render.extract import extract_draw_data as extract_t
from torch_jax_cache import jax_cache_of_the_module  # noqa: F401

SIZE = 64
ATOL = 1e-5  # XLA's fused multiply-adds (module docstring)
REL = 0.005  # checksum tolerance (bench.py:155-161)
DT = 1.0 / 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch's vectorised unary ops (floor, sqrt) hand even small tensors
    to OpenMP, whose wake-up costs milliseconds a call on a shared host, and
    the plain raster path calls them thousands of times: these tests run
    PyTorch single-threaded, and restore its thread count after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _camera(mod, size=SIZE, eye=(0.5, 1.0, 6.0)):
    return mod.CameraParams(mod.look_at(eye, (0.0, 0.0, 0.0)), mod.perspective(0.9, 1.0, 0.1, 100.0),
                            (size, size))


# ---- texture helpers and _bilinear_wrap --------------------------------------


@pytest.mark.parametrize("helper,args", [("make_circle_texture", (32, 0.2)),
                                         ("make_anim_sprite_sheet", (6, 16, False)),
                                         ("make_cloud_texture", (32, 3, 3))])
def test_texture_helpers_equal_the_jax_package(helper, args):
    np.testing.assert_array_equal(getattr(texutils_t, helper)(*args), getattr(texutils_j, helper)(*args))


@pytest.mark.parametrize("shape", [(16, 16), (8, 32), (5, 3)])  # square, a sprite sheet, odd
def test_bilinear_wrap_is_exact(shape):
    """Negative, > 1, huge and exactly-on-texel UVs, a non-square texture:
    equal to JAX's ``_bilinear_wrap`` bit for bit."""
    r = np.random.default_rng(shape[0])
    tex = r.uniform(0, 1, shape + (4,)).astype(np.float32)
    u = r.uniform(-3.0, 4.0, (200,)).astype(np.float32)
    v = r.uniform(-3.0, 4.0, (200,)).astype(np.float32)
    u[:8] = [0.0, 1.0, -1.0, 0.5 / shape[1], 1e7, -1e7, 2.0 - 2 ** -20, -0.0]
    v[:8] = [0.0, -1.0, 1.0, 0.5 / shape[0], -1e7, 1e7, -0.0, 3.0]
    want = np.asarray(_bilinear_wrap(lambda vi, ui: jnp.asarray(tex)[vi, ui], shape[1], shape[0],
                                     jnp.asarray(u), jnp.asarray(v)))
    got = raster.bilinear_wrap(torch.from_numpy(tex), torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), want)


# ---- render modifiers: JSON and the draw columns -----------------------------


def _modifier_pair(name):
    wj = bj.ExprWriter()
    mods = {
        "texture": lambda M: M.ParticleTextureModifier(1, M.ImageSampleMapping.MODULATE_OPACITY_FROM_R),
        "flipbook": lambda M: M.FlipbookModifier((3, 2)),
        "screen": lambda M: M.ScreenSpaceSizeModifier(),
        "round": lambda M: M.RoundModifier(wj.lit(0.4).expr()),
    }
    return mods[name]


@pytest.mark.parametrize("name", ["texture", "flipbook", "screen", "round"])
def test_render_modifiers_cross_as_json(name):
    import bevy_hanabi_tpu.modifiers as MJ
    import bevy_hanabi_tpu_torch.modifiers as MT

    mod_j = _modifier_pair(name)(MJ)
    mod_t = MT.modifier_from_json(mod_j.to_json())
    assert type(mod_t).__name__ == type(mod_j).__name__
    assert mod_t.to_json() == mod_j.to_json()


def _asset_j(render):
    w = bj.ExprWriter()
    a = (bj.EffectAsset("m", 64, bj.SpawnerSettings.once(64.0), w.finish())
         .init(bj.SetPositionSphereModifier(w.lit((0.0, 0.0, 0.0)).expr(), w.lit(1.5).expr(),
                                            bj.ShapeDimension.VOLUME))
         .init(bj.SetAttributeModifier(bj.attributes.LIFETIME, w.lit(10.0).expr()))
         .init(bj.SetAttributeModifier(bj.attributes.SIZE, (w.rand(bj.FLOAT) * 8.0 + 2.0).expr()))
         .init(bj.SetAttributeModifier(bj.attributes.SPRITE_INDEX,
                                       (w.rand(bj.FLOAT) * 13.0).cast(bj.INT).expr())))
    for m in render(w):
        a = a.render(m)
    return a


def _stepped(asset_j):
    fx_j = EffectJ(asset_j)
    pool_j, _ = fx_j.step(fx_j.create_pool(), InputsJ.make(64, 5), bj.SimParams(delta_time=DT))
    attrs = {k: np.asarray(v) for k, v in pool_j.attrs.items()}
    pool_t = bt.ParticlePool.from_numpy(attrs, np.asarray(pool_j.alive), np.asarray(pool_j.seed),
                                        int(pool_j.counter), "cpu")
    return pool_j, pool_t, bt.EffectAsset.from_json(asset_j.to_json())


def test_extracted_draw_columns_match_jax():
    """Roundness, the flipbook frame and grid, the texture layers, needs_uv
    and the screen-space size (ops/linalg mvp_w and mat4_mul) as the JAX
    package extracts them."""
    asset_j = _asset_j(lambda w: [bj.ParticleTextureModifier(0), bj.FlipbookModifier((4, 4)),
                                  bj.ScreenSpaceSizeModifier(), bj.RoundModifier(w.lit(0.5).expr())])
    pool_j, pool_t, asset_t = _stepped(asset_j)
    dj = extract_j(asset_j, pool_j, _camera(camera_j))
    dt = extract_t(asset_t, pool_t, _camera(camera_t))
    for f in ("position", "axis_x", "axis_y", "color", "roundness", "sprite_index"):
        np.testing.assert_array_equal(getattr(dt, f).numpy(), np.asarray(getattr(dj, f)), err_msg=f)
    assert dt.sprite_grid_size == dj.sprite_grid_size == (4, 4)
    assert [(s, m.value) for s, m in dt.texture_layers] == [(s, m.value) for s, m in dj.texture_layers]
    assert dt.needs_uv and dj.needs_uv and dt.lighting is None


# ---- the raster branches -----------------------------------------------------


def _quads(n, seed, size=(0.05, 0.5)):
    r = np.random.default_rng(seed)
    view = camera_t.look_at((0.5, 1.0, 6.0), (0.0, 0.0, 0.0))
    rot = camera_t.CameraParams(view, camera_t.perspective(0.9, 1.0, 0.1, 100.0), (SIZE, SIZE)).rotation.numpy()
    s = r.uniform(*size, (n, 2)).astype(np.float32)
    return {
        "position": r.uniform(-2.0, 2.0, (n, 3)).astype(np.float32),
        "axis_x": (rot[:, 0][None, :] * s[:, :1]).astype(np.float32),
        "axis_y": (rot[:, 1][None, :] * s[:, 1:]).astype(np.float32),
        "color": r.uniform(0.0, 1.0, (n, 4)).astype(np.float32),
        "alive": r.random(n) < 0.9,
    }


def _images(cols, static, mode="blend", textures=(), config=None):
    """The same draw through both rasterizers: ``cols`` numpy columns,
    ``static`` the draw's static state."""
    cfg = dict(width=SIZE, height=SIZE, **(config or {}))
    jfields = {k: jnp.asarray(v) for k, v in cols.items()}
    if "sprite_index" not in jfields:
        jfields["sprite_index"] = jnp.zeros(len(cols["alive"]), jnp.int32)
    if "roundness" not in jfields:
        jfields["roundness"] = None
    dj = DrawJ(**jfields, **{k: v for k, v in static.items()})
    dt = DrawT(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in cols.items()}, **static)
    img_j = np.asarray(rasterize_j(dj, _camera(camera_j), CfgJ(**cfg), mode,
                                   textures=[jnp.asarray(t) for t in textures]))
    img_t = raster.rasterize(dt, _camera(camera_t), raster.RasterConfig(**cfg), mode,
                             textures=[torch.from_numpy(t) for t in textures]).numpy()
    assert np.abs(img_j).sum() > 0
    return img_t, img_j


STATIC = dict(sprite_grid_size=(1, 1), texture_layers=(), needs_uv=False)


def test_texture_mappings_match_jax():
    """The three mappings as three layers in modifier order, over a
    non-square texture and a square one."""
    cols = _quads(600, 1)
    r = np.random.default_rng(3)
    cloud = texutils_t.make_cloud_texture(16, seed=2)
    cloud[..., :3] = r.uniform(0, 1, (16, 16, 3))
    sheet = r.uniform(0, 1, (8, 24, 4)).astype(np.float32)
    layers = ((1, bj.ImageSampleMapping.MODULATE), (0, bj.ImageSampleMapping.MODULATE_RGB),
              (1, bj.ImageSampleMapping.MODULATE_OPACITY_FROM_R))
    static = dict(STATIC, texture_layers=layers, needs_uv=True)
    got, want = _images(cols, static, textures=[cloud, sheet])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("grid", [(4, 2), (3, 2), (1, 5)])
def test_flipbook_cells_match_jax(grid):
    """Frames past the sheet and negative ones wrap as jnp.mod and
    jnp.floor_divide do; a grid of 3 divides as XLA compiles it."""
    cols = _quads(600, 2)
    cols["sprite_index"] = np.random.default_rng(4).integers(-7, 30, 600).astype(np.int32)
    sheet = texutils_t.make_anim_sprite_sheet(grid[0] * grid[1], 8)
    static = dict(STATIC, sprite_grid_size=grid, texture_layers=((0, bj.ImageSampleMapping.MODULATE),),
                  needs_uv=True)
    got, want = _images(cols, static, textures=[sheet])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("roundness", [1.0, 2.0 / 3.0, 0.15])
def test_squircle_matches_jax(roundness):
    cols = _quads(600, 3, size=(0.3, 0.9))
    cols["roundness"] = np.full(600, roundness, np.float32)
    cols["roundness"][:50] = 0.0  # a plain quad
    got, want = _images(cols, STATIC)
    off = np.abs(got - want).max(-1) > ATOL
    assert off.mean() <= 0.001, f"{int(off.sum())} pixels off"


LIGHT = (0.9, 0.8, 0.7, 1.0)  # multiply modulates what is there


@pytest.mark.parametrize("mode,config", [
    ("premultiply", dict(background=(0.2, 0.4, 0.6, 0.5))),
    ("premultiply", dict(tile_slots=2)),
    ("multiply", dict(background=LIGHT)),  # the fast "depth" path
    ("multiply", dict(background=LIGHT, overflow_policy="first")),
    ("multiply", dict(background=LIGHT, order_independent_fast=False)),
])
def test_premultiply_and_multiply_match_jax(mode, config):
    got, want = _images(_quads(900, 5), STATIC, mode=mode, config=config)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# ---- the examples: flipbook and squircle -------------------------------------


@pytest.mark.parametrize("example", ["example_circle", "example_2d"])
def test_examples_match_jax(example):
    """A few frames through ``step_render_chunk``: the assets' JSON equal,
    masks and seeds bit for bit, every frame's checksum within 0.5%."""
    asset_j = getattr(examples_j, example)()
    asset_t = getattr(examples_t, example)()
    assert asset_t.to_json() == asset_j.to_json()
    textures = [texutils_j.make_anim_sprite_sheet(8, 16)] if example == "example_circle" else []
    frames, spawn = 6, 40
    fx_j, fx_t = EffectJ(asset_j), bt.CompiledEffect(asset_t, device="cpu")
    ins_j = [InputsJ.make(spawn, 7 * i + 1) for i in range(frames)]
    ins_t = [bt.StepInputs.make(spawn, 7 * i + 1) for i in range(frames)]
    sims_j = [bj.SimParams(time=i * DT, delta_time=DT) for i in range(frames)]
    sims_t = [bt.SimParams(time=i * DT, delta_time=DT) for i in range(frames)]
    cam = (0.0, 0.0, 2.0)
    pool_j, _, sums_j = fx_j.step_render_chunk(fx_j.create_pool(), *fx_j.stack_frames(ins_j, sims_j),
                                               _camera(camera_j, eye=cam), CfgJ(SIZE, SIZE),
                                               tuple(jnp.asarray(t) for t in textures))
    pool_t, _, sums_t = fx_t.step_render_chunk(fx_t.create_pool(), *fx_t.stack_frames(ins_t, sims_t),
                                               _camera(camera_t, eye=cam),
                                               raster.RasterConfig(SIZE, SIZE), textures)
    np.testing.assert_array_equal(pool_t.alive.numpy(), np.asarray(pool_j.alive))
    np.testing.assert_array_equal(pool_t.to_numpy()[2], np.asarray(pool_j.seed))
    sums_j = np.asarray(sums_j)
    assert sums_j[-1] > 0
    np.testing.assert_allclose(sums_t.numpy(), sums_j, rtol=REL)


def test_texture_slot_past_the_list_raises_like_jax():
    cols = _quads(8, 6)
    static = dict(STATIC, texture_layers=((1, bj.ImageSampleMapping.MODULATE),), needs_uv=True)
    dt = DrawT(**{k: torch.from_numpy(v) for k, v in cols.items()}, **static)
    with pytest.raises(ValueError, match="texture slot 1"):
        raster.rasterize(dt, _camera(camera_t), raster.RasterConfig(SIZE, SIZE),
                         textures=[torch.zeros((2, 2, 4))])
