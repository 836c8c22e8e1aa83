"""The headline's companion configs and JAX's default binning end to end, on the CPU.

``step_render_chunk`` of ``gradient_effect(8192)`` at the headline's three
companion configs (bench.py:470-563: ``slots2``, ``hifi``, ``exact``, at
128x128), and ``HanabiScene.render`` and ``update_render_chunk`` with no
config (``RasterConfig(width, height)``: ``tile_slots=0``) on a small
mixed scene under both pipelines, in both packages. Tolerances: alive
masks and PCG seeds bit for bit (the same integer ops); pixels within 1e-5
absolute (f32 blend rounding); checksums within 0.5% (bench.py:155-161).
"""

import math

import numpy as np
import pytest
import torch

import bevy_hanabi_tpu as bj
from bevy_hanabi_tpu.models import firework_effect as firework_j
from bevy_hanabi_tpu.models import firework_trail_effect as trail_j
from bevy_hanabi_tpu.models import gradient_effect as gradient_j
from bevy_hanabi_tpu.models import spawn_gravity_effect as gravity_j
from bevy_hanabi_tpu.render import camera as camera_j
from bevy_hanabi_tpu.render.raster import RasterConfig as CfgJ
from bevy_hanabi_tpu.runtime import HanabiScene as SceneJ
from bevy_hanabi_tpu_torch import CompiledEffect, EffectAsset, HanabiScene, RasterConfig
from bevy_hanabi_tpu_torch import SimParams, StepInputs
from bevy_hanabi_tpu_torch.render import camera as camera_t
from bevy_hanabi_tpu_torch.render.raster import fast_mode as raster_mode
from torch_jax_cache import jax_cache_of_the_module  # noqa: F401

REL = 0.005  # checksum tolerance (bench.py:155-161)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain raster path calls small vectorised ops thousands of times,
    each of which wakes OpenMP: run PyTorch single-threaded here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the headline's three companions (bench.py:470-472, 550), cut to 128x128
COMPANIONS = {
    "slots2": dict(tile_slots=2),
    "hifi": dict(tile_slots=2, tile_size=8),
    "exact": dict(tile_slots=0),
}


def _close_sum(got, want):
    got, want = float(np.asarray(got).sum()), float(np.asarray(want).sum())
    assert abs(got - want) <= REL * max(abs(want), 1.0), (got, want)


def _cam(mod, size, eye=(0.0, 0.0, 6.0)):
    return mod.CameraParams(mod.look_at(eye, (0.0, 0.0, 0.0)), mod.perspective(0.9, 1.0, 0.1, 100.0),
                            (size, size))


# ---- the headline's companion configs through step_render_chunk -------------


@pytest.mark.parametrize("companion", list(COMPANIONS))
def test_step_render_chunk_at_companion_configs_matches_jax(companion):
    from bevy_hanabi_tpu.compiler import SimParams as SimJ
    from bevy_hanabi_tpu.runtime.effect import CompiledEffect as EffectJ
    from bevy_hanabi_tpu.runtime.effect import StepInputs as InputsJ

    spawns = [4096, 1024, 2048]  # test_torch_slice.py's three frames at 2 s

    def frames(Inputs, Sim):
        return ([Inputs.make(s, 7 + 31 * i) for i, s in enumerate(spawns)],
                [Sim(time=2.0 * i, delta_time=2.0) for i in range(len(spawns))])

    cfg = COMPANIONS[companion]
    fx_j = EffectJ(gradient_j(8192))
    pool_j, img_j, sums_j = fx_j.step_render_chunk(
        fx_j.create_pool(), *fx_j.stack_frames(*frames(InputsJ, SimJ)),
        _cam(camera_j, 128), CfgJ(128, 128, **cfg))
    fx_t = CompiledEffect(EffectAsset.from_json(fx_j.asset.to_json()), device="cpu")
    pool_t, img_t, sums_t = fx_t.step_render_chunk(
        fx_t.create_pool(), *fx_t.stack_frames(*frames(StepInputs, SimParams)),
        _cam(camera_t, 128), RasterConfig(128, 128, **cfg))
    _, alive, seed, _ = pool_t.to_numpy()
    np.testing.assert_array_equal(alive, np.asarray(pool_j.alive))
    np.testing.assert_array_equal(seed, np.asarray(pool_j.seed))
    assert torch.isfinite(img_t).all()
    for got, want in zip(sums_t.tolist(), np.asarray(sums_j).tolist()):
        assert want > 0 and abs(got - want) <= REL * abs(want)


# ---- HanabiScene with no config: JAX's default binning ----------------------


def _persp(mod, size=128):
    return mod.CameraParams(
        view=mod.look_at((0.0, 0.0, 26.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
        proj=mod.perspective(math.radians(60.0), 1.0, 0.1, 200.0),
        viewport=(size, size),
    )


def _mixed_pair():
    """A small mixed scene (bench.py:672-774 cut down): opaque gravity
    debris, a gradient, rockets and their trails, in both packages."""
    build = [
        (gravity_j(capacity=1024, rate=2000.0).with_alpha_mode(bj.AlphaMode.OPAQUE), "opq", {}),
        (gradient_j(4096), "grad", {}),
        (firework_j(512), "rocket", {}),
        (trail_j(2048), "trail", {"parent": "rocket"}),
    ]
    sj, st = SceneJ(seed=3), HanabiScene(seed=3, device="cpu")
    for asset, name, kw in build:
        sj.add(asset, name, **kw)
        st.add(EffectAsset.from_json(asset.to_json()), name, **kw)
    return sj, st


def _assert_pools_equal(sj, st):
    for inst in sj.effects():
        _, alive, seed, _ = st[inst.name].pool.to_numpy()
        np.testing.assert_array_equal(alive, np.asarray(inst.pool.alive))
        np.testing.assert_array_equal(seed, np.asarray(inst.pool.seed))


@pytest.mark.parametrize("pipeline", ["auto", "split"])
def test_scene_render_with_no_config_matches_jax(pipeline):
    sj, st = _mixed_pair()
    for _ in range(3):
        sj.update(0.1)
        st.update(0.1)
    _assert_pools_equal(sj, st)
    img_j = np.asarray(sj.render(_persp(camera_j), pipeline=pipeline))
    img_t = st.render(_persp(camera_t), pipeline=pipeline).numpy()
    assert img_t.shape == (128, 128, 4) and np.isfinite(img_t).all()
    np.testing.assert_allclose(img_t, img_j, atol=1e-5)
    _close_sum(img_t, img_j)


@pytest.mark.parametrize("pipeline", ["auto", "split"])
def test_update_render_chunk_with_no_config_matches_jax(pipeline):
    sj, st = _mixed_pair()
    for _ in range(2):  # the first burst's rockets die in the second chunk
        img_j, sums_j = sj.update_render_chunk(8, 0.1, _persp(camera_j), pipeline=pipeline)
        img_t, sums_t = st.update_render_chunk(8, 0.1, _persp(camera_t), pipeline=pipeline)
        for got, want in zip(sums_t.tolist(), np.asarray(sums_j).tolist()):
            assert abs(got - want) <= REL * max(abs(want), 1.0)
    _assert_pools_equal(sj, st)
    assert int(st["trail"].pool.counter) > 0  # events flowed
    _close_sum(img_t.numpy(), np.asarray(img_j))


# ---- the JAX package's device checks at its own config (bench.py:200) -------


def test_gradient_render_8k_at_the_default_config_matches_jax():
    """bench.py:203-219: ``gradient_effect(8192)``, one step of 8192
    spawns, one frame through ``EffectRenderer`` at ``RasterConfig(128,
    128)`` (``tile_slots=0``)."""
    from bevy_hanabi_tpu.compiler import SimParams as SimJ
    from bevy_hanabi_tpu.render.renderer import EffectRenderer as RendererJ
    from bevy_hanabi_tpu.runtime.effect import CompiledEffect as EffectJ
    from bevy_hanabi_tpu.runtime.effect import StepInputs as InputsJ
    from bevy_hanabi_tpu_torch import EffectRenderer

    dt = 1.0 / 60.0
    g = gradient_j(8192)
    fx_j = EffectJ(g)
    pool_j, _ = fx_j.step(fx_j.create_pool(), InputsJ.make(8192, 3), SimJ(delta_time=dt))
    img_j = np.asarray(RendererJ(g, CfgJ(128, 128)).render(pool_j, _cam(camera_j, 128), SimJ()))
    asset = EffectAsset.from_json(g.to_json())
    fx_t = CompiledEffect(asset, device="cpu")
    pool_t, _ = fx_t.step(fx_t.create_pool(), StepInputs.make(8192, 3), SimParams(delta_time=dt))
    img_t = EffectRenderer(asset, RasterConfig(128, 128)).render(pool_t, _cam(camera_t, 128),
                                                                  SimParams()).numpy()
    _, alive, seed, _ = pool_t.to_numpy()
    np.testing.assert_array_equal(alive, np.asarray(pool_j.alive))
    np.testing.assert_array_equal(seed, np.asarray(pool_j.seed))
    assert img_t.shape == (128, 128, 4) and np.isfinite(img_t).all() and img_j.sum() > 0
    np.testing.assert_allclose(img_t, img_j, atol=1e-5)
    _close_sum(img_t, img_j)


# ---- the ribbon gate (bench.py:221-251) at the JAX package's own config ------


@pytest.fixture(scope="module")
def ribbon_gate_exact():
    """``ribbon_order_check_effect(8192, 64)``, 30 frames of 256 spawns,
    through ``step_render_chunk`` at ``RasterConfig(128, 128)`` (bench.py:200:
    ``tile_slots=0``) in both packages."""
    from bevy_hanabi_tpu.compiler import SimParams as SimJ
    from bevy_hanabi_tpu.models import ribbon_order_check_effect as check_j
    from bevy_hanabi_tpu.runtime.effect import CompiledEffect as EffectJ
    from bevy_hanabi_tpu.runtime.effect import StepInputs as InputsJ

    dt = 1.0 / 60.0
    fx_j = EffectJ(check_j(8192, 64))
    ins = [InputsJ.make(256, 7 * i + 1) for i in range(30)]
    sims = [SimJ(time=i * dt, delta_time=dt) for i in range(30)]
    pool_j, img_j, sums_j = fx_j.step_render_chunk(
        fx_j.create_pool(), *fx_j.stack_frames(ins, sims), _cam(camera_j, 128), CfgJ(128, 128))
    fx_t = CompiledEffect(EffectAsset.from_json(fx_j.asset.to_json()), device="cpu")
    ins = [StepInputs.make(256, 7 * i + 1) for i in range(30)]
    sims = [SimParams(time=i * dt, delta_time=dt) for i in range(30)]
    pool_t, img_t, sums_t = fx_t.step_render_chunk(
        fx_t.create_pool(), *fx_t.stack_frames(ins, sims), _cam(camera_t, 128), RasterConfig(128, 128))
    return (pool_j, np.asarray(img_j), np.asarray(sums_j)), (pool_t, img_t.numpy(), sums_t.numpy())


def test_ribbon_gate_at_exact_binning_state_is_bit_exact(ribbon_gate_exact):
    (pool_j, _, _), (pool_t, _, _) = ribbon_gate_exact
    _, alive, seed, counter = pool_t.to_numpy()
    np.testing.assert_array_equal(alive, np.asarray(pool_j.alive))
    np.testing.assert_array_equal(seed, np.asarray(pool_j.seed))
    assert int(counter) == int(pool_j.counter) == 30 * 256


def test_ribbon_gate_at_exact_binning_checksums_match_jax(ribbon_gate_exact):
    """Span^2 crops the long segment quads as JAX does, and a segment now
    has up to four entries, each in its own tile. The ADD pass takes the
    ``depth`` key (32 768 entries, 64 tiles), which ends in the entry index:
    unique per entry, so the sort's stability does not enter (ROADMAP
    Queue 3), and the images agree within f32 blend rounding."""
    (_, img_j, sums_j), (_, img_t, sums_t) = ribbon_gate_exact
    assert sums_t.shape == (30,) and np.isfinite(img_t).all()
    assert raster_mode(RasterConfig(128, 128), "add", 4 * 8192) == "depth"
    for got, want in zip(sums_t.tolist(), sums_j.tolist()):
        assert want > 0 and abs(got - want) <= REL * abs(want)
    _close_sum(img_t, img_j)
    np.testing.assert_allclose(img_t, img_j, atol=1e-5)
