"""The port's auxiliary subsystems against the JAX package, on the CPU:
bloom and the tonemaps (tests/test_render.py:773), profiling spans and debug
capture, scene checkpoints (tests/test_utils.py:63-240) and their crossing
between the packages both ways, and ``DebugSettings.validate``
(tests/test_utils.py:247-432): each poisoned pool raises in the port where
the JAX package's checked executables raise, and a clean one raises in
neither.

Tolerances: integer state (alive masks, PCG seeds, counters, event counts)
bit for bit; float state rtol 1e-2 / atol 1e-3; bloom and the tonemaps
atol 1e-5; a resumed run equals the uninterrupted one exactly.
"""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_hanabi_tpu.models import firework_effect as firework_j
from bevy_hanabi_tpu.models import firework_trail_effect as trail_j
from bevy_hanabi_tpu.models import gradient_effect as gradient_j
from bevy_hanabi_tpu.models import spawn_gravity_effect as gravity_j
from bevy_hanabi_tpu.render import camera as camera_j
from bevy_hanabi_tpu.render import post as post_j
from bevy_hanabi_tpu.runtime import HanabiScene as SceneJ
from bevy_hanabi_tpu.runtime.effect import CompiledEffect as CompiledEffectJ
from bevy_hanabi_tpu.runtime.pool import ParticlePool as PoolJ
from bevy_hanabi_tpu.utils import load_scene_state as load_j
from bevy_hanabi_tpu.utils import save_scene_state as save_j
from bevy_hanabi_tpu_torch import HanabiScene, RasterConfig
from bevy_hanabi_tpu_torch.models import firework_effect, firework_trail_effect, gradient_effect
from bevy_hanabi_tpu_torch.models import spawn_gravity_effect
from bevy_hanabi_tpu_torch.render import bloom, tonemap_aces, tonemap_reinhard
from bevy_hanabi_tpu_torch.render import camera as camera_t
from bevy_hanabi_tpu_torch.runtime.effect import StepChecks
from bevy_hanabi_tpu_torch.runtime.pool import ParticlePool
from bevy_hanabi_tpu_torch.utils import (
    DebugSettings,
    load_scene_state,
    profile_span,
    save_scene_state,
)
from torch_jax_cache import jax_cache_of_the_module  # noqa: F401

DT = 1.0 / 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_jax_cache(monkeypatch):
    """Each test steps its JAX scenes on an empty ``CompiledEffect._CACHE``
    of the JAX package, and the old dict is put back after it. The
    validated JAX scenes here build checked executables on the cached
    effects, which the JAX package's own tests in the same process would
    otherwise get back (tests/test_utils.py:277 expects none)."""
    monkeypatch.setattr(CompiledEffectJ, "_CACHE", {})


def host(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# -- bloom and tonemaps ------------------------------------------------------


@pytest.mark.parametrize("sigma", [0.3, 2.5, 3.0, 4.0])
def test_bloom_and_tonemaps_match_jax(sigma):
    rng = np.random.default_rng(int(sigma * 10))
    img = (rng.random((48, 40, 4)) * 3.0).astype(np.float32)
    img[5, 7, :3] = 40.0  # one very bright pixel near a corner
    t, j = torch.from_numpy(img), jnp.asarray(img)
    for fn_t, fn_j in ((bloom, post_j.bloom), (tonemap_aces, post_j.tonemap_aces),
                       (tonemap_reinhard, post_j.tonemap_reinhard)):
        args = (1.0, sigma, 0.8) if fn_t is bloom else ()
        out = fn_t(t, *args).numpy()
        np.testing.assert_allclose(out, np.asarray(fn_j(j, *args)), atol=1e-5)
        np.testing.assert_array_equal(out[..., 3], img[..., 3])  # alpha passes through
    chain = tonemap_aces(bloom(t, 0.8, 2.5, 0.9)).numpy()
    np.testing.assert_allclose(chain, np.asarray(post_j.tonemap_aces(post_j.bloom(j, 0.8, 2.5, 0.9))),
                               atol=1e-5)


def test_bloom_glow_spreads_around_a_bright_pixel():
    img = torch.zeros((32, 32, 4))
    img[16, 16, :3] = 10.0
    out = bloom(img, threshold=1.0, sigma=2.0, intensity=1.0)
    assert out[16, 20, 0] > 0 and out[16, 30, 0] == 0  # radius int(3 * 2 + 0.5) = 6
    assert float(out[..., 3].abs().sum()) == 0.0


# -- profiling and capture -----------------------------------------------------


def test_profile_span_runs():
    with profile_span("hanabi:update"):
        x = torch.ones(8).sum()
    assert float(x) == 8.0


def _gravity_scene(seed=11):
    s = HanabiScene(seed=seed, device="cpu")
    s.add(spawn_gravity_effect(capacity=512, rate=120.0), "fx")
    return s


CAPTURE_CAMERA = camera_t.CameraParams(camera_t.look_at((0, 0, 26), (0, 0, 0)),
                                        camera_t.perspective(math.radians(60), 1, 0.1, 200),
                                        (64, 64))


def _trace_spans(directory) -> list:
    """The program spans of the one Chrome trace in ``directory``, in order."""
    (name,) = os.listdir(directory)
    with open(os.path.join(directory, name)) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events if e.get("name", "").startswith("hanabi:")]


def test_debug_capture_cycle(tmp_path):
    settings = DebugSettings(capture_dir=str(tmp_path / "trace"))
    s = _gravity_scene()
    s.debug = settings
    settings.start_capture_this_frame = True
    settings.capture_frame_count = 2
    s.update(DT)
    assert settings.is_capturing
    s.render(CAPTURE_CAMERA, RasterConfig(64, 64))
    s.update(DT)
    # a frame runs from one update to the next: the second one's render is to come
    assert settings.is_capturing
    s.render(CAPTURE_CAMERA, RasterConfig(64, 64))
    s.update(DT)
    assert not settings.is_capturing
    assert os.listdir(settings.capture_dir)  # a Chrome trace
    spans = _trace_spans(settings.capture_dir)
    assert spans.count("hanabi:update") == 2 and spans.count("hanabi:render") == 2
    assert spans.count("hanabi:raster") == 2


def test_capture_on_new_effect(tmp_path):
    s = _gravity_scene()
    s.update(DT)  # consume the initial new-effect flag
    s.debug = DebugSettings(start_capture_on_new_effect=True, capture_dir=str(tmp_path / "t2"))
    s.update(DT)
    assert not s.debug.is_capturing
    s.add(spawn_gravity_effect(capacity=64, rate=10.0), "fx2")
    s.update(DT)
    assert os.path.isdir(str(tmp_path / "t2"))
    # the one captured frame holds its render, and ends at the next update
    assert s.debug.is_capturing
    s.render(CAPTURE_CAMERA, RasterConfig(64, 64))
    s.update(DT)
    assert not s.debug.is_capturing
    spans = _trace_spans(str(tmp_path / "t2"))
    assert spans.count("hanabi:update") == 1 and "hanabi:raster" in spans


# -- checkpoints ---------------------------------------------------------------


def test_scene_checkpoint_roundtrip(tmp_path):
    s = _gravity_scene()
    for _ in range(45):
        s.update(DT)
    path = str(tmp_path / "scene.npz")
    save_scene_state(s, path)
    s2 = _gravity_scene(seed=99)
    load_scene_state(s2, path)
    assert s2["fx"].alive_count() == s["fx"].alive_count() > 0
    assert s2.clock.time == s.clock.time
    for a, b in zip(s2["fx"].pool.to_numpy()[1:], s["fx"].pool.to_numpy()[1:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(host(s2["fx"].pool.attrs["position"]),
                                  host(s["fx"].pool.attrs["position"]))
    s2.update(DT)
    assert abs(s2.clock.time - (s.clock.time + DT)) < 1e-9


def test_scene_checkpoint_resume_matches_uninterrupted(tmp_path):
    from bevy_hanabi_tpu_torch.cpu_value import CpuValue
    from bevy_hanabi_tpu_torch.spawn import SpawnerSettings

    def build(seed=29):
        asset = spawn_gravity_effect(capacity=512, rate=120.0).with_spawner(
            SpawnerSettings.burst(CpuValue.uniform(8.0, 32.0), 0.05))
        s = HanabiScene(seed=seed, device="cpu")
        s.add(asset, "fx")
        return s

    s = build()
    for _ in range(30):
        s.update(DT)
    path = str(tmp_path / "scene.npz")
    save_scene_state(s, path)
    s2 = build(seed=5)
    load_scene_state(s2, path)
    for _ in range(30):
        s.update(DT)
        s2.update(DT)
    assert s2["fx"].alive_count() == s["fx"].alive_count()
    for a, b in zip(s2["fx"].pool.to_numpy()[1:], s["fx"].pool.to_numpy()[1:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(host(s2["fx"].pool.attrs["position"]),
                                  host(s["fx"].pool.attrs["position"]))


def _tree_t(seed=3):
    s = HanabiScene(seed=seed, device="cpu")
    s.add(firework_effect(capacity=1024), "rocket")
    s.add(firework_trail_effect(capacity=4096), "trail", parent="rocket")
    return s


def _tree_j(seed=3):
    s = SceneJ(seed=seed)
    s.add(firework_j(capacity=1024), "rocket")
    s.add(trail_j(capacity=4096), "trail", parent="rocket")
    return s


def _run_until_events(s):
    for _ in range(240):
        s.update(DT)
        ev = s["rocket"].last_events.get(0)
        if ev is not None and int(ev.num_events) > 0:
            return int(ev.num_events)
    raise AssertionError("the rocket never emitted events")


def test_scene_checkpoint_preserves_in_flight_events(tmp_path):
    s = _tree_t()
    n_events = _run_until_events(s)
    path = str(tmp_path / "scene.npz")
    save_scene_state(s, path)
    s2 = _tree_t(seed=8)
    load_scene_state(s2, path)
    ev2 = s2["rocket"].last_events.get(0)
    assert ev2 is not None and int(ev2.num_events) == n_events
    assert set(ev2.payload) == set(s["rocket"].last_events[0].payload)
    before = s2["trail"].alive_count()
    s.update(DT)
    s2.update(DT)
    assert s2["trail"].alive_count() == s["trail"].alive_count() > before


def _state(s, name):
    attrs, alive, seed, counter = (
        s[name].pool.to_numpy() if isinstance(s, HanabiScene)
        else ({k: np.asarray(v) for k, v in s[name].pool.attrs.items()},
              np.asarray(s[name].pool.alive), np.asarray(s[name].pool.seed),
              np.asarray(s[name].pool.counter))
    )
    return attrs, alive, seed, counter


def _same_state(st, sj):
    for name in ("rocket", "trail"):
        (at, alt, set_, ct), (aj, alj, sej, cj) = _state(st, name), _state(sj, name)
        np.testing.assert_array_equal(alt, alj)
        np.testing.assert_array_equal(set_, sej)
        np.testing.assert_array_equal(ct, cj)
        np.testing.assert_allclose(at["position"], aj["position"], rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_cross_between_the_packages(tmp_path, direction):
    """A checkpoint one package wrote (with events in flight) loads in the
    other, built from a different seed, and both continue identically: the
    pools, spawner cycles, RNG streams, clock and events crossed."""
    path = str(tmp_path / "cross.npz")
    if direction == "jax_to_port":
        src, dst = _tree_j(), _tree_t(seed=77)
        n_events = _run_until_events(src)
        save_j(src, path)
        load_scene_state(dst, path)
        st, sj = dst, src
    else:
        src, dst = _tree_t(), _tree_j(seed=77)
        n_events = _run_until_events(src)
        save_scene_state(src, path)
        load_j(dst, path)
        st, sj = src, dst
    assert int(st["rocket"].last_events[0].num_events) == n_events
    assert int(sj["rocket"].last_events[0].num_events) == n_events
    assert st.clock.time == sj.clock.time
    _same_state(st, sj)
    for _ in range(6):
        st.update(DT)
        sj.update(DT)
    assert st["trail"].alive_count() == sj["trail"].alive_count() > 0
    _same_state(st, sj)


def test_pool_save_load_crosses_both_ways(tmp_path):
    s = _tree_t()
    _run_until_events(s)
    pool = s["trail"].pool
    pool.save(str(tmp_path / "t.npz"))
    pj = PoolJ.load(str(tmp_path / "t.npz"))
    attrs, alive, seed, counter = pool.to_numpy()
    np.testing.assert_array_equal(np.asarray(pj.alive), alive)
    np.testing.assert_array_equal(np.asarray(pj.seed), seed)
    assert np.asarray(pj.seed).dtype == np.uint32
    for k, v in attrs.items():
        np.testing.assert_array_equal(np.asarray(pj.attrs[k]), v)
    pj.save(str(tmp_path / "j"))
    back = ParticlePool.load(str(tmp_path / "j"), "cpu")
    for a, b in zip(back.to_numpy()[1:], (alive, seed, counter)):
        np.testing.assert_array_equal(a, b)
    for k, v in attrs.items():
        np.testing.assert_array_equal(back.to_numpy()[0][k], v)


def test_checkpoint_resume_through_fused_scene_chunk(tmp_path):
    cam = camera_t.CameraParams(
        view=camera_t.look_at((0.0, 3.0, 8.0), (0.0, 3.0, 0.0)),
        proj=camera_t.perspective(math.radians(60.0), 1.0, 0.1, 100.0),
        viewport=(64, 64),
    )
    cfg = RasterConfig(width=64, height=64)

    def build():
        s = HanabiScene(seed=21, device="cpu")
        s.add(firework_effect(capacity=512), "p")
        s.add(firework_trail_effect(capacity=2048), "c", parent="p")
        return s

    s = build()
    s.update_render_chunk(6, DT, cam, cfg)
    path = str(tmp_path / "mid.ckpt")
    save_scene_state(s, path)
    img_cont, sums_cont = s.update_render_chunk(6, DT, cam, cfg)
    fresh = build()
    load_scene_state(fresh, path)
    img_res, sums_res = fresh.update_render_chunk(6, DT, cam, cfg)
    np.testing.assert_array_equal(img_cont.numpy(), img_res.numpy())
    np.testing.assert_array_equal(sums_cont.numpy(), sums_res.numpy())


# -- debug validation ----------------------------------------------------------


def _poison_j(pool):
    pos = np.array(pool.get("position"))
    pos[..., 0, :] = np.float32(np.nan)
    alive = np.array(pool.alive)
    alive[..., 0] = True
    attrs = dict(pool.attrs)
    attrs["position"] = jnp.asarray(pos)
    return PoolJ(attrs=attrs, alive=jnp.asarray(alive), seed=pool.seed, counter=pool.counter)


def _poison_t(pool):
    """One ALIVE lane (the first of each instance) whose position is NaN
    (the 0xFFFFFFFF poison bit pattern read as f32)."""
    pos = pool.attrs["position"].clone()
    pos[..., 0, :] = float("nan")
    alive = pool.alive.clone()
    alive[..., 0] = True
    return ParticlePool({**pool.attrs, "position": pos}, alive, pool.seed, pool.counter)


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the outcome is what is compared
        return "nan" in str(e).lower(), type(e).__name__
    return None


def _gravity(Scene, gravity, capacity, **kw):
    s = Scene(seed=0, **kw)
    s.add(gravity(capacity=capacity, rate=60.0), "fx")
    return s


def _case_update(Scene, gravity, poison, **kw):
    s = _gravity(Scene, gravity, 256, **kw)
    s.update(DT)
    s["fx"].pool = poison(s["fx"].pool)
    s.update(DT)  # validation off: the corrupt frame steps silently
    s["fx"].pool = poison(s["fx"].pool)
    s.debug.validate = True
    return lambda: s.update(DT)


def _case_update_chunk(Scene, gravity, poison, **kw):
    s = _gravity(Scene, gravity, 128, **kw)
    s.update_chunk(2, DT)
    s["fx"].pool = poison(s["fx"].pool)
    s.debug.validate = True
    return lambda: s.update_chunk(2, DT)


def _case_family(Scene, firework, trail, poison, **kw):
    s = Scene(seed=4, **kw)
    s.add(firework(capacity=128), "rocket")
    s.add(trail(capacity=512), "trail", parent="rocket")
    s.update_chunk(2, DT)
    s["trail"].pool = poison(s["trail"].pool)
    s.debug.validate = True
    return lambda: s.update_chunk(2, DT)


def _case_group(Scene, gravity, poison, chunk, **kw):
    s = Scene(seed=0, **kw)
    s.add_group(gravity(capacity=64, rate=60.0), 4, "grp")
    (s.update_chunk(2, DT) if chunk else s.update(DT))
    g = s._groups["grp"]
    g["pools"] = poison(g["pools"])
    s.debug.validate = True
    return (lambda: s.update_chunk(2, DT)) if chunk else (lambda: s.update(DT))


def _case_aabb(Scene, gravity, poison, cam, **kw):
    s = _gravity(Scene, gravity, 256, **kw)
    s.update(DT)
    s["fx"].pool = poison(s["fx"].pool)
    s.debug.validate = True
    return lambda: s.update(DT, cameras=cam)


def _case_poison_pools(Scene, firework, trail, **kw):
    """Pools from create_pool(poison=True): NaN in every dead lane."""
    s = Scene(seed=4, **kw)
    s.add(firework(capacity=128), "rocket")
    s.add(trail(capacity=512), "trail", parent="rocket")
    for inst in s.effects():
        inst.pool = inst.fx.create_pool(inst.pool.capacity, poison=True)
    s.debug.validate = True
    return lambda: [s.update(DT) for _ in range(3)]


def _case_clean(Scene, gradient, cam, cfg, **kw):
    s = Scene(seed=1, **kw)
    s.add(gradient(capacity=256), "fx")
    s.debug.validate = True

    def run():
        for _ in range(3):
            s.update(DT)
        s.update_chunk(2, DT)
        img = s.render(cam, cfg, pipeline="split")
        assert np.isfinite(host(img)).all() and s["fx"].alive_count() > 0

    return run


def _case_render(Scene, gravity, poison, cam, cfg, **kw):
    """A poisoned live lane reaching render() with validation on: the
    phase-split frame is checked for non-finite pixels."""
    s = _gravity(Scene, gravity, 256, **kw)
    s.update(DT)
    s["fx"].pool = poison(s["fx"].pool)
    s.debug.validate = True
    return lambda: s.render(cam, cfg, pipeline="split")


def _case_render_nan_color(Scene, gravity, color, cam, cfg, pipeline, **kw):
    """A NaN colour reaching the framebuffer: the phase-split frame raises,
    the painter frame is not checked (scene.py:2447-2458 returns first)."""
    s = Scene(seed=1, **kw)
    s.add(gravity(capacity=256, rate=60.0).render(color((float("nan"), 0.0, 0.0, 1.0))), "fx")
    for _ in range(5):
        s.update(DT)
    s.debug.validate = True
    return lambda: s.render(cam, cfg, pipeline=pipeline)


def _cam(mod):
    return mod.CameraParams(view=mod.look_at(np.asarray([0.0, 0.0, 6.0]), np.zeros(3)),
                            proj=mod.perspective(math.radians(60.0), 1.0, 0.1, 100.0),
                            viewport=(32, 32))


def _cases(side):
    from bevy_hanabi_tpu.modifiers import SetColorModifier as ColorJ
    from bevy_hanabi_tpu.render.raster import RasterConfig as CfgJ
    from bevy_hanabi_tpu_torch.modifiers import SetColorModifier as ColorT

    if side == "port":
        S, P, C, kw = HanabiScene, _poison_t, ColorT, {"device": "cpu"}
        grav, fw, tr, grad, cam, cfg = (spawn_gravity_effect, firework_effect,
                                        firework_trail_effect, gradient_effect, _cam(camera_t),
                                        RasterConfig(32, 32))
    else:
        S, P, C, kw = SceneJ, _poison_j, ColorJ, {}
        grav, fw, tr, grad, cam, cfg = (gravity_j, firework_j, trail_j, gradient_j, _cam(camera_j),
                                        CfgJ(width=32, height=32))
    return {
        "update": lambda: _case_update(S, grav, P, **kw),
        "update_chunk": lambda: _case_update_chunk(S, grav, P, **kw),
        "family_chunk": lambda: _case_family(S, fw, tr, P, **kw),
        "group_update": lambda: _case_group(S, grav, P, False, **kw),
        "group_chunk": lambda: _case_group(S, grav, P, True, **kw),
        "aabb": lambda: _case_aabb(S, grav, P, cam, **kw),
        "poison_pools": lambda: _case_poison_pools(S, fw, tr, **kw),
        "clean": lambda: _case_clean(S, grad, cam, cfg, **kw),
        "render": lambda: _case_render(S, grav, P, cam, cfg, **kw),
        "render_nan_split": lambda: _case_render_nan_color(S, grav, C, cam, cfg, "split", **kw),
        "render_nan_painter": lambda: _case_render_nan_color(S, grav, C, cam, cfg, "painter",
                                                             **kw),
    }


@pytest.mark.parametrize("case", ["update", "update_chunk", "family_chunk", "group_update",
                                  "group_chunk", "aabb", "poison_pools", "clean", "render",
                                  "render_nan_split", "render_nan_painter"])
def test_validate_raises_where_jax_raises(case):
    readbacks = StepChecks.readbacks
    run_t = _cases("port")[case]()
    # building the case ran frames with validation off: nothing was checked
    assert StepChecks.readbacks == readbacks
    got = _outcome(run_t)
    want = _outcome(_cases("jax")[case]())
    assert (got is None) == (want is None), (got, want)
    if want is not None:
        assert got[0] and want[0], (got, want)  # both messages say "nan"
    if case == "clean":
        assert StepChecks.readbacks > readbacks


def test_validated_jax_case_leaves_the_jax_cache_clean():
    """The fixture above at work: a validated JAX case stepped on its own
    cache builds checked executables, and once that cache is put back a
    fresh JAX scene on the same asset gets an effect without one, as
    tests/test_utils.py:277 needs."""
    outer = CompiledEffectJ._CACHE
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CompiledEffectJ, "_CACHE", {})
        assert _outcome(_cases("jax")["update"]()) is not None
        assert any(fx._jit_step_checked is not None for fx in CompiledEffectJ._CACHE.values())
    assert CompiledEffectJ._CACHE is outer
    fresh = SceneJ(seed=0)
    fresh.add(gravity_j(capacity=256, rate=60.0), "fx")
    assert fresh["fx"].fx._jit_step_checked is None


def test_validate_traps_poison_in_update_render_chunk():
    """The whole-scene step+render chunk traps poison, with one readback for
    the chunk (the JAX package's checked scan raises here too,
    tests/test_utils.py:386-410)."""
    s = HanabiScene(seed=0, device="cpu")
    s.add(spawn_gravity_effect(capacity=128, rate=60.0), "fx")
    cam = _cam(camera_t)
    s.update_render_chunk(2, DT, cam)
    readbacks = StepChecks.readbacks
    s.debug.validate = True
    s.update_render_chunk(2, DT, cam)  # clean: passes
    assert StepChecks.readbacks == readbacks + 1
    s["fx"].pool = _poison_t(s["fx"].pool)
    with pytest.raises(FloatingPointError, match="nan"):
        s.update_render_chunk(2, DT, [cam, cam])


def test_validate_bounds_the_parent_pool_gather():
    """A child stepped from a payload-less event buffer reads its parent's
    pool by slot: under validation an out-of-range slot raises IndexError,
    tested before the gather, which reads the clamped slots."""
    from bevy_hanabi_tpu_torch.compiler import SimParams
    from bevy_hanabi_tpu_torch.runtime.effect import CompiledEffect, StepInputs
    from bevy_hanabi_tpu_torch.runtime.events import EventBuffer

    s = _tree_t()
    rocket, trail = s["rocket"], s["trail"]
    cap = rocket.pool.capacity
    ev = EventBuffer(torch.full((cap,), cap + 5, dtype=torch.int64),
                     torch.ones((cap,), dtype=torch.int64), torch.tensor(cap, dtype=torch.int32))
    fx = CompiledEffect(trail.asset, "cpu", parent_layout=rocket.asset.particle_layout())
    assert fx._inherited_attrs  # the trail reads its parent's attributes
    with pytest.raises(IndexError, match="parent pool"):
        fx.step_checked(fx.create_pool(), StepInputs.make(), SimParams(delta_time=DT),
                        events_in=ev, parent_pool=rocket.pool)
