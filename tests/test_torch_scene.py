"""The port's HanabiScene on the firework event tree against the JAX package,
on the CPU.

The 2k -> 8k tree of the JAX package's device gate (bench.py:253-293):
``firework_effect(2048)`` emits OnDie events (count 4) into
``firework_trail_effect(8192)``. The gate's 30 frames of 1/60 s end before
the first rocket dies (ages start below 0.2 s, lifetimes at 0.8 s), so no
event would flow; these tests take 30 frames of 1/20 s instead, in which
rockets die, events flow and trails spawn. Tolerances are the gate's:
alive counts, alive masks, PCG seeds and the event buffers' slots, counts
and lengths bit for bit (the same integer ops); positions, the event
payload included, rtol 1e-2 / atol 1e-3 (transcendental ULPs);
the rendered ADD frame's checksum within 0.5% (bench.py:155-161).
"""

import numpy as np
import pytest
import torch

from bevy_hanabi_tpu.models import firework_effect as firework_j
from bevy_hanabi_tpu.models import firework_trail_effect as trail_j
from bevy_hanabi_tpu.models import gradient_effect as gradient_j
from bevy_hanabi_tpu.render.camera import CameraParams as CamJ
from bevy_hanabi_tpu.render.raster import RasterConfig as CfgJ
from bevy_hanabi_tpu.runtime import HanabiScene as SceneJ
from bevy_hanabi_tpu.runtime.effect import CompiledEffect as CompiledEffectJ
from bevy_hanabi_tpu_torch import HanabiScene, RasterConfig
from bevy_hanabi_tpu_torch.models import firework_effect, firework_trail_effect, gradient_effect
from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective
from torch_jax_cache import jax_cache_of_the_module  # noqa: F401

FRAMES = 30
DT = 1.0 / 20.0


@pytest.fixture(autouse=True)
def _fresh_jax_cache(monkeypatch):
    """Each test steps its JAX scenes on an empty ``CompiledEffect._CACHE``
    of the JAX package, and the old dict is put back after it: a validated
    JAX scene here would otherwise leave checked executables in the cache
    for the JAX package's own tests in the same process
    (tests/test_utils.py:277 expects none)."""
    monkeypatch.setattr(CompiledEffectJ, "_CACHE", {})


def _scene_j():
    s = SceneJ(seed=17)
    s.add(firework_j(2048), "rocket")
    s.add(trail_j(8192), "trail", parent="rocket")
    return s


def _scene_t():
    s = HanabiScene(seed=17, device="cpu")
    s.add(firework_effect(2048), "rocket")
    s.add(firework_trail_effect(8192), "trail", parent="rocket")
    return s


def _camera(Cam):
    return Cam(look_at((0.0, 2.0, 8.0), (0.0, 2.0, 0.0)), perspective(0.9, 1.0, 0.1, 100.0), (128, 128))


@pytest.fixture(scope="module")
def stepped():
    """Both scenes after 30 update() calls."""
    sj, st = _scene_j(), _scene_t()
    for _ in range(FRAMES):
        sj.update(DT)
        st.update(DT)
    return sj, st


@pytest.fixture(scope="module")
def chunked():
    """Both scenes after one update_chunk(30)."""
    sj, st = _scene_j(), _scene_t()
    sj.update_chunk(FRAMES, DT)
    st.update_chunk(FRAMES, DT)
    return sj, st


def _assert_state_equal(sj, st):
    for name in ("rocket", "trail"):
        assert st[name].alive_count() == sj[name].alive_count()
        _, alive, seed, counter = st[name].pool.to_numpy()
        np.testing.assert_array_equal(alive, np.asarray(sj[name].pool.alive))
        np.testing.assert_array_equal(seed, np.asarray(sj[name].pool.seed))
        assert int(counter) == int(sj[name].pool.counter)
    ev_j, ev_t = sj["rocket"].last_events[0], st["rocket"].last_events[0]
    np.testing.assert_array_equal(ev_t.parent_slot.numpy().astype(np.uint32), np.asarray(ev_j.parent_slot))
    np.testing.assert_array_equal(ev_t.count.numpy().astype(np.uint32), np.asarray(ev_j.count))
    assert int(ev_t.num_events) == int(ev_j.num_events)
    assert sorted(ev_t.payload) == sorted(ev_j.payload) == ["position"]
    # the payload is the rockets' positions, which differ by transcendental ULPs
    np.testing.assert_allclose(
        ev_t.payload["position"].numpy(), np.asarray(ev_j.payload["position"]), rtol=1e-2, atol=1e-3
    )


def test_update_matches_jax_bit_for_bit(stepped):
    sj, st = stepped
    assert st["trail"].alive_count() > 0  # events flowed
    _assert_state_equal(sj, st)


def test_update_positions_within_device_gate(stepped):
    sj, st = stepped
    for name in ("rocket", "trail"):
        attrs, alive, _, _ = st[name].pool.to_numpy()
        for attr in ("position", "velocity"):
            np.testing.assert_allclose(
                attrs[attr][alive], np.asarray(sj[name].pool.attrs[attr])[alive], rtol=1e-2, atol=1e-3
            )


def test_update_chunk_matches_jax_bit_for_bit(chunked):
    sj, st = chunked
    assert st["trail"].alive_count() > 0
    _assert_state_equal(sj, st)


def test_update_chunk_equals_per_frame_updates(stepped, chunked):
    # the family chunk carries the pending buffers exactly as update() routes them
    _, st = stepped
    _, sc = chunked
    for name in ("rocket", "trail"):
        for a, b in zip(st[name].pool.to_numpy()[1:], sc[name].pool.to_numpy()[1:]):
            np.testing.assert_array_equal(a, b)


def test_render_add_checksum_matches_jax(stepped):
    sj, st = stepped
    img_j = np.asarray(sj.render(_camera(CamJ), CfgJ(128, 128, tile_slots=1)))
    img_t = st.render(_camera(CameraParams), RasterConfig(128, 128, tile_slots=1))
    assert img_t.shape == (128, 128, 4) and torch.isfinite(img_t).all()
    s_t, s_j = float(img_t.sum()), float(img_j.sum())
    assert s_j > 0 and abs(s_t - s_j) <= 0.005 * abs(s_j)


def test_payload_layout_matches_jax(stepped):
    sj, st = stepped
    assert st["rocket"].fx.payload_attrs == sj["rocket"].fx.payload_attrs == ("position",)
    assert st["trail"].fx._inherited_attrs == sj["trail"].fx._inherited_attrs
    assert st["trail"].fx.parent_const_count == sj["trail"].fx.parent_const_count == 4
    assert st["trail"].child_channel == sj["trail"].child_channel == 0
    assert st.total_alive() == sj.total_alive()


def test_single_effect_update_chunk_matches_jax():
    # an effect outside any event tree takes step_chunk, not the family chunk
    sj = SceneJ(seed=3)
    sj.add(gradient_j(4096), "g")
    st = HanabiScene(seed=3, device="cpu")
    st.add(gradient_effect(4096), "g")
    sj.update_chunk(6, 1.0 / 10.0)
    st.update_chunk(6, 1.0 / 10.0)
    assert st["g"].alive_count() == sj["g"].alive_count() > 0
    np.testing.assert_array_equal(st["g"].pool.to_numpy()[2], np.asarray(sj["g"].pool.seed))


def _small(Scene, firework, trail, **kw):
    """A small firework tree stepped until trails fly."""
    s = Scene(seed=17, **kw)
    s.add(firework(256), "rocket")
    s.add(trail(1024), "trail", parent="rocket")
    for _ in range(20):
        s.update(DT)
    return s


def _drifted(s, gradient):
    # an asset edited after add(): hot reload recompiles it at the next
    # entry point (the capacity edit resets its pool to the new capacity)
    s.add(gradient(96), "edited")
    s["edited"].asset.capacity += 1


def _validating(s):
    s.debug.validate = True


def _host(x):
    if isinstance(x, (tuple, list)):
        return [_host(v) for v in x]
    if isinstance(x, (set, int, float, type(None))):
        return x
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cull_pad(s, firework, cam):
    s.add(firework(64), "x", cull_pad=1.0)
    for _ in range(3):
        s.update(DT, cameras=cam)
    return s["x"].alive_count(), s._culled_names([cam], for_render=True), s["x"].cull_pad


# Each branch the port once refused now runs: the same call on the same
# small scene in both packages, its result compared (alive counts, culled
# sets and capacities exactly; images and checksums within 0.5% of the
# checksum and 1e-4 a pixel).
BRANCHES = {
    "cull_pad": lambda s, P: _cull_pad(s, P["firework"], P["cam"]),
    "cameras": lambda s, P: s.update_render_chunk(4, DT, [P["cam"]] * 2),
    "update_render_chunk": lambda s, P: (_drifted(s, P["gradient"]),
                                         s.update_render_chunk(4, DT, P["cam"]),
                                         s["edited"].pool.capacity)[1:],
    "render_views": lambda s, P: s.render_views([P["cam"]]),
    "return_depth": lambda s, P: (_validating(s), s.render(P["cam"], return_depth=True))[1],
    "painter": lambda s, P: (_drifted(s, P["gradient"]),
                             s.render(P["cam"], pipeline="painter"))[1],
    "validate": lambda s, P: (_validating(s), s.update(DT), s.total_alive())[2],
    "hot_reload": lambda s, P: (_drifted(s, P["gradient"]), s.update_chunk(2, DT),
                                s["edited"].pool.capacity, s.total_alive())[2:],
}


def _camera_small(Cam):
    return Cam(look_at((0.0, 2.0, 8.0), (0.0, 2.0, 0.0)), perspective(0.9, 1.0, 0.1, 100.0), (64, 64))


def _same(got, want):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    if isinstance(got, (set, int, float, type(None))):
        assert got == want
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if got.ndim >= 2 and np.isfinite(want).all():
        assert abs(float(got.sum()) - float(want.sum())) <= 0.005 * max(abs(float(want.sum())), 1.0)
    np.testing.assert_allclose(got, want, rtol=0.005, atol=1e-4)


@pytest.mark.parametrize(
    "branch",
    ["add_group", "cull_pad", "cameras", "update_render_chunk", "render_views", "return_depth",
     "painter", "validate", "hot_reload"],
)
def test_unported_scene_branches_raise(branch):
    """The branches this file once held to ``NotImplementedError``: grouping
    an event-emitting asset keeps the JAX package's ValueError
    (scene.py:356-357); every other branch now runs and matches the JAX
    package."""
    if branch == "add_group":
        with pytest.raises(ValueError, match="event-emitting assets cannot be grouped"):
            _scene_t().add_group(firework_effect(64), 4)
        return
    st = _small(HanabiScene, firework_effect, firework_trail_effect, device="cpu")
    sj = _small(SceneJ, firework_j, trail_j)
    got = _host(BRANCHES[branch](st, {"firework": firework_effect, "gradient": gradient_effect,
                                      "cam": _camera_small(CameraParams)}))
    want = _host(BRANCHES[branch](sj, {"firework": firework_j, "gradient": gradient_j,
                                       "cam": _camera_small(CamJ)}))
    _same(got, want)


def test_a_child_needs_an_emitting_parent():
    s = HanabiScene(seed=0, device="cpu")
    s.add(gradient_effect(64), "g")
    with pytest.raises(ValueError, match="EmitSpawnEventModifier"):
        s.add(firework_trail_effect(64), "t", parent="g")
    with pytest.raises(KeyError):
        s.add(firework_trail_effect(64), "t", parent="nope")


def test_render_single_effect_pass_matches_jax():
    # one visible effect: the plan's "eff" pass through EffectRenderer,
    # composited over an opaque black clear colour
    sj = SceneJ(seed=4)
    sj.add(gradient_j(2048), "g")
    st = HanabiScene(seed=4, device="cpu")
    st.add(gradient_effect(2048), "g")
    for _ in range(3):
        sj.update(0.5)
        st.update(0.5)
    black = (0.0, 0.0, 0.0, 1.0)
    img_j = np.asarray(sj.render(_camera(CamJ), CfgJ(128, 128, tile_slots=1), background=black))
    img_t = st.render(_camera(CameraParams), RasterConfig(128, 128, tile_slots=1), background=black)
    assert img_t.shape == (128, 128, 4) and float(img_t[..., 3].min()) == 1.0
    s_t, s_j = float(img_t.sum()), float(img_j.sum())
    assert abs(s_t - s_j) <= 0.005 * abs(s_j)


def test_simulation_clock_matches_jax():
    from bevy_hanabi_tpu.time import EffectSimulationClock as ClockJ
    from bevy_hanabi_tpu_torch import EffectSimulationClock

    cj, ct = ClockJ(), EffectSimulationClock()
    for c in (cj, ct):
        c.advance(0.1)
        c.set_relative_speed(2.0)
        c.advance(0.05)
        c.pause()
        c.advance(0.2)
        c.unpause()
    assert vars(ct.advance(0.025)) == vars(cj.advance(0.025))
    assert (ct.time, ct.delta, ct.is_paused()) == (cj.time, cj.delta, cj.is_paused())
