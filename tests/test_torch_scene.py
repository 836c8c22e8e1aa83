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
from bevy_hanabi_tpu_torch import HanabiScene, RasterConfig
from bevy_hanabi_tpu_torch.models import firework_effect, firework_trail_effect, gradient_effect
from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective

FRAMES = 30
DT = 1.0 / 20.0


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


def _drifted(s):
    # an asset no other test builds: the compiled-effect cache keeps the
    # first asset object of each signature, which this edit mutates
    s.add(gradient_effect(96), "edited")
    s["edited"].asset.capacity += 1


def _validating(s):
    s.debug.validate = True


@pytest.mark.parametrize(
    "call",
    [
        # instanced groups are ported: an event-emitting asset is refused
        # with the JAX package's ValueError (scene.py:356-357)
        lambda s: s.add_group(firework_effect(64), 4),
        lambda s: s.add(firework_effect(64), "x", cull_pad=1.0),
        # a camera list (multi-view) stays unported in the render chunk
        lambda s: s.update_render_chunk(4, DT, [_camera(CameraParams)] * 2),
        lambda s: (_drifted(s), s.update_render_chunk(4, DT, _camera(CameraParams))),
        lambda s: s.render_views([_camera(CameraParams)]),
        lambda s: (_validating(s), s.render(_camera(CameraParams), return_depth=True)),
        lambda s: (_drifted(s), s.render(_camera(CameraParams), pipeline="painter")),
        lambda s: (_validating(s), s.update(DT)),
        lambda s: (_drifted(s), s.update_chunk(2, DT)),
    ],
    ids=["add_group", "cull_pad", "cameras", "update_render_chunk", "render_views",
         "return_depth", "painter", "validate", "hot_reload"],
)
def test_unported_scene_branches_raise(call, request):
    if request.node.callspec.id == "add_group":
        with pytest.raises(ValueError, match="event-emitting assets cannot be grouped"):
            call(_scene_t())
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        call(_scene_t())


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
