"""The port's ``cull_pad`` frustum culling and LOCAL-space effects against
the JAX package, on the CPU (tests/test_visibility.py:141-195, 225-277),
and LOCAL-space frames rendered against the JAX package's.

Each case builds the same scene in both packages. Culled sets and render
plans are equal; pool AABBs within rtol 1e-2 / atol 1e-3 (the pools'
float state); framebuffers within 0.5% on their checksums (bench.py:155-161)
and pixel for pixel within 1e-4 (the local frame passes through two f32
matrix products whose rounding XLA may contract differently).
"""

import math
import types

import numpy as np
import pytest
import torch

import bevy_hanabi_tpu as bj
import bevy_hanabi_tpu_torch as bt
from bevy_hanabi_tpu.models import instancing_effect as instancing_j
from bevy_hanabi_tpu.models import spawn_gravity_effect as gravity_j
from bevy_hanabi_tpu.modifiers import OrientModifier as OrientJ
from bevy_hanabi_tpu.modifiers.output import OrientMode as ModeJ
from bevy_hanabi_tpu.render import camera as camera_j
from bevy_hanabi_tpu.render.raster import RasterConfig as CfgJ
from bevy_hanabi_tpu.runtime import HanabiScene as SceneJ
from bevy_hanabi_tpu_torch.models import instancing_effect as instancing_t
from bevy_hanabi_tpu_torch.models import spawn_gravity_effect as gravity_t
from bevy_hanabi_tpu_torch.modifiers import OrientModifier as OrientT
from bevy_hanabi_tpu_torch.modifiers.output import OrientMode as ModeT
from bevy_hanabi_tpu_torch.render import camera as camera_t
from bevy_hanabi_tpu_torch.render.raster import RasterConfig as CfgT
from torch_jax_cache import jax_cache_of_the_module  # noqa: F401

DT = 1.0 / 60.0
REL = 0.005

JAX = types.SimpleNamespace(
    pkg=bj, gravity=gravity_j, instancing=instancing_j, cam=camera_j, Cfg=CfgJ,
    Orient=OrientJ, Mode=ModeJ, scene=lambda seed: SceneJ(seed=seed), host=np.asarray,
)
PORT = types.SimpleNamespace(
    pkg=bt, gravity=gravity_t, instancing=instancing_t, cam=camera_t, Cfg=CfgT,
    Orient=OrientT, Mode=ModeT, scene=lambda seed: bt.HanabiScene(seed=seed, device="cpu"),
    host=lambda t: t.numpy(),
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _offset(t):
    return np.concatenate([np.eye(3, dtype=np.float32), np.asarray(t, np.float32)[:, None]], axis=1)


def _cam(P, eye=(0.0, 0.0, 6.0), target=(0.0, 0.0, 0.0), size=64):
    return P.cam.CameraParams(
        view=P.cam.look_at(np.asarray(eye, np.float32), np.asarray(target, np.float32)),
        proj=P.cam.perspective(math.radians(60.0), 1.0, 0.1, 100.0),
        viewport=(size, size),
    )


def _always(P):
    return P.gravity(capacity=256, rate=600.0).with_simulation_condition(
        P.pkg.SimulationCondition.ALWAYS)


def _local(P):
    return P.gravity(capacity=256, rate=600.0).with_simulation_space(P.pkg.SimulationSpace.LOCAL)


def _same_image(got, want, atol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert abs(float(got.sum()) - float(want.sum())) <= REL * max(abs(float(want.sum())), 1.0)
    np.testing.assert_allclose(got, want, atol=atol)


def _both(build):
    return build(PORT), build(JAX)


def _plan(P, s, insts, groups, cam):
    culled = s._culled_names([cam], for_render=True)
    if P is PORT:
        return s._scene_render_plan(insts, cam, culled=culled, groups=groups)
    return s._scene_render_plan(insts, groups, cam, culled=culled)


def cull_pad_per_camera(P):
    s = P.scene(0)
    s.add(_always(P), "side", transform=_offset((30.0, 0.0, 0.0)), cull_pad=1.0)
    for _ in range(4):
        s.update(DT)
    origin, side = _cam(P), _cam(P, eye=(30.0, 0.0, 6.0), target=(30.0, 0.0, 0.0))
    cfg = P.Cfg(width=64, height=64)
    return [s["side"].alive_count(), _plan(P, s, s.effects(), [], origin),
            _plan(P, s, s.effects(), [], side), P.host(s.render(origin, cfg)),
            P.host(s.render(side, cfg))]


def test_cull_pad_drops_raster_pass_per_camera():
    got, want = _both(cull_pad_per_camera)
    assert got[:3] == want[:3]
    assert got[0] > 0 and got[1] == ((), ()) and len(got[2][0]) + len(got[2][1]) == 1
    _same_image(got[3], want[3])
    _same_image(got[4], want[4])
    assert got[3][..., :3].sum() == 0.0 and got[4][..., :3].sum() > 0.0


def always_without_pad(P):
    s = P.scene(0)
    s.add(_always(P), "side", transform=_offset((30.0, 0.0, 0.0)))
    s.update(DT)
    cam = _cam(P)
    return [s._culled_names([cam], for_render=True), _plan(P, s, s.effects(), [], cam)]


def test_always_effects_without_cull_pad_never_culled():
    got, want = _both(always_without_pad)
    assert got == want
    assert got[0] == set() and len(got[1][0]) + len(got[1][1]) == 1


def emitter_before_spawn(P):
    s = P.scene(0)
    s.add(P.gravity(capacity=256, rate=600.0), "fx")
    out = [s._culled_names([_cam(P)], for_render=False)]
    s.update(DT, cameras=_cam(P))
    return out + [s["fx"].alive_count()]


def test_aabb_includes_emitter_before_first_spawn():
    got, want = _both(emitter_before_spawn)
    assert got == want
    assert got[0] == set() and got[1] > 0


def group_culling(P):
    s = P.scene(0)
    tfs = np.broadcast_to(_offset((0.0, 40.0, 0.0)), (4, 3, 4))
    s.add_group(P.instancing(capacity=64), 4, name="grp", transforms=tfs, cull_pad=1.0)
    s.update(DT)
    cam = _cam(P)
    return [s._culled_names([cam], for_render=True), _plan(P, s, [], [s._groups["grp"]], cam)]


def test_group_culling():
    got, want = _both(group_culling)
    assert got == want
    assert "grp" in got[0] and got[1] == ((), ())


def local_aabb_world(P):
    s = P.scene(0)
    s.add(_local(P), "fx", transform=_offset((100.0, 0.0, 0.0)), cull_pad=1.0)
    at_fx = _cam(P, eye=(100.0, 0.0, 6.0), target=(100.0, 0.0, 0.0))
    for _ in range(4):
        s.update(DT, cameras=at_fx)
    return [s["fx"].alive_count(), s._culled_names([at_fx], for_render=True),
            P.host(s.render(at_fx, P.Cfg(width=64, height=64))),
            s._culled_names([_cam(P)], for_render=True), s._refresh_aabbs()["fx"]]


def test_local_space_aabb_is_world_space():
    got, want = _both(local_aabb_world)
    assert got[0] == want[0] > 0
    assert got[1] == want[1] == set()
    assert got[3] == want[3] == {"fx"}
    _same_image(got[2], want[2])
    assert got[2][..., :3].sum() > 0.0
    np.testing.assert_allclose(np.asarray(got[4]), np.asarray(want[4]), rtol=1e-2, atol=1e-3)


# 90 degrees about +y: local +x -> world -z
ROT_Y = np.asarray([[0.0, 0.0, 1.0, 0.0], [0.0, 1.0, 0.0, 0.0], [-1.0, 0.0, 0.0, 0.0]], np.float32)


def local_aabb_rotation(P):
    s = P.scene(0)
    s.add(_local(P), "fx", transform=ROT_Y, cull_pad=0.25)
    s.update(DT, cameras=_cam(P))
    return s._refresh_aabbs()["fx"]


def test_local_space_aabb_applies_rotation():
    (mn, mx), want = _both(local_aabb_rotation)
    np.testing.assert_allclose(np.asarray((mn, mx)), np.asarray(want), rtol=1e-2, atol=1e-3)
    assert np.all(mn <= 0.5) and np.all(mx >= -0.5) and np.all(mx - mn < 10.0)


# a rotated, scaled, translated emitter: 30 degrees about +z, scale 1.5,
# at (0.5, -0.5, 1)
_C, _S = math.cos(math.radians(30.0)), math.sin(math.radians(30.0))
TF_LOCAL = np.asarray([[1.5 * _C, -1.5 * _S, 0.0, 0.5], [1.5 * _S, 1.5 * _C, 0.0, -0.5],
                       [0.0, 0.0, 1.5, 1.0]], np.float32)


def local_frames(P, part):
    """LOCAL-space effects through every scene pass. ``passes``: one effect
    alone (its own pass), then with a second LOCAL effect and a GLOBAL one
    batched (split) and in the painter pass; ``chunk``: the render chunk and
    a 2D camera. The first effect faces the camera position, which the
    extraction reads in effect space."""
    facing = _local(P).render(P.Orient(P.Mode.FACE_CAMERA_POSITION))
    s = P.scene(9)
    s.add(facing, "a", transform=TF_LOCAL)
    for _ in range(20):
        s.update(DT)
    cam = _cam(P, eye=(1.0, 2.0, 7.0))
    cfg = P.Cfg(width=64, height=64)
    out = [P.host(s.render(cam, cfg))] if part == "passes" else []
    s.add(_local(P), "b", transform=_offset((-1.0, 0.5, 0.0)))
    s.add(P.gravity(capacity=256, rate=600.0), "g")
    for _ in range(10):
        s.update(DT)
    if part == "passes":
        return out + [P.host(s.render(cam, cfg, pipeline="split")), P.host(s.render(cam, cfg))]
    img, sums = s.update_render_chunk(3, DT, cam, cfg)
    return [P.host(img), P.host(s.render(P.cam.camera_2d((64, 64), scale=3.0), cfg)),
            P.host(sums)]


@pytest.mark.parametrize("part", ["passes", "chunk"])
def test_local_space_frames_match_jax(part):
    got, want = _both(lambda P: local_frames(P, part))
    for g, w in zip(got[:3] if part == "passes" else got[:2], want):
        _same_image(g, w)
        assert g[..., :3].sum() > 0.0
    if part == "chunk":
        np.testing.assert_allclose(got[2], want[2], rtol=REL)


def test_local_extraction_matches_jax_draw():
    """The extraction alone: camera into effect space, axes and positions
    back to world, on the same pool in both packages."""
    from bevy_hanabi_tpu.render.extract import extract_draw_data as extract_j
    from bevy_hanabi_tpu.runtime import CompiledEffect as FxJ
    from bevy_hanabi_tpu.runtime.effect import StepInputs as InJ
    from bevy_hanabi_tpu_torch.render.extract import extract_draw_data as extract_t
    from bevy_hanabi_tpu_torch.runtime.pool import ParticlePool

    asset_j = _local(JAX).render(OrientJ(ModeJ.FACE_CAMERA_POSITION))
    asset_t = bt.EffectAsset.from_json(asset_j.to_json())
    fx = FxJ(asset_j)
    pool = fx.create_pool()
    sim = bj.SimParams(time=0.0, delta_time=DT)
    for j in range(10):
        pool, _ = fx.step(pool, InJ.make(12, j, TF_LOCAL), sim)
    cam_j, cam_t = _cam(JAX, eye=(1.0, 2.0, 7.0)), _cam(PORT, eye=(1.0, 2.0, 7.0))
    d_j = extract_j(asset_j, pool, cam_j, sim=sim, transform=TF_LOCAL)
    pool_t = ParticlePool.from_numpy({k: np.asarray(v) for k, v in pool.attrs.items()},
                                     pool.alive, pool.seed, pool.counter, "cpu")
    d_t = extract_t(asset_t, pool_t, cam_t, sim=sim, transform=TF_LOCAL)
    for f in ("position", "axis_x", "axis_y", "color"):
        np.testing.assert_allclose(getattr(d_t, f).numpy(), np.asarray(getattr(d_j, f)),
                                   rtol=1e-5, atol=1e-5)
