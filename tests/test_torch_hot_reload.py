"""The port's hot reload (``HanabiScene.hot_reload``, ``apply_asset_changes``)
against the JAX package, on the CPU.

Each case of the JAX package's tests/test_hot_reload.py runs the same
scenario in both packages: the same asset built in each package's own
authoring layer, the same live edits, the same frames. The observations
(alive counts and capacities bit for bit, which entities recompiled, whether
the compiled effect object was kept, alive velocities within rtol 1e-2 /
atol 1e-3) must agree, and the port must also meet the JAX test's own
assertions.
"""

import types

import numpy as np
import pytest
import torch

import bevy_hanabi_tpu as bj
import bevy_hanabi_tpu_torch as bt
from bevy_hanabi_tpu import modifiers as mods_j
from bevy_hanabi_tpu.graph import ExprWriter as WriterJ
from bevy_hanabi_tpu.render import camera as camera_j
from bevy_hanabi_tpu.runtime import HanabiScene as SceneJ
from bevy_hanabi_tpu.spawn import SpawnerSettings as SpawnJ
from bevy_hanabi_tpu_torch import modifiers as mods_t
from bevy_hanabi_tpu_torch.graph import ExprWriter as WriterT
from bevy_hanabi_tpu_torch.render import camera as camera_t
from bevy_hanabi_tpu_torch.spawn import SpawnerSettings as SpawnT
from torch_jax_cache import jax_cache_of_the_module  # noqa: F401

DT = 1.0 / 60.0

JAX = types.SimpleNamespace(
    pkg=bj, m=mods_j, W=WriterJ, S=SpawnJ, cam=camera_j,
    scene=lambda: SceneJ(), host=np.asarray,
)
PORT = types.SimpleNamespace(
    pkg=bt, m=mods_t, W=WriterT, S=SpawnT, cam=camera_t,
    scene=lambda: bt.HanabiScene(device="cpu"),
    host=lambda t: t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t),
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def gravity_asset(P, g=-1.0, once=4.0, capacity=64):
    A = P.pkg.attributes
    w = P.W()
    asset = (
        P.pkg.EffectAsset("hr", capacity, P.S.once(once), w.finish())
        .init(P.m.SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
        .init(P.m.SetAttributeModifier(A.LIFETIME, w.lit(100.0).expr()))
        .init(P.m.SetAttributeModifier(A.POSITION, w.lit((0.0, 0.0, 0.0)).expr()))
        .init(P.m.SetAttributeModifier(A.VELOCITY, w.lit((0.0, 0.0, 0.0)).expr()))
        .update(P.m.AccelModifier(w.lit((0.0, g, 0.0)).expr()))
    )
    return asset, w


def accel(P, w, g):
    return P.m.AccelModifier(w.lit((0.0, g, 0.0)).expr())


def vy(P, pools):
    vel, alive = P.host(pools.attrs["velocity"]), P.host(pools.alive)
    return vel[alive][..., 1]


def _camera(P):
    return P.cam.CameraParams(
        view=P.cam.look_at((0.0, 0.0, 4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
        proj=P.cam.orthographic(-2.0, 2.0, -2.0, 2.0, 0.1, 50.0),
        viewport=(32, 32),
    )


# -- scenarios: each returns its observations, in the same order in both
#    packages (floats compared within tolerance, everything else exactly)


def constant_edit(P):
    asset, w = gravity_asset(P, g=-1.0)
    s = P.scene()
    s.add(asset, "fx")
    s.update(DT)
    s.update(DT)
    out = [vy(P, s["fx"].pool)]
    asset.update_modifiers[-1] = accel(P, w, -100.0)
    s.update(DT)
    return out + [vy(P, s["fx"].pool), s["fx"].alive_count()]


def layout_migration(P):
    A = P.pkg.attributes
    asset, w = gravity_asset(P)
    s = P.scene()
    s.add(asset, "fx")
    s.update(DT)
    s.update(DT)
    before = P.host(s["fx"].pool.attrs["position"]).copy()
    alive_before = P.host(s["fx"].pool.alive).copy()
    asset.init(P.m.SetAttributeModifier(A.F32_0, w.lit(7.0).expr()))
    s.update(DT)
    pool = s["fx"].pool
    alive = P.host(pool.alive)
    return [sorted(pool.attrs), s["fx"].alive_count(), alive_before, alive,
            P.host(pool.attrs["f32_0"])[alive], before, P.host(pool.attrs["position"])]


def capacity_reset(P):
    asset, _ = gravity_asset(P, capacity=64)
    s = P.scene()
    s.add(asset, "fx")
    s.update(DT)
    out = [s["fx"].pool.capacity]
    asset.capacity = 128
    s.update(DT)
    return out + [s["fx"].pool.capacity, s["fx"].alive_count()]


def spawner_only(P):
    asset, _ = gravity_asset(P, once=2.0)
    s = P.scene()
    s.add(asset, "fx")
    s.update(DT)
    out = [s["fx"].alive_count()]
    old_fx = s["fx"].fx
    asset.spawner = P.S.rate(60.0)
    for _ in range(10):
        s.update(DT)
    inst = s["fx"]
    return out + [inst.fx is old_fx, inst.spawner.settings is asset.spawner, inst.alive_count()]


def property_resync(P):
    A = P.pkg.attributes
    w = P.W()
    w.add_property("accel", (0.0, -1.0, 0.0))
    asset = (
        P.pkg.EffectAsset("p", 16, P.S.once(1.0), w.finish())
        .init(P.m.SetAttributeModifier(A.LIFETIME, w.lit(100.0).expr()))
        .init(P.m.SetAttributeModifier(A.POSITION, w.lit((0.0, 0.0, 0.0)).expr()))
        .init(P.m.SetAttributeModifier(A.VELOCITY, w.lit((0.0, 0.0, 0.0)).expr()))
        .update(P.m.AccelModifier(w.prop("accel").expr()))
    )
    s = P.scene()
    s.add(asset, "fx")
    s.set_property("fx", "accel", (0.0, -50.0, 0.0))
    s.update(DT)
    w.add_property("accel2", (0.0, 0.0, 0.0))
    asset.update(P.m.AccelModifier(w.prop("accel2").expr()))
    s.update(DT)
    props = s["fx"].properties.as_dict()
    return [np.asarray(props["accel"], np.float32), np.asarray(props["accel2"], np.float32),
            vy(P, s["fx"].pool)]


def render_edit(P):
    asset, w = gravity_asset(P, g=0.0, once=1.0)
    asset.render(P.m.SetColorModifier((1.0, 0.0, 0.0, 1.0)))
    s = P.scene()
    s.add(asset, "fx")
    s.update(DT)
    cam = _camera(P)
    img = P.host(s.render(cam))
    asset.render_modifiers[-1] = P.m.SetColorModifier((0.0, 1.0, 0.0, 1.0))
    img2 = P.host(s.render(cam))
    return [img, img2]


def _family(P, emit_count=3):
    A, m = P.pkg.attributes, P.m
    wp = P.W()
    parent = (
        P.pkg.EffectAsset("par", 8, P.S.once(2.0), wp.finish())
        .init(m.SetAttributeModifier(A.AGE, wp.lit(0.0).expr()))
        .init(m.SetAttributeModifier(A.LIFETIME, wp.lit(2.5 * DT).expr()))
        .init(m.SetAttributeModifier(A.POSITION, wp.lit((1.0, 2.0, 3.0)).expr()))
        .update(m.EmitSpawnEventModifier(m.EventEmitCondition.ON_DIE,
                                         wp.module.lit(emit_count, None), 0))
    )
    wc = P.W()
    child = (
        P.pkg.EffectAsset("chi", 64, P.S.once(0.0), wc.finish())
        .init(m.InheritAttributeModifier(A.POSITION))
        .init(m.SetAttributeModifier(A.LIFETIME, wc.lit(100.0).expr()))
    )
    return parent, child, wp


def parent_edit_child_noop(P):
    A = P.pkg.attributes
    parent, child, wp = _family(P)
    s = P.scene()
    s.add(parent, "P")
    s.add(child, "C", parent="P")
    s.update(DT)
    child_fx = s["C"].fx
    parent.init_modifiers[2] = P.m.SetAttributeModifier(A.POSITION, wp.lit((1.0, 2.0, 3.0)).expr())
    s.update(DT)
    out = [s["C"].fx is child_fx]
    for _ in range(6):
        s.update(DT)
    return out + [s["C"].alive_count(), P.host(s["C"].pool.attrs["position"])[P.host(s["C"].pool.alive)]]


def parent_emit_count_edit(P):
    m = P.m
    parent, child, wp = _family(P, emit_count=3)
    s = P.scene()
    s.add(parent, "P")
    s.add(child, "C", parent="P")
    s.update(DT)
    child_fx = s["C"].fx
    parent.update_modifiers[-1] = m.EmitSpawnEventModifier(
        m.EventEmitCondition.ON_DIE, wp.module.lit(5, None), 0)
    for _ in range(7):
        s.update(DT)
    return [s["C"].fx is not child_fx, s["C"].alive_count()]


def group_reload(P):
    asset, w = gravity_asset(P, g=-1.0, once=2.0)
    s = P.scene()
    s.add_group(asset, count=3, name="grp")
    s.update(DT)
    s.update(DT)
    out = [s.group_alive("grp")]
    asset.update_modifiers[-1] = accel(P, w, -100.0)
    s.update(DT)
    return out + [s.group_alive("grp"), vy(P, s._groups["grp"]["pools"])]


def reload_off(P):
    asset, w = gravity_asset(P, g=-1.0)
    s = P.scene()
    s.hot_reload = "off"
    s.add(asset, "fx")
    s.update(DT)
    old_fx = s["fx"].fx
    asset.update_modifiers[-1] = accel(P, w, -100.0)
    for _ in range(40):
        s.update(DT)
    return [s["fx"].fx is old_fx, vy(P, s["fx"].pool)]


def reload_periodic(P):
    asset, w = gravity_asset(P, g=-1.0)
    s = P.scene()
    s.hot_reload = "periodic"
    s.add(asset, "fx")
    s.update(DT)
    old_fx = s["fx"].fx
    asset.update_modifiers[-1] = accel(P, w, -100.0)
    kept = []
    for _ in range(130):
        s.update(DT)
        kept.append(s["fx"].fx is old_fx)
    return [kept, vy(P, s["fx"].pool)]


def chunk_applies(P):
    asset, w = gravity_asset(P, g=-1.0, once=2.0)
    s = P.scene()
    s.add(asset, "fx")
    s.update_chunk(2, DT)
    asset.update_modifiers[-1] = accel(P, w, -100.0)
    s.update_chunk(1, DT)
    return [vy(P, s["fx"].pool)]


def returns_names(P):
    asset, w = gravity_asset(P)
    s = P.scene()
    s.hot_reload = "off"
    s.add(asset, "fx")
    s.update(DT)
    out = [s.apply_asset_changes()]
    asset.update_modifiers[-1] = accel(P, w, -9.0)
    return out + [s.apply_asset_changes(), s.apply_asset_changes()]


def capacity_override_retired(P):
    asset, w = gravity_asset(P, capacity=64)
    asset.spawner = P.S.rate(240.0)
    s = P.scene()
    s.add(asset, "fx", capacity=1024)
    s.update(DT)
    out = [s["fx"].pool.capacity]
    asset.capacity = 128
    s.update(DT)
    out.append(s["fx"].pool.capacity)
    s.update(DT)
    out.append(s["fx"].alive_count())
    asset.update_modifiers[-1] = accel(P, w, -9.0)
    s.update(DT)
    return out + [s["fx"].pool.capacity, s["fx"].alive_count()]


def group_capacity_override_retired(P):
    asset, w = gravity_asset(P, capacity=64, once=2.0)
    s = P.scene()
    s.add_group(asset, count=2, name="grp", capacity=256)
    s.update(DT)

    def cap():
        return int(s._groups["grp"]["pools"].alive.shape[-1])

    out = [cap()]
    asset.capacity = 32
    s.update(DT)
    out.append(cap())
    asset.update_modifiers[-1] = accel(P, w, -9.0)
    s.update(DT)
    return out + [cap()]


def spawner_forever_to_finite(P):
    asset, _ = gravity_asset(P, capacity=256)
    asset.spawner = P.S.rate(60.0)
    s = P.scene()
    s.add(asset, "fx")
    for _ in range(5):
        s.update(DT)
    out = [s["fx"].alive_count()]
    asset.spawner = P.S.once(16.0)
    s.update(DT)
    out.append(s["fx"].alive_count())
    s.update(DT)
    return out + [s["fx"].alive_count()]


def spawner_edit_no_churn(P):
    asset, _ = gravity_asset(P, once=2.0)
    s = P.scene()
    s.add(asset, "fx")
    s.update(DT)
    cam = _camera(P)
    s.render(cam)
    fx, renderer = s["fx"].fx, s["fx"].renderer
    asset.spawner = P.S.rate(30.0)
    s.update(DT)
    img = P.host(s.render(cam))
    # a spawner-only edit recompiles nothing: the compiled effect and its
    # renderer are the ones from before the edit
    return [s["fx"].fx is fx, s["fx"].renderer is renderer, s["fx"].alive_count(), img]


CASES = {
    "constant_edit": constant_edit,
    "layout_migration": layout_migration,
    "capacity_reset": capacity_reset,
    "spawner_only": spawner_only,
    "property_resync": property_resync,
    "render_edit": render_edit,
    "parent_edit_child_noop": parent_edit_child_noop,
    "parent_emit_count_edit": parent_emit_count_edit,
    "group_reload": group_reload,
    "reload_off": reload_off,
    "reload_periodic": reload_periodic,
    "chunk_applies": chunk_applies,
    "returns_names": returns_names,
    "capacity_override_retired": capacity_override_retired,
    "group_capacity_override_retired": group_capacity_override_retired,
    "spawner_forever_to_finite": spawner_forever_to_finite,
    "spawner_edit_no_churn": spawner_edit_no_churn,
}


def _same(a, b):
    if isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a_arr, b_arr = np.asarray(a), np.asarray(b)
    if a_arr.dtype.kind == "f" or b_arr.dtype.kind == "f":
        np.testing.assert_allclose(a_arr, b_arr, rtol=1e-2, atol=1e-3)
    else:
        np.testing.assert_array_equal(a_arr, b_arr)


@pytest.mark.parametrize("case", list(CASES))
def test_hot_reload_matches_jax(case):
    got = CASES[case](PORT)
    want = CASES[case](JAX)
    _same(got, want)
    # and the JAX test's own assertions hold on the port
    CHECKS[case](got)


def _check_constant_edit(o):
    assert o[0] == pytest.approx(-2 * DT, rel=1e-4)
    assert o[1] == pytest.approx(-2 * DT - 100.0 * DT, rel=1e-4)
    assert o[2] == 4


def _check_layout(o):
    names, n, alive_before, alive, f32_0, before, after = o
    assert "f32_0" in names and n == 4
    assert np.array_equal(alive_before, alive)
    assert np.all(f32_0 == 0.0)
    assert np.all(after[alive][:, 1] <= before[alive][:, 1])


CHECKS = {
    "constant_edit": _check_constant_edit,
    "layout_migration": _check_layout,
    "capacity_reset": lambda o: o == [64, 128, 0] or pytest.fail(str(o)),
    "spawner_only": lambda o: (o[0] == 2 and o[1] and o[2] and o[3] > 2) or pytest.fail(str(o)),
    "property_resync": lambda o: o[2] == pytest.approx(-100.0 * DT, rel=1e-4),
    "render_edit": lambda o: (o[0][..., 0].max() > 0 and o[0][..., 1].max() == 0
                              and o[1][..., 1].max() > 0 and o[1][..., 0].max() == 0)
    or pytest.fail("render edit"),
    "parent_edit_child_noop": lambda o: (o[0] and o[1] == 6) or pytest.fail(str(o[:2])),
    "parent_emit_count_edit": lambda o: o == [True, 10] or pytest.fail(str(o)),
    "group_reload": lambda o: (o[0] == o[1] == 6
                               and o[2] == pytest.approx(-2 * DT - 100.0 * DT, rel=1e-4))
    or pytest.fail(str(o)),
    "reload_off": lambda o: (o[0] and o[1] == pytest.approx(-41 * DT, rel=1e-3))
    or pytest.fail(str(o)),
    "reload_periodic": lambda o: (not o[0][-1]) or pytest.fail("never recompiled"),
    "chunk_applies": lambda o: o[0] == pytest.approx(-2 * DT - 100.0 * DT, rel=1e-4),
    "returns_names": lambda o: o == [[], ["fx"], []] or pytest.fail(str(o)),
    "capacity_override_retired": lambda o: (o[:2] == [1024, 128] and o[2] > 0 and o[3] == 128
                                            and o[4] >= o[2]) or pytest.fail(str(o)),
    "group_capacity_override_retired": lambda o: o == [256, 32, 32] or pytest.fail(str(o)),
    "spawner_forever_to_finite": lambda o: (o[0] + 16 <= o[1] <= o[0] + 17 and o[2] == o[1])
    or pytest.fail(str(o)),
    "spawner_edit_no_churn": lambda o: (o[0] and o[1]) or pytest.fail(str(o[:3])),
}
