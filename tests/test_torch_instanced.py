"""The port's instanced groups against the JAX package, on the CPU.

``InstancedEffect`` steps I instances of one asset as one pass over their
flat ``[I*N]`` lanes; the JAX package vmaps its step over the instance
axis. The same inputs (spawn counts, frame seeds, per-instance transforms
and properties, made from a numpy seed) go through both at 4-8 instances
of 128-256 lanes. Tolerances are the repo's device gate's
(bench.py:121-130, 155-161): alive masks, PCG seeds and counters of every
instance bit for bit (the same integer ops); positions rtol 1e-2 / atol
1e-3 (transcendental ULPs); images within 0.5% of their checksum (f32 blend
arithmetic; a dropped or doubled splat moves it by far more). Then the
scene's groups (``HanabiScene.add_group`` and its controls) in the JAX
package's own scenarios (tests/test_scene.py:406-513, 707-786,
tests/test_utils.py:179, tests/test_visibility.py:206).
"""

import numpy as np
import pytest
import torch

import bevy_hanabi_tpu as bj
import bevy_hanabi_tpu.models.examples  # noqa: F401
import bevy_hanabi_tpu.spawn  # noqa: F401
import bevy_hanabi_tpu_torch as bt
import bevy_hanabi_tpu_torch.models.examples  # noqa: F401
import bevy_hanabi_tpu_torch.spawn  # noqa: F401
from bevy_hanabi_tpu.models import firework_effect as firework_j
from bevy_hanabi_tpu.models import firework_trail_effect as trail_j
from bevy_hanabi_tpu.models import gradient_effect as gradient_j
from bevy_hanabi_tpu.models import instancing_effect as instancing_j
from bevy_hanabi_tpu.models import spawn_gravity_effect as gravity_j
from bevy_hanabi_tpu.render import orthographic as ortho_j
from bevy_hanabi_tpu.render.extract import flatten_instance_axis as flatten_j
from bevy_hanabi_tpu.runtime import HanabiScene as SceneJ
from bevy_hanabi_tpu.runtime.instanced import InstancedEffect as InstJ
from bevy_hanabi_tpu_torch import EffectAsset, HanabiScene, InstancedEffect, RasterConfig
from bevy_hanabi_tpu_torch.models import firework_effect, instancing_effect
from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, orthographic
from bevy_hanabi_tpu_torch.render.extract import flatten_instance_axis
from bevy_hanabi_tpu_torch.render.renderer import EffectRenderer
from bevy_hanabi_tpu_torch.runtime.pool import ParticlePool
from torch_jax_cache import jax_cache_of_the_module  # noqa: F401

DT = 1.0 / 60.0
CHECKSUM_REL = 0.005


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain raster path calls small vectorised ops thousands of times,
    each of which wakes OpenMP: run PyTorch single-threaded here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(asset_j):
    """The JAX asset as the port's, through JSON."""
    return EffectAsset.from_json(asset_j.to_json())


def _same_pools(pool_t, pools_j):
    """Every instance's alive mask, seeds and counter bit for bit, the
    alive lanes' float attributes within the gate."""
    attrs, alive, seed, counter = pool_t.to_numpy()
    np.testing.assert_array_equal(alive, np.asarray(pools_j.alive))
    np.testing.assert_array_equal(seed, np.asarray(pools_j.seed))
    np.testing.assert_array_equal(counter, np.asarray(pools_j.counter))
    for name, v in attrs.items():
        want = np.asarray(pools_j.attrs[name])
        if v.dtype == np.float32:
            np.testing.assert_allclose(v[alive], want[alive], rtol=1e-2, atol=1e-3, err_msg=name)
        else:
            np.testing.assert_array_equal(v[alive], want[alive], err_msg=name)


def _checksum_close(a, b):
    assert abs(float(a) - float(b)) <= CHECKSUM_REL * max(abs(float(b)), 1.0), (a, b)


def _camera(mod, size=64, ortho=False):
    if ortho:
        return mod.CameraParams(mod.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0)),
                                mod.orthographic(-2, 2, -2, 2, 0.1, 10.0), (size, size))
    return mod.CameraParams(mod.look_at((0.0, 0.0, 6.0), (0.0, 0.0, 0.0)),
                            mod.perspective(1.05, 1.0, 0.1, 100.0), (size, size))


def _prop_asset():
    """Per-instance properties in the init and update passes: a spawn
    centre (vec3) and an acceleration scale (f32)."""
    w = bj.ExprWriter()
    w.add_property("centre", (0.0, 0.0, 0.0))
    w.add_property("lift", 1.0)
    A = bj.attributes
    return (
        bj.EffectAsset("ip", 256, bj.SpawnerSettings.rate(600.0), w.finish())
        .init(bj.SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
        .init(bj.SetAttributeModifier(A.LIFETIME, (w.rand(bj.FLOAT) * 0.3 + 0.1).expr()))
        .init(bj.SetPositionSphereModifier(w.prop("centre").expr(), w.lit(0.5).expr(),
                                           bj.ShapeDimension.VOLUME))
        .init(bj.SetVelocitySphereModifier(w.lit((0.0, 0.0, 0.0)).expr(), w.lit(1.0).expr()))
        .update(bj.AccelModifier((w.lit((0.0, 1.0, 0.0)) * w.prop("lift")).expr()))
    )


def _frames(i, k, seed=0):
    """K frames of per-instance inputs from a numpy seed: spawn counts,
    frame seeds, transforms and the two properties."""
    rng = np.random.default_rng(seed)
    tfs = np.tile(np.eye(3, 4, dtype=np.float32), (i, 1, 1))
    tfs[:, :, 3] = rng.uniform(-2.0, 2.0, (i, 3)).astype(np.float32)
    tfs[:, :, :3] *= rng.uniform(0.5, 1.5, (i, 1, 1)).astype(np.float32)  # scaled emitters
    out = []
    for _ in range(k):
        out.append(dict(
            spawn_counts=rng.integers(-2, 60, i),
            frame_seeds=rng.integers(0, 2**32, i, dtype=np.uint32),
            transforms=tfs,
            properties={"centre": rng.uniform(-1, 1, (i, 3)).astype(np.float32),
                        "lift": np.float32(rng.uniform(0.5, 2.0))},
        ))
    return out


def _stack(fx, frames, Sim, start=0):
    ins = [fx.make_inputs(**f) for f in frames]
    sims = [Sim(time=(start + j) * DT, delta_time=DT) for j in range(len(frames))]
    return ins, sims


# ---- InstancedEffect -----------------------------------------------------------


def test_instanced_effect_independent_instances():
    """tests/test_parallel.py:74: each instance spawns its own count."""
    asset = gravity_j(capacity=128, rate=0.0)
    out = []
    for Inst, asset_, Sim, kw in ((InstJ, asset, bj.SimParams, {}),
                                  (InstancedEffect, _port(asset), bt.SimParams, {"device": "cpu"})):
        fx = Inst(asset_, 4, capacity=128, **kw)
        pools, _ = fx.step(fx.create_pools(), fx.make_inputs([10, 0, 128, 5], [1, 2, 3, 4]),
                           Sim(delta_time=DT))
        out.append((fx, pools))
    (fj, pj), (ft, pt) = out
    np.testing.assert_array_equal(ft.alive_counts(pt).numpy(), [10, 0, 128, 5])
    assert int(ft.total_alive(pt)) == 143
    np.testing.assert_array_equal(ft.alive_counts(pt).numpy(), np.asarray(fj.alive_counts(pj)))
    _same_pools(pt, pj)


def test_instanced_step_matches_jax_with_transforms_and_properties():
    """Eight frames of 6 instances x 256 lanes, each instance with its own
    spawn count (some negative: no spawn), seed, scaled and moved emitter
    and property values; lifetimes of 0.1-0.4 s reap and recycle lanes."""
    asset = _prop_asset()
    fj = InstJ(asset, 6)
    ft = InstancedEffect(_port(asset), 6, device="cpu")
    pj, pt = fj.create_pools(), ft.create_pools()
    for j, f in enumerate(_frames(6, 8)):
        pj, _ = fj.step(pj, fj.make_inputs(**f), bj.SimParams(time=j * DT, delta_time=0.05))
        pt, _ = ft.step(pt, ft.make_inputs(**f), bt.SimParams(time=j * DT, delta_time=0.05))
    assert 0 < int(ft.total_alive(pt)) < 6 * 256
    _same_pools(pt, pj)


def _same_events(ev_t, ev_j):
    """An instanced step's buffers: every channel, every field with its [I]
    axis; slots, counts and num_events bit for bit, the payload of each
    instance's events within the gate (the attributes' own ULPs)."""
    assert sorted(ev_t) == sorted(ev_j)
    for ch, t in ev_t.items():
        j = ev_j[ch]
        np.testing.assert_array_equal(t.num_events.numpy(), np.asarray(j.num_events))
        np.testing.assert_array_equal(t.parent_slot.numpy(), np.asarray(j.parent_slot))
        np.testing.assert_array_equal(t.count.numpy(), np.asarray(j.count))
        assert sorted(t.payload) == sorted(j.payload)
        for k, v in t.payload.items():
            want = np.asarray(j.payload[k])
            assert v.shape == want.shape, k
            for i, ne in enumerate(t.num_events.tolist()):
                np.testing.assert_allclose(v[i, :ne].numpy(), want[i, :ne], rtol=1e-2, atol=1e-3,
                                           err_msg=k)


@pytest.mark.parametrize("method", ["step", "step_checked", "step_chunk"])
def test_instanced_emitting_asset_matches_jax(method):
    """The firework (one event channel, the rockets' death bursts) as 3
    instances x 128 lanes, 100 frames of 0-2 spawns an instance: the
    per-instance event buffers of every frame (step, step_checked) against
    JAX's vmapped step, and the pools after the chunk (step_chunk, whose
    events are dropped in both packages)."""
    asset = firework_j(128)
    fj, ft = InstJ(asset, 3), InstancedEffect(_port(asset), 3, device="cpu")
    rng = np.random.default_rng(5)
    frames = [dict(spawn_counts=rng.integers(0, 3, 3),
                   frame_seeds=rng.integers(0, 2**32, 3, dtype=np.uint32)) for _ in range(100)]
    if method == "step_chunk":
        ii, ss = fj.effect.stack_frames(*_stack(fj, frames, bj.SimParams))
        pj = fj.step_chunk(fj.create_pools(), ii, ss)
        ii, ss = ft.effect.stack_frames(*_stack(ft, frames, bt.SimParams))
        _same_pools(ft.step_chunk(ft.create_pools(), ii, ss), pj)
        return
    pj, pt, emitted = fj.create_pools(), ft.create_pools(), 0
    for (ins_j, sim_j), (ins_t, sim_t) in zip(zip(*_stack(fj, frames, bj.SimParams)),
                                              zip(*_stack(ft, frames, bt.SimParams))):
        pj, ej = getattr(fj, method)(pj, ins_j, sim_j)
        pt, et = getattr(ft, method)(pt, ins_t, sim_t)
        _same_events(et, ej)
        emitted += int(et[0].num_events.sum())
    _same_pools(pt, pj)
    assert emitted > 0


def test_instanced_consuming_asset_raises_like_jax():
    """An asset that consumes events has no parent as an instance: the
    trail's inherited position raises JAX's ValueError, and a consuming
    step raises JAX's "pass events_in" (effect.py:535-540)."""
    from bevy_hanabi_tpu.runtime.effect import CompiledEffect as EffectJ

    from bevy_hanabi_tpu_torch import CompiledEffect

    msgs = []
    for Inst, asset, Sim, kw in ((InstJ, trail_j(128), bj.SimParams, {}),
                                 (InstancedEffect, _port(trail_j(128)), bt.SimParams,
                                  {"device": "cpu"})):
        fx = Inst(asset, 2, **kw)
        with pytest.raises(ValueError) as err:
            fx.step(fx.create_pools(), fx.make_inputs([3, 4], [1, 2]), Sim(delta_time=DT))
        msgs.append(str(err.value))
        parent = (firework_j(128) if Inst is InstJ else _port(firework_j(128))).particle_layout()
        get = EffectJ.get if Inst is InstJ else CompiledEffect.get
        fx.effect = get(asset, parent_layout=parent, **kw)
        with pytest.raises(ValueError) as err:
            fx.step(fx.create_pools(), fx.make_inputs([3, 4], [1, 2]), Sim(delta_time=DT))
        msgs.append(str(err.value))
    assert msgs[:2] == msgs[2:]
    assert "requires a parent effect" in msgs[0] and "pass events_in" in msgs[1]


def test_instanced_property_shapes_and_dtypes():
    """tests/test_runtime.py:351: make_inputs keeps declared dtypes and uses
    the declared shape to tell a shared vec-k from per-instance values."""
    w = bt.ExprWriter()
    w.add_property("accel3", (0.0, -1.0, 0.0))
    w.add_property("tick", np.uint32(16777217))  # not float32-representable
    asset = (
        bt.EffectAsset("ip", 16, bt.SpawnerSettings.once(4.0), w.finish())
        .init(bt.SetAttributeModifier(bt.attributes.POSITION, w.lit([0.0, 0.0, 0.0]).expr()))
        .init(bt.SetAttributeModifier(bt.attributes.LIFETIME, w.lit(5.0).expr()))
    )
    fx = InstancedEffect(asset, 3, device="cpu")
    fj = InstJ(bj.EffectAsset.from_json(asset.to_json()), 3)
    props = {"accel3": np.asarray([1.0, 2.0, 3.0], np.float32), "tick": np.uint32(16777217)}
    ins, ins_j = fx.make_inputs([4] * 3, [1, 2, 3], properties=props), fj.make_inputs(
        [4] * 3, [1, 2, 3], properties=props)
    assert ins.properties["accel3"].shape == (3, 3)
    np.testing.assert_allclose(ins.properties["accel3"][2], [1.0, 2.0, 3.0])
    assert ins.properties["tick"].dtype == np.uint32
    assert int(ins.properties["tick"][0]) == 16777217
    for k in props:
        np.testing.assert_array_equal(ins.properties[k], np.asarray(ins_j.properties[k]))
        assert ins.properties[k].dtype == np.asarray(ins_j.properties[k]).dtype
    per = np.arange(9, dtype=np.float32).reshape(3, 3)
    np.testing.assert_allclose(fx.make_inputs([0] * 3, [0] * 3, properties={"accel3": per})
                               .properties["accel3"], per)
    with pytest.raises(ValueError):
        fx.make_inputs([0] * 3, [0] * 3, properties={"accel3": np.zeros((2, 3))})
    # the uint32 property reaches the step whole (int64 carrier, no f32 cast)
    pools, _ = fx.step(fx.create_pools(), ins, bt.SimParams(delta_time=DT))
    assert fx.alive_counts(pools).tolist() == [4, 4, 4]


def test_instanced_step_chunk_matches_jax():
    """tests/test_parallel.py:408's chunk: six frames through step_chunk
    against JAX's scan over the vmapped step."""
    asset = _prop_asset()
    fj, ft = InstJ(asset, 4), InstancedEffect(_port(asset), 4, device="cpu")
    frames = _frames(4, 6, seed=1)
    ii, ss = fj.effect.stack_frames(*_stack(fj, frames, bj.SimParams))
    pj = fj.step_chunk(fj.create_pools(), ii, ss)
    ii, ss = ft.effect.stack_frames(*_stack(ft, frames, bt.SimParams))
    pt = ft.step_chunk(ft.create_pools(), ii, ss)
    _same_pools(pt, pj)


def test_instanced_step_render_chunk_matches_jax():
    """tests/test_parallel.py:408: the fused step+render chunk, against
    JAX's and against the port's step_chunk then the flat pool's render."""
    asset = gradient_j(capacity=128)
    I, K = 4, 6
    bank_seed = 3

    def inputs(fx, bank_mod, Sim):
        bank = bank_mod.make_spawner_bank(asset.spawner, I, seed=bank_seed)
        rng = np.random.default_rng(7)
        frames = [dict(spawn_counts=bank.tick(DT),
                       frame_seeds=rng.integers(0, 2**32, I, dtype=np.uint32)) for _ in range(K)]
        return fx.effect.stack_frames(*_stack(fx, frames, Sim))

    cfg = dict(width=64, height=64, max_entries_per_tile=256)
    fj = InstJ(asset, I, 128)
    pj, img_j, sums_j = fj.step_render_chunk(fj.create_pools(), *inputs(fj, bj.spawn, bj.SimParams),
                                             _camera(bj.render), bj.render.RasterConfig(**cfg))
    ft = InstancedEffect(_port(asset), I, 128, device="cpu")
    cam = _camera(bt.render.camera)
    pt, img_t, sums_t = ft.step_render_chunk(ft.create_pools(), *inputs(ft, bt.spawn, bt.SimParams),
                                             cam, RasterConfig(**cfg))
    _same_pools(pt, pj)
    assert sums_t.shape == (K,) and float(sums_t[-1]) > 0
    for a, b in zip(sums_t.tolist(), np.asarray(sums_j).tolist()):
        _checksum_close(a, b)
    # the fused chunk's last frame is the flat pool's render after step_chunk
    ft2 = InstancedEffect(_port(asset), I, 128, device="cpu")
    p2 = ft2.step_chunk(ft2.create_pools(), *inputs(ft2, bt.spawn, bt.SimParams))
    ref = EffectRenderer(ft2.asset, RasterConfig(**cfg)).render(
        p2.flatten(), cam, sim=bt.SimParams(time=(K - 1) * DT, delta_time=DT))
    np.testing.assert_allclose(img_t.numpy(), ref.numpy(), atol=1e-5)


def test_instanced_render_chunk_per_instance_properties():
    """tests/test_parallel.py:464: render modifiers see each instance's OWN
    property values: instance 0 draws a square quad (roundness 0), instance
    1 a circle (roundness 1)."""
    out = []
    for pkg, Inst, kw in ((bj, InstJ, {}), (bt, InstancedEffect, {"device": "cpu"})):
        w = pkg.ExprWriter()
        w.add_property("r", 0.0)
        A = pkg.attributes
        asset = (
            pkg.EffectAsset("rnd", 4, pkg.SpawnerSettings.once(1.0), w.finish())
            .init(pkg.SetAttributeModifier(A.POSITION, w.lit((0.0, 0.0, 0.0)).expr()))
            .init(pkg.SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
            .init(pkg.SetAttributeModifier(A.LIFETIME, w.lit(10.0).expr()))
            .render(pkg.SetSizeModifier((0.5, 0.5, 0.5)))
            .render(pkg.RoundModifier(w.prop("r").expr()))
        )
        fx = Inst(asset, 2, 4, **kw)
        t0, t1 = np.eye(3, 4, dtype=np.float32), np.eye(3, 4, dtype=np.float32)
        t0[0, 3], t1[0, 3] = -0.5, 0.5
        frames = [dict(spawn_counts=np.asarray([1, 1]) if j == 0 else np.asarray([0, 0]),
                       frame_seeds=np.asarray([1, 2], np.uint32), transforms=np.stack([t0, t1]),
                       properties={"r": np.asarray([0.0, 1.0], np.float32)}) for j in range(2)]
        ii, ss = fx.effect.stack_frames(*_stack(fx, frames, pkg.SimParams))
        mod = bj.render if pkg is bj else bt.render.camera
        cam = mod.CameraParams(mod.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0)),
                               (ortho_j if pkg is bj else orthographic)(-1, 1, -1, 1, 0.1, 10.0),
                               (64, 64))
        Cfg = bj.render.RasterConfig if pkg is bj else RasterConfig
        out.append(np.asarray(fx.step_render_chunk(fx.create_pools(), ii, ss, cam,
                                                   Cfg(width=64, height=64, tile_size=16))[1]))
    img_j, img_t = out
    assert img_t[32 - 7, 16 - 7, 3] > 0.0  # instance 0: the square's corner filled
    assert img_t[32 - 7, 48 - 7, 3] == 0.0  # instance 1: the circle cuts the corner
    np.testing.assert_allclose(img_t, img_j, atol=1e-5)


def test_instanced_render_chunk_refusals_and_checked_steps():
    """LOCAL, ribbon and event-linked assets are refused as in the JAX
    package; the checked steps (DebugSettings.validate) step as the JAX
    package's do, and raise where they raise: on poisoned pools (NaN in the
    dead lanes, create_pools(poison=True))."""
    local = instancing_effect(64).with_simulation_space(bt.SimulationSpace.LOCAL)
    fx = InstancedEffect(local, 2, device="cpu")
    ii, ss = fx.effect.stack_frames(*_stack(fx, [dict(spawn_counts=[1, 1], frame_seeds=[1, 2])],
                                            bt.SimParams))
    cam, cfg = _camera(bt.render.camera), RasterConfig(64, 64)
    with pytest.raises(ValueError, match="GLOBAL"):
        fx.step_render_chunk(fx.create_pools(), ii, ss, cam, cfg)
    rib = InstancedEffect(bt.models.example_ribbon(), 2, 64, device="cpu")
    with pytest.raises(ValueError, match="quad billboards"):
        rib.step_render_chunk(rib.create_pools(), ii, ss, cam, cfg)
    ev = InstancedEffect(firework_effect(64), 2, device="cpu")
    with pytest.raises(ValueError, match="event-linked"):
        ev.step_render_chunk(ev.create_pools(), ii, ss, cam, cfg)
    pools, events = ev.step(ev.create_pools(), ev.make_inputs([1, 1], [1, 2]), bt.SimParams())
    assert list(events) == [0] and tuple(events[0].parent_slot.shape) == (2, 64)
    assert tuple(events[0].num_events.shape) == (2,)  # an emitting asset's step: its events
    fx_j = InstJ(instancing_j(64).with_simulation_space(bj.SimulationSpace.LOCAL), 2)
    ii_j, ss_j = fx_j.effect.stack_frames(*_stack(fx_j, [dict(spawn_counts=[1, 1],
                                                              frame_seeds=[1, 2])], bj.SimParams))
    one_t = (fx.make_inputs([3, 1], [1, 2]), bt.SimParams(delta_time=DT))
    one_j = (fx_j.make_inputs([3, 1], [1, 2]), bj.SimParams(delta_time=DT))
    pools_t, _ = fx.step_checked(fx.create_pools(), *one_t)
    pools_j, _ = fx_j.step_checked(fx_j.create_pools(), *one_j)
    np.testing.assert_array_equal(pools_t.alive.numpy(), np.asarray(pools_j.alive))
    chunk_t = fx.step_chunk_checked(fx.create_pools(), ii, ss)
    chunk_j = fx_j.step_chunk_checked(fx_j.create_pools(), ii_j, ss_j)
    np.testing.assert_array_equal(chunk_t.seed.numpy(), np.asarray(chunk_j.seed))
    for fx_, one, chunk in ((fx, one_t, (ii, ss)), (fx_j, one_j, (ii_j, ss_j))):
        with pytest.raises(Exception, match="nan"):
            fx_.step_checked(fx_.create_pools(poison=True), *one)
        with pytest.raises(Exception, match="nan"):
            fx_.step_chunk_checked(fx_.create_pools(poison=True), *chunk)


def test_flatten_and_stacked_pools_cross_from_jax():
    """pool.flatten (pool.py:103-128) with composite ribbon ids, and
    ParticlePool.from_numpy of stacked [I, N] pools, against JAX."""
    asset = bj.models.examples.example_ribbon()
    fj = InstJ(asset, 3, 16)
    pj, _ = fj.step(fj.create_pools(), fj.make_inputs([5, 0, 9], [4, 5, 6]),
                    bj.SimParams(delta_time=DT))
    pj.attrs["ribbon_id"] = pj.attrs["ribbon_id"] + np.arange(3, dtype=np.uint32)[:, None] * 7
    pt = ParticlePool.from_numpy({k: np.asarray(v) for k, v in pj.attrs.items()}, pj.alive,
                                 pj.seed, pj.counter, device="cpu")
    assert pt.counter.shape == (3,) and pt.capacity == 16
    for comp in (False, True):
        fl_j, fl_t = pj.flatten(composite_ribbon_ids=comp), pt.flatten(composite_ribbon_ids=comp)
        attrs, alive, seed, counter = fl_t.to_numpy()
        np.testing.assert_array_equal(alive, np.asarray(fl_j.alive))
        np.testing.assert_array_equal(seed, np.asarray(fl_j.seed))
        assert int(counter) == int(fl_j.counter)
        for k, v in attrs.items():
            np.testing.assert_array_equal(v, np.asarray(fl_j.attrs[k]), err_msg=k)
    tree = {"a": torch.arange(24.0).reshape(2, 3, 4), "b": torch.ones(2, 3)}
    want = flatten_j({k: v.numpy() for k, v in tree.items()})
    for k, v in flatten_instance_axis(tree).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))


# ---- HanabiScene groups --------------------------------------------------------


def _ring(n, radius=1.5):
    tfs = np.tile(np.eye(3, 4, dtype=np.float32), (n, 1, 1))
    angles = np.linspace(0, 2 * np.pi, n, endpoint=False)
    tfs[:, 0, 3] = radius * np.cos(angles)
    tfs[:, 1, 3] = radius * np.sin(angles)
    return tfs


@pytest.fixture(scope="module")
def ring():
    """tests/test_scene.py:476: a ring of 12 instances in both scenes after
    30 updates."""
    asset = instancing_j(capacity=128)
    sj, st = SceneJ(seed=5), HanabiScene(seed=5, device="cpu")
    sj.add_group(asset, 12, "ring", transforms=_ring(12))
    st.add_group(_port(asset), 12, "ring", transforms=_ring(12))
    for _ in range(30):
        sj.update(DT)
        st.update(DT)
    return sj, st


def test_instanced_group_in_scene(ring):
    sj, st = ring
    alive = st.group_alive("ring")
    assert alive == sj.group_alive("ring") and alive > 12 * 30 // 3
    assert st.total_alive() == alive
    _same_pools(st._groups["ring"]["pools"], sj._groups["ring"]["pools"])
    flat = st._group_flat_pool(st._groups["ring"])
    pos = flat.get("position")[flat.alive].numpy()
    assert pos[:, 0].min() < -1.0 and pos[:, 0].max() > 1.0  # each instance's transform baked


@pytest.mark.parametrize("pipeline", ["split", "painter"])
def test_group_renders_like_jax(ring, pipeline):
    """A group's flat pool drawn in its "grp" pass and in the painter pass."""
    sj, st = ring
    img_j = np.asarray(sj.render(_camera(bj.render, ortho=True), bj.render.RasterConfig(
        width=64, height=64, tile_size=16), pipeline=pipeline))
    img_t = st.render(_camera(bt.render.camera, ortho=True),
                      RasterConfig(width=64, height=64, tile_size=16), pipeline=pipeline).numpy()
    assert img_t[..., :3].max() > 0.05
    _checksum_close(img_t.sum(), img_j.sum())


def test_group_rejects_event_assets_and_local_space():
    s = HanabiScene(seed=0, device="cpu")
    with pytest.raises(ValueError, match="event-emitting"):
        s.add_group(firework_effect(512), 4)
    with pytest.raises(ValueError, match="GLOBAL"):
        s.add_group(instancing_effect(128).with_simulation_space(bt.SimulationSpace.LOCAL), 4)
    # cull_pad is ported: the group takes part in culling as in the JAX package
    sj = SceneJ(seed=0)
    for scene, asset in ((s, instancing_effect(128)), (sj, instancing_j(128))):
        scene.add_group(asset, 4, "padded", cull_pad=1.0)
        scene.update(DT)
    cam_t, cam_j = _camera(bt.render.camera), _camera(bj.render)
    assert s._groups["padded"]["cull_pad"] == sj._groups["padded"]["cull_pad"] == 1.0
    assert s._culled_names([cam_t], True) == sj._culled_names([cam_j], True) == set()


def _mixed(Scene, grav, inst, **kw):
    s = Scene(seed=7, **kw)
    s.add(grav, "fx")
    s.add_group(inst, 4, "g")
    return s


def test_update_chunk_matches_per_frame_and_jax():
    """tests/test_scene.py:530: a chunk advances the same spawner and clock
    state as per-frame updates; the groups' pools equal JAX's chunk."""
    grav, inst = gravity_j(512, 300.0), instancing_j(128)
    a = _mixed(HanabiScene, _port(grav), _port(inst), device="cpu")
    for _ in range(30):
        a.update(DT)
    b = _mixed(HanabiScene, _port(grav), _port(inst), device="cpu")
    b.update_chunk(30, DT)
    j = _mixed(SceneJ, grav, inst)
    j.update_chunk(30, DT)
    assert a["fx"].alive_count() == b["fx"].alive_count()
    assert a.group_alive("g") == b.group_alive("g") == j.group_alive("g")
    assert abs(a.clock.time - b.clock.time) < 1e-9
    _same_pools(b._groups["g"]["pools"], j._groups["g"]["pools"])


@pytest.mark.parametrize("pipeline", ["auto", "split"])
def test_update_render_chunk_with_a_group_matches_jax(pipeline):
    """An effect and a group stepped and drawn in one chunk: every frame's
    checksum, the group's pools and the effect's alive count against JAX."""
    grav, inst = gravity_j(256, 300.0), instancing_j(64)
    j = _mixed(SceneJ, grav, inst)
    t = _mixed(HanabiScene, _port(grav), _port(inst), device="cpu")
    cfg = dict(width=64, height=64, tile_size=16)
    _, sums_j = j.update_render_chunk(6, DT, _camera(bj.render), bj.render.RasterConfig(**cfg),
                                      pipeline=pipeline)
    img_t, sums_t = t.update_render_chunk(6, DT, _camera(bt.render.camera), RasterConfig(**cfg),
                                          pipeline=pipeline)
    for a, b in zip(sums_t.tolist(), np.asarray(sums_j).tolist()):
        _checksum_close(a, b)
    assert t["fx"].alive_count() == j["fx"].alive_count()
    _same_pools(t._groups["g"]["pools"], j._groups["g"]["pools"])


def test_group_with_textures_renders():
    """tests/test_scene.py:707: a flipbook group samples its sprite sheet."""
    sheet = bt.models.make_anim_sprite_sheet(frames=4, size=16)
    out = []
    for Scene, ex, kw in ((SceneJ, bj.models.examples, {}), (HanabiScene, bt.models.examples,
                                                             {"device": "cpu"})):
        s = Scene(seed=8, **kw)
        s.add_group(ex.example_circle(4), 3, "g", textures=[sheet])
        for _ in range(30):
            s.update(DT)
        mod = bj.render if Scene is SceneJ else bt.render.camera
        cam = mod.CameraParams(mod.look_at((0.0, 1.0, 4.0), (0.0, 0.5, 0.0)),
                               mod.perspective(1.0, 1.0, 0.1, 100.0), (64, 64))
        Cfg = bj.render.RasterConfig if Scene is SceneJ else RasterConfig
        out.append(np.asarray(s.render(cam, Cfg(width=64, height=64, tile_size=16))))
    img_j, img_t = out
    assert (img_t[..., :3] > 0.05).any()
    _checksum_close(img_t.sum(), img_j.sum())


def test_group_controls():
    """tests/test_scene.py:786: spawner activation, visibility of an ALWAYS
    group, and moved transforms, each step against JAX's alive counts."""
    def run(s, asset):
        s.add_group(asset, 4, "g")
        counts = []
        s.set_spawner_active("g", False)
        for _ in range(10):
            s.update(DT)
        counts.append(s.group_alive("g"))
        s.set_spawner_active("g", True)
        for _ in range(5):  # rate ~43/s needs a few frames for the first particle
            s.update(DT)
        counts.append(s.group_alive("g"))
        s.set_visible("g", False)  # ALWAYS: still simulating
        s.update(DT)
        counts.append(s.group_alive("g"))
        s.set_transform("g", np.tile(np.concatenate([np.eye(3), [[50.0], [0.0], [0.0]]], axis=1),
                                     (4, 1, 1)))
        s.reset_spawner("g")
        for _ in range(5):
            s.update(DT)
        counts.append(s.group_alive("g"))
        return counts

    st = HanabiScene(seed=9, device="cpu")
    ct = run(st, instancing_effect(128))
    assert ct == run(SceneJ(seed=9), instancing_j(128))
    assert ct[0] == 0 and ct[1] > 0 and ct[2] >= ct[1]
    flat = st._group_flat_pool(st._groups["g"])
    assert (flat.get("position")[flat.alive][:, 0] > 10).any()


def test_scene_remove_group_and_effect():
    """tests/test_utils.py:179: a removed group is gone from every count;
    an effect with children refuses removal until they go."""
    s = HanabiScene(seed=0, device="cpu")
    s.add_group(instancing_effect(128), 4, "g")
    s.add(firework_effect(64), "p")
    s.add(bt.models.firework_trail_effect(256), "c", parent="p")
    s.update(DT)
    assert s.group_alive("g") >= 0
    s.remove("g")
    assert "g" not in s._groups and s.total_alive() >= 0
    with pytest.raises(ValueError, match="children"):
        s.remove("p")
    s.remove("c")
    s.remove("p")
    assert s.effects() == [] and s.total_alive() == 0
    s.update(DT)


def test_group_culling():
    """tests/test_visibility.py:206 without ``cull_pad`` (not ported): a
    WhenVisible group far outside the frustum is culled from the plan and
    pauses under ``update(dt, cameras=...)``, as in the JAX package."""
    asset = gravity_j(64, 600.0)  # WhenVisible
    tfs = np.tile(np.eye(3, 4, dtype=np.float32), (4, 1, 1))
    tfs[:, 1, 3] = 40.0
    out = []
    for Scene, a, mod, kw in ((SceneJ, asset, bj.render, {}),
                              (HanabiScene, _port(asset), bt.render.camera, {"device": "cpu"})):
        s = Scene(seed=0, **kw)
        s.add_group(a, 4, name="grp", transforms=tfs)
        cam = mod.CameraParams(mod.look_at((0.0, 0.0, 6.0), (0.0, 0.0, 0.0)),
                               mod.perspective(0.9, 1.0, 0.1, 100.0), (64, 64))
        s.update(DT, cameras=cam)
        culled = s._culled_names([cam], for_render=True)
        if Scene is SceneJ:
            plan = s._scene_render_plan([], [s._groups["grp"]], cam, culled=culled)
        else:
            plan = s._scene_render_plan([], cam, culled=culled, groups=[s._groups["grp"]])
        out.append((culled, plan, s.group_alive("grp")))
    assert out[0] == out[1] == ({"grp"}, ((), ()), 0)


def test_group_ribbons_stay_per_instance():
    """tests/test_scene.py:406: same-rid trails of two instances do not
    connect after the flattening (ribbon ids composited per instance), in
    the split and painter pipelines and the render chunk."""
    A = bt.attributes
    w = bt.ExprWriter()
    asset = (
        bt.EffectAsset("grib", 16, bt.SpawnerSettings.once(0.0), w.finish())
        .init(bt.SetAttributeModifier(A.POSITION, w.lit([0.0, 0.0, 0.0]).expr()))
        .init(bt.SetAttributeModifier(A.RIBBON_ID, w.lit(0, None).expr()))
        .init(bt.SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
        .init(bt.SetAttributeModifier(A.LIFETIME, w.lit(100.0).expr()))
        .init(bt.SetAttributeModifier(A.SIZE, w.lit(0.1).expr()))
    )
    scene = HanabiScene(seed=3, device="cpu")
    scene.add_group(asset, 2, "rg")
    pools = scene._groups["rg"]["pools"]
    I, N = 2, 16
    pos = np.zeros((I, N, 3), np.float32)
    for k, x in enumerate((-0.75, 0.0, 0.75)):
        pos[0, k] = [x, -0.5, 0.0]
        pos[1, k] = [x, 0.5, 0.0]
    age = np.zeros((I, N), np.float32)
    age[0, :3] = [3.0, 2.0, 1.0]
    age[1, :3] = [6.0, 5.0, 4.0]
    alive = np.zeros((I, N), bool)
    alive[:, :3] = True
    pools.attrs["position"] = torch.from_numpy(pos)
    pools.attrs["age"] = torch.from_numpy(age)
    pools.attrs["lifetime"] = torch.full((I, N), 100.0)
    pools.attrs["ribbon_id"] = torch.zeros((I, N), dtype=torch.int64)
    pools.attrs["size"] = torch.full((I, N), 0.1)
    pools.alive = torch.from_numpy(alive)
    cam = CameraParams(look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0)),
                       orthographic(-1, 1, -1, 1, 0.1, 10.0), (64, 64))
    cfg = RasterConfig(width=64, height=64, tile_size=16, tile_span=4, max_entries_per_tile=16)
    images = {p: scene.render(cam, cfg, pipeline=p).numpy() for p in ("split", "painter")}
    images["chunk"] = scene.update_render_chunk(1, 1e-5, cam, cfg)[0].numpy()
    for name, img in images.items():
        a = img[..., 3]
        assert (a[12:20, :] > 0.1).any(), name  # y=+0.5 trail present
        assert (a[44:52, :] > 0.1).any(), name  # y=-0.5 trail present
        assert not (a[28:37, :] > 0.05).any(), name  # no cross-instance segment


def test_stats_warmup_and_raster_override():
    """stats (scene.py:1241), warmup (:2341) and add(raster_override=)
    against the JAX package: the overridden effect renders in its own pass
    at its tile span, in the same image."""
    out = []
    for Scene, grav, inst, mod, Cfg, kw in (
        (SceneJ, gravity_j(256, 600.0), instancing_j(64), bj.render, bj.render.RasterConfig, {}),
        (HanabiScene, _port(gravity_j(256, 600.0)), instancing_effect(64), bt.render.camera,
         RasterConfig, {"device": "cpu"}),
    ):
        s = Scene(seed=11, **kw)
        s.add(grav, "big", raster_override={"tile_span": 4})
        s.add_group(inst, 3, "g")
        s.warmup()
        for _ in range(4):
            s.update(DT)
        cam = mod.CameraParams(mod.look_at((0.0, 0.0, 6.0), (0.0, 0.0, 0.0)),
                               mod.perspective(0.9, 1.0, 0.1, 100.0), (64, 64))
        plan = (s._scene_render_plan([s["big"]], [], cam) if Scene is SceneJ
                else s._scene_render_plan([s["big"]], cam))
        img = np.asarray(s.render(cam, Cfg(width=64, height=64, tile_size=16)))
        out.append((s.stats(), plan, img))
    (st_j, plan_j, img_j), (st_t, plan_t, img_t) = out
    assert plan_t == tuple(tuple(p) for p in plan_j) and plan_t[1][0][0] == "eff"
    for key in ("frame", "time", "total_alive", "groups"):
        assert st_t[key] == st_j[key], key
    assert st_t["effects"]["big"] == st_j["effects"]["big"]
    assert st_t["last_frame_ms"] > 0
    _checksum_close(img_t.sum(), img_j.sum())
    s = HanabiScene(seed=0, device="cpu")
    s.add(instancing_effect(64), "x", raster_override={"tile_span": 4})
    with pytest.raises(ValueError, match="painter-eligible"):
        s.render(_camera(bt.render.camera), pipeline="painter")
