"""The port's sharded scene paths against the JAX package's, on the CPU:
``HanabiScene.add(mesh=)``, ``add_sharded_group`` and everything a sharded
pool passes through in the scene (``update``, ``update_chunk``,
``update_render_chunk``, both render pipelines, hot reload, checkpoints,
validation and culling).

The JAX scenes shard over ``make_mesh(jax.devices()[:8], ...)`` (conftest.py's
8 virtual CPU devices), the port's over the same factors of
``[torch.device("cpu")] * 8``. Mirrors tests/test_parallel.py's scene cases.
Tolerances: alive counts, masks, PCG seeds and counters bit for bit and
float state rtol 1e-2 / atol 1e-3 against JAX; the port's sharded scene
equals its unsharded twin exactly where tests/test_parallel.py holds the two
equal (no tile overflowing M); images within 0.5% of the JAX package's
checksum.
"""

import math

import jax
import numpy as np
import pytest
import torch

import bevy_hanabi_tpu as bj
from bevy_hanabi_tpu.models import firework_effect as firework_j
from bevy_hanabi_tpu.models import firework_trail_effect as trail_j
from bevy_hanabi_tpu.models import gradient_effect as gradient_j
from bevy_hanabi_tpu.models import spawn_gravity_effect as gravity_j
from bevy_hanabi_tpu.parallel import make_mesh as make_mesh_j
from bevy_hanabi_tpu.render import camera as camera_j
from bevy_hanabi_tpu.render.raster import RasterConfig as CfgJ
from bevy_hanabi_tpu.runtime import HanabiScene as SceneJ
from bevy_hanabi_tpu.runtime.effect import CompiledEffect as CompiledEffectJ
from bevy_hanabi_tpu.utils import save_scene_state as save_j
from bevy_hanabi_tpu_torch import HanabiScene, InstancedEffect, RasterConfig, SimParams
from bevy_hanabi_tpu_torch import models as models_t
from bevy_hanabi_tpu_torch.parallel import ShardedEffect, ShardedRenderer, make_mesh
from bevy_hanabi_tpu_torch.render import camera as camera_t
from bevy_hanabi_tpu_torch.runtime.pool import ShardedPool
from bevy_hanabi_tpu_torch.utils import load_scene_state, save_scene_state
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
    """JAX scenes here step (some under validation) on an empty
    ``CompiledEffect._CACHE``, the old dict put back after each test (see
    test_torch_utils.py)."""
    monkeypatch.setattr(CompiledEffectJ, "_CACHE", {})


# the two packages side by side: (scene class, models, camera module,
# raster config, mesh maker, scene kwargs)
JAX = (SceneJ, bj.models, camera_j, lambda **kw: CfgJ(**kw),
       lambda **kw: make_mesh_j(jax.devices()[:8], **kw), {})
PORT = (HanabiScene, models_t, camera_t, lambda **kw: RasterConfig(**kw),
        lambda **kw: make_mesh(CPUS, **kw), {"device": "cpu"})


def _cam(cm, size=64, z=8.0):
    return cm.CameraParams(view=cm.look_at(np.array([0.0, 0.0, z]), np.zeros(3), np.array([0.0, 1.0, 0.0])),
                           proj=cm.perspective(math.radians(60.0), 1.0, 0.1, 100.0),
                           viewport=(size, size))


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _checksum_close(got, want):
    got, want = float(np.sum(_host(got))), float(np.sum(_host(want)))
    assert abs(got - want) <= CHECKSUM_REL * max(abs(want), 1.0), (got, want)


def _same_pool(pool_t, pool_j):
    """A port pool (sharded or not) against the JAX package's."""
    attrs, alive, seed, counter = pool_t.to_numpy()
    np.testing.assert_array_equal(alive, np.asarray(pool_j.alive))
    np.testing.assert_array_equal(seed, np.asarray(pool_j.seed))
    np.testing.assert_array_equal(counter, np.asarray(pool_j.counter))
    for k, v in attrs.items():
        want = np.asarray(pool_j.attrs[k])
        if v.dtype == np.float32:
            np.testing.assert_allclose(v[alive], want[alive], rtol=1e-2, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(v[alive], want[alive], err_msg=k)


def _same_port(a, b):
    """Two port pools equal bit for bit."""
    ha, hb = a.to_numpy(), b.to_numpy()
    for x, y in zip(ha[1:], hb[1:]):
        np.testing.assert_array_equal(x, y)
    for k in ha[0]:
        np.testing.assert_array_equal(ha[0][k], hb[0][k], err_msg=k)


# -- sharded groups ------------------------------------------------------------


def _mixed(side, sharded=True, seed=11, rate=2000.0, cap=64, alpha=None, frames=12, **gkw):
    """tests/test_parallel.py:307: a plain effect beside an 8-instance group
    (a quarter of the JAX test's lanes, so M = 1024 overflows no tile)."""
    Scene, models, _, _, mk, kw = side
    s = Scene(seed=seed, **kw)
    s.add(models.gradient_effect(capacity=512), "plain")
    asset = models.spawn_gravity_effect(capacity=cap, rate=rate)
    if alpha is not None:
        asset = asset.with_alpha_mode(getattr(type(asset.alpha_mode), alpha.upper()))
    if sharded:
        s.add_sharded_group(asset, count=8, mesh=mk(dp=4, sp=2), name="big", **gkw)
    else:
        s.add_group(asset, count=8, name="big")
    for _ in range(frames):
        s.update(DT)
    return s


@pytest.mark.parametrize("alpha", ["blend", "add"])
def test_scene_mixed_sharded_and_plain(alpha):
    """tests/test_parallel.py:307: a mixed scene steps and renders sharded and
    unsharded effects together; its split pipeline draws the group through
    the ShardedRenderer (slice for blend, psum for add)."""
    st, sj = _mixed(PORT, alpha=alpha), _mixed(JAX, alpha=alpha)
    ref = _mixed(PORT, sharded=False, alpha=alpha)
    assert isinstance(st._groups["big"]["pools"], ShardedPool)
    assert st.group_alive("big") == sj.group_alive("big") == ref.group_alive("big") > 0
    assert st["plain"].alive_count() == sj["plain"].alive_count() > 0
    _same_pool(st._groups["big"]["pools"], sj._groups["big"]["pools"])
    _same_port(st._groups["big"]["pools"], ref._groups["big"]["pools"])
    cfg = dict(width=64, height=64, max_entries_per_tile=1024)
    img = st.render(_cam(camera_t), RasterConfig(**cfg), pipeline="split")
    assert isinstance(st._groups["big"]["renderer"], ShardedRenderer)
    assert st._groups["big"]["renderer"].mode == ("psum" if alpha == "add" else "slice")
    img_j = sj.render(_cam(camera_j), CfgJ(**cfg), pipeline="split")
    img = img.numpy()
    assert img.shape == (64, 64, 4) and np.isfinite(img).all()
    assert (img[..., :3].sum(axis=-1) > 0).sum() > 4  # both effects drew
    _checksum_close(img, img_j)
    ref_img = ref.render(_cam(camera_t), RasterConfig(**cfg), pipeline="split").numpy()
    np.testing.assert_allclose(img, ref_img, atol=1e-5 if alpha == "add" else 0.0)


def test_scene_sharded_group_update_chunk():
    """tests/test_parallel.py:359 (dp=8, sp=1), against the JAX package's."""
    pools = []
    for Scene, models, _, _, mk, kw in (JAX, PORT):
        s = Scene(seed=4, **kw)
        g = s.add_sharded_group(models.spawn_gravity_effect(capacity=128, rate=600.0), count=8,
                                mesh=mk(dp=8, sp=1))
        s.update_chunk(10, DT)
        assert s.group_alive(g) > 0
        pools.append(s._groups[g]["pools"])
    _same_pool(pools[1], pools[0])


def _flat_asset(models_mod, name, pos, mode, color):
    """tests/test_parallel.py:487: one unit quad at ``pos``."""
    import bevy_hanabi_tpu_torch as bt

    pkg = bj if models_mod is bj.models else bt
    w = pkg.ExprWriter()
    a = (
        pkg.EffectAsset(name, 8, pkg.SpawnerSettings.once(1.0), w.finish())
        .init(pkg.SetAttributeModifier(pkg.attributes.POSITION, w.lit(pos).expr()))
        .init(pkg.SetAttributeModifier(pkg.attributes.LIFETIME, w.lit(100.0).expr()))
        .init(pkg.SetAttributeModifier(pkg.attributes.HDR_COLOR, w.lit(color).expr()))
        .render(pkg.SetSizeModifier((0.5, 0.5, 0.5)))
    )
    a.with_alpha_mode(getattr(pkg.AlphaMode, mode.upper()))
    return a


def test_sharded_opaque_group_writes_scene_depth():
    """tests/test_parallel.py:478: a sharded OPAQUE group joins the opaque
    phase, its depth plane occluding a transparent effect behind it."""
    out = []
    for Scene, models, cm, _, mk, kw in (JAX, PORT):
        cam = cm.CameraParams(view=cm.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0)),
                              proj=cm.orthographic(-1, 1, -1, 1, 0.1, 10.0), viewport=(64, 64))
        s = Scene(**kw)
        s.add_sharded_group(_flat_asset(models, "sg", (0.0, 0.0, 0.0), "opaque", (1.0, 0.0, 1.0, 1.0)),
                            count=8, mesh=mk(dp=4, sp=2), name="sg")
        t = np.eye(3, 4, dtype=np.float32)
        t[2, 3] = 4.0  # the nearest emitter: drawn last without phases
        s.add(_flat_asset(models, "tr", (0.0, 0.0, -4.9), "blend", (0.0, 1.0, 0.0, 1.0)), "tr",
              transform=t)
        s.update(DT)
        img, depth = s.render(cam, background=(0, 0, 0, 0), return_depth=True, pipeline="split")
        out.append((_host(img), _host(depth)))
    (img_j, dep_j), (img, dep) = out
    np.testing.assert_allclose(img[32, 32, :3], [1.0, 0.0, 1.0], atol=1e-5)
    np.testing.assert_allclose(dep[32, 32], 5.0, atol=1e-5)
    assert np.isinf(dep[2, 2])
    np.testing.assert_allclose(img, img_j, atol=1e-5)
    np.testing.assert_allclose(dep, dep_j, atol=1e-5)


def test_painter_includes_sharded_groups():
    """tests/test_parallel.py:778: the painter pass takes the sharded group
    assembled, exactly as the unsharded scene draws it."""
    cfg = dict(width=64, height=64, max_entries_per_tile=1024)
    st, ref = _mixed(PORT, seed=13, rate=1500.0, frames=10), _mixed(PORT, False, 13, 1500.0,
                                                                     frames=10)
    sj = _mixed(JAX, seed=13, rate=1500.0, frames=10)
    img = st.render(_cam(camera_t), RasterConfig(**cfg), pipeline="painter").numpy()
    assert np.isfinite(img).all() and (img[..., :3].sum(axis=-1) > 0).sum() > 4
    np.testing.assert_array_equal(
        img, ref.render(_cam(camera_t), RasterConfig(**cfg), pipeline="painter").numpy())
    _checksum_close(img, sj.render(_cam(camera_j), CfgJ(**cfg), pipeline="painter"))


def test_painter_sharded_update_render_chunk():
    """tests/test_parallel.py:831: the whole-scene chunk over a sharded
    group, equal to the unsharded chunk and within the JAX checksums."""
    cfg = dict(width=64, height=64, max_entries_per_tile=1024)
    st, ref = _mixed(PORT, seed=13, rate=1500.0, frames=0), _mixed(PORT, False, 13, 1500.0,
                                                                    frames=0)
    sj = _mixed(JAX, seed=13, rate=1500.0, frames=0)
    img, sums = st.update_render_chunk(4, DT, _cam(camera_t), RasterConfig(**cfg), pipeline="painter")
    img_r, sums_r = ref.update_render_chunk(4, DT, _cam(camera_t), RasterConfig(**cfg),
                                            pipeline="painter")
    img_j, sums_j = sj.update_render_chunk(4, DT, _cam(camera_j), CfgJ(**cfg), pipeline="painter")
    assert np.isfinite(img.numpy()).all() and st.group_alive("big") > 0
    np.testing.assert_array_equal(img.numpy(), img_r.numpy())
    np.testing.assert_array_equal(sums.numpy(), sums_r.numpy())
    for a, b in zip(sums.numpy(), np.asarray(sums_j)):
        _checksum_close(a, b)
    _same_pool(st._groups["big"]["pools"], sj._groups["big"]["pools"])


def test_sharded_group_step_render_chunk():
    """``ShardedEffect.step_render_chunk`` (inherited from InstancedEffect)
    steps the shards and renders the assembled pools: equal to the
    unsharded group's chunk."""
    asset = models_t.gradient_effect(capacity=128)
    fx = ShardedEffect(asset, 4, make_mesh(CPUS, dp=2, sp=4), device="cpu")
    plain = InstancedEffect(asset, 4, device="cpu")
    rng = np.random.default_rng(7)
    ins = [fx.make_inputs(rng.integers(0, 40, 4), rng.integers(0, 2**32, 4, dtype=np.uint32))
           for _ in range(6)]
    sims = [SimParams(time=j * DT, delta_time=DT) for j in range(6)]
    ii, ss = fx.effect.stack_frames(ins, sims)
    cam, cfg = _cam(camera_t), RasterConfig(64, 64, max_entries_per_tile=256)
    pools, img, sums = fx.step_render_chunk(fx.create_pools(), ii, ss, cam, cfg)
    pools_r, img_r, sums_r = plain.step_render_chunk(plain.create_pools(), ii, ss, cam, cfg)
    assert float(sums[-1]) > 0
    _same_port(pools, pools_r)
    np.testing.assert_array_equal(img.numpy(), img_r.numpy())
    np.testing.assert_array_equal(sums.numpy(), sums_r.numpy())


# -- sharded effects (add(mesh=)) ------------------------------------------------


def _tree(side, sharded=True, seed=3, **kw_add):
    Scene, models, _, _, mk, kw = side
    s = Scene(seed=seed, **kw)
    s.add(models.firework_effect(capacity=512), "p", mesh=mk() if sharded else None, **kw_add)
    s.add(models.firework_trail_effect(capacity=2048), "c", parent="p", **kw_add)
    return s


def test_sharded_event_tree_renders():
    """tests/test_parallel.py:740: a sharded tree through the scene's split
    passes (a no-op raster override each) equals the unsharded tree's frame;
    the painter pass too (tests/test_parallel.py:855)."""
    noop = {"max_entries_per_tile": 64}
    st, ref, sj = (_tree(PORT, raster_override=noop), _tree(PORT, False, raster_override=noop),
                   _tree(JAX, raster_override=noop))
    for _ in range(45):
        for s in (st, ref, sj):
            s.update(DT)
    cfg = dict(width=64, height=64)
    for pipeline in ("split", "painter"):
        if pipeline == "painter":
            for s in (st, ref, sj):
                for n in ("p", "c"):
                    s[n].raster_override = None
        img = st.render(_cam(camera_t, z=6.0), RasterConfig(**cfg), pipeline=pipeline).numpy()
        assert np.isfinite(img).all() and img[..., :3].sum() > 0.0
        np.testing.assert_array_equal(
            img, ref.render(_cam(camera_t, z=6.0), RasterConfig(**cfg), pipeline=pipeline).numpy())
        _checksum_close(img, sj.render(_cam(camera_j, z=6.0), CfgJ(**cfg), pipeline=pipeline))


def test_sharded_child_mesh_mismatch_rejected():
    """tests/test_parallel.py:757: a child on another mesh than its parent's."""
    for Scene, models, _, _, mk, kw in (JAX, PORT):
        s = Scene(seed=0, **kw)
        s.add(models.firework_effect(capacity=512), "p", mesh=mk(dp=8, sp=1))
        with pytest.raises(ValueError, match="parent's mesh"):
            s.add(models.firework_trail_effect(capacity=2048), "c", parent="p", mesh=mk(dp=4, sp=2))


def test_sharded_capacity_divisibility_rejected():
    """tests/test_parallel.py:771: a capacity the mesh does not divide."""
    for Scene, models, _, _, mk, kw in (JAX, PORT):
        s = Scene(seed=0, **kw)
        with pytest.raises(ValueError, match="divisible"):
            s.add(models.spawn_gravity_effect(capacity=500), "odd", mesh=mk())
        with pytest.raises(ValueError, match="divisible"):
            s.add(models.spawn_gravity_effect(capacity=512), "odd", mesh=mk(), capacity=500)


def _update_settled(s):
    """``s.update(DT)``, then a JAX scene's pools waited for, so that no two
    of its 8-device programs are in flight at once: XLA's CPU client runs
    every device's part on one pool of as many threads as the host has
    cores, and two programs that each hold part of it in an all-gather wait
    on each other until the 40 s rendezvous timeout aborts the process
    (seen with conftest's 8 virtual devices on an 8-core host when 40 JAX
    frames were dispatched back to back)."""
    s.update(DT)
    if isinstance(s, SceneJ):
        jax.block_until_ready([inst.pool for inst in s.effects()])


def test_sharded_checkpoint_crosses_between_packages():
    """A sharded tree saved mid-burst (events in flight) by the JAX package
    loads into the port's sharded tree; 20 frames later it agrees with the
    JAX tree run on, and the port's own save (the assembled pools, the
    gap-separated buffers) loads into a sharded port tree of another seed
    that then runs bit for bit as the first. (The JAX package's loader
    puts single-device arrays into a scene; a sharded JAX scene is not
    loaded here.)"""
    import os
    import tempfile

    sj, st, ref = _tree(JAX, seed=9), _tree(PORT, seed=9), _tree(PORT, seed=99)
    for _ in range(40):
        _update_settled(sj)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tree.npz")
        save_j(sj, path)
        load_scene_state(st, path)
        assert isinstance(st["c"].pool, ShardedPool)
        _same_pool(st["c"].pool, sj["c"].pool)
        path2 = os.path.join(tmp, "port.npz")
        save_scene_state(st, path2)
        load_scene_state(ref, path2)
    for _ in range(20):
        for s in (sj, st, ref):
            _update_settled(s)
    assert st["c"].alive_count() > 0
    for n in ("p", "c"):
        _same_pool(st[n].pool, sj[n].pool)
        _same_port(st[n].pool, ref[n].pool)


def test_hot_reload_of_sharded_entities():
    """scene.py:1004-1007 and 873-949: a layout edit of a sharded group and
    a capacity edit of a sharded effect rebuild them on the same mesh
    (the group's pools migrate), as the JAX package does."""
    from bevy_hanabi_tpu.modifiers import SetAttributeModifier as SetJ
    from bevy_hanabi_tpu_torch.modifiers import SetAttributeModifier as SetT

    out = []
    for side, Set in ((JAX, SetJ), (PORT, SetT)):
        Scene, models, _, _, mk, kw = side
        s = Scene(seed=2, **kw)
        mesh = mk(dp=4, sp=2)
        g = s.add_sharded_group(models.spawn_gravity_effect(capacity=64, rate=600.0), count=8,
                                mesh=mesh)
        s.add(models.spawn_gravity_effect(capacity=128, rate=600.0), "fx", mesh=mk())
        for _ in range(5):
            s.update(DT)
        alive = s.group_alive(g)
        pkg = bj if side is JAX else __import__("bevy_hanabi_tpu_torch")
        w = pkg.ExprWriter()
        s._groups[g]["asset"].init(Set(pkg.attributes.AXIS_X, w.lit((1.0, 0.0, 0.0)).expr()))
        s["fx"].asset.capacity = 256
        s.update(DT)
        assert s._groups[g]["fx"].mesh is mesh and s["fx"].fx.mesh is not None
        assert s.group_alive(g) >= alive  # the pools migrated
        assert s["fx"].pool.capacity == 256
        out.append((s._groups[g]["pools"], s["fx"].pool))
    (gj, fj), (gt, ft) = out
    assert isinstance(gt, ShardedPool) and isinstance(ft, ShardedPool)
    _same_pool(gt, gj)
    _same_pool(ft, fj)


@pytest.mark.parametrize("what", ["group", "effect"])
def test_validate_traps_poison_in_sharded_pools(what):
    """tests/test_utils.py:247-300 on sharded pools: a poisoned live lane
    raises at the validated frame in both packages, a clean one in neither."""
    def poison_j(pool):
        import jax.numpy as jnp

        pos = pool.attrs["position"]
        i = tuple(np.argwhere(np.asarray(pool.alive))[0])
        # kept on the mesh: the sharded step takes its pools sharded
        bad = jax.device_put(pos.at[i].set(jnp.nan), pos.sharding)
        return type(pool)({**pool.attrs, "position": bad}, pool.alive, pool.seed, pool.counter)

    def poison_t(pool):
        shard = next(p for p in pool.flat if bool(p.alive.any()))
        i = tuple(torch.nonzero(shard.alive)[0].tolist())
        shard.attrs["position"] = shard.attrs["position"].clone()
        shard.attrs["position"][i] = float("nan")
        return pool

    outcomes = []
    for side, poison in ((JAX, poison_j), (PORT, poison_t)):
        Scene, models, _, _, mk, kw = side
        s = Scene(seed=0, **kw)
        asset = models.spawn_gravity_effect(capacity=64, rate=600.0)
        if what == "group":
            s.add_sharded_group(asset, count=8, mesh=mk(dp=4, sp=2), name="x")
        else:
            s.add(asset, "x", mesh=mk())
        s.debug.validate = True
        s.update(DT)  # clean: no raise
        s.debug.validate = False
        if what == "group":
            s._groups["x"]["pools"] = poison(s._groups["x"]["pools"])
        else:
            s["x"].pool = poison(s["x"].pool)
        s.debug.validate = True
        try:
            s.update(DT)
            outcomes.append(None)
        except Exception as e:  # noqa: BLE001 - the outcome is what is compared
            outcomes.append("nan" in str(e).lower())
    assert outcomes[0] is not None and outcomes == [True, True], outcomes


def test_sharded_group_culling():
    """A sharded group with ``cull_pad`` takes part in frustum culling from
    its assembled pools, culled where the JAX package culls it."""
    culled = []
    for Scene, models, cm, _, mk, kw in (JAX, PORT):
        s = Scene(seed=1, **kw)
        s.add_sharded_group(models.spawn_gravity_effect(capacity=64, rate=600.0), count=8,
                            mesh=mk(dp=4, sp=2), name="g", cull_pad=0.5,
                            transforms=np.tile(np.eye(3, 4, dtype=np.float32), (8, 1, 1)))
        for _ in range(3):
            s.update(DT)
        away = cm.CameraParams(view=cm.look_at(np.array([50.0, 0.0, 8.0]), np.array([80.0, 0.0, 0.0]),
                                               np.array([0.0, 1.0, 0.0])),
                               proj=cm.perspective(math.radians(60.0), 1.0, 0.1, 20.0),
                               viewport=(64, 64))
        culled.append((s._culled_names([_cam(cm)], for_render=True),
                       s._culled_names([away], for_render=True)))
    assert culled[0] == culled[1] == (set(), {"g"})
