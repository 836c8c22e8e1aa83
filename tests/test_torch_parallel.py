"""The port's sharding (``bevy_hanabi_tpu_torch.parallel``) against the JAX
package's, on the CPU: the mesh, ``ShardedEffect``'s step, and the sharded
event tree of ``CompiledEffect(mesh=)``.

The JAX side runs on ``make_mesh(jax.devices()[:8], dp, sp)`` over the 8
virtual CPU devices of conftest.py; the port on the same factors over
``[torch.device("cpu")] * 8``, one process driving every shard. Inputs come
from a numpy seed, assets cross as JSON. Mirrors tests/test_parallel.py case
by case where the case has a counterpart here (its instanced-only cases are
mirrored in test_torch_instanced.py). Tolerances: alive masks, PCG seeds,
counters, integer attributes and event buffers bit for bit; float
attributes rtol 1e-2 / atol 1e-3 against JAX (transcendental ULPs, the
repo's device gate), and exactly equal between the port's sharded and
unsharded runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_hanabi_tpu as bj
from bevy_hanabi_tpu.models import firework_effect as firework_j
from bevy_hanabi_tpu.models import firework_trail_effect as trail_j
from bevy_hanabi_tpu.models import spawn_gravity_effect as gravity_j
from bevy_hanabi_tpu.parallel import ShardedEffect as ShardedJ
from bevy_hanabi_tpu.parallel import make_mesh as make_mesh_j
from bevy_hanabi_tpu.runtime import HanabiScene as SceneJ
from bevy_hanabi_tpu.runtime import events as events_j
from bevy_hanabi_tpu.runtime.effect import CompiledEffect as CompiledEffectJ
from bevy_hanabi_tpu_torch import EffectAsset, HanabiScene, InstancedEffect, SimParams
from bevy_hanabi_tpu_torch.models import firework_effect, firework_trail_effect
from bevy_hanabi_tpu_torch.parallel import Mesh, ShardedEffect, make_mesh
from bevy_hanabi_tpu_torch.runtime import events as events_t
from bevy_hanabi_tpu_torch.runtime.pool import ShardedPool
from torch_jax_cache import jax_cache_of_the_module  # noqa: F401

DT = 1.0 / 60.0
CPUS = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_jax_cache(monkeypatch):
    """JAX scenes here step on an empty ``CompiledEffect._CACHE``, the old
    dict put back after each test (see test_torch_utils.py)."""
    monkeypatch.setattr(CompiledEffectJ, "_CACHE", {})


def _port(asset_j) -> EffectAsset:
    return EffectAsset.from_json(asset_j.to_json())


def _same_state(attrs, alive, seed, counter, pool_j, exact=False):
    """One pool against the JAX package's: integer state bit for bit, the
    alive lanes' floats within the gate (or exactly)."""
    np.testing.assert_array_equal(alive, np.asarray(pool_j.alive))
    np.testing.assert_array_equal(seed, np.asarray(pool_j.seed))
    np.testing.assert_array_equal(counter, np.asarray(pool_j.counter))
    m = alive
    for name, v in attrs.items():
        want = np.asarray(pool_j.attrs[name])
        if v.dtype == np.float32 and not exact:
            np.testing.assert_allclose(v[m], want[m], rtol=1e-2, atol=1e-3, err_msg=name)
        else:
            np.testing.assert_array_equal(v[m], want[m], err_msg=name)


def _same_port(a, b):
    """Two port pools (host tuples) equal bit for bit."""
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)
    for k in a[0]:
        np.testing.assert_array_equal(a[0][k], b[0][k], err_msg=k)


# -- the mesh ------------------------------------------------------------------


def test_mesh_construction_variants():
    """tests/test_parallel.py:56: the factoring and its ValueError."""
    devs = jax.devices()[:8]
    for kw in ({}, {"sp": 4}, {"dp": 2}, {"dp": 4, "sp": 2}, {"dp": 1, "sp": 8}):
        m_t, m_j = make_mesh(CPUS, **kw), make_mesh_j(devs, **kw)
        assert m_t.shape == dict(m_j.shape)
        assert m_t.axis_names == tuple(m_j.axis_names)
        assert m_t.size == 8 and m_t.flat_devices() == CPUS
    for kw in ({"dp": 3, "sp": 3}, {"dp": 3}):
        with pytest.raises(ValueError, match="dp\\*sp must equal"):
            make_mesh(CPUS, **kw)
        with pytest.raises(ValueError, match="dp\\*sp must equal"):
            make_mesh_j(devs, **kw)


def test_mesh_defaults_to_cuda_devices():
    """With no devices the mesh takes every CUDA device; none are here."""
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in make_mesh().flat_devices())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    with pytest.raises(ValueError, match="rectangular"):
        Mesh([[torch.device("cpu")], []])


def test_sharded_validation():
    """tests/test_parallel.py:67: the divisibility ValueErrors."""
    asset_j = gravity_j(capacity=512, rate=0.0)
    mesh_j = make_mesh_j(jax.devices()[:8], dp=4, sp=2)
    mesh_t = make_mesh(CPUS, dp=4, sp=2)
    for n, cap in ((3, 512), (4, 511)):
        with pytest.raises(ValueError, match="not divisible"):
            ShardedJ(asset_j, n, mesh_j, capacity=cap)
        with pytest.raises(ValueError, match="not divisible"):
            ShardedEffect(_port(asset_j), n, mesh_t, capacity=cap)


# -- the sharded step ----------------------------------------------------------


def _step_both(dp, sp, frames=5, cap=512, ninst=8, seed=0):
    """``frames`` steps of the JAX package's and the port's ShardedEffect
    and the port's InstancedEffect on the same random inputs."""
    asset_j = gravity_j(capacity=cap, rate=0.0)
    rng = np.random.default_rng(seed)
    fx_j = ShardedJ(asset_j, ninst, make_mesh_j(jax.devices()[:8], dp=dp, sp=sp), capacity=cap)
    fx_t = ShardedEffect(_port(asset_j), ninst, make_mesh(CPUS, dp=dp, sp=sp), capacity=cap)
    plain = InstancedEffect(_port(asset_j), ninst, capacity=cap, device="cpu")
    pj, pt, pp = fx_j.create_pools(), fx_t.create_pools(), plain.create_pools()
    for f in range(frames):
        spawn = rng.integers(-3, cap // 3, ninst).astype(np.int32)
        seeds = rng.integers(0, 2**32, ninst, dtype=np.uint32)
        props = {"gravity": rng.uniform(-3, 3, (ninst, 3)).astype(np.float32)}
        pj, _ = fx_j.step(pj, fx_j.shard_inputs(fx_j.make_inputs(spawn, seeds, properties=props)),
                          bj.SimParams(time=f * DT, delta_time=DT))
        sim = SimParams(time=f * DT, delta_time=DT)
        pt, _ = fx_t.step(pt, fx_t.shard_inputs(fx_t.make_inputs(spawn, seeds, properties=props)), sim)
        pp, _ = plain.step(pp, plain.make_inputs(spawn, seeds, properties=props), sim)
    return fx_j, pj, fx_t, pt, plain, pp


@pytest.mark.parametrize("dp,sp", [(4, 2), (2, 4), (8, 1), (1, 8)])
def test_sharded_matches_unsharded(dp, sp):
    """tests/test_parallel.py:24: the sharded step equals the unsharded one
    (bit for bit in the port) and the JAX package's sharded step."""
    fx_j, pj, fx_t, pt, plain, pp = _step_both(dp, sp)
    assert isinstance(pt, ShardedPool) and len(pt.shards) == dp and len(pt.shards[0]) == sp
    assert pt.shards[1 % dp][0].alive.shape == (8 // dp, 512 // sp)
    host = pt.to_numpy()
    _same_state(*host, pj)
    _same_port(host, pp.to_numpy())
    np.testing.assert_array_equal(fx_t.alive_counts(pt).numpy(), np.asarray(fx_j.alive_counts(pj)))
    assert int(fx_t.total_alive(pt)) == int(fx_j.total_alive(pj)) > 0
    # the whole pools cross back as a split and assemble as they were
    again = fx_t.place_pools(fx_t.assemble(pt))
    _same_port(again.to_numpy(), host)


def test_sharded_step_chunk_and_checked():
    """__graft_entry__.py:127-157 at a small size: two spawning steps, then
    a 6-frame ``step_chunk``, its checked twin, and ``step_checked``, each
    against the JAX package's."""
    dp, ninst, cap = 4, 4, 256
    asset_j = gravity_j(capacity=cap, rate=0.0)
    fx_j = ShardedJ(asset_j, ninst, make_mesh_j(jax.devices()[:8], dp=dp, sp=2), capacity=cap)
    fx_t = ShardedEffect(_port(asset_j), ninst, make_mesh(CPUS, dp=dp, sp=2), capacity=cap)
    grav = {"gravity": np.tile(np.asarray([0.0, -3.0, 0.0], np.float32), (ninst, 1))}
    pj, pt = fx_j.create_pools(), fx_t.create_pools()
    for f in range(2):
        args = (np.full(ninst, cap // 2, np.int32), np.arange(ninst, dtype=np.uint32) + f)
        pj, _ = fx_j.step(pj, fx_j.shard_inputs(fx_j.make_inputs(*args, properties=grav)),
                          bj.SimParams(time=f * DT, delta_time=DT))
        pt, _ = fx_t.step(pt, fx_t.shard_inputs(fx_t.make_inputs(*args, properties=grav)),
                          SimParams(time=f * DT, delta_time=DT))
    assert int(fx_t.total_alive(pt)) == ninst * cap

    def frames(fx, Sim, stack):
        ins = [fx.make_inputs(np.full(ninst, 9, np.int32), np.full(ninst, j, np.uint32),
                              properties=grav) for j in range(6)]
        return stack(ins, [Sim(time=(2 + j) * DT, delta_time=DT) for j in range(6)])

    ii, ss = frames(fx_j, bj.SimParams, CompiledEffectJ.stack_frames)
    pj = fx_j.step_chunk(pj, ii, ss)
    ii, ss = frames(fx_t, SimParams, fx_t.effect.stack_frames)
    pt = fx_t.step_chunk(pt, ii, ss)
    _same_state(*pt.to_numpy(), pj)
    ii, ss = frames(fx_j, bj.SimParams, CompiledEffectJ.stack_frames)
    pj = fx_j.step_chunk_checked(pj, ii, ss)
    ii, ss = frames(fx_t, SimParams, fx_t.effect.stack_frames)
    pt = fx_t.step_chunk_checked(pt, ii, ss)
    _same_state(*pt.to_numpy(), pj)
    args = (np.full(ninst, 5, np.int32), np.arange(ninst, dtype=np.uint32))
    pj, _ = fx_j.step_checked(pj, fx_j.make_inputs(*args, properties=grav), bj.SimParams(delta_time=DT))
    pt, _ = fx_t.step_checked(pt, fx_t.make_inputs(*args, properties=grav), SimParams(delta_time=DT))
    _same_state(*pt.to_numpy(), pj)
    with pytest.raises(ValueError, match="instance axis"):
        fx_t.shard_inputs(fx_t.make_inputs(*args)._replace(spawn_count=np.zeros(3, np.int32)))


def test_sharded_emitting_asset_matches_instanced_and_jax():
    """An emitting asset as a ShardedEffect: the firework as 8 instances x
    128 lanes over (dp=4, sp=2), 90 frames of 0-2 spawns an instance. Each
    frame's per-instance buffers equal the port's InstancedEffect's bit for
    bit (the shards' lanes joined, each instance compacted whole), and the
    JAX package's sharded step's: slots, counts and num_events bit for bit,
    the events' payload within the gate. The pools as in the tests above."""
    ninst, cap = 8, 128
    asset_j = firework_j(cap)
    fx_j = ShardedJ(asset_j, ninst, make_mesh_j(jax.devices()[:8], dp=4, sp=2), capacity=cap)
    fx_t = ShardedEffect(_port(asset_j), ninst, make_mesh(CPUS, dp=4, sp=2), capacity=cap)
    plain = InstancedEffect(_port(asset_j), ninst, capacity=cap, device="cpu")
    pj, pt, pp = fx_j.create_pools(), fx_t.create_pools(), plain.create_pools()
    rng = np.random.default_rng(6)
    emitted = 0
    for f in range(90):
        spawn = rng.integers(0, 3, ninst).astype(np.int32)
        seeds = rng.integers(0, 2**32, ninst, dtype=np.uint32)
        pj, ej = fx_j.step(pj, fx_j.shard_inputs(fx_j.make_inputs(spawn, seeds)),
                           bj.SimParams(time=f * DT, delta_time=DT))
        sim = SimParams(time=f * DT, delta_time=DT)
        pt, et = fx_t.step(pt, fx_t.shard_inputs(fx_t.make_inputs(spawn, seeds)), sim)
        pp, ep = plain.step(pp, plain.make_inputs(spawn, seeds), sim)
        assert sorted(et) == sorted(ep) == sorted(ej) == [0]
        t, p, j = et[0], ep[0], ej[0]
        for a, b in ((t.parent_slot, p.parent_slot), (t.count, p.count),
                     (t.num_events, p.num_events), *((t.payload[k], p.payload[k]) for k in p.payload)):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(t.num_events.numpy(), np.asarray(j.num_events))
        np.testing.assert_array_equal(t.parent_slot.numpy(), np.asarray(j.parent_slot))
        np.testing.assert_array_equal(t.count.numpy(), np.asarray(j.count))
        for k, v in j.payload.items():
            for i, ne in enumerate(t.num_events.tolist()):
                np.testing.assert_allclose(t.payload[k][i, :ne].numpy(), np.asarray(v)[i, :ne],
                                           rtol=1e-2, atol=1e-3, err_msg=k)
        emitted += int(t.num_events.sum())
    assert emitted > 0
    _same_state(*pt.to_numpy(), pj)
    _same_port(pt.to_numpy(), pp.to_numpy())


# -- cross-shard spawn events --------------------------------------------------


def _tree(Scene, fw, tr, mesh=None, seed=11, **kw):
    s = Scene(seed=seed, **kw)
    s.add(fw(capacity=512), "p", mesh=mesh)
    s.add(tr(capacity=2048), "c", parent="p")
    return s


def _same_tree(st, sj, exact_to=None):
    for name in ("p", "c"):
        _same_state(*st[name].pool.to_numpy(), sj[name].pool)
        if exact_to is not None:
            _same_port(st[name].pool.to_numpy(), exact_to[name].pool.to_numpy())


def _same_events(ev_t, ev_j, exact_payload=False):
    """An event buffer against the JAX package's: slots, counts and length
    bit for bit (the gaps of a sharded buffer included), the payload of the
    events within the gate (or bit for bit)."""
    np.testing.assert_array_equal(ev_t.parent_slot.numpy().astype(np.uint32),
                                  np.asarray(ev_j.parent_slot))
    count = ev_t.count.numpy().astype(np.uint32)
    np.testing.assert_array_equal(count, np.asarray(ev_j.count))
    assert int(ev_t.num_events) == int(ev_j.num_events)
    for k, v in ev_j.payload.items():
        got, want = ev_t.payload[k].numpy(), np.asarray(v)
        if exact_payload:
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        else:
            np.testing.assert_allclose(got[count > 0], want[count > 0], rtol=1e-2, atol=1e-3)


def test_sharded_event_tree_matches_single_device():
    """tests/test_parallel.py:697: the firework tree 8-way sharded, 60
    update() frames: rockets die, events cross shards, trails inherit. The
    port's sharded tree equals its unsharded one bit for bit and the JAX
    package's sharded tree (its event buffers too, gaps and all)."""
    mesh_t = make_mesh(CPUS)
    sj = _tree(SceneJ, firework_j, trail_j, make_mesh_j(jax.devices()[:8]))
    st = _tree(HanabiScene, firework_effect, firework_trail_effect, mesh_t, device="cpu")
    ref = _tree(HanabiScene, firework_effect, firework_trail_effect, device="cpu")
    assert st["p"].fx.mesh is mesh_t and st["c"].fx.mesh is mesh_t  # the child inherits
    assert st["c"].fx.parent_const_count is None  # gap-separated buffers
    assert isinstance(st["c"].pool, ShardedPool) and len(st["c"].pool.flat) == 8
    max_child, gapped = 0, False
    for _ in range(60):
        sj.update(DT)
        st.update(DT)
        ref.update(DT)
        max_child = max(max_child, st["c"].alive_count())
        ev_t, ev_j = st["p"].last_events[0], sj["p"].last_events[0]
        _same_events(ev_t, ev_j)
        n = int(ev_t.num_events)
        gapped |= n > 0 and bool((ev_t.count[:n] == 0).any())
    assert max_child > 0 and st["c"].alive_count() > 0, "no child ever spawned"
    assert gapped, "no frame had events on two shards with a gap between them"
    _same_tree(st, sj, exact_to=ref)
    assert st["c"].alive_count() == sj["c"].alive_count() == ref["c"].alive_count()


def test_sharded_event_tree_update_chunk():
    """tests/test_parallel.py:727: the family chunk over sharded pools and
    buffers, against the JAX package's and the port's unsharded chunk."""
    sj = _tree(SceneJ, firework_j, trail_j, make_mesh_j(jax.devices()[:8]), seed=7)
    st = _tree(HanabiScene, firework_effect, firework_trail_effect, make_mesh(CPUS, dp=4, sp=2),
               seed=7, device="cpu")
    ref = _tree(HanabiScene, firework_effect, firework_trail_effect, seed=7, device="cpu")
    for s in (sj, st, ref):
        s.update_chunk(60, DT)
    assert st["c"].alive_count() > 0
    _same_tree(st, sj, exact_to=ref)
    _same_events(st["p"].last_events[0], sj["p"].last_events[0])


def test_sharded_child_of_plain_parent():
    """A sharded child of an unsharded parent reads the dense buffer with
    the rank // K map, each shard ranking among the whole pool."""
    scenes = []
    for Scene, fw, tr, mesh, kw in ((SceneJ, firework_j, trail_j,
                                     make_mesh_j(jax.devices()[:8], dp=2, sp=4), {}),
                                    (HanabiScene, firework_effect, firework_trail_effect,
                                     make_mesh(CPUS, dp=2, sp=4), {"device": "cpu"})):
        s = Scene(seed=5, **kw)
        s.add(fw(capacity=512), "p")
        s.add(tr(capacity=2048), "c", parent="p", mesh=mesh)
        assert s["c"].fx.parent_const_count == 4
        for _ in range(50):
            s.update(DT)
        scenes.append(s)
    sj, st = scenes
    assert st["c"].alive_count() > 0
    _same_tree(st, sj)


def test_event_index_skips_the_gaps():
    """``consume_events`` on a gap-separated buffer of 8 shards, a child
    shard's ranks offset into the whole pool (``lanes``), against the JAX
    package's consume on the whole child pool."""
    rng = np.random.default_rng(3)
    n_parent, n_child, shards = 512, 2048, 8
    mask = rng.random(n_parent) < 0.1
    count = np.where(mask, rng.integers(1, 7, n_parent), 0).astype(np.uint32)
    pos = rng.standard_normal((n_parent, 3)).astype(np.float32)
    # the sharded build: each shard compacted on its own, slots made global
    parts = []
    size = n_parent // shards
    for d in range(shards):
        sl = slice(d * size, (d + 1) * size)
        b = events_t.build_event_buffer(torch.from_numpy(mask[sl]),
                                        torch.from_numpy(count[sl].astype(np.int64)),
                                        {"position": torch.from_numpy(pos[sl])})
        b.parent_slot = b.parent_slot + d * size
        parts.append(b)
    buf_t = events_t.EventBuffer.concat(parts, "cpu")
    mesh_j = make_mesh_j(jax.devices()[:8])
    fx_j = CompiledEffectJ(firework_j(n_parent), mesh=mesh_j)
    buf_j = fx_j._build_events_sharded(jnp.asarray(count), {"position": jnp.asarray(pos)}, n_parent)
    _same_events(buf_t, buf_j, exact_payload=True)
    dead = rng.random(n_child) < 0.7
    rank = np.cumsum(dead) - dead
    pslot_j, total_j, pay_j = events_j.consume_events(buf_j, jnp.asarray(rank, jnp.int32))
    lanes = n_child // shards
    for d in range(shards):
        sl = slice(d * lanes, (d + 1) * lanes)
        pslot_t, total_t, pay_t = events_t.consume_events(
            buf_t, torch.from_numpy(rank[sl].astype(np.int32)), lanes=n_child)
        spawned = rank[sl] < int(total_j)
        np.testing.assert_array_equal(pslot_t.numpy()[spawned].astype(np.uint32),
                                      np.asarray(pslot_j)[sl][spawned])
        np.testing.assert_array_equal(pay_t["position"].numpy()[spawned],
                                      np.asarray(pay_j["position"])[sl][spawned])
        assert int(total_t) == int(total_j)
