"""The port's native (C++) host runtime against the JAX package's, on the CPU.

``bevy_hanabi_tpu_torch.native`` builds the JAX package's C++ source (the
same bytes) into ``build/`` and binds it with the same ctypes signatures.
The JAX package's ten tests of tests/test_native.py run here against the
port's module; then the two banks tick bit-equal counts (the same integer
and float ops on the same PCG32 streams, so no tolerance), the slab
allocators agree, ``make_spawner_bank`` chooses as the JAX package does,
and a scene's group with ``CpuValue.uniform`` spawner settings spawns
bit-equal counts and alive masks in both packages through ``add_group``,
``add_sharded_group`` and a hot-reload rebuild.
"""

import ctypes
import time
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

import bevy_hanabi_tpu as bj
import bevy_hanabi_tpu.models  # noqa: F401
import bevy_hanabi_tpu.native as native_j
import bevy_hanabi_tpu.spawn as spawn_j
import bevy_hanabi_tpu_torch as bt
import bevy_hanabi_tpu_torch.models  # noqa: F401
import bevy_hanabi_tpu_torch.native as native_t
import bevy_hanabi_tpu_torch.spawn as spawn_t
from bevy_hanabi_tpu.parallel import make_mesh as make_mesh_j
from bevy_hanabi_tpu.runtime import HanabiScene as SceneJ
from bevy_hanabi_tpu.runtime.effect import CompiledEffect as CompiledEffectJ
from bevy_hanabi_tpu_torch import HanabiScene
from bevy_hanabi_tpu_torch.cpu_value import CpuValue
from bevy_hanabi_tpu_torch.native import NativeSpawnerBank, SlabAllocator, native_available
from bevy_hanabi_tpu_torch.parallel import make_mesh
from bevy_hanabi_tpu_torch.spawn import EffectSpawner, SpawnerBank, SpawnerSettings
from torch_jax_cache import jax_cache_of_the_module  # noqa: F401

DT = 1.0 / 60.0


@pytest.fixture(autouse=True)
def _fresh_jax_cache(monkeypatch):
    monkeypatch.setattr(CompiledEffectJ, "_CACHE", {})


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded():
    """The JAX package's native library, the reference of this file. Its
    loader builds it beside its source at first use and gives up for the
    whole process when the file it opens is still being written by another
    process, as a fresh checkout's parallel test workers race to build it;
    a worker that lost that race loads it again."""
    for _ in range(10):
        if native_j.load_native() is not None:
            break
        time.sleep(1.0)
        native_j._TRIED = False
    assert native_j.load_native() is not None, "the JAX package's native library does not load"


# -- tests/test_native.py, against the port's module --------------------------


def test_native_builds():
    assert native_available()
    lib = native_t._library_path()
    assert lib.parent == native_t.BUILD_DIR and lib.exists()


def test_native_spawner_rate_matches_python():
    settings = SpawnerSettings.rate(7.3)
    nb = NativeSpawnerBank(settings, 16)
    ref = EffectSpawner(settings)
    for frame in range(300):
        np.testing.assert_array_equal(nb.tick(1 / 60), ref.tick(1 / 60), err_msg=f"frame {frame}")


def test_native_spawner_zero_dt_and_multicycle_match_python():
    nb = NativeSpawnerBank(SpawnerSettings.once(100.0), 4)
    ref = EffectSpawner(SpawnerSettings.once(100.0))
    np.testing.assert_array_equal(nb.tick(0.0), ref.tick(0.0))
    settings = replace(SpawnerSettings.burst(10.0, 1.0), spawn_duration=CpuValue.single(0.05))
    nb2 = NativeSpawnerBank(settings, 3)
    ref2 = EffectSpawner(settings)
    for dt in (8.0, 0.3, 0.0, 2.7, 1 / 60):
        np.testing.assert_array_equal(nb2.tick(dt), ref2.tick(dt), err_msg=f"dt={dt}")


def test_native_spawner_burst_and_once():
    nb = NativeSpawnerBank(SpawnerSettings.burst(10.0, 0.5), 4)
    total = np.zeros(4, np.int64)
    for _ in range(60):
        total += nb.tick(1 / 60)
    np.testing.assert_array_equal(total, 20)
    once = NativeSpawnerBank(SpawnerSettings.once(100.0), 8)
    np.testing.assert_array_equal(once.tick(1 / 60), 100)
    np.testing.assert_array_equal(once.tick(1 / 60), 0)
    once.reset()
    np.testing.assert_array_equal(once.tick(1 / 60), 100)


def test_native_spawner_uniform_ranges():
    s = SpawnerSettings(count=CpuValue.uniform(1.0, 10.0), spawn_duration=CpuValue.single(0.0),
                        period=CpuValue.single(0.05), cycle_count=0)
    nb = NativeSpawnerBank(s, 8, seed=42)
    totals = np.zeros(8, np.int64)
    for _ in range(100):
        totals += nb.tick(0.05)
    # E[count] = 5.5 a cycle, ~100-200 cycles; independent streams
    assert (totals > 100).all() and (totals < 1500).all()
    assert len(set(totals.tolist())) > 2


def test_native_spawner_set_active():
    nb = NativeSpawnerBank(SpawnerSettings.rate(600.0), 4)
    nb.set_active(False, index=2)
    c = nb.tick(1.0)
    assert c[2] == 0 and c[0] > 0


def test_native_spawner_scales():
    nb = NativeSpawnerBank(SpawnerSettings.rate(100.0), 10000)
    c = nb.tick(0.1)
    assert c.shape == (10000,)
    np.testing.assert_array_equal(c, 10)


def test_slab_alloc_free_coalesce():
    slab = SlabAllocator(1000)
    a, b, c = slab.alloc(100), slab.alloc(200), slab.alloc(300)
    assert (a, b, c) == (0, 100, 300)
    assert slab.used == 600
    slab.free(b, 200)
    assert slab.alloc(150) == 100  # the hole, best fit
    slab.free(a, 100)
    slab.free(100, 150)
    slab.free(c, 300)
    assert slab.used == 0
    assert slab.num_free_ranges() == 1  # fully coalesced
    assert slab.largest_free == 1000


def test_slab_exhaustion_and_errors():
    slab = SlabAllocator(64)
    assert slab.alloc(64) == 0
    assert slab.alloc(1) is None
    with pytest.raises(ValueError):
        slab.free(0, 128)  # out of bounds
    slab.free(0, 64)
    with pytest.raises(ValueError):
        slab.free(0, 64)  # double free


def _python_slab(capacity):
    py = SlabAllocator.__new__(SlabAllocator)
    py.capacity, py._lib, py._handle = capacity, None, None
    py._free, py._used = {0: capacity}, 0
    return py


def test_slab_python_fallback_equivalence():
    py = _python_slab(256)
    offs = [py.alloc(s) for s in (32, 64, 16)]
    assert offs == [0, 32, 96]
    py.free(32, 64)
    assert py.alloc(60) == 32
    nat = SlabAllocator(256)
    assert [nat.alloc(s) for s in (32, 64, 16)] == offs
    nat.free(32, 64)
    assert nat.alloc(60) == 32


# -- the port's bank and allocator against the JAX package's ------------------


def _settings(pkg, kind):
    S, V = pkg.spawn.SpawnerSettings, pkg.cpu_value.CpuValue
    if kind == "constant":
        return S.rate(7.3)
    if kind == "uniform":
        return S.burst(V.uniform(1.0, 10.0), 0.05)
    if kind == "burst":
        return replace(S.burst(V.uniform(2.0, 6.0), V.uniform(0.02, 0.1)),
                       spawn_duration=V.uniform(0.0, 0.01))
    # multi-cycle: three cycles of a spread duration, not emitting on start
    return S(V.uniform(5.0, 50.0), V.uniform(0.05, 0.2), V.uniform(0.2, 0.4), 3,
             emit_on_start=False)


@pytest.mark.parametrize("kind", ["constant", "uniform", "burst", "multicycle"])
def test_bank_ticks_like_jax(kind):
    """300 ticks of dt cycling through 1/60, 0, 0.3 and 1/144: equal
    counts every tick (the same C++ on the same PCG32 streams), then a
    paused instance, one reset and a resumed run, equal too."""
    seed = 123
    bj_ = native_j.NativeSpawnerBank(_settings(bj, kind), 6, seed=seed)
    bt_ = NativeSpawnerBank(_settings(bt, kind), 6, seed=seed)
    dts = [1 / 60, 0.0, 0.3, 1 / 144]
    for k in range(300):
        if k == 100:
            for b in (bj_, bt_):
                b.set_active(False, index=4)
        if k == 150:
            for b in (bj_, bt_):
                b.reset(1)
        if k == 200:
            for b in (bj_, bt_):
                b.set_active(True)
                b.reset()
        np.testing.assert_array_equal(bt_.tick(dts[k % 4]), bj_.tick(dts[k % 4]), err_msg=f"{k}")


def test_uniform_burst_counts_are_the_jax_bank_s():
    """The sums that chip_smoke.py holds as a constant: six instances,
    seed 123, burst(uniform(1, 10), 0.05), ten ticks of 1/60 s."""
    settings = SpawnerSettings.burst(CpuValue.uniform(1.0, 10.0), 0.05)
    banks = [spawn_t.make_spawner_bank(settings, 6, seed=123),
             spawn_j.make_spawner_bank(_settings(bj, "uniform"), 6, seed=123)]
    sums = [sum(b.tick(DT).astype(np.int64) for _ in range(10)) for b in banks]
    np.testing.assert_array_equal(sums[0], sums[1])
    np.testing.assert_array_equal(sums[0], [16, 22, 17, 19, 13, 27])


def test_slab_allocator_like_jax():
    sequence = [("a", 100), ("a", 37), ("a", 500), ("f", 1), ("a", 20), ("a", 64), ("f", 0),
                ("f", 2), ("a", 600), ("a", 1), ("f", 4), ("a", 400), ("a", 0), ("a", 10**6)]
    out = []
    for slab in (native_j.SlabAllocator(1024), SlabAllocator(1024), _python_slab(1024)):
        offs, trace = [], []
        for op, v in sequence:
            if op == "a":
                off = slab.alloc(v)
                offs.append((off, v))
                trace.append(off)
            else:
                off, size = offs[v]
                slab.free(off, size)
            trace.append((slab.used, slab.largest_free, slab.num_free_ranges()))
        out.append(trace)
    assert out[1] == out[0]
    assert out[2] == out[0]  # the Python mirror too
    assert native_t.NO_SPACE == native_j.NO_SPACE == 0xFFFFFFFF


def test_make_spawner_bank_chooses_like_jax():
    s_t, s_j = _settings(bt, "uniform"), _settings(bj, "uniform")
    got = type(spawn_t.make_spawner_bank(s_t, 4)).__name__
    assert got == type(spawn_j.make_spawner_bank(s_j, 4)).__name__ == "NativeSpawnerBank"


def test_no_compiler_takes_the_numpy_bank_and_python_slab(monkeypatch):
    """The two documented fallbacks, and only where no g++ is on PATH."""
    monkeypatch.setattr(native_t, "_LIB", None)
    monkeypatch.setattr(native_t.shutil, "which", lambda name: None)
    assert not native_available()
    assert type(spawn_t.make_spawner_bank(_settings(bt, "constant"), 4)) is SpawnerBank
    slab = SlabAllocator(64)
    assert slab._handle is None and slab.alloc(16) == 0 and slab.used == 16
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        NativeSpawnerBank(_settings(bt, "constant"), 4)


def test_failing_compiler_raises_with_its_output(monkeypatch, tmp_path):
    """A g++ that fails raises with the compiler's diagnostics; nothing is
    written next to either package's source or into build/."""
    bad = tmp_path / "hanabi_native.cpp"
    bad.write_text("extern \"C\" int broken( { return 0; }\n")
    monkeypatch.setattr(native_t, "_LIB", None)
    monkeypatch.setattr(native_t, "_SRC", bad)
    with pytest.raises(RuntimeError, match="error"):
        native_t.load_native()
    assert not native_t._library_path().exists()
    assert not list(tmp_path.glob("*.so"))


def test_library_is_loaded_from_build():
    lib = native_t.load_native()
    assert isinstance(lib, ctypes.CDLL)
    assert lib._name == str(native_t._library_path())
    here = native_t._SRC.parent.parent
    assert not list(here.rglob("*.so"))  # nothing beside the port's source


# -- a group with uniform spawner settings in both scenes ---------------------


def _uniform_asset(pkg):
    return pkg.models.spawn_gravity_effect(capacity=64).with_spawner(_settings(pkg, "uniform"))


def _same_group(sj, st, name):
    pj, pt = sj._groups[name]["pools"], st._groups[name]["pools"]
    _, alive, seed, counter = pt.to_numpy()
    np.testing.assert_array_equal(counter, np.asarray(pj.counter))  # the spawn totals
    np.testing.assert_array_equal(alive, np.asarray(pj.alive))
    np.testing.assert_array_equal(seed, np.asarray(pj.seed))


@pytest.mark.parametrize("how", ["add_group", "add_sharded_group", "hot_reload"])
def test_uniform_group_spawns_like_jax(how):
    """Eight instances of 64 lanes, six frames (and six after a layout
    edit rebuilds the group): spawn totals, alive masks and seeds bit-equal
    to the JAX scene's. The sharded group lies on a (dp=4, sp=2) mesh, of
    conftest's virtual CPU devices in JAX and of ``[cpu] * 8`` here."""
    scenes = []
    for pkg, Scene, kw, mk in ((bj, SceneJ, {}, lambda: make_mesh_j(jax.devices()[:8], dp=4, sp=2)),
                               (bt, HanabiScene, {"device": "cpu"},
                                lambda: make_mesh([torch.device("cpu")] * 8, dp=4, sp=2))):
        s = Scene(seed=9, **kw)
        if how == "add_sharded_group":
            s.add_sharded_group(_uniform_asset(pkg), count=8, mesh=mk(), name="g")
        else:
            s.add_group(_uniform_asset(pkg), count=8, name="g")
        for _ in range(6):
            s.update(DT)
        if how == "hot_reload":
            w = pkg.ExprWriter()
            s._groups["g"]["asset"].init(pkg.SetAttributeModifier(
                pkg.attributes.AXIS_X, w.lit((1.0, 0.0, 0.0)).expr()))
            for _ in range(6):
                s.update(DT)
        assert type(s._groups["g"]["bank"]).__name__ == "NativeSpawnerBank"
        scenes.append(s)
    _same_group(*scenes, "g")
    assert scenes[1].group_alive("g") > 0
