"""The reference examples and the authoring gaps of the port against the JAX
package, on the CPU.

Every builder of ``models/examples.py`` builds the JAX package's asset
(``to_json`` equal) and runs in the port's ``HanabiScene`` as in the JAX
package's (alive masks and PCG seeds bit for bit, positions rtol 1e-2 /
atol 1e-3, bench.py:121-130); the scenarios of tests/test_examples.py run
at 10 frames; the gallery's 5x5 ``add_group`` grid (examples/run_all.py:
81-97) runs and renders (checksums within 0.5%, bench.py:155-161). Then
what the examples needed of the port: ``texture_sample`` reaching the
render modifiers through ``extract_draw_data``, round and textured ribbons
(the sprite column in segment order), and ``ron.py`` and
``graph/node.py``, copies of the JAX package's (held equal to them in
tests/test_torch_slice.py).
"""

import numpy as np
import pytest
import torch

import bevy_hanabi_tpu as bj
import bevy_hanabi_tpu.models.examples as ex_j
import bevy_hanabi_tpu.render as render_j
import bevy_hanabi_tpu.ron as ron_j
import bevy_hanabi_tpu_torch as bt
import bevy_hanabi_tpu_torch.models.examples as ex_t
import bevy_hanabi_tpu_torch.render.camera as render_t
import bevy_hanabi_tpu_torch.ron as ron_t
from bevy_hanabi_tpu.render.extract import extract_draw_data as extract_j
from bevy_hanabi_tpu.render.ribbon import build_ribbon_segments as segments_j
from bevy_hanabi_tpu.runtime import HanabiScene as SceneJ
from bevy_hanabi_tpu_torch import EffectAsset, HanabiScene, RasterConfig
from bevy_hanabi_tpu_torch.models import make_anim_sprite_sheet
from bevy_hanabi_tpu_torch.render.extract import extract_draw_data
from bevy_hanabi_tpu_torch.render.ribbon import build_ribbon_segments
from torch_jax_cache import jax_cache_of_the_module  # noqa: F401

DT = 1.0 / 60.0
FRAMES = 10
CHECKSUM_REL = 0.005
SINGLE = sorted(k for k in ex_j.examples_registry() if k not in ("lifetime", "worms"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain raster path calls small vectorised ops thousands of times,
    each of which wakes OpenMP: run PyTorch single-threaded here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scenes(seed):
    return SceneJ(seed=seed), HanabiScene(seed=seed, device="cpu")


def _same_pool(pool_t, pool_j, label=""):
    attrs, alive, seed, _ = pool_t.to_numpy()
    np.testing.assert_array_equal(alive, np.asarray(pool_j.alive), err_msg=label)
    np.testing.assert_array_equal(seed, np.asarray(pool_j.seed), err_msg=label)
    for name, v in attrs.items():
        want = np.asarray(pool_j.attrs[name])
        if v.dtype == np.float32:
            np.testing.assert_allclose(v[alive], want[alive], rtol=1e-2, atol=1e-3,
                                       err_msg=f"{label} {name}")
        else:
            np.testing.assert_array_equal(v[alive], want[alive], err_msg=f"{label} {name}")


def _checksum_close(a, b):
    assert abs(float(a) - float(b)) <= CHECKSUM_REL * max(abs(float(b)), 1.0), (a, b)


def _cameras(eye=(0.0, 0.0, 8.0), target=(0.0, 0.0, 0.0), size=64):
    return tuple(m.CameraParams(m.look_at(eye, target), m.perspective(0.9, 1.0, 0.1, 200.0),
                                (size, size)) for m in (render_j, render_t))


# ---- the builders --------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(ex_j.examples_registry()))
def test_builder_json_equals_jax(name):
    a, b = ex_j.examples_registry()[name](), ex_t.examples_registry()[name]()
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        pairs = [(a[k], b[k]) for k in a]
    else:
        pairs = [(a, b)]
    for x, y in pairs:
        assert y.to_json() == x.to_json()
        assert EffectAsset.from_json(y.to_json()).to_json() == y.to_json()


@pytest.mark.parametrize("name", SINGLE)
def test_example_runs_like_jax(name):
    """tests/test_examples.py:26 at 10 frames: the same pool in both scenes."""
    sj, st = _scenes(1)
    sj.add(ex_j.examples_registry()[name](), "fx")
    st.add(ex_t.examples_registry()[name](), "fx")
    for _ in range(FRAMES):
        sj.update(DT)
        st.update(DT)
    assert st["fx"].alive_count() == sj["fx"].alive_count()
    _same_pool(st["fx"].pool, sj["fx"].pool, name)


# ---- the scenarios of tests/test_examples.py at 10 frames ------------------------


def test_example_lifetime_trio():
    sj, st = _scenes(1)
    for s, ex in ((sj, ex_j), (st, ex_t)):
        for name, asset in ex.example_lifetime().items():
            s.add(asset, name)
        for _ in range(FRAMES):
            s.update(DT)
    for name in ex_t.example_lifetime():
        assert st[name].alive_count() == sj[name].alive_count() > 0
        _same_pool(st[name].pool, sj[name].pool, name)


def test_example_worms_parent_child_ribbons():
    sj, st = _scenes(2)
    for s, ex in ((sj, ex_j), (st, ex_t)):
        assets = ex.example_worms()
        s.add(assets["heads"], "heads")
        s.add(assets["bodies"], "bodies", parent="heads")
        for _ in range(4 * FRAMES):  # the heads spawn at 2/s: the first after 0.5 s
            s.update(DT)
    assert st["heads"].alive_count() > 0 and st["bodies"].alive_count() > 0
    for name in ("heads", "bodies"):
        _same_pool(st[name].pool, sj[name].pool, name)
    # each body particle carries its parent's counter as ribbon id
    bodies = st["bodies"].pool
    assert len(np.unique(bodies.get("ribbon_id")[bodies.alive].numpy())) >= 1


def test_example_activate_toggling():
    counts = []
    for s, ex in zip(_scenes(3), (ex_j, ex_t)):
        s.add(ex.example_activate(), "fx")
        seen = []
        for active in (None, True, False):
            if active is not None:
                s.set_spawner_active("fx", active)
            for _ in range(FRAMES):
                s.update(DT)
            seen.append(s["fx"].alive_count())
        counts.append(seen)
    assert counts[1] == counts[0]
    assert counts[1][0] == 0 and counts[1][1] > 0


def test_example_spawn_on_command_reset():
    out = []
    for s, ex in zip(_scenes(4), (ex_j, ex_t)):
        s.add(ex.example_spawn_on_command(), "fx")
        s.set_property("fx", "spawn_color", 0xFF00FF00)
        s.set_property("fx", "normal", (0.0, 1.0, 0.0))
        for _ in range(5):
            s.update(DT)
        assert s["fx"].alive_count() == 0
        # "on command": activate + reset fires the once-spawner
        s.set_spawner_active("fx", True)
        s.reset_spawner("fx")
        s.update(DT)
        assert s["fx"].alive_count() == 100
        out.append(s["fx"].pool)
    pool_j, pool_t = out
    colors = pool_t.get("color")[pool_t.alive].numpy()
    assert (colors.astype(np.uint32) == 0xFF00FF00).all()
    _same_pool(pool_t, pool_j)


def test_example_lightning_expression_stress():
    out = []
    for s, ex in zip(_scenes(5), (ex_j, ex_t)):
        s.add(ex.example_lightning(particles_per_bolt=64), "bolt")
        s.set_property("bolt", "wave_seed", 3.25)
        s.update(DT)
        out.append(s)
    sj, st = out
    pool = st["bolt"].pool
    pos = pool.get("position")[pool.alive].numpy()
    assert int(pool.alive.sum()) == 64
    assert pos[:, 1].min() < 0.5 and pos[:, 1].max() > 7.5
    assert np.abs(pos[:, 0]).max() <= 0.9
    _same_pool(pool, sj["bolt"].pool)
    # a new seed property reshapes the bolt without recompiling
    for s in out:
        s.set_property("bolt", "wave_seed", 7.5)
        s.reset_spawner("bolt")
        for _ in range(FRAMES):
            s.update(DT)
    _same_pool(st["bolt"].pool, sj["bolt"].pool)


def test_example_ribbon_trails():
    sj, st = _scenes(6)
    sj.add(ex_j.example_ribbon(), "rib")
    st.add(ex_t.example_ribbon(), "rib")
    for _ in range(FRAMES):
        sj.update(DT)
        st.update(DT)
    pool = st["rib"].pool
    assert (pool.get("ribbon_id")[pool.alive] == 0).all()  # all one ribbon
    _same_pool(pool, sj["rib"].pool)


def test_gallery_instancing_grid():
    """examples/run_all.py:81-97: a 5x5 grid of small emitters through one
    add_group, 10 frames, then a frame at 64x64 in both packages."""
    grid = np.tile(np.eye(3, 4, dtype=np.float32), (25, 1, 1))
    grid[:, 0, 3] = (np.arange(25) % 5 - 2) * 2.0
    grid[:, 1, 3] = (np.arange(25) // 5 - 2) * 2.0
    asset = bj.models.instancing_effect(capacity=512).render(
        bj.SizeOverLifetimeModifier(bj.Gradient.linear((0.15,), (0.05,))))
    sj, st = _scenes(97)
    sj.add_group(asset, 25, "grid", transforms=grid)
    st.add_group(EffectAsset.from_json(asset.to_json()), 25, "grid", transforms=grid)
    for _ in range(FRAMES):
        sj.update(DT)
        st.update(DT)
    assert st.group_alive("grid") == sj.group_alive("grid") > 25
    cam_j, cam_t = _cameras(eye=(0.0, 0.0, 14.0))
    cfg = dict(width=64, height=64, tile_size=16, tile_span=2, max_entries_per_tile=128)
    img_j = np.asarray(sj.render(cam_j, render_j.RasterConfig(**cfg)))
    img_t = st.render(cam_t, RasterConfig(**cfg)).numpy()
    assert img_t[..., :3].max() > 0.05
    _checksum_close(img_t.sum(), img_j.sum())


# ---- texture_sample, round and textured ribbons ----------------------------------


def test_texture_sample_reaches_render_modifiers():
    """A RoundModifier whose roundness is a texture sample at a per-particle
    UV: the textures reach the render-time evaluation through
    extract_draw_data (effect.py:392-399), and the draw's roundness is the
    JAX package's."""
    tex = np.random.default_rng(2).random((8, 6, 4), dtype=np.float32)
    draws = []
    for pkg, Scene, extract, kw in ((bj, SceneJ, extract_j, {}),
                                    (bt, HanabiScene, extract_draw_data, {"device": "cpu"})):
        asset = ex_j.example_2d() if pkg is bj else ex_t.example_2d()
        m = asset.module
        slot = m.add_texture_slot("noise")
        pos = m.attr(pkg.attributes.POSITION)
        uv = m.binary(pkg.graph.BinaryOp.VEC2,
                      m.mul(m.unary(pkg.graph.UnaryOp.X, pos), m.lit(7.3)),
                      m.mul(m.unary(pkg.graph.UnaryOp.Y, pos), m.lit(-5.1)))
        sample = m.texture_sample(slot, uv)
        asset = asset.render(pkg.RoundModifier(m.unary(pkg.graph.UnaryOp.X, sample)))
        s = Scene(seed=3, **kw)
        s.add(asset, "fx", textures=[tex])
        for _ in range(FRAMES):
            s.update(DT)
        cam = _cameras()[0 if pkg is bj else 1]
        texs = [tex] if pkg is bj else [torch.from_numpy(tex)]
        draws.append(extract(asset, s["fx"].pool, cam, textures=texs))
    dj, dt = draws
    alive = dt.alive.numpy()
    assert alive.sum() > 0
    np.testing.assert_array_equal(alive, np.asarray(dj.alive))
    np.testing.assert_allclose(dt.roundness.numpy()[alive], np.asarray(dj.roundness)[alive],
                               rtol=1e-5, atol=1e-6)


def _sprite_ribbon(pkg, ex, textured=True, round_=False):
    """example_ribbon with a flipbook sprite index animated by age (a
    column that varies along each trail), textured and optionally round."""
    asset = ex.example_ribbon()
    m = asset.module
    A = pkg.attributes
    w = pkg.ExprWriter()
    w.module = m
    frame = (w.attr(A.AGE) * 3.0).min(w.lit(3.0)).cast(pkg.INT)
    asset = asset.update(pkg.SetAttributeModifier(A.SPRITE_INDEX, frame.expr()))
    if textured:
        asset = asset.render(pkg.ParticleTextureModifier(0)).render(pkg.FlipbookModifier((4, 1)))
    if round_:
        asset = asset.render(pkg.RoundModifier(m.lit(0.5)))
    return asset


@pytest.mark.parametrize("textured,round_", [(True, False), (False, True), (True, True)],
                         ids=["textured", "round", "textured_round"])
def test_round_and_textured_ribbons_match_jax(textured, round_):
    """Round and textured ribbons render (JAX's ribbon.py:104-121: roundness
    dropped, texture layers kept, the sprite in segment order), in both
    pipelines, within 0.5% of the JAX package's checksum."""
    sheet = make_anim_sprite_sheet(frames=4, size=16)
    texs = [sheet] if textured else []
    sj, st = _scenes(6)
    sj.add(_sprite_ribbon(bj, ex_j, textured, round_), "r", textures=texs)
    st.add(_sprite_ribbon(bt, ex_t, textured, round_), "r", textures=texs)
    for _ in range(40):
        sj.update(DT)
        st.update(DT)
    cam_j, cam_t = _cameras(size=96)
    for pipeline in ("split", "painter"):
        img_j = np.asarray(sj.render(cam_j, render_j.RasterConfig(96, 96), pipeline=pipeline))
        img_t = st.render(cam_t, RasterConfig(96, 96), pipeline=pipeline).numpy()
        assert img_t[..., 3].max() > 0.1
        _checksum_close(img_t.sum(), img_j.sum())


def test_ribbon_sprite_column_in_segment_order():
    """The segment draw's sprite index is JAX's ``sprite_index[remap]`` on
    every valid segment, and it varies along the trail."""
    sj, st = _scenes(6)
    sj.add(_sprite_ribbon(bj, ex_j), "r")
    st.add(_sprite_ribbon(bt, ex_t), "r")
    for _ in range(40):
        sj.update(DT)
        st.update(DT)
    cam_j, cam_t = _cameras()
    seg_j = segments_j(extract_j(sj["r"].asset, sj["r"].pool, cam_j), cam_j)
    seg_t = build_ribbon_segments(extract_draw_data(st["r"].asset, st["r"].pool, cam_t), cam_t)
    valid = seg_t.alive.numpy()
    np.testing.assert_array_equal(valid, np.asarray(seg_j.alive))
    want = np.asarray(seg_j.sprite_index)[np.asarray(seg_j.remap)][valid]
    got = seg_t.sprite_index.numpy()[valid]
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1 and seg_t.roundness is None


# ---- the copies ------------------------------------------------------------------


def test_ron_round_trip_like_jax():
    """Every example asset through RON: the port writes the JAX package's
    text, and reads it back to the asset the JAX package reads."""
    for name, build in ex_t.examples_registry().items():
        assets = build()
        for k, a in (assets.items() if isinstance(assets, dict) else [(name, assets)]):
            try:
                want = ron_j.asset_to_ron(bj.EffectAsset.from_json(a.to_json()))
            except ron_j.RonError:  # a custom modifier exports through JSON only
                with pytest.raises(ron_t.RonError, match="no reference RON counterpart"):
                    ron_t.asset_to_ron(a)
                continue
            text = ron_t.asset_to_ron(a)
            assert text == want, k
            assert ron_t.asset_from_ron(text).to_json() == ron_j.asset_from_ron(text).to_json(), k


def test_node_graph_builds_the_same_module():
    """tests/test_node_graph.py:26: a NodeGraph of the port compiles to the
    JAX package's expressions."""
    mods = []
    for pkg in (bj, bt):
        n = pkg.graph
        g = n.NodeGraph()
        pos = g.add(n.AttributeNode(pkg.attributes.POSITION))
        two = g.add(n.LiteralNode(2.0))
        scaled = g.add(n.MulNode())
        g.link(pos, scaled, "lhs")
        g.link(two, scaled, "rhs")
        norm = g.add(n.NormalizeNode())
        g.link(scaled, norm, "value")
        m = pkg.Module()
        h = g.compile(m, norm)
        mods.append((h, m.to_json()))
    assert mods[1] == mods[0]
