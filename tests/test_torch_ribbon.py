"""The port's ribbon path against the JAX package, on the CPU: the
``(ribbon, age, counter)`` segment sort, ``build_ribbon_segments``, the
ribbon gate, ``ribbon_bench_effect`` through ``step_render_chunk``, and
ribbons in ``HanabiScene`` under both pipelines.

Every case feeds the same inputs to both packages: hand-built or
numpy-seeded pools, or assets built in the JAX package that cross to the
port as JSON. The JAX package runs as its own tests run it (``lax.sort`` on
the CPU; it reaches no Pallas kernel). Tolerances: the sort order, the valid
segment set, alive masks and PCG seeds bit for bit (the same integer ops and
keys); segment geometry within 1e-5 absolute, because XLA's CPU backend may
contract a multiply and an add of the cross product into one fused op where
PyTorch rounds twice (f32 ULPs at these magnitudes); colour exactly (a
gather); images within 1e-5 absolute on the transcendental-free check effect
(the ribbon gate measures 0.0) and checksums within 0.5% where positions
come from sin/cos (bench.py:155-161, the repo's device-gate tolerance).
"""

import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_hanabi_tpu as bj
import bevy_hanabi_tpu_torch as bt
from bevy_hanabi_tpu import attributes as AJ
from bevy_hanabi_tpu.attributes import ParticleLayout as LayoutJ
from bevy_hanabi_tpu.compiler import SimParams as SimJ
from bevy_hanabi_tpu.models import gradient_effect as gradient_j
from bevy_hanabi_tpu.models import ribbon_bench_effect as bench_j
from bevy_hanabi_tpu.models import ribbon_order_check_effect as check_j
from bevy_hanabi_tpu.render import camera as camera_j
from bevy_hanabi_tpu.render.extract import extract_draw_data as extract_j
from bevy_hanabi_tpu.render.extract import resolve_remap
from bevy_hanabi_tpu.render.raster import RasterConfig as CfgJ
from bevy_hanabi_tpu.render.raster import rasterize as rasterize_j
from bevy_hanabi_tpu.render.ribbon import build_ribbon_segments as segments_j
from bevy_hanabi_tpu.runtime import HanabiScene as SceneJ
from bevy_hanabi_tpu.runtime.effect import CompiledEffect as EffectJ
from bevy_hanabi_tpu.runtime.effect import StepInputs as InputsJ
from bevy_hanabi_tpu.runtime.pool import ParticlePool as PoolJ
from bevy_hanabi_tpu_torch import CompiledEffect, EffectAsset, HanabiScene, ParticlePool
from bevy_hanabi_tpu_torch import RasterConfig, SimParams, StepInputs
from bevy_hanabi_tpu_torch.models import ribbon_bench_effect, ribbon_order_check_effect
from bevy_hanabi_tpu_torch.render import camera as camera_t
from bevy_hanabi_tpu_torch.render.extract import ParticleDrawData
from bevy_hanabi_tpu_torch.render.extract import extract_draw_data as extract_t
from bevy_hanabi_tpu_torch.render.raster import rasterize as rasterize_t
from bevy_hanabi_tpu_torch.render.ribbon import build_ribbon_segments, ribbon_sort
from torch_jax_cache import jax_cache_of_the_module  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
DT = 1.0 / 60.0
REL = 0.005  # checksum tolerance (bench.py:155-161)
GEOM_ATOL = 1e-5
SENTINEL = 0xFFFFFFFF


def _ortho(cam_mod):
    return cam_mod.CameraParams(
        view=cam_mod.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0)),
        proj=cam_mod.orthographic(-1, 1, -1, 1, 0.1, 10.0),
        viewport=(64, 64),
    )


def _gate_camera(cam_mod):
    """The device gate's camera (bench.py:195-199)."""
    return cam_mod.CameraParams(
        cam_mod.look_at((0, 0, 6), (0, 0, 0)), cam_mod.perspective(0.9, 1.0, 0.1, 100.0), (128, 128)
    )


def _ribbon_asset_j():
    """test_scene.py:259's asset: RIBBON_ID alone (the pool carries the rest)."""
    w = bj.ExprWriter()
    return bj.EffectAsset("rib", 16, bj.SpawnerSettings.once(0.0), w.finish()).init(
        bj.SetAttributeModifier(AJ.RIBBON_ID, w.lit(0, None).expr())
    )


def _pool_pair(cols, counter=False):
    """The same hand-built ribbon pool in both packages. ``cols``: numpy
    ``position``, ``age``, ``ribbon_id`` (uint32) and ``alive``, optionally
    ``particle_counter`` (uint32)."""
    names = [AJ.POSITION, AJ.AGE, AJ.LIFETIME, AJ.RIBBON_ID, AJ.SIZE]
    if counter:
        names.append(AJ.PARTICLE_COUNTER)
    n = cols["alive"].shape[0]
    attrs = {
        "position": cols["position"].astype(np.float32),
        "age": cols["age"].astype(np.float32),
        "lifetime": np.full(n, 100.0, np.float32),
        "ribbon_id": cols["ribbon_id"].astype(np.uint32),
        "size": np.full(n, 0.1, np.float32),
    }
    if counter:
        attrs["particle_counter"] = cols["particle_counter"].astype(np.uint32)
    pool_j = PoolJ.create(LayoutJ(names), n)
    pool_j.attrs.update({k: jnp.asarray(v) for k, v in attrs.items()})
    pool_j.alive = jnp.asarray(cols["alive"])
    pool_t = ParticlePool.from_numpy(attrs, cols["alive"], np.zeros(n, np.uint32), 0, "cpu")
    return pool_j, pool_t


def _points_cols(points, ribbon_ids, n=16):
    """test_scene.py:231's pool: ``points`` alive, oldest first."""
    k = len(points)
    cols = {
        "position": np.zeros((n, 3), np.float32),
        "age": np.zeros(n, np.float32),
        "ribbon_id": np.zeros(n, np.uint32),
        "alive": np.zeros(n, bool),
    }
    cols["position"][:k] = points
    cols["age"][:k] = np.arange(k, 0, -1)
    cols["ribbon_id"][:k] = ribbon_ids
    cols["alive"][:k] = True
    return cols


def _segments_both(cols, counter=False, cam=_ortho, appearance=None):
    """``build_ribbon_segments`` in both packages on the same pool: the JAX
    segment draw, the port's, and the port's sort order. ``appearance``
    replaces the draws' colour / cutoff columns (numpy)."""
    pool_j, pool_t = _pool_pair(cols, counter)
    asset_j = _ribbon_asset_j()
    asset_t = EffectAsset.from_json(asset_j.to_json())
    cam_j, cam_t = cam(camera_j), cam(camera_t)
    draw_j = extract_j(asset_j, pool_j, cam_j)
    draw_t = extract_t(asset_t, pool_t, cam_t)
    if appearance:
        draw_j = dataclasses.replace(draw_j, **{k: jnp.asarray(v) for k, v in appearance.items()})
        draw_t = dataclasses.replace(draw_t, **{k: torch.from_numpy(v) for k, v in appearance.items()})
    return segments_j(draw_j, cam_j), build_ribbon_segments(draw_t, cam_t), ribbon_sort(draw_t).order


def _assert_segments_match(seg_j, seg_t, order_t):
    """The valid set equal row for row, the order (and every valid row's
    predecessor) equal to JAX's ``remap``, colour and cutoff equal to the
    resolved JAX draw's, geometry within ``GEOM_ATOL``."""
    valid = np.asarray(seg_j.alive)
    np.testing.assert_array_equal(seg_t.alive.numpy(), valid)
    remap = np.asarray(seg_j.remap)
    order = order_t.numpy()
    np.testing.assert_array_equal(order[valid], remap[valid])
    np.testing.assert_array_equal(np.roll(order, 1)[valid], np.roll(remap, 1)[valid])
    resolved = resolve_remap(seg_j)
    np.testing.assert_array_equal(seg_t.color.numpy()[valid], np.asarray(resolved.color)[valid])
    if seg_t.alpha_cutoff is not None:
        np.testing.assert_array_equal(seg_t.alpha_cutoff.numpy()[valid],
                                      np.asarray(resolved.alpha_cutoff)[valid])
    for f in ("position", "axis_x", "axis_y"):
        np.testing.assert_allclose(getattr(seg_t, f).numpy()[valid],
                                   np.asarray(getattr(seg_j, f))[valid], rtol=0, atol=GEOM_ATOL)
    assert seg_t.ribbon_id is None and seg_t.age is None and seg_t.counter is None


# ---- (1) the sort keys: lax.sort's order -----------------------------------

# -0.0, +0.0, subnormals, +-inf, NaNs of both signs, normal ages
SPECIAL_AGES = np.asarray(
    [0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40, 1.17549435e-38, -1.17549435e-38, np.inf, -np.inf,
     np.nan, -np.nan, 0.5, -0.5, 3.0, 1e30],
    np.float32,
)


def _same_float(a, b) -> bool:
    """Equal under lax.sort's comparison on the CPU: NaN to NaN, zeros and
    subnormals to each other (measured: they tie), else exactly."""
    tiny = np.float32(1.17549435e-38)
    if np.isnan(a) or np.isnan(b):
        return bool(np.isnan(a) and np.isnan(b))
    if abs(a) < tiny or abs(b) < tiny:
        return bool(abs(a) < tiny and abs(b) < tiny)
    return bool(a == b)


@pytest.mark.parametrize("counter", [True, False])
def test_sort_order_equals_lax_sort(counter):
    """Ribbon ids 0, 1, 2**31 and the sentinel (alive and dead), the special
    ages and ties: the port's two stable sorts give lax.sort's order."""
    r = np.random.default_rng(11)
    n = 512
    rid = r.choice(np.asarray([0, 1, 2**31, SENTINEL], np.uint32), n)
    age = r.choice(SPECIAL_AGES, n)
    alive = r.random(n) < 0.75
    cnt = r.permutation(n).astype(np.uint32) * np.uint32(8388593)
    draw = ParticleDrawData(
        *(torch.zeros((n, 3)),) * 3, torch.zeros((n, 4)), torch.from_numpy(alive),
        ribbon_id=torch.from_numpy(rid.astype(np.int64)), age=torch.from_numpy(age),
        counter=torch.from_numpy(cnt.astype(np.int64)) if counter else None,
    )
    order = ribbon_sort(draw).order.numpy()

    big = jnp.uint32(SENTINEL)
    rid_k = jnp.where(alive, jnp.asarray(rid), big)
    age_k = jnp.where(alive, -jnp.asarray(age), jnp.inf)
    keys = (rid_k, age_k) + ((jnp.where(alive, jnp.asarray(cnt), big),) if counter else ())
    out = jax.lax.sort(keys + (jnp.arange(n, dtype=jnp.int32),), num_keys=len(keys))
    want = np.asarray(out[-1])
    # the sorted key sequences agree everywhere
    got_rid = np.where(alive, rid, SENTINEL)[order]
    got_age = np.where(alive, -age, np.inf).astype(np.float32)[order]
    np.testing.assert_array_equal(got_rid, np.asarray(out[0]))
    assert all(_same_float(a, b) for a, b in zip(got_age, np.asarray(out[1])))
    if counter:
        np.testing.assert_array_equal(np.where(alive, cnt, SENTINEL)[order], np.asarray(out[2]))
        # with unique counters only the dead lanes tie on all three keys
        live = ~(np.asarray(out[0] == big) & np.isposinf(np.asarray(out[1]))
                 & np.asarray(out[2] == big))
        np.testing.assert_array_equal(order[live], want[live])
        assert live.sum() > n // 2


def test_sort_ties_zeros_and_subnormals_like_lax_sort():
    """lax.sort on the CPU compares -0.0, +0.0 and subnormals as equal, so
    the counter decides (measured with JAX on the CPU): every new particle
    has -age == -0.0."""
    ages = np.asarray([-0.0, 0.0, 1e-40, -0.0, 0.0, -1e-45], np.float32)
    n = ages.shape[0]
    cnt = np.arange(n, 0, -1).astype(np.uint32)
    draw = ParticleDrawData(
        *(torch.zeros((n, 3)),) * 3, torch.zeros((n, 4)), torch.ones(n, dtype=torch.bool),
        ribbon_id=torch.zeros(n, dtype=torch.int64), age=torch.from_numpy(ages),
        counter=torch.from_numpy(cnt.astype(np.int64)),
    )
    out = jax.lax.sort((jnp.zeros(n, jnp.uint32), -jnp.asarray(ages), jnp.asarray(cnt),
                        jnp.arange(n, dtype=jnp.int32)), num_keys=3)
    np.testing.assert_array_equal(ribbon_sort(draw).order.numpy(), np.asarray(out[3]))
    np.testing.assert_array_equal(np.asarray(out[3]), np.arange(n)[::-1])


# ---- (2) build_ribbon_segments against JAX (test_scene.py's cases) ----------


def test_segments_connect_same_ribbon_by_age_like_jax():
    pts = [[-0.5, 0.0, 0.0], [0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [0.0, 0.5, 0.0]]
    seg_j, seg_t, order = _segments_both(_points_cols(pts, [0, 0, 0, 1]))
    _assert_segments_match(seg_j, seg_t, order)
    valid = seg_t.alive.numpy()
    assert valid.sum() == 2
    np.testing.assert_allclose(sorted(seg_t.position.numpy()[valid][:, 0]), [-0.25, 0.25], atol=1e-6)
    np.testing.assert_allclose(np.abs(seg_t.axis_x.numpy()[valid][:, 0]), 0.5, atol=1e-6)


def test_segment_side_matches_reference_orientation_like_jax():
    seg_j, seg_t, order = _segments_both(_points_cols([[-0.5, 0.0, 0.0], [0.5, 0.0, 0.0]], [0, 0]))
    _assert_segments_match(seg_j, seg_t, order)
    valid = seg_t.alive.numpy()
    assert valid.sum() == 1
    side = seg_t.axis_y.numpy()[valid][0]
    assert side[1] < 0 and abs(side[0]) < 1e-6 and abs(side[2]) < 1e-6


def _appearance_case():
    k = 9
    pts = np.stack([np.linspace(-0.8, 0.8, k), 0.4 * np.sin(np.linspace(0, 3.0, k)), np.zeros(k)],
                   axis=1).astype(np.float32)
    rng = np.random.default_rng(7)
    appearance = {"color": rng.random((16, 4), dtype=np.float32),
                  "alpha_cutoff": rng.random(16, dtype=np.float32)}
    return _points_cols(pts.tolist(), [0, 0, 0, 1, 1, 1, 2, 2, 2]), appearance


def test_segment_appearance_is_resolved_like_jax():
    """The port gathers colour and cutoff into segment order; the JAX
    package keeps them behind ``remap``: the same resolved columns."""
    cols, appearance = _appearance_case()
    seg_j, seg_t, order = _segments_both(cols, appearance=appearance)
    assert seg_j.remap is not None
    _assert_segments_match(seg_j, seg_t, order)
    assert seg_t.alpha_cutoff is not None and seg_t.alive.sum() == 6


@pytest.mark.parametrize("mode", ["blend", "add", "mask"])
def test_segment_images_match_jax_lazy_and_resolved(mode):
    """test_scene.py:308 at tile_slots=1 in both packages: the port's
    resolved segments render as JAX's lazy ``remap`` and its resolved draw."""
    cols, appearance = _appearance_case()
    seg_j, seg_t, _ = _segments_both(cols, appearance=appearance)
    cfg = dict(width=64, height=64, tile_size=16, tile_slots=1)
    img_t = rasterize_t(seg_t, _ortho(camera_t), RasterConfig(**cfg), alpha_mode=mode).numpy()
    img_lazy = np.asarray(rasterize_j(seg_j, _ortho(camera_j), CfgJ(**cfg), alpha_mode=mode))
    img_res = np.asarray(rasterize_j(resolve_remap(seg_j), _ortho(camera_j), CfgJ(**cfg),
                                     alpha_mode=mode))
    np.testing.assert_array_equal(img_lazy, img_res)
    np.testing.assert_allclose(img_t, img_lazy, rtol=0, atol=GEOM_ATOL)
    assert img_t.sum() > 0


def test_segments_render_a_continuous_line_like_jax():
    """test_scene.py:387 with one 64-pixel tile: ``tile_slots=1`` bins a
    segment into its centre tile only, so the whole line fits one tile."""
    seg_j, seg_t, order = _segments_both(
        _points_cols([[-0.75, 0.0, 0.0], [0.0, 0.0, 0.0], [0.75, 0.0, 0.0]], [0, 0, 0]))
    _assert_segments_match(seg_j, seg_t, order)
    cfg = dict(width=64, height=64, tile_size=64, tile_slots=1, max_entries_per_tile=16)
    img_t = rasterize_t(seg_t, _ortho(camera_t), RasterConfig(**cfg), "blend").numpy()
    img_j = np.asarray(rasterize_j(seg_j, _ortho(camera_j), CfgJ(**cfg), "blend"))
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=GEOM_ATOL)
    xs = np.flatnonzero(img_t[32, :, 3] > 0.5)
    assert xs.min() < 10 and xs.max() > 54
    assert np.all(np.diff(xs) == 1)


def test_equal_ages_chain_in_counter_order_like_jax():
    """test_scene.py:970: a burst shares one age; the counter orders it."""
    pts = [[-0.6, 0.0, 0.0], [-0.2, 0.0, 0.0], [0.2, 0.0, 0.0], [0.6, 0.0, 0.0]]
    cols = _points_cols(pts, [0, 0, 0, 0])
    cols["age"][:] = 0.0
    cols["particle_counter"] = np.zeros(16, np.uint32)
    cols["particle_counter"][:4] = [3, 2, 1, 0]  # spawn order right to left
    seg_j, seg_t, order = _segments_both(cols, counter=True)
    _assert_segments_match(seg_j, seg_t, order)
    valid = seg_t.alive.numpy()
    assert valid.sum() == 3
    np.testing.assert_allclose(np.sort(seg_t.position.numpy()[valid][:, 0]), [-0.4, 0.0, 0.4],
                               atol=1e-6)


@pytest.mark.parametrize("counter", [True, False])
def test_seeded_pool_of_64_ribbons_matches_jax(counter):
    """4096 lanes in 64 ribbons, a quarter dead, bursts of equal ages."""
    r = np.random.default_rng(3)
    n = 4096
    cols = {
        "position": r.uniform(-1.0, 1.0, (n, 3)).astype(np.float32),
        "age": r.choice(np.arange(40, dtype=np.float32) / 10.0, n),
        "ribbon_id": r.integers(0, 64, n).astype(np.uint32),
        "alive": r.random(n) < 0.75,
        "particle_counter": r.permutation(n).astype(np.uint32),
    }
    if not counter:  # unique (ribbon, age) pairs among the alive lanes: no tie to break
        cols["age"] = r.permutation(n).astype(np.float32) / 100.0
    seg_j, seg_t, order = _segments_both(cols, counter=counter, cam=_gate_camera)
    _assert_segments_match(seg_j, seg_t, order)
    assert 2000 < int(seg_t.alive.sum()) < n


def test_row_zero_starts_no_segment_when_one_ribbon_holds_every_lane_like_jax():
    """Rows n - 1 and 0 are alive rows of one ribbon: row 0, whose
    predecessor is row n - 1 (the roll), is still no segment."""
    pts = np.stack([np.linspace(-0.8, 0.8, 16), np.zeros(16), np.zeros(16)], axis=1)
    seg_j, seg_t, order = _segments_both(_points_cols(pts.tolist(), [0] * 16))
    _assert_segments_match(seg_j, seg_t, order)
    valid = seg_t.alive.numpy()
    assert not valid[0] and valid[1:].all()


@pytest.mark.parametrize("counter", [True, False])
def test_ribbons_across_the_kernel_tiles_like_jax(counter):
    """2100 lanes in ribbons of 200 rows, in a shuffled pool: ribbons run
    across the card kernel's tiles (rows 128, 256, 512, 1024 and 2048)."""
    r = np.random.default_rng(5)
    n = 2100
    rank = r.permutation(n)
    cols = {
        "position": r.uniform(-1.0, 1.0, (n, 3)).astype(np.float32),
        "age": (1.0 + (n - rank) / n).astype(np.float32),
        "ribbon_id": (rank // 200).astype(np.uint32),
        "alive": np.ones(n, bool),
        "particle_counter": r.permutation(n).astype(np.uint32),
    }
    seg_j, seg_t, order = _segments_both(cols, counter=counter, cam=_gate_camera)
    _assert_segments_match(seg_j, seg_t, order)
    np.testing.assert_array_equal(seg_t.alive.numpy(), np.arange(n) % 200 != 0)


def test_missing_age_raises_like_jax():
    draw = ParticleDrawData(*(torch.zeros((4, 3)),) * 3, torch.zeros((4, 4)),
                            torch.ones(4, dtype=torch.bool), ribbon_id=torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="RIBBON_ID and AGE"):
        build_ribbon_segments(draw, _ortho(camera_t))


# ---- (3) the ribbon gate (bench.py:221-251) at tile_slots=1 -----------------


@pytest.fixture(scope="module")
def ribbon_gate():
    """``ribbon_order_check_effect(8192, 64)``, 30 frames of 256 spawns,
    through ``step_render_chunk`` in both packages."""
    fx_j = EffectJ(check_j(8192, 64))
    ins = [InputsJ.make(256, 7 * i + 1) for i in range(30)]
    sims = [SimJ(time=i * DT, delta_time=DT) for i in range(30)]
    pool_j, img_j, sums_j = fx_j.step_render_chunk(
        fx_j.create_pool(), *fx_j.stack_frames(ins, sims), _gate_camera(camera_j),
        CfgJ(128, 128, tile_slots=1))
    fx_t = CompiledEffect(EffectAsset.from_json(fx_j.asset.to_json()), device="cpu")
    ins = [StepInputs.make(256, 7 * i + 1) for i in range(30)]
    sims = [SimParams(time=i * DT, delta_time=DT) for i in range(30)]
    pool_t, img_t, sums_t = fx_t.step_render_chunk(
        fx_t.create_pool(), *fx_t.stack_frames(ins, sims), _gate_camera(camera_t),
        RasterConfig(128, 128, tile_slots=1))
    return (fx_j, pool_j, np.asarray(img_j), np.asarray(sums_j)), (fx_t, pool_t, img_t, sums_t)


def test_ribbon_gate_state_is_bit_exact(ribbon_gate):
    (_, pool_j, _, _), (_, pool_t, _, _) = ribbon_gate
    attrs, alive, seed, counter = pool_t.to_numpy()
    np.testing.assert_array_equal(alive, np.asarray(pool_j.alive))
    np.testing.assert_array_equal(seed, np.asarray(pool_j.seed))
    np.testing.assert_array_equal(attrs["ribbon_id"], np.asarray(pool_j.attrs["ribbon_id"]))
    assert int(counter) == int(pool_j.counter) == 30 * 256


def test_ribbon_gate_images_match_jax(ribbon_gate):
    (_, _, img_j, sums_j), (_, _, img_t, sums_t) = ribbon_gate
    assert sums_t.shape == (30,)
    for got, want in zip(sums_t.tolist(), sums_j.tolist()):
        assert want > 0 and abs(got - want) <= REL * abs(want)
    np.testing.assert_allclose(img_t.numpy(), img_j, rtol=0, atol=GEOM_ATOL)


def test_ribbon_gate_segments_match_jax(ribbon_gate):
    (fx_j, pool_j, _, _), (fx_t, pool_t, _, _) = ribbon_gate
    cam_j, cam_t = _gate_camera(camera_j), _gate_camera(camera_t)
    draw_t = extract_t(fx_t.asset, pool_t, cam_t)
    seg_j = segments_j(extract_j(fx_j.asset, pool_j, cam_j), cam_j)
    seg_t = build_ribbon_segments(draw_t, cam_t)
    _assert_segments_match(seg_j, seg_t, ribbon_sort(draw_t).order)
    assert int(seg_t.alive.sum()) > 7000  # 7680 alive lanes in 64 ribbons


# ---- (4) ribbon_bench_effect through step_render_chunk (test_examples.py:148)


def test_ribbon_bench_effect_chains_and_renders_like_jax():
    def cam(m):
        return m.CameraParams(
            view=m.look_at((0.0, 0.0, 10.0), (0.0, 0.0, 0.0)),
            proj=m.perspective(math.radians(60.0), 1.0, 0.1, 100.0),
            viewport=(64, 64),
        )

    asset_j = bench_j(capacity=2048, num_ribbons=32)
    fx_j = EffectJ(asset_j)
    fx_t = CompiledEffect(ribbon_bench_effect(capacity=2048, num_ribbons=32), device="cpu")
    assert fx_t.asset.to_json() == asset_j.to_json()
    sp_j = bj.EffectSpawner(asset_j.spawner, rng=np.random.default_rng(0))
    sp_t = bt.EffectSpawner(fx_t.asset.spawner, rng=np.random.default_rng(0))
    pool_j, pool_t = fx_j.create_pool(), fx_t.create_pool()
    K, frame = 16, 0
    for _ in range(4):
        ticks = [sp_j.tick(DT) for _ in range(K)]
        assert ticks == [sp_t.tick(DT) for _ in range(K)]
        frames = [(ticks[j], frame + j, (frame + j) * DT) for j in range(K)]
        ii, ss = fx_j.stack_frames([InputsJ.make(s, seed) for s, seed, _ in frames],
                                   [SimJ(time=t, delta_time=DT) for _, _, t in frames])
        pool_j, img_j, sums_j = fx_j.step_render_chunk(pool_j, ii, ss, cam(camera_j),
                                                       CfgJ(64, 64, tile_slots=1))
        ii, ss = fx_t.stack_frames([StepInputs.make(s, seed) for s, seed, _ in frames],
                                   [SimParams(time=t, delta_time=DT) for _, _, t in frames])
        pool_t, img_t, sums_t = fx_t.step_render_chunk(pool_t, ii, ss, cam(camera_t),
                                                       RasterConfig(64, 64, tile_slots=1))
        for got, want in zip(sums_t.tolist(), np.asarray(sums_j).tolist()):
            assert abs(got - want) <= REL * max(abs(want), 1.0)
        frame += K
    attrs, alive, seed, _ = pool_t.to_numpy()
    np.testing.assert_array_equal(alive, np.asarray(pool_j.alive))
    np.testing.assert_array_equal(seed, np.asarray(pool_j.seed))
    assert alive.sum() > 500
    assert len(np.unique(attrs["ribbon_id"][alive])) == 32  # every ribbon populated
    assert (img_t.numpy()[..., 3] > 0).sum() > 50  # trails visible
    assert float(sums_t[-1]) > 0


# ---- (5) HanabiScene: a ribbon effect beside a gradient effect --------------


def _scene_pair():
    sj, st = SceneJ(seed=4), HanabiScene(seed=4, device="cpu")
    for asset, name in ((check_j(4096, 32), "rib"), (gradient_j(2048), "grad")):
        sj.add(asset, name)
        st.add(EffectAsset.from_json(asset.to_json()), name)
    return sj, st


@pytest.mark.parametrize("pipeline", ["auto", "split"])
def test_scene_with_ribbons_matches_jax(pipeline):
    """``update`` and ``render``, then ``update_render_chunk``, in both
    packages: alive masks and seeds bit for bit, checksums within 0.5%."""
    sj, st = _scene_pair()
    cfg_j, cfg_t = CfgJ(128, 128, tile_slots=1), RasterConfig(128, 128, tile_slots=1)
    for _ in range(6):
        sj.update(DT)
        st.update(DT)
    img_j = np.asarray(sj.render(_gate_camera(camera_j), cfg_j, pipeline=pipeline))
    img_t = st.render(_gate_camera(camera_t), cfg_t, pipeline=pipeline).numpy()
    assert img_t.sum() > 0 and abs(img_t.sum() - img_j.sum()) <= REL * img_j.sum()
    _, sums_j = sj.update_render_chunk(8, DT, _gate_camera(camera_j), cfg_j, pipeline=pipeline)
    _, sums_t = st.update_render_chunk(8, DT, _gate_camera(camera_t), cfg_t, pipeline=pipeline)
    for got, want in zip(sums_t.tolist(), np.asarray(sums_j).tolist()):
        assert want > 0 and abs(got - want) <= REL * abs(want)
    for name in ("rib", "grad"):
        _, alive, seed, _ = st[name].pool.to_numpy()
        np.testing.assert_array_equal(alive, np.asarray(sj[name].pool.alive))
        np.testing.assert_array_equal(seed, np.asarray(sj[name].pool.seed))


def test_ribbon_effects_never_batch():
    """Two ribbon effects of one blend state stay separate passes, as JAX's
    ``batch_key`` keeps them (scene.py:1546-1557)."""
    st = HanabiScene(seed=4, device="cpu")
    for name in ("rib_a", "rib_b"):
        st.add(ribbon_order_check_effect(1024, 8), name)
    cam = _gate_camera(camera_t)
    assert st._scene_render_plan(st.effects(), cam, "split") == (
        (), (("eff", 0, "add"), ("eff", 1, "add")))
    assert st._scene_render_plan(st.effects(), cam, "auto") == ((), (("painter", (0, 1), ()),))


# ---- (6) the asset checks and the models cross as JSON ----------------------


def test_ribbon_id_without_age_raises_like_jax():
    w = bj.ExprWriter()
    asset_j = (
        bj.EffectAsset("rib_no_age", 16, bj.SpawnerSettings.once(4.0), w.finish())
        .init(bj.SetAttributeModifier(AJ.POSITION, w.lit((0.0, 0.0, 0.0)).expr()))
        .init(bj.SetAttributeModifier(AJ.RIBBON_ID, w.lit(0, None).expr()))
    )
    with pytest.raises(ValueError, match="requires the AGE attribute"):
        EffectJ(asset_j)
    with pytest.raises(ValueError, match="requires the AGE attribute"):
        CompiledEffect(EffectAsset.from_json(asset_j.to_json()), device="cpu")


@pytest.mark.parametrize("effect", ["ribbon_bench_effect", "ribbon_order_check_effect"])
@pytest.mark.parametrize("size", [(1 << 20, 4096), (8192, 64)])
def test_ribbon_models_json_is_equal_in_both_packages(effect, size):
    import bevy_hanabi_tpu.models as mj
    import bevy_hanabi_tpu_torch.models as mt

    make_j, make_t = getattr(mj, effect), getattr(mt, effect)
    assert make_t(*size).to_json() == make_j(*size).to_json()
    assert make_t(*size).signature() == make_j(*size).signature()


# ---- (7) the ribbon module needs no JAX -------------------------------------


def test_ribbon_module_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['bevy_hanabi_tpu'] = None\n"
        "import bevy_hanabi_tpu_torch.render.ribbon as r\n"
        "assert set(r.KERNELS) == {'ribbon_keys', 'ribbon_segments'}\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
