"""The ported slice end to end against the JAX package, on the CPU.

``gradient_effect(8192)`` runs three frames (spawns 4096, 1024, 2048, one
``delta_time`` of 2 s for every frame, so the first batch is reaped in the
third) through ``CompiledEffect.step_render_chunk`` in both packages.
Tolerances are the repo's device gate's (bench.py:121-130, 155-191): alive
masks and PCG seeds bit for bit (same integer ops); positions rtol 1e-2 /
atol 1e-3 (transcendental ULPs); per-frame checksums 0.5% (f32 blend
arithmetic; any dropped or duplicated splat moves the sum by far more).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bevy_hanabi_tpu.compiler import SimParams as SimJ
from bevy_hanabi_tpu.models import gradient_effect as gradient_j
from bevy_hanabi_tpu.render.camera import CameraParams as CamJ
from bevy_hanabi_tpu.render.raster import RasterConfig as CfgJ
from bevy_hanabi_tpu.runtime.effect import CompiledEffect as EffectJ
from bevy_hanabi_tpu.runtime.effect import StepInputs as InputsJ
from bevy_hanabi_tpu_torch import CompiledEffect, ParticlePool, SimParams, StepInputs
from bevy_hanabi_tpu_torch.asset import EffectAsset
from bevy_hanabi_tpu_torch.models import gradient_effect
from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective
from bevy_hanabi_tpu_torch.render.raster import RasterConfig

REPO = Path(__file__).resolve().parent.parent
SPAWNS = [4096, 1024, 2048]
DT = 2.0


def _frames(Inputs, Sim):
    inputs = [Inputs.make(s, 7 + 31 * i) for i, s in enumerate(SPAWNS)]
    sims = [Sim(time=DT * i, delta_time=DT) for i in range(len(SPAWNS))]
    return inputs, sims


def _camera(Cam):
    return Cam(look_at((0, 0, 6), (0, 0, 0)), perspective(0.9, 1.0, 0.1, 100.0), (128, 128))


@pytest.fixture(scope="module")
def both():
    fx_j = EffectJ(gradient_j(8192))
    ins, sims = fx_j.stack_frames(*_frames(InputsJ, SimJ))
    pool_j, img_j, sums_j = fx_j.step_render_chunk(
        fx_j.create_pool(), ins, sims, _camera(CamJ), CfgJ(128, 128, tile_slots=1)
    )
    # the port's asset comes over as JSON, as any JAX asset would
    fx_t = CompiledEffect(EffectAsset.from_json(fx_j.asset.to_json()), device="cpu")
    ins, sims = fx_t.stack_frames(*_frames(StepInputs, SimParams))
    pool_t, img_t, sums_t = fx_t.step_render_chunk(
        fx_t.create_pool(), ins, sims, _camera(CameraParams), RasterConfig(128, 128, tile_slots=1)
    )
    return (pool_j, np.asarray(img_j), np.asarray(sums_j)), (pool_t, img_t, sums_t)


def test_slice_alive_and_seeds_bit_exact(both):
    (pool_j, _, _), (pool_t, _, _) = both
    _, alive, seed, counter = pool_t.to_numpy()
    np.testing.assert_array_equal(alive, np.asarray(pool_j.alive))
    np.testing.assert_array_equal(seed, np.asarray(pool_j.seed))
    assert int(counter) == int(pool_j.counter) == sum(SPAWNS)
    assert alive.sum() == SPAWNS[1] + SPAWNS[2]  # the first batch was reaped


def test_slice_positions_within_device_gate(both):
    (pool_j, _, _), (pool_t, _, _) = both
    attrs, alive, _, _ = pool_t.to_numpy()
    for name in ("position", "velocity", "age"):
        np.testing.assert_allclose(
            attrs[name][alive], np.asarray(pool_j.attrs[name])[alive], rtol=1e-2, atol=1e-3
        )


def test_slice_checksums_within_half_a_percent(both):
    (_, img_j, sums_j), (_, img_t, sums_t) = both
    assert img_t.shape == (128, 128, 4) and torch.isfinite(img_t).all()
    assert sums_t.shape == (3,)
    for got, want in zip(sums_t.tolist(), sums_j.tolist()):
        assert want > 0 and abs(got - want) <= 0.005 * abs(want)
    assert abs(float(img_t.sum()) - img_j.sum()) <= 0.005 * img_j.sum()


def test_step_chunk_matches_step_render_chunk_state(both):
    _, (pool_t, _, _) = both
    fx = CompiledEffect(gradient_effect(8192), device="cpu")
    pool = fx.step_chunk(fx.create_pool(), *fx.stack_frames(*_frames(StepInputs, SimParams)))
    for a, b in zip(pool.to_numpy()[1:], pool_t.to_numpy()[1:]):
        np.testing.assert_array_equal(a, b)


def test_pool_from_numpy_round_trip(both):
    (pool_j, _, _), _ = both
    attrs = {k: np.asarray(v) for k, v in pool_j.attrs.items()}
    pool = ParticlePool.from_numpy(attrs, pool_j.alive, pool_j.seed, pool_j.counter, "cpu")
    assert pool.seed.dtype == torch.int64 and int(pool.alive_count()) == int(pool_j.alive_count())
    attrs2, alive, seed, counter = pool.to_numpy()
    assert seed.dtype == np.uint32 and seed.max() > 2**31  # uint32 values survive
    np.testing.assert_array_equal(seed, np.asarray(pool_j.seed))
    np.testing.assert_array_equal(alive, np.asarray(pool_j.alive))
    for k, v in attrs.items():
        np.testing.assert_array_equal(attrs2[k], v)


@pytest.mark.parametrize("poison", [False, True])
def test_create_pool_matches_jax(poison):
    pool_j = EffectJ(gradient_j(64)).create_pool(poison=poison)
    attrs, alive, seed, counter = CompiledEffect(gradient_effect(64), device="cpu").create_pool(
        poison=poison
    ).to_numpy()
    for k, v in pool_j.attrs.items():
        np.testing.assert_array_equal(attrs[k].view(np.uint32), np.asarray(v).view(np.uint32))
    assert not alive.any() and not seed.any() and counter == 0


def test_event_linked_assets_raise():
    import bevy_hanabi_tpu_torch as bt

    w = bt.ExprWriter()
    asset = gradient_effect(64)
    asset.update(bt.EmitSpawnEventModifier(bt.EventEmitCondition.ON_DIE, w.lit(2, bt.UINT).expr()))
    with pytest.raises(NotImplementedError, match="event"):
        CompiledEffect(asset, device="cpu")


# ---- (f) the asset crosses as JSON; the port needs no JAX -------------------


def test_gradient_effect_json_is_equal_in_both_packages():
    assert gradient_effect(1 << 20).to_json() == gradient_j(1 << 20).to_json()
    assert gradient_effect(4096).signature() == gradient_j(4096).signature()


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['bevy_hanabi_tpu'] = None\n"
        "import bevy_hanabi_tpu_torch, bevy_hanabi_tpu_torch.models\n"
        "import bevy_hanabi_tpu_torch.render.raster, bevy_hanabi_tpu_torch.cuda_build\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules if sys.modules[m])\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
