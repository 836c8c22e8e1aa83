"""The force field (BASELINE config 3) and the kill and shape modifiers, against the JAX package.

Every effect is built in both packages, and its JSON must be equal; then
the same frames (spawn counts, frame seeds, properties, made with numpy)
step it in both. Tolerances are the repo's device gate's (bench.py:121-130):
alive masks and PCG seeds bit for bit (the same integer ops and draws, in
the JAX package's order); positions and velocities of the alive lanes rtol
1e-2 / atol 1e-3 (transcendental ULPs).
"""

import numpy as np
import pytest

import bevy_hanabi_tpu as bj
import bevy_hanabi_tpu_torch as bt
from bevy_hanabi_tpu.models import force_field_effect as force_field_j
from bevy_hanabi_tpu_torch import EffectAsset
from bevy_hanabi_tpu_torch.models import force_field_effect
from torch_jax_cache import jax_cache_of_the_module  # noqa: F401

POS_RTOL, POS_ATOL = 1e-2, 1e-3
FF_DT = 1.0 / 60.0
FF_FRAMES = 300  # 5 s: past the 4 s lifetime
FF_MOVE_AT = 180  # the frame from which the attractor sits at FF_MOVED
FF_MOVED = (9.0, 1.0, 0.0)  # near the kill box's +x face: lanes leave it and die


def _frames(pkg, counts, seed0=0, properties=None):
    inputs = [pkg.StepInputs.make(int(c), seed0 + 7 * j,
                                  properties=None if properties is None else properties(j))
              for j, c in enumerate(counts)]
    sims = [pkg.SimParams(time=j * FF_DT, delta_time=FF_DT) for j in range(len(counts))]
    return inputs, sims


def _run_both(asset_j, counts, chunk, properties=None):
    """Step the asset in both packages over ``counts`` spawns, in chunks of
    ``chunk`` frames; returns the pools and the port's counter after each chunk."""
    fx_j = bj.CompiledEffect(asset_j)
    fx_t = bt.CompiledEffect(EffectAsset.from_json(asset_j.to_json()), device="cpu")
    pool_j, pool_t = fx_j.create_pool(), fx_t.create_pool()
    counters = []
    for k in range(0, len(counts), chunk):
        part = counts[k:k + chunk]
        props = None if properties is None else (lambda j, k=k: properties(k + j))
        pool_j = fx_j.step_chunk(pool_j, *fx_j.stack_frames(*_frames(bj, part, k, props)))
        pool_t = fx_t.step_chunk(pool_t, *fx_t.stack_frames(*_frames(bt, part, k, props)))
        counters.append(int(pool_t.counter))
    return pool_j, pool_t, counters


def _assert_pools_match(pool_j, pool_t):
    attrs, alive, seed, counter = pool_t.to_numpy()
    np.testing.assert_array_equal(alive, np.asarray(pool_j.alive))
    np.testing.assert_array_equal(seed, np.asarray(pool_j.seed))
    assert int(counter) == int(pool_j.counter)
    for name in ("position", "velocity"):
        np.testing.assert_allclose(attrs[name][alive], np.asarray(pool_j.attrs[name])[alive],
                                   rtol=POS_RTOL, atol=POS_ATOL)
    return attrs, alive


# ---- the five modifiers, each in a stepped effect ---------------------------


def _modifier_asset(pkg, case):
    """A 2048-lane effect: a sphere volume init (where the case has no
    position shape), a long lifetime, and the modifier under test."""
    A = pkg.attributes
    w = pkg.ExprWriter()
    a = (pkg.EffectAsset(f"mod_{case}", 2048, pkg.SpawnerSettings.rate(600.0), w.finish())
         .init(pkg.SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
         .init(pkg.SetAttributeModifier(A.LIFETIME, w.lit(100.0).expr())))
    center = w.lit((0.2, -0.1, 0.3)).expr()
    sphere = pkg.SetPositionSphereModifier(center, w.lit(1.0).expr(), pkg.ShapeDimension.VOLUME)
    outward = pkg.SetVelocitySphereModifier(center, w.lit(0.5).uniform(w.lit(2.0)).expr())
    if case == "circle surface":
        axis = w.lit((0.0, 0.6, 0.8)).expr()
        return (a.init(pkg.SetPositionCircleModifier(center, axis, w.lit(1.5).expr(),
                                                     pkg.ShapeDimension.SURFACE))
                .init(pkg.SetVelocityCircleModifier(center, axis, w.lit(1.0).uniform(w.lit(3.0)).expr())))
    if case == "circle volume":  # an axis with z < 0: the basis' other sign
        axis = w.lit((0.6, 0.0, -0.8)).expr()
        return (a.init(pkg.SetPositionCircleModifier(center, axis, w.lit(0.5).uniform(w.lit(2.0)).expr(),
                                                     pkg.ShapeDimension.VOLUME))
                .init(pkg.SetVelocityCircleModifier(center, axis, w.lit(2.0).expr())))
    if case == "cone3d":
        return (a.init(pkg.SetPositionCone3dModifier(w.lit(2.0).expr(), w.lit(1.0).expr(),
                                                     w.lit(0.3).expr(), pkg.ShapeDimension.VOLUME))
                .init(pkg.SetVelocityTangentModifier(w.lit((0.0, 0.0, 0.0)).expr(),
                                                     w.lit((0.0, 1.0, 0.0)).expr(), w.lit(2.0).expr())))
    if case == "tangent per lane":
        return (a.init(sphere)
                .init(pkg.SetVelocityTangentModifier(center, w.lit((0.3, 0.9, 0.3)).expr(),
                                                     w.lit(1.0).uniform(w.lit(2.0)).expr())))
    kill = {
        "kill sphere inside": lambda: pkg.KillSphereModifier(w.lit((0.5, 0.0, 0.0)).expr(),
                                                             w.lit(0.6).expr()),
        "kill sphere outside": lambda: pkg.KillSphereModifier(center, w.lit(2.0).expr(), False),
        "kill aabb inside": lambda: pkg.KillAabbModifier(w.lit((0.5, 0.0, 0.0)).expr(),
                                                         w.lit((0.6, 0.5, 0.7)).expr()),
        "kill aabb outside": lambda: pkg.KillAabbModifier(center, w.lit((1.5, 1.2, 1.8)).expr(),
                                                          False),
    }[case]()
    return a.init(sphere).init(outward).update(kill)


MODIFIER_CASES = ["circle surface", "circle volume", "cone3d", "tangent per lane",
                  "kill sphere inside", "kill sphere outside", "kill aabb inside",
                  "kill aabb outside"]


@pytest.mark.parametrize("case", MODIFIER_CASES)
def test_modifier_json_is_equal_in_both_packages(case):
    asset_j = _modifier_asset(bj, case)
    assert _modifier_asset(bt, case).to_json() == asset_j.to_json()
    assert EffectAsset.from_json(asset_j.to_json()).to_json() == asset_j.to_json()


@pytest.mark.parametrize("case", MODIFIER_CASES)
def test_modifier_steps_like_jax(case):
    counts = np.full(40, 48)  # 40 frames of 48 spawns: 1920 of 2048 lanes
    pool_j, pool_t, _ = _run_both(_modifier_asset(bj, case), counts, 40)
    attrs, alive = _assert_pools_match(pool_j, pool_t)
    if case.startswith("kill"):
        # lanes died in the region, long before their 100 s lifetime
        assert 0 < alive.sum() < counts.sum() - 100
    else:
        assert alive.sum() == counts.sum()
        speed = np.linalg.norm(attrs["velocity"][alive], axis=1)
        assert (speed > 0.5).all()


def test_shape_modifiers_are_exported():
    for name in ("KillSphereModifier", "KillAabbModifier", "SetPositionCircleModifier",
                 "SetPositionCone3dModifier", "SetVelocityCircleModifier", "SetVelocityTangentModifier"):
        assert name in bt.modifiers.MODIFIER_REGISTRY and hasattr(bt, name)
    assert bt.modifiers.position.orthonormal_basis is not None


def test_orthonormal_basis_matches_jax():
    import jax.numpy as jnp
    import torch

    from bevy_hanabi_tpu.modifiers.position import orthonormal_basis as onb_j
    from bevy_hanabi_tpu_torch.modifiers.position import orthonormal_basis as onb_t

    r = np.random.default_rng(3)
    n = r.standard_normal((512, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0]]
    for got, want in zip(onb_t(torch.from_numpy(n)), onb_j(jnp.asarray(n))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ---- force_field_effect (bench.py:568) --------------------------------------


def test_force_field_effect_json_is_equal_in_both_packages():
    for cap in (4096, 100_000):
        assert force_field_effect(cap).to_json() == force_field_j(cap).to_json()


def test_force_field_past_its_lifetime_matches_jax():
    """force_field_effect(4096) for 5 s at 1/60 s: the spawner's counts, the
    attractor at its default until 3 s, then at FF_MOVED (as the reference
    example's cursor moves it), so lanes leave the kill box."""
    spawner = bt.EffectSpawner(force_field_effect(4096).spawner, rng=np.random.default_rng(0))
    counts = np.asarray([spawner.tick(FF_DT) for _ in range(FF_FRAMES)])

    def properties(j):
        return {"attractor": FF_MOVED if j >= FF_MOVE_AT else (0.0, 1.0, 0.0)}

    pool_j, pool_t, counters = _run_both(force_field_j(4096), counts, 60, properties)
    attrs, alive = _assert_pools_match(pool_j, pool_t)
    # every lane alive now was spawned in the last 4 s (after frame 60): the
    # lanes spawned then and dead already died by the box, not their lifetime
    spawned_since = counters[-1] - counters[0]
    early = spawned_since - int(alive.sum())
    assert early > 500, (spawned_since, int(alive.sum()))
    assert np.abs(attrs["position"][alive]).max() <= 8.0 + 1.0  # within a frame's flight of the box
