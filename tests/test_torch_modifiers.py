"""Parity of the port's gradient sampler, expression evaluator and modifiers
with the JAX package, on the CPU.

Every case builds the same expression module in both packages and feeds
both the same numpy-seeded inputs. Tolerance: 1e-6 absolute/relative on
floats. Both sides run the same f32 op sequence; the only differences are
ULPs of sin/cos/sqrt/rsqrt between XLA's and PyTorch's CPU math libraries.
PCG seeds and integer results must match bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_hanabi_tpu as bj
import bevy_hanabi_tpu_torch as bt
from bevy_hanabi_tpu import compiler as comp_j
from bevy_hanabi_tpu.render.camera import CameraParams as CamJ
from bevy_hanabi_tpu_torch import compiler as comp_t
from bevy_hanabi_tpu_torch.render.camera import CameraParams as CamT
from bevy_hanabi_tpu_torch.render.camera import look_at, perspective

TOL = dict(rtol=1e-6, atol=1e-6)
N = 2048


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    return {
        "age": r.uniform(0.0, 6.0, N).astype(np.float32),
        "lifetime": r.uniform(1.0, 5.0, N).astype(np.float32),
        "position": r.standard_normal((N, 3)).astype(np.float32),
        "velocity": r.standard_normal((N, 3)).astype(np.float32),
        "seed": r.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32),
    }


def _ctx_pair(kind, module_j, module_t, data, **extra):
    """The same context in both packages over ``data``."""
    pj = {k: jnp.asarray(v) for k, v in data.items() if k != "seed"}
    pt = {k: torch.from_numpy(v.copy()) for k, v in data.items() if k != "seed"}
    seed_j = jnp.asarray(data["seed"])
    seed_t = torch.from_numpy(data["seed"].astype(np.int64))
    idx_j = jnp.arange(N, dtype=jnp.uint32)
    idx_t = torch.arange(N, dtype=torch.int64)
    cj = getattr(comp_j, kind)(module_j, pj, seed_j, particle_index=idx_j, **extra.get("j", {}))
    ct = getattr(comp_t, kind)(module_t, pt, seed_t, particle_index=idx_t, **extra.get("t", {}))
    return cj, ct


def _close(t, j):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    if j.dtype == np.uint32:
        t = t.astype(np.uint32)
    if j.dtype.kind in "biu":
        np.testing.assert_array_equal(np.broadcast_to(t, j.shape), j)
    else:
        np.testing.assert_allclose(np.broadcast_to(t, j.shape), j, **TOL)


# ---- gradient sampler --------------------------------------------------------

GRADIENTS = {
    "constant": [(0.3, (0.5, 0.25))],
    "linear": [(0.0, (0.1,)), (1.0, (0.02,))],
    "three_keys": [(0.0, (1, 0, 0, 1)), (0.5, (1, 1, 0, 1)), (1.0, (0, 0, 1, 0))],
    "duplicated_ratio": [(0.0, (0.0,)), (0.5, (1.0,)), (0.5, (3.0,)), (1.0, (2.0,))],
    "duplicated_start": [(0.0, (4.0, 1.0)), (0.0, (2.0, 0.0)), (0.75, (1.0, 1.0))],
}


@pytest.mark.parametrize("name", sorted(GRADIENTS))
def test_gradient_sampler_matches_jax(name):
    keys = GRADIENTS[name]
    x = np.random.default_rng(3).uniform(-0.2, 1.2, 4096).astype(np.float32)
    x[:6] = [0.0, 0.5, 0.75, 1.0, np.nan, np.float32(0.5) + np.float32(1e-7)]
    got = bt.Gradient(keys).sample_torch(torch.from_numpy(x))
    want = bj.Gradient(keys).sample_jax(jnp.asarray(x))
    _close(got, want)


def test_gradient_sampler_refuses_more_than_16_keys():
    """Gradients of more than 16 keys once raised; they now take the JAX
    package's searchsorted form (gradient.py:177-193), bit for bit: 21
    keys with a duplicated ratio, on exact hits, both ends, NaN and -0.0."""
    keys = [(i / 20, (float(i), float(i * i % 7))) for i in range(21)]
    keys[5] = (keys[4][0], (9.0, -9.0))
    x = np.random.default_rng(5).uniform(-0.2, 1.2, 4096).astype(np.float32)
    x[:8] = [0.0, 0.5, 0.75, 1.0, np.nan, -0.0, keys[4][0], np.inf]
    got = bt.Gradient(keys).sample_torch(torch.from_numpy(x)).numpy()
    want = np.asarray(bj.Gradient(keys).sample_jax(jnp.asarray(x)))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# ---- expression evaluator --------------------------------------------------

EXPRS = {
    "arith": lambda w, p, A: ((w.attr(A.AGE) * w.lit(2.0) - w.lit(0.5)).abs() + 1.0).sqrt(),
    "trig": lambda w, p, A: w.attr(A.AGE).sin() * w.attr(A.LIFETIME).cos()
    + w.attr(A.AGE).atan2(w.lit(1.5)) + (w.attr(A.AGE) * 0.1).tan(),
    "inverse_trig": lambda w, p, A: (w.attr(A.AGE) / 6.0).asin() + (w.attr(A.AGE) / 6.0).acos()
    + w.attr(A.AGE).atan(),
    "exp_log": lambda w, p, A: w.attr(A.LIFETIME).log() + (w.attr(A.AGE) * -0.5).exp()
    + w.attr(A.AGE).exp2().log2() + w.attr(A.LIFETIME).inverse_sqrt(),
    "rounding": lambda w, p, A: w.attr(A.AGE).fract() + w.attr(A.AGE).floor() - w.attr(A.LIFETIME).ceil()
    + (w.attr(A.AGE) - 3.0).sign() + (w.attr(A.AGE) * 1.5).round() + (w.attr(A.AGE) - 2.0).saturate(),
    "normalize": lambda w, p, A: w.attr(A.POSITION).normalized(),
    "length_dot": lambda w, p, A: w.attr(A.POSITION).length() + w.attr(A.POSITION).dot(w.attr(A.VELOCITY)),
    "cross": lambda w, p, A: w.attr(A.POSITION).cross(w.attr(A.VELOCITY)),
    "distance": lambda w, p, A: w.attr(A.POSITION).distance(w.attr(A.VELOCITY)),
    "swizzle_vec": lambda w, p, A: w.attr(A.POSITION).y().vec3(w.attr(A.AGE), w.lit(2.0))
    + w.attr(A.VELOCITY).z().vec3(w.attr(A.POSITION).x(), w.attr(A.AGE)),
    "vec2_vec4": lambda w, p, A: w.attr(A.POSITION).vec4_xyz_w(w.attr(A.AGE)).w()
    + w.attr(A.AGE).vec2(w.lit(1.0)).y(),
    "scalar_times_vec": lambda w, p, A: w.attr(A.VELOCITY) * w.attr(A.AGE),
    "mix_clamp": lambda w, p, A: w.attr(A.POSITION).mix(w.attr(A.VELOCITY), w.attr(A.AGE) / 6.0)
    .clamp(w.lit(-0.5), w.lit(0.5)),
    "smoothstep_step": lambda w, p, A: w.lit(1.0).smoothstep(w.lit(5.0), w.attr(A.AGE))
    + w.attr(A.LIFETIME).step(w.attr(A.AGE)),
    "min_max_rem": lambda w, p, A: w.attr(A.AGE).min(w.attr(A.LIFETIME)) + w.attr(A.AGE).max(w.lit(2.0))
    + w.attr(A.AGE) % w.lit(1.25),
    "compare": lambda w, p, A: (w.attr(A.AGE) < w.attr(A.LIFETIME)).vec2(w.attr(A.AGE) >= w.lit(3.0)).all(),
    "uint_wrap": lambda w, p, A: w.lit(0xFFFFFFF0, p.UINT) + w.attr(A.AGE).cast(p.UINT) * w.lit(0x10001, p.UINT),
    "int_rem": lambda w, p, A: (w.attr(A.AGE) * 100.0 - 300.0).cast(p.INT) % w.lit(7, p.INT),
    # out of range on most lanes: XLA's convert saturates
    "int_cast_saturates": lambda w, p, A: ((w.attr(A.AGE) - 3.0) * 2e9).cast(p.INT),
    "uint_cast_saturates": lambda w, p, A: ((w.attr(A.AGE) - 3.0) * 2e9).cast(p.UINT),
    # by zero: lax.rem gives the dividend (a property at 0 on every lane, the id on lane 0)
    "int_rem_by_zero": lambda w, p, A: (w.attr(A.AGE) * 100.0 - 300.0).cast(p.INT)
    % w.prop(w.add_property("divisor", 0)),
    "uint_rem_by_zero": lambda w, p, A: (w.attr(A.AGE) * 1e9).cast(p.UINT) % w.attr(A.ID),
    "pack_unpack": lambda w, p, A: w.attr(A.POSITION).vec4_xyz_w(w.attr(A.AGE) / 6.0).pack4x8snorm().unpack4x8snorm()
    + w.attr(A.POSITION).vec4_xyz_w(w.attr(A.AGE) / 6.0).pack4x8unorm().unpack4x8unorm(),
    "uniform_rand": lambda w, p, A: w.lit(1.0).uniform(w.lit(3.0)) + w.lit((0.0, 1.0, 2.0)).uniform(w.lit(4.0)).x(),
    "normal_rand": lambda w, p, A: w.lit((0.0, 0.0)).normal(w.lit(1.0)),
    "rand_types": lambda w, p, A: w.rand(p.VEC3F).z() + w.rand(p.FLOAT)
    + w.rand(p.UINT).cast(p.FLOAT) + w.rand(p.INT).cast(p.FLOAT),
    "time": lambda w, p, A: w.time() * w.attr(A.AGE) + w.delta_time(),
}


def _eval_pair(name):
    out = []
    for pkg in (bj, bt):
        w = pkg.ExprWriter()
        h = EXPRS[name](w, pkg, pkg.attributes).expr()
        out.append((w.finish(), h))
    (mj, hj), (mt, ht) = out
    sim = dict(time=1.25, delta_time=1.0 / 60.0)
    cj, ct = _ctx_pair(
        "InitContext", mj, mt, _inputs(7),
        j={"sim": comp_j.SimParams(**sim)}, t={"sim": comp_t.SimParams(**sim)},
    )
    return ct.eval(ht), cj.eval(hj), ct, cj


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_eval_expr_matches_jax(name):
    got, want, ct, cj = _eval_pair(name)
    _close(got, want)
    _close(ct.seed, cj.seed)


# NaN, +-inf, -1, 2^31, 2^32, the largest f32 below each top end, both ends' neighbours
OUT_OF_RANGE = np.array([np.nan, np.inf, -np.inf, -1.0, -0.5, 2.0**31, 2.0**32, 2147483520.0,
                         4294967040.0, -(2.0**31), -2147483904.0, 3e9, -3e9, 1.5], np.float32)


@pytest.mark.parametrize("target", ["INT", "UINT"])
def test_out_of_range_cast_matches_jax_astype(target):
    data = _inputs(7)
    data["age"][: OUT_OF_RANGE.size] = OUT_OF_RANGE
    out = []
    for pkg in (bj, bt):
        w = pkg.ExprWriter()
        h = w.attr(pkg.attributes.AGE).cast(getattr(pkg, target)).expr()
        out.append((w.finish(), h))
    (mj, hj), (mt, ht) = out
    cj, ct = _ctx_pair("InitContext", mj, mt, data)
    got, want = ct.eval(ht), cj.eval(hj)
    assert want.dtype == (jnp.int32 if target == "INT" else jnp.uint32)
    _close(got, want)


def test_texture_sample_is_not_ported():
    """``texture_sample`` once raised; it now samples as the JAX package's
    compiler does (compiler.py:663-690: bilinear, repeat addressing) at
    per-particle UVs far outside [0, 1), and an unbound slot raises its
    IndexError."""
    data = _inputs(3)
    tex = np.random.default_rng(4).random((5, 7, 4), dtype=np.float32)
    out = []
    for pkg in (bj, bt):
        w = pkg.ExprWriter()
        slot = w.module.add_texture_slot("t")
        uv = w.module.vec2((w.attr(pkg.attributes.POSITION).x() * 3.7).expr(),
                           (w.attr(pkg.attributes.AGE) - w.lit(2.5)).expr())
        out.append((w.finish(), w.module.texture_sample(slot, uv)))
    (mj, hj), (mt, ht) = out
    cj, ct = _ctx_pair("InitContext", mj, mt, data, j={"textures": [jnp.asarray(tex)]},
                       t={"textures": [torch.from_numpy(tex)]})
    _close(ct.eval(ht), cj.eval(hj))
    _, unbound = _ctx_pair("InitContext", mj, mt, data)
    with pytest.raises(IndexError, match="slot 0 not bound"):
        unbound.eval(ht)


# ---- the five modifiers of the slice ---------------------------------------


def _modifier_pair(build):
    mods = []
    for pkg in (bj, bt):
        w = pkg.ExprWriter()
        mod = build(w, pkg)
        mods.append((w.finish(), mod))
    return mods


@pytest.mark.parametrize("dimension", ["SURFACE", "VOLUME"])
def test_set_position_sphere_matches_jax(dimension):
    (mj, modj), (mt, modt) = _modifier_pair(
        lambda w, pkg: pkg.SetPositionSphereModifier(
            w.lit((0.5, -1.0, 2.0)).expr(),
            (w.lit(1.0) + w.attr(pkg.attributes.AGE)).expr(),
            getattr(pkg.ShapeDimension, dimension),
        )
    )
    data = _inputs(11)
    cj, ct = _ctx_pair("InitContext", mj, mt, data)
    modj.apply(mj, cj)
    modt.apply(mt, ct)
    _close(ct.particle["position"], cj.particle["position"])
    _close(ct.seed, cj.seed)


def test_set_velocity_sphere_matches_jax():
    (mj, modj), (mt, modt) = _modifier_pair(
        lambda w, pkg: pkg.SetVelocitySphereModifier(
            w.lit((0.25, 0.0, -0.5)).expr(), w.lit(1.0).uniform(w.lit(3.0)).expr()
        )
    )
    data = _inputs(12)
    data["position"][:3] = (0.25, 0.0, -0.5)  # zero-length: the safe normalize
    cj, ct = _ctx_pair("InitContext", mj, mt, data)
    modj.apply(mj, cj)
    modt.apply(mt, ct)
    _close(ct.particle["velocity"], cj.particle["velocity"])
    _close(ct.seed, cj.seed)


def _render_pair(mj, mt, data):
    view = look_at((1.0, 2.0, 6.0), (0.0, 0.0, 0.0))
    proj = perspective(0.9, 1.0, 0.1, 100.0)
    cj, ct = _ctx_pair(
        "RenderContext", mj, mt, data,
        j={"camera": CamJ(view, proj, (128, 128))},
        t={"camera": CamT(view, proj, (128, 128))},
    )
    cj.color = jnp.ones((N, 4), jnp.float32)
    ct.color = torch.ones((N, 4))
    return cj, ct


@pytest.mark.parametrize(
    "mode,rotated",
    [
        ("PARALLEL_CAMERA_DEPTH_PLANE", False),
        ("PARALLEL_CAMERA_DEPTH_PLANE", True),
        ("FACE_CAMERA_POSITION", False),
        ("FACE_CAMERA_POSITION", True),
        ("ALONG_VELOCITY", False),
    ],
)
def test_orient_matches_jax(mode, rotated):
    (mj, modj), (mt, modt) = _modifier_pair(
        lambda w, pkg: pkg.OrientModifier(
            getattr(pkg.OrientMode, mode),
            (w.attr(pkg.attributes.AGE) * 0.7).expr() if rotated else None,
        )
    )
    cj, ct = _render_pair(mj, mt, _inputs(13))
    modj.apply_render(mj, cj)
    modt.apply_render(mt, ct)
    for axis in ("axis_x", "axis_y", "axis_z"):
        _close(getattr(ct, axis), getattr(cj, axis))


@pytest.mark.parametrize("blend,mask", [("OVERWRITE", "RGBA"), ("MODULATE", "RGB"), ("ADD", "A")])
def test_color_over_lifetime_matches_jax(blend, mask):
    keys = GRADIENTS["three_keys"]
    (mj, modj), (mt, modt) = _modifier_pair(
        lambda w, pkg: pkg.ColorOverLifetimeModifier(
            pkg.Gradient(keys), getattr(pkg.ColorBlendMode, blend), getattr(pkg.ColorBlendMask, mask)
        )
    )
    cj, ct = _render_pair(mj, mt, _inputs(14))
    modj.apply_render(mj, cj)
    modt.apply_render(mt, ct)
    _close(ct.color, cj.color)


@pytest.mark.parametrize("width", [1, 2, 3])
def test_size_over_lifetime_matches_jax(width):
    start, end = (0.1, 0.2, 0.3)[:width], (0.02, 0.5, 0.0)[:width]
    (mj, modj), (mt, modt) = _modifier_pair(
        lambda w, pkg: pkg.SizeOverLifetimeModifier(pkg.Gradient.linear(start, end))
    )
    cj, ct = _render_pair(mj, mt, _inputs(15))
    modj.apply_render(mj, cj)
    modt.apply_render(mt, ct)
    _close(ct.size, cj.size)


# ---- accel / force modifiers and event emission (update context) -----------

UPDATE_TOL = dict(rtol=1e-5, atol=1e-6)


def _update_pair(mj, mt, data, alive):
    sim = dict(time=0.5, delta_time=1.0 / 30.0)
    return _ctx_pair(
        "UpdateContext", mj, mt, data,
        j={"sim": comp_j.SimParams(**sim), "alive": jnp.asarray(alive)},
        t={"sim": comp_t.SimParams(**sim), "alive": torch.from_numpy(alive)},
    )


UPDATE_MODIFIERS = {
    "accel": lambda w, pkg, A: pkg.AccelModifier(w.lit((0.0, -6.0, 0.5)).expr()),
    "radial_accel": lambda w, pkg, A: pkg.RadialAccelModifier(
        w.lit((0.1, 0.2, -0.3)).expr(), (w.attr(A.AGE) * 0.5 - 1.0).expr()
    ),
    "tangent_accel": lambda w, pkg, A: pkg.TangentAccelModifier(
        w.lit((0.0, 0.0, 0.0)).expr(), w.lit((0.0, 1.0, 0.0)).expr(), w.lit(2.5).expr()
    ),
    "linear_drag": lambda w, pkg, A: pkg.LinearDragModifier((w.attr(A.LIFETIME) * 4.0).expr()),
    "conform_to_sphere": lambda w, pkg, A: pkg.ConformToSphereModifier(
        w.lit((0.0, 1.0, 0.0)).expr(), w.lit(1.0).expr(), w.lit(10.0).expr(),
        w.lit(30.0).expr(), w.lit(5.0).expr(),
    ),
    "conform_to_sphere_shell": lambda w, pkg, A: pkg.ConformToSphereModifier(
        w.lit((0.0, 0.0, 0.0)).expr(), w.lit(1.5).expr(), w.lit(1.0).expr(),
        w.lit(20.0).expr(), w.lit(3.0).expr(), w.lit(0.3).expr(), w.lit(4.0).expr(),
    ),
}


@pytest.mark.parametrize("name", sorted(UPDATE_MODIFIERS))
def test_accel_and_force_modifiers_match_jax(name):
    # rtol 1e-5: the same f32 op sequence; sqrt and division may differ by
    # an ULP between XLA's and PyTorch's CPU kernels, amplified by the
    # normalizations
    (mj, modj), (mt, modt) = _modifier_pair(
        lambda w, pkg: UPDATE_MODIFIERS[name](w, pkg, pkg.attributes)
    )
    data = _inputs(21)
    alive = np.random.default_rng(22).random(N) < 0.8
    cj, ct = _update_pair(mj, mt, data, alive)
    modj.apply(mj, cj)
    modt.apply(mt, ct)
    np.testing.assert_allclose(
        ct.particle["velocity"].numpy(), np.asarray(cj.particle["velocity"]), **UPDATE_TOL
    )


@pytest.mark.parametrize("condition", ["ON_DIE", "ALWAYS"])
@pytest.mark.parametrize("count", ["literal", "per_particle"])
def test_emit_events_masks_match_jax(condition, count):
    def build(w, pkg):
        c = w.lit(4, pkg.UINT) if count == "literal" else (w.attr(pkg.attributes.AGE) * 2.0).cast(pkg.UINT)
        return pkg.EmitSpawnEventModifier(getattr(pkg.EventEmitCondition, condition), c.expr(), 1)

    (mj, modj), (mt, modt) = _modifier_pair(build)
    data = _inputs(23)
    alive = np.random.default_rng(24).random(N) < 0.7
    dies = np.random.default_rng(25).random(N) < 0.2
    cj, ct = _update_pair(mj, mt, data, alive)
    cj.kill(jnp.asarray(dies))
    ct.kill(torch.from_numpy(dies))
    modj.apply(mj, cj)
    modt.apply(mt, ct)
    ((ch_j, mask_j, cnt_j),) = cj.events_out
    ((ch_t, mask_t, cnt_t),) = ct.events_out
    assert ch_j == ch_t == 1
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(cnt_t.numpy().astype(np.uint32), np.asarray(cnt_j))
    assert mask_t.any() and not mask_t.all()
