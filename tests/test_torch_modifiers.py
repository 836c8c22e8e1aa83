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
    g = bt.Gradient([(i / 20, (float(i),)) for i in range(21)])
    with pytest.raises(NotImplementedError, match="16 keys"):
        g.sample_torch(torch.zeros(4))


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


def test_texture_sample_is_not_ported():
    m = bt.Module()
    h = m.texture_sample(m.add_texture_slot("t"), m.lit((0.5, 0.5)))
    ctx = comp_t.InitContext(m, {}, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(NotImplementedError, match="texture_sample"):
        ctx.eval(h)


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
