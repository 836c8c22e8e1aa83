"""The generated step kernel (``codegen.py``, ``runtime/fused.py``).

On the CPU: the generated source is deterministic and writes its literals
bit-exactly; the engagement decision for every asset of ``models/``; the
scene's ``fused_step_share`` off the card; and the source's per-lane
functions compiled with ``g++`` (``-ffp-contract=off``, the host build of
the source) under a sequential host loop written here, stepped against the
eager step on the CPU over spawn and death cycles: alive masks, PCG seeds
and counters bit for bit (the same integer and IEEE ops), float state
within 1e-5 relative (the host's ``sinf``, ``cosf`` and ``powf`` are not
PyTorch's vectorised ones).

On a card (marked ``cuda``, skipped without one): the kernel against the
eager step on the card over 120 frames, every attribute bit-equal. The file
imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_step_codegen.py -q
"""

import collections
import contextlib
import ctypes
import math
import shutil
import subprocess

import numpy as np
import pytest
import torch

from bevy_hanabi_tpu_torch import (
    CompiledEffect,
    EffectAsset,
    EffectSpawner,
    HanabiScene,
    InstancedEffect,
    RasterConfig,
    SimParams,
    SpawnerSettings,
    StepInputs,
    codegen,
)
from bevy_hanabi_tpu_torch.attributes import Attribute
from bevy_hanabi_tpu_torch.graph.expr import BuiltInOp, ExprWriter
from bevy_hanabi_tpu_torch.models import benchmarks, examples, gradient_effect, instancing_effect
from bevy_hanabi_tpu_torch.modifiers.accel import AccelModifier
from bevy_hanabi_tpu_torch.modifiers.attr import SetAttributeModifier
from bevy_hanabi_tpu_torch.modifiers.force import LinearDragModifier
from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective
from bevy_hanabi_tpu_torch.runtime import fused as fused_mod
from bevy_hanabi_tpu_torch.runtime.pool import ParticlePool
from bevy_hanabi_tpu_torch.spawn import make_spawner_bank
from bevy_hanabi_tpu_torch.values import BOOL, FLOAT, INT, UINT, VEC2F, VEC3F, VEC4F


def _model_assets():
    """Every asset of ``models/``: ``(label, asset)``."""
    out = []
    for name in sorted(n for n in dir(benchmarks) if n.endswith("_effect")):
        out.append((name, getattr(benchmarks, name)()))
    for name, build in examples.examples_registry().items():
        made = build()
        items = made.items() if isinstance(made, dict) else [(None, made)]
        for key, asset in items:
            out.append((f"example_{name}" + (f".{key}" if key else ""), asset))
    return out


# Which assets the generated step takes, and why the rest keep the eager one.
ENGAGEMENT = {
    "firework_effect": "it emits GPU spawn events",
    "firework_trail_effect": "init modifier InheritAttributeModifier has no emitter",
    "force_field_effect": "update modifier ConformToSphereModifier has no emitter",
    "gradient_effect": None,
    "instancing_effect": None,
    "ribbon_bench_effect": "PARTICLE_COUNTER (it reads the counter before the step's update)",
    "ribbon_order_check_effect": "PARTICLE_COUNTER (it reads the counter before the step's update)",
    "spawn_gravity_effect": None,
    "textured_mesh_check_effect": None,
    "example_2d": "init modifier SetPositionCircleModifier has no emitter",
    "example_activate": "update modifier KillAabbModifier has no emitter",
    "example_billboard": "init modifier SetPositionCircleModifier has no emitter",
    "example_circle": "init modifier SetPositionCircleModifier has no emitter",
    "example_expr": "init modifier SetPositionCircleModifier has no emitter",
    "example_init_circle": "init modifier SetPositionCircleModifier has no emitter",
    "example_init_sphere": None,
    "example_init_cone": "init modifier SetPositionCone3dModifier has no emitter",
    "example_lifetime.short": None,
    "example_lifetime.exact": None,
    "example_lifetime.long": None,
    "example_lightning": "PARTICLE_COUNTER (it reads the counter before the step's update)",
    "example_mesh_path": None,
    "example_multicam": None,
    "example_ordering": None,
    "example_portal": "init modifier SetPositionCircleModifier has no emitter",
    "example_puffs": "init modifier SetPositionCircleModifier has no emitter",
    "example_random": None,
    "example_ribbon": None,
    "example_spawn_on_command": "cross (ATen's kernel may contract to FMA)",
    "example_visibility": None,
    "example_worms.heads": "it emits GPU spawn events",
    "example_worms.bodies": "init modifier InheritAttributeModifier has no emitter",
}
FUSED = sorted(k for k, v in ENGAGEMENT.items() if v is None) + ["every_node"]
IDENTITY = np.concatenate([np.eye(3, dtype=np.float32), np.zeros((3, 1), np.float32)], 1)


def _every_node(capacity: int = 1024) -> EffectAsset:
    """An asset that reaches every node kind and op the generator writes:
    each kind of rand draw, casts, properties of three kinds, builtins,
    ``is_alive`` and the lane's index, every unary, binary and ternary op
    it takes, in both passes."""
    w = ExprWriter()
    w.add_property("tint", (0.5, 0.25, 1.0))
    w.add_property("gain", 2.0)
    w.add_property("shift", 3)
    one3 = w.lit((1.0, 1.0, 1.0))
    r = w.rand(FLOAT)
    pos = (w.rand(VEC3F) * 2.0 - one3) * w.prop("gain")
    vel = w.lit((0.0, 0.5, 0.0)).normal(w.lit((1.0, 2.0, 0.5)))
    hdr = (w.rand(VEC4F) * w.prop("tint").vec4_xyz_w(w.lit(1.0).normal(w.lit(0.25)))).saturate()
    ids = w.rand(UINT) + (w.attr(Attribute.AGE) * 1000.0).cast(UINT) + w.attr(Attribute.ID)
    sprite = (r * 8.0).floor().cast(INT) + w.prop("shift") - w.rand(INT).max(w.lit(-5))
    v2 = w.rand(VEC2F)
    mixed = (w.lit(0.0).smoothstep(w.lit(1.0), r) + v2.x().mix(v2.y(), r)
             + pos.length() + pos.dot(one3) + pos.distance(one3) + v2.x().atan2(r - 0.5)
             + (r + 1.0).log() + r.exp() + r.sin() * r.cos() + (r * 0.5).tan() + r.sqrt()
             + (r * 2.0 - 1.0).asin() + (r * 2.0 - 1.0).acos() + r.atan() + (r + 1.0).log2()
             + r.exp2() + (r + 0.5).inverse_sqrt() + (r * 3.0 - 1.5).sign() + (r * 7.0).fract()
             + (r * 7.0).round() + (r * 7.0).ceil() + (r - 0.5).abs() + (r % 0.3)
             + r.min(0.25) + r.clamp(0.2, 0.7) + w.lit(0.5).step(r) + w.rand(BOOL).cast(FLOAT)
             + (pos.normalized() * r).y() + r.vec3(r * 2.0, w.time()).z()
             + (v2 / r.vec2(w.lit(2.0))).x())
    later = (w.time() * w.delta_time() + w.builtin(BuiltInOp.IS_ALIVE).cast(FLOAT)
             + w.builtin(BuiltInOp.PARTICLE_INDEX).cast(FLOAT) * 0.001
             + (w.attr(Attribute.POSITION) < w.lit((0.0, 0.5, 1.0))).any().cast(FLOAT)
             + (w.attr(Attribute.POSITION) > w.lit((-9.0, -9.0, -9.0))).all().cast(FLOAT)
             + w.attr(Attribute.F32_0).max(w.attr(Attribute.AGE)) + w.rand(FLOAT))
    return (EffectAsset("every_node", capacity, SpawnerSettings.rate(capacity / 2.0), w.finish())
            .init(SetAttributeModifier(Attribute.POSITION, pos.expr()))
            .init(SetAttributeModifier(Attribute.VELOCITY, vel.expr()))
            .init(SetAttributeModifier(Attribute.AGE, (r * 0.5).expr()))
            .init(SetAttributeModifier(Attribute.LIFETIME, w.lit(1.0).uniform(w.lit(3.0)).expr()))
            .init(SetAttributeModifier(Attribute.HDR_COLOR, hdr.expr()))
            .init(SetAttributeModifier(Attribute.U32_0, ids.expr()))
            .init(SetAttributeModifier(Attribute.SPRITE_INDEX, sprite.expr()))
            .init(SetAttributeModifier(Attribute.F32_0, mixed.expr()))
            .update(AccelModifier((w.prop("tint") * -1.0).expr()))
            .update(LinearDragModifier(w.lit(0.5).expr()))
            .update(SetAttributeModifier(Attribute.F32_1, later.expr()))
            .update(SetAttributeModifier(Attribute.U32_0,
                                         (w.attr(Attribute.U32_0) * w.lit(3, UINT)
                                          + w.rand(UINT)).expr())))


def _asset(label: str, capacity: int = None) -> EffectAsset:
    if label == "every_node":
        return _every_node(capacity or 1024)
    asset = dict(_model_assets())[label]
    if capacity is not None:
        asset.capacity = capacity
    return asset


# ---------------------------------------------------------------------------
# the source


def test_source_is_deterministic():
    """Two builds of the same asset, and its JSON round trip, give the same
    text and the same library name; another asset another text."""
    a, b = gradient_effect(4096), gradient_effect(4096)
    sa, sb = codegen.generate(a), codegen.generate(b)
    assert sa.text == sb.text and sa.digest == sb.digest
    assert codegen.generate(EffectAsset.from_json(a.to_json())).text == sa.text
    assert fused_mod.library_path(sa.text) == fused_mod.library_path(sb.text)
    assert fused_mod.library_path(sa.text).name.startswith("libhanabi_step-")
    other = codegen.generate(instancing_effect(4096))
    assert other.text != sa.text and other.digest != sa.digest
    assert fused_mod.library_path(other.text) != fused_mod.library_path(sa.text)
    # the capacity is a launch argument, not part of the source
    assert codegen.generate(gradient_effect(64)).text == sa.text


SPECIAL_FLOATS = [0.0, -0.0, 1.0 / 3.0, 0.1, 1e-24, 2.0**-149, 1e-40, 3.4028234663852886e38,
                  -2.5, 6.283185307179586, float("inf"), float("-inf"), float("nan")]


def _parse_c_float(text: str) -> np.float32:
    if text.startswith("bits_f("):
        return np.array(int(text[len("bits_f("):-2], 16), np.uint32).view(np.float32)
    return np.float32(float.fromhex(text[:-1]))


@pytest.mark.parametrize("x", SPECIAL_FLOATS, ids=repr)
def test_literal_round_trips(x):
    """A literal's C++ text is exactly the f32 it rounds to, sign of zero,
    subnormals, infinities and NaN bits included, and appears as such in
    the source of an asset that holds it."""
    text = codegen.c_float(x)
    bits = np.array(np.float32(x)).view(np.uint32)
    assert np.array(_parse_c_float(text)).view(np.uint32) == bits
    w = ExprWriter()
    asset = (EffectAsset("literal", 64, SpawnerSettings.rate(10.0), w.finish())
             .init(SetAttributeModifier(Attribute.POSITION, w.lit((0.0, 0.0, 0.0)).expr()))
             .init(SetAttributeModifier(Attribute.AGE, w.lit(x).expr())))
    assert f"= {text};" in codegen.generate(asset).text


def test_engagement_of_every_model_asset():
    """The generated step takes every asset of ``models/`` whose modifiers
    and nodes it can write, and names what keeps each other one eager."""
    got = {label: codegen.fuse_reason(asset) for label, asset in _model_assets()}
    assert got == ENGAGEMENT
    # a consumer of events, or a sharded effect, keeps the eager step
    assert codegen.fuse_reason(gradient_effect(64), consumes_events=True) == \
        "it consumes GPU spawn events"
    assert codegen.fuse_reason(gradient_effect(64), sharded=True) == \
        "its pool is sharded over a mesh"
    fx = CompiledEffect(gradient_effect(64), device="cpu")
    assert fx.fuse_reason is None and fx.fused_step is not None
    assert CompiledEffect(benchmarks.firework_effect(64), device="cpu").fused_step is None


def test_fused_step_share_is_zero_off_the_card():
    """On the CPU every frame takes the eager step."""
    scene = HanabiScene(seed=3, device="cpu")
    name = scene.add(gradient_effect(512), "grad")
    scene.add_group(instancing_effect(64), 3, "group")
    for _ in range(3):
        scene.update(1.0 / 60.0)
    stats = scene.stats()
    assert stats["fused_step_share"] == {name: 0.0, "group": 0.0}
    assert scene[name].fx.eager_frames == 3 and scene[name].fx.fused_frames == 0


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_tensor_property_words_match_host_words(lead):
    """A property value held as a tensor is left to the card by
    ``FusedStep.words`` and gives there the words its host value gives:
    float bits, integers of another width, a vector's lanes."""
    fused = fused_mod.FusedStep(codegen.generate(_every_node()))
    r = np.random.default_rng(5)
    host = {"tint": r.uniform(-2, 2, lead + (3,)).astype(np.float32),
            "gain": r.uniform(-2, 2, lead),
            "shift": r.integers(-9, 9, lead)}
    counts = np.ones(lead, np.int32)
    seeds = np.arange(int(np.prod(lead, dtype=np.int64))).reshape(lead)
    want, held = fused.words(counts, seeds, IDENTITY, host, lead)
    assert held == []
    got, held = fused.words(counts, seeds, IDENTITY,
                            {k: torch.as_tensor(v) for k, v in host.items()}, lead)
    assert sorted(slot.name for slot, _, _ in held) == sorted(host)
    for slot, value, shape in held:
        cols = slice(slot.offset, slot.offset + slot.lanes)
        assert not got[..., cols].any()
        got[..., cols] = fused_mod._tensor_words(slot.kind, value, shape, "cpu").numpy().view(
            np.uint32)
    np.testing.assert_array_equal(got, want)


def test_property_of_another_shape_raises():
    """The generated step takes one value an instance; any other shape is a
    clear error, not a silent fallback. A leading axis of one is dropped, as
    the eager step broadcasts it."""
    fused = fused_mod.FusedStep(codegen.generate(_every_node()))
    counts, seeds = np.ones(3, np.int32), np.arange(3)
    with pytest.raises(ValueError, match="'gain'.*one value an instance"):
        fused.words(counts, seeds, IDENTITY, {"gain": np.ones(4, np.float32)}, (3,))
    with pytest.raises(ValueError, match="'tint'"):
        fused.words(counts, seeds, IDENTITY, {"tint": torch.ones(3, 2)}, (3,))
    with pytest.raises(ValueError, match="'gain'"):
        fused.words(1, 0, IDENTITY, {"gain": np.ones(5, np.float32)}, ())
    one, _ = fused.words(1, 0, IDENTITY, {"gain": np.full((1,), 0.5, np.float32)}, ())
    slot = next(s for s in fused.source.properties if s.name == "gain")
    assert one[slot.offset] == np.float32(0.5).view(np.uint32)


# ---------------------------------------------------------------------------
# the source's lane functions on the host, against the eager step

HOST_LOOP = r"""
extern "C" void host_step(void* const* ptrs, const uint32_t* frame, const uint32_t* staged,
                          int instances, long long per) {
  const Pool p = make_pool(ptrs);
  Frame f;
  memcpy(&f, frame, sizeof(Frame));
  for (int inst = 0; inst < instances; ++inst) {
    uint32_t w[W];
    for (int j = 0; j < W; ++j)
      w[j] = staged ? staged[((long long)f.k * f.instances + inst) * W + j] : f.w[j];
    const long long first = (long long)inst * per;
    int dead = 0;
    for (long long i = first; i < first + per; ++i) dead += p.alive[i] ? 0 : 1;
    const int requested = int(w[0]);
    int rank = 0;
    for (long long i = first; i < first + per; ++i) {
      Lane l;
      load_lane(p, i, l);
      const uint32_t slot = uint32_t(i - first);
      if (!l.alive) {
        if (rank < requested) spawn_lane(l, slot, uint32_t(rank), f, w);
        ++rank;
      }
      update_lane(l, slot, f, w);
      store_lane(p, i, l);
    }
    p.counter[inst] = (p.counter[inst] + (long long)(requested < dead ? requested : dead))
                      & 0xFFFFFFFFLL;
  }
}
"""


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """``asset -> (FusedStep, host library)``: the asset's source with the
    loop above, built with ``g++`` (cached by source)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the source's host functions")
    root = tmp_path_factory.mktemp("step_host")
    built = {}

    def build(asset):
        fused = fused_mod.FusedStep(codegen.generate(asset))
        lib = built.get(fused.source.digest)
        if lib is None:
            src = root / f"{fused.source.digest}.cpp"
            src.write_text(fused.source.text + HOST_LOOP)
            so = root / f"{fused.source.digest}.so"
            run = subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
                                  "-shared", "-o", str(so), str(src)],
                                 capture_output=True, text=True)
            assert run.returncode == 0, run.stderr
            lib = ctypes.CDLL(str(so))
            lib.host_step.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong]
            built[fused.source.digest] = lib
        return fused, lib

    return build


def _host_step(fused, lib, pool, inputs, sim, instances):
    """One frame of ``pool`` (flat lanes) by the host build, in place."""
    n = pool.alive.shape[-1]
    count = max(instances, 1)
    words, _ = fused.words(inputs.spawn_count, inputs.frame_seed, inputs.transform,
                           inputs.properties, (instances,) if instances else ())
    if instances:
        staged = words
        frame = fused._frame(sim, 0, count, None)
    else:
        staged = None
        frame = fused._frame(sim, 0, 1, words)
    fused._own(pool, n, instances)
    tensors = [pool.attrs[f.name] for f in fused.source.fields] + [pool.alive, pool.seed,
                                                                   pool.counter]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    lib.host_step(ptrs, frame.ctypes.data, None if staged is None else staged.ctypes.data, count,
                  n // count)


def _flat(pools, instances):
    n = pools.alive.shape[-1]
    return ParticlePool(
        {k: v.reshape((instances * n,) + tuple(v.shape[2:])) for k, v in pools.attrs.items()},
        pools.alive.reshape(instances * n), pools.seed.reshape(instances * n), pools.counter)


def _clone(pool):
    return ParticlePool({k: v.clone() for k, v in pool.attrs.items()}, pool.alive.clone(),
                        pool.seed.clone(), pool.counter.clone())


def _assert_close(host, eager, label):
    assert torch.equal(host.alive, eager.alive), f"{label}: alive"
    assert torch.equal(host.seed, eager.seed), f"{label}: seed"
    assert torch.equal(host.counter, eager.counter), f"{label}: counter"
    for k, v in eager.attrs.items():
        h = host.attrs[k].reshape(v.shape)
        if v.is_floating_point():
            torch.testing.assert_close(h, v, rtol=1e-5, atol=1e-5, equal_nan=True,
                                       msg=f"{label}: {k}")
        else:
            assert torch.equal(h, v), f"{label}: {k}"


def _schedule(frames, capacity, seed):
    """Spawn counts through fill, a full pool, starvation and death."""
    r = np.random.default_rng(seed)
    counts = r.integers(0, capacity // 8 + 2, frames)
    counts[frames // 4: frames // 4 + 3] = 2 * capacity  # more than the pool holds
    counts[frames // 2: frames // 2 + frames // 6] = 0
    return counts


@pytest.mark.parametrize("label", FUSED)
def test_host_build_matches_eager(label, host_build):
    """Every asset the generated step takes, 48 frames of 1/4 s at 1003
    lanes (not a multiple of four) on the host, against the eager step."""
    asset = _asset(label, capacity=1003)
    fx = CompiledEffect(asset, device="cpu")
    fused, lib = host_build(asset)
    eager = fx.create_pool()
    host = _clone(eager)
    r = np.random.default_rng(11)
    props = {}
    for name, v in asset.module.properties().items():
        props[name] = (np.asarray(v.to_numpy()) + r.uniform(-1, 1, np.shape(v.to_numpy()))).astype(
            np.asarray(v.to_numpy()).dtype)
    tf = np.concatenate([np.eye(3, dtype=np.float32) * 1.5, np.array([[1.0], [-2.0], [0.5]],
                                                                     np.float32)], axis=1)
    for j, n_spawn in enumerate(_schedule(48, 1003, 5)):
        inputs = StepInputs.make(int(n_spawn), int(r.integers(0, 2**32)), tf, props)
        sim = SimParams(time=j * 0.25, delta_time=0.25)
        eager, _ = fx._step(eager, inputs, sim, None, None)
        _host_step(fused, lib, host, inputs, sim, 0)
        _assert_close(host, eager, f"{label} frame {j}")
    assert int(host.alive.sum()) > 0


def _group_props(asset, instances, r):
    """Each instance its own value of every property of ``asset``."""
    out = {}
    for name, v in asset.module.properties().items():
        d = np.asarray(v.to_numpy())
        out[name] = (d + r.uniform(-1, 1, (instances,) + d.shape)).astype(d.dtype)
    return out


@pytest.mark.parametrize("label,instances,lanes", [("instancing_effect", 3, 1000),
                                                   ("instancing_effect", 5, 1001),
                                                   ("every_node", 4, 301)])
def test_host_build_matches_eager_group(label, instances, lanes, host_build):
    """The instanced group: each instance its own counts, seeds, transform
    and property values, ranked among its own lanes."""
    group = InstancedEffect(_asset(label, lanes), instances, device="cpu")
    fused, lib = host_build(group.asset)
    eager = group.create_pools()
    host = _flat(_clone(eager), instances)
    r = np.random.default_rng(3)
    tfs = np.broadcast_to(IDENTITY, (instances, 3, 4)).copy()
    tfs[:, :, 3] = r.uniform(-5, 5, (instances, 3))
    props = _group_props(group.asset, instances, r)
    for j in range(40):
        counts = r.integers(0, lanes // 4, instances)
        if j in (10, 11):
            counts[:] = 3 * lanes
        inputs = group.make_inputs(counts, r.integers(0, 2**32, instances, dtype=np.uint32), tfs,
                                   props)
        sim = SimParams(time=j * 0.3, delta_time=0.3)
        eager, _ = group._step(eager, inputs, sim)
        _host_step(fused, lib, host, inputs, sim, instances)
        _assert_close(host, _flat(eager, instances), f"group frame {j}")


# ---------------------------------------------------------------------------
# on the card: the kernel against the eager step, bit for bit


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the generated kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def eager():
    """``eager(fx, ...)``: a context in which those effects take the eager
    step."""

    @contextlib.contextmanager
    def ctx(*fxs):
        kept = [fx.fused_step for fx in fxs]
        for fx in fxs:
            fx.fused_step = None
        try:
            yield
        finally:
            for fx, fused in zip(fxs, kept):
                fx.fused_step = fused

    return ctx


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same(a, b, label):
    """Every tensor of two pools bit-equal (NaNs by their bits)."""
    for name, x, y in [("alive", a.alive, b.alive), ("seed", a.seed, b.seed),
                       ("counter", a.counter, b.counter)] + \
            [(k, a.attrs[k], b.attrs[k]) for k in b.attrs]:
        x, y = _bits(x.contiguous()), _bits(y.contiguous())
        bad = int((x != y).sum())
        assert bad == 0, f"{label}: {name} differs in {bad} of {y.numel()} values"


def _single_frames(fx, frames, dt, seed, counts=None):
    sp = EffectSpawner(fx.asset.spawner, rng=np.random.default_rng(seed))
    r = np.random.default_rng(seed + 1)
    ins, sims = [], []
    for j in range(frames):
        n = sp.tick(dt) if counts is None else int(counts[j])
        ins.append(StepInputs.make(n, int(r.integers(0, 2**32))))
        sims.append(SimParams(time=j * dt, delta_time=dt))
    return ins, sims


def _run_single(fx, ins, sims):
    pool = fx.create_pool()
    for k in range(0, len(ins), 60):
        pool = fx.step_chunk(pool, *fx.stack_frames(ins[k:k + 60], sims[k:k + 60]))
    torch.cuda.synchronize()
    return pool


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [3001, 1_000_003, 4_194_304])
def test_kernel_matches_eager(cuda, eager, lanes):
    """The gradient effect over 120 frames of 1/10 s (spawns, then deaths):
    one block an instance (3001 lanes), tiles with a count pass and a ragged
    end (1 000 003), the benchmark's 4M pool."""
    fx = CompiledEffect(gradient_effect(lanes), device=cuda)
    ins, sims = _single_frames(fx, 120, 0.1, lanes)
    with eager(fx):
        want = _run_single(fx, ins, sims)
    before, launched = fx.fused_frames, fx.fused_step.launches
    got = _run_single(fx, ins, sims)
    assert fx.fused_frames - before == 120
    # kernels: one a frame up to 4096 lanes, a count, a scan and the step above
    assert fx.fused_step.launches - launched == 120 * (1 if lanes <= 4096 else 3)
    assert 0 < int(got.alive.sum()) < lanes
    _assert_same(got, want, f"gradient {lanes}")


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [5000, 1_000_003])
def test_kernel_full_and_empty_pool(cuda, eager, lanes):
    """Requests above the free lanes (a full pool, num_free 0), no requests
    until every lane died (an empty pool), then spawns again."""
    fx = CompiledEffect(gradient_effect(lanes), device=cuda)
    counts = [2 * lanes] * 8 + [0] * 60 + [lanes // 3] * 12
    ins, sims = _single_frames(fx, len(counts), 0.25, 9, counts)
    with eager(fx):
        want = fx.create_pool()
        for i, s in zip(ins, sims):
            want, _ = fx.step(want, i, s)
            if s.time == 7 * 0.25:
                assert int(want.alive.sum()) == lanes
    got = fx.create_pool()
    for j, (i, s) in enumerate(zip(ins, sims)):
        got, _ = fx.step(got, i, s)
        if j == 67:
            assert int(got.alive.sum()) == 0
    _assert_same(got, want, f"full/empty {lanes}")


@pytest.mark.cuda
@pytest.mark.parametrize("label,instances,lanes", [
    ("instancing_effect", 1024, 4096), ("instancing_effect", 3, 1000),
    ("instancing_effect", 5, 1001), ("instancing_effect", 2, 10_000), ("every_node", 4, 3001)])
def test_kernel_matches_eager_group(cuda, eager, label, instances, lanes):
    """The instanced group over 120 frames of 1/20 s, a chunk of 60 (its
    words staged once) then a frame a call: 1024 x 4096 (the benchmark's),
    3 x 1000, 5 x 1001 (no 16-byte path), 2 x 10 000 (tiles an instance),
    and the every-node asset with each instance's own property values."""
    group = InstancedEffect(_asset(label, lanes), instances, device=cuda)
    bank = make_spawner_bank(group.asset.spawner, instances, seed=4)
    r = np.random.default_rng(8)
    tfs = np.broadcast_to(IDENTITY, (instances, 3, 4)).copy()
    tfs[:, :, 3] = r.uniform(-5, 5, (instances, 3))
    props = _group_props(group.asset, instances, r)
    ins = [group.make_inputs(bank.tick(0.05), r.integers(0, 2**32, instances, dtype=np.uint32), tfs,
                             props) for _ in range(120)]
    sims = [SimParams(time=j * 0.05, delta_time=0.05) for j in range(120)]

    def run():
        pools = group.create_pools()
        pools = group.step_chunk(pools, *group.effect.stack_frames(ins[:60], sims[:60]))
        for i, s in zip(ins[60:], sims[60:]):  # a frame a call: its words uploaded alone
            pools, _ = group.step(pools, i, s)
        torch.cuda.synchronize()
        return pools

    with eager(group.effect):
        want = run()
    before = group.effect.fused_frames
    got = run()
    assert group.effect.fused_frames - before == 120
    _assert_same(got, want, f"{label} group {instances} x {lanes}")


@pytest.mark.cuda
def test_kernel_takes_property_tensors(cuda, eager):
    """Property values held as tensors on the card: a single effect (its
    words then go to the card as a group's do) a frame a call, and a group
    of 4 x 3001, a chunk of 30 then a frame a call. Every frame through the
    kernel, bit-equal to the eager step."""
    r = np.random.default_rng(31)

    def on_card(props):
        return {k: torch.as_tensor(np.ascontiguousarray(v), device=cuda) for k, v in props.items()}

    fx = CompiledEffect(_every_node(20_011), device=cuda)
    counts = _schedule(60, 20_011, 3)
    ins = [StepInputs.make(int(c), int(r.integers(0, 2**32)), IDENTITY, on_card(
        {"tint": r.uniform(-1, 1, 3).astype(np.float32), "gain": r.uniform(0.5, 2.0),
         "shift": r.integers(-4, 4)})) for c in counts]
    sims = [SimParams(time=j / 8, delta_time=1 / 8) for j in range(60)]

    def run_single():
        pool = fx.create_pool()
        for i, s in zip(ins, sims):
            pool, _ = fx.step(pool, i, s)
        torch.cuda.synchronize()
        return pool

    with eager(fx):
        want = run_single()
    before = fx.fused_frames
    got = run_single()
    assert fx.fused_frames - before == 60
    _assert_same(got, want, "single effect, property tensors")

    group = InstancedEffect(_every_node(3001), 4, device=cuda)
    bank = make_spawner_bank(group.asset.spawner, 4, seed=6)
    host = [group.make_inputs(bank.tick(0.05), r.integers(0, 2**32, 4, dtype=np.uint32), None,
                              _group_props(group.asset, 4, r)) for _ in range(60)]
    gsims = [SimParams(time=j * 0.05, delta_time=0.05) for j in range(60)]
    chunk, chunk_sims = group.effect.stack_frames(host[:30], gsims[:30])
    chunk = chunk._replace(properties=on_card(chunk.properties))
    frames = [i._replace(properties=on_card(i.properties)) for i in host[30:]]

    def run_group():
        pools = group.step_chunk(group.create_pools(), chunk, chunk_sims)
        for i, s in zip(frames, gsims[30:]):
            pools, _ = group.step(pools, i, s)
        torch.cuda.synchronize()
        return pools

    with eager(group.effect):
        want = run_group()
    before = group.effect.fused_frames
    got = run_group()
    assert group.effect.fused_frames - before == 60
    _assert_same(got, want, "group, property tensors")


@pytest.mark.cuda
@pytest.mark.parametrize("label", FUSED)
def test_kernel_matches_eager_every_model(cuda, eager, label):
    """Every asset of ``models/`` the generated step takes, at 20 011 lanes
    over 90 frames of 1/8 s with moved property values and a transform."""
    asset = _asset(label, capacity=20_011)
    fx = CompiledEffect(asset, device=cuda)
    r = np.random.default_rng(21)
    props = {name: (np.asarray(v.to_numpy()) + 0.5).astype(np.asarray(v.to_numpy()).dtype)
             for name, v in asset.module.properties().items()}
    tf = np.concatenate([np.eye(3, dtype=np.float32) * 0.75, np.array([[2.0], [0.0], [-1.0]],
                                                                      np.float32)], axis=1)
    counts = _schedule(90, 20_011, 2)
    ins = [StepInputs.make(int(c), int(r.integers(0, 2**32)), tf, props) for c in counts]
    sims = [SimParams(time=j / 8, delta_time=1 / 8) for j in range(90)]
    with eager(fx):
        want = _run_single(fx, ins, sims)
    got = _run_single(fx, ins, sims)
    _assert_same(got, want, label)


@pytest.mark.cuda
def test_kernel_in_a_scene_with_two_frames_in_flight(cuda, eager):
    """``HanabiScene`` update and render a frame, two frames enqueued
    before one is waited on (the game loop): images and pools as the eager
    step's, and every frame through the kernel."""
    cam = CameraParams(look_at((0, 0, 12), (0, 0, 0)), perspective(math.radians(60), 1, 0.1, 100),
                       (128, 128))
    cfg = RasterConfig(128, 128, tile_slots=1)

    def run():
        scene = HanabiScene(seed=13, device=cuda)
        name = scene.add(gradient_effect(300_000), "grad")
        pending, sums = collections.deque(), []
        for _ in range(90):
            scene.update(0.1, cameras=[cam])
            sums.append(scene.render(cam, cfg).sum())
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) >= 2:
                pending.popleft().synchronize()
        torch.cuda.synchronize()
        return scene, name, torch.stack(sums)

    fx = CompiledEffect.get(gradient_effect(300_000), cuda)  # the scenes' (one signature)
    with eager(fx):
        scene_e, name, sums_e = run()
        assert scene_e[name].fx is fx
        assert scene_e.stats()["fused_step_share"][name] == 0.0
    fx.fused_frames = fx.eager_frames = 0
    scene_f, name, sums_f = run()
    assert scene_f.stats()["fused_step_share"][name] == 1.0
    assert torch.equal(sums_f, sums_e)
    _assert_same(scene_f[name].pool, scene_e[name].pool, "scene")


def test_step_metric_reads_the_generated_kernels():
    """``step_ms_per_frame`` reads the generated step's kernels (count and
    scan passes included) and nothing else; ``aten_ms_per_frame`` does not
    read them. Nothing to read: None, as on a program without them."""
    from hanabi_bench import spec, trace

    ops = [("void hanabi_step_kernel<256>(Pool, Frame, unsigned int const*, int const*, long long, "
            "int)", 0, 100_000),
           ("hanabi_step_count_kernel(unsigned char const*, int*, long long, int)", 100_000,
            103_000),
           ("hanabi_step_scan_kernel(Pool, Frame, unsigned int const*, int*, int)", 103_000,
            105_000),
           ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>",
            105_000, 106_000)]
    summary = trace.Summary(2, (0, 1_000_000), ops, {})
    cell = spec.load().cell("gradient_4m.chunk120")
    step = spec.load_module("metrics", "step_ms_per_frame")
    aten = spec.load_module("metrics", "aten_ms_per_frame")
    assert step.read(summary, cell) == pytest.approx(0.105 / 2)
    assert aten.read(summary, cell) == pytest.approx(0.001 / 2)
    assert step.read(trace.Summary(2, (0, 10), ops[3:], {}), cell) is None
