"""The port's spans on the CPU: under ``torch.profiler`` every span of
``utils.profiling.SPANS`` that a path runs appears once a frame, inside the
span that calls it, on the chunk paths of ``CompiledEffect`` and
``InstancedEffect`` and on the scene's ``update`` and ``render``; with no
profiler session active a span enters no ``record_function``."""

import math
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bevy_hanabi_tpu_torch import (CompiledEffect, EffectSpawner, HanabiScene, InstancedEffect,
                                   RasterConfig, SimParams, StepInputs)
from bevy_hanabi_tpu_torch.models import gradient_effect, instancing_effect
from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective
from bevy_hanabi_tpu_torch.utils.profiling import SPANS, profile_span

DT = 1.0 / 60.0
FRAMES = 2
CONFIG = RasterConfig(64, 64)
CAMERA = CameraParams(look_at((0, 0, 26), (0, 0, 0)), perspective(math.radians(60), 1, 0.1, 200),
                      (64, 64))


def _spans(prof) -> Counter:
    """``(span, innermost enclosing span or None)`` of every program span
    in the profile, counted."""
    out = Counter()
    for e in prof.events():
        if not e.name.startswith("hanabi:"):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("hanabi:"):
            parent = parent.cpu_parent
        out[(e.name, None if parent is None else parent.name)] += 1
    return out


def _per_frame(spans: dict) -> Counter:
    return Counter({k: FRAMES * v for k, v in spans.items()})


def _effect_chunk():
    fx = CompiledEffect(gradient_effect(2048), device="cpu")
    sp = EffectSpawner(fx.asset.spawner, rng=np.random.default_rng(0))
    ins = [StepInputs.make(sp.tick(DT), j) for j in range(FRAMES)]
    sims = [SimParams(time=j * DT, delta_time=DT) for j in range(FRAMES)]
    return fx, fx.create_pool(), fx.stack_frames(ins, sims)


def _group_chunk():
    fx = InstancedEffect(instancing_effect(256), 4, device="cpu")
    rng = np.random.default_rng(0)
    ins = [fx.make_inputs(np.full(4, 8), rng.integers(0, 2**32, 4, dtype=np.uint32))
           for _ in range(FRAMES)]
    sims = [SimParams(time=j * DT, delta_time=DT) for j in range(FRAMES)]
    return fx, fx.create_pools(), CompiledEffect.stack_frames(ins, sims)


# a frame's spans in a chunk, which is one hanabi:chunk a call
RENDERED = {("hanabi:step", "hanabi:chunk"): 1, ("hanabi:extract", "hanabi:chunk"): 1,
            ("hanabi:raster", "hanabi:chunk"): 1, ("hanabi:sort", "hanabi:raster"): 1}


@pytest.mark.parametrize("what", ["effect", "group"])
def test_step_render_chunk_spans(what):
    fx, pool, stacked = _effect_chunk() if what == "effect" else _group_chunk()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fx.step_render_chunk(pool, *stacked, CAMERA, CONFIG)
    assert _spans(prof) == _per_frame(RENDERED) + Counter({("hanabi:chunk", None): 1})


@pytest.mark.parametrize("what", ["effect", "group"])
def test_step_chunk_spans(what):
    fx, pool, stacked = _effect_chunk() if what == "effect" else _group_chunk()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fx.step_chunk(pool, *stacked)
    assert _spans(prof) == Counter({("hanabi:chunk", None): 1,
                                    ("hanabi:step", "hanabi:chunk"): FRAMES})


def _scene():
    s = HanabiScene(seed=5, device="cpu")
    s.add(gradient_effect(2048), "fx")
    s.update(DT, cameras=[CAMERA])
    s.render(CAMERA, CONFIG)
    return s


def test_scene_frame_spans():
    s = _scene()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(FRAMES):
            s.update(DT, cameras=[CAMERA])
            s.render(CAMERA, CONFIG)
    want = {("hanabi:update", None): 1, ("hanabi:cull", "hanabi:update"): 1,
            ("hanabi:spawn", "hanabi:update"): 1, ("hanabi:step", "hanabi:update"): 1,
            ("hanabi:render", None): 1, ("hanabi:cull", "hanabi:render"): 1,
            ("hanabi:plan", "hanabi:render"): 1, ("hanabi:extract", "hanabi:render"): 1,
            ("hanabi:raster", "hanabi:render"): 1, ("hanabi:sort", "hanabi:raster"): 1}
    got = _spans(prof)
    assert got == _per_frame(want)
    # every span but the chunk's and those of events and the painter pass,
    # which a single effect never opens (test_torch_mixed_tracing.py)
    assert {name for name, _ in got} | {"hanabi:chunk", "hanabi:events",
                                        "hanabi:painter"} == set(SPANS)


def test_scene_group_spawn_span():
    s = HanabiScene(seed=5, device="cpu")
    s.add_group(instancing_effect(256), 4, "grid")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.update(DT)
    assert _spans(prof) == Counter({("hanabi:update", None): 1,
                                    ("hanabi:spawn", "hanabi:update"): 1,
                                    ("hanabi:step", "hanabi:update"): 1})


def test_span_without_profiler_enters_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    fx, pool, stacked = _effect_chunk()
    fx.step_render_chunk(pool, *stacked, CAMERA, CONFIG)
    gx, pools, gstacked = _group_chunk()
    gx.step_render_chunk(pools, *gstacked, CAMERA, CONFIG)
    s = _scene()
    s.update(DT, cameras=[CAMERA])
    s.render(CAMERA, CONFIG)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="record_function entered"):
            with profile_span("hanabi:step"):
                pass


def test_span_passes_exceptions_and_closes():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            with profile_span("hanabi:plan"):
                raise ValueError("inside")
        with profile_span("hanabi:cull"):
            pass
    assert _spans(prof) == Counter({("hanabi:plan", None): 1, ("hanabi:cull", None): 1})
