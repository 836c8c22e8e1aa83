"""An event-linked effect tree through the harness, on the test tree
``data/tree/firework_tree.json`` (512 rockets that emit ON_DIE events, 2048
trails that consume them) at a tiny size on the CPU: whole runs through
``update_render_chunk``, ``update_chunk`` and the scene loop agree with
the tree's plain reference (``data/tree/firework_tree.py``, on
``reference/_events.py``), with events compared; a traced run's summary
holds the program's spans and counters; and the comparison catches a
broken timed path and the bf16 control."""

from __future__ import annotations

import time

import pytest
import torch

from hanabi_bench import control, inputs, loops, program, run, verify
from hanabi_bench.tests._tiny import TREE_MIXES, TreeBench

SEED = 2**31 + 4321
MIXES = sorted(TREE_MIXES)
RENDERED = ["chunk", "scene"]


def _run(mix, seconds=0.5):
    return run.run(TreeBench(), f"firework_tree.{mix}", SEED, seconds, False, "cpu")


def _broken_run(mix):
    """A window of one call, which opens as the rockets die and the trails
    spawn, so that the span the comparison reads holds them: a longer
    window's last span may open after every trail has died."""
    return _run(mix, 0.0)


@pytest.mark.parametrize("mix", MIXES)
def test_tree_run_is_correct(mix):
    out = _run(mix)
    assert out["error"] is None and out["frames"] > 0
    assert out["correct"], out["readings"]
    assert set(out["readings"]) == set(out["limits"])
    assert all(v == 0.0 for v in out["readings"].values()), out["readings"]


@pytest.mark.parametrize("mix", MIXES)
def test_events_inside_a_compared_span(mix):
    """The window's first call: the rockets' events and the trails spawned
    from them during the span are in the state the comparison reads."""
    cell = TreeBench().cell(f"firework_tree.{mix}")
    window = loops.run_window(cell, SEED, 0.0, False, "cpu", time.perf_counter())
    (span,) = window.record.spans
    trail, rocket = span.end["trail"], span.end["rocket"]
    young = trail["alive"] & (trail["age"] <= span.frames * inputs.frame_dt(cell.traffic) + 1e-6)
    assert int(young.sum()) > 0, "no trail lane spawned from an event inside the span"
    assert int(rocket["events0.num"]) > 0 and "events0.position" in rocket
    readings = verify.compare(window.record, cell, SEED, "cpu")
    assert verify.judge(readings, cell.limits), readings


def test_tree_refuses_benchmark_frame_seeds():
    cell = TreeBench().cell("firework_tree.chunk")
    with pytest.raises(ValueError, match="frame_seeds"):
        program.build(cell.config, dict(cell.traffic, frame_seeds="benchmark"), 1, "cpu")


def _after_warmup(monkeypatch, mix, asset_name, broken):
    """Replace the step of ``asset_name``'s effect by ``broken(original,
    self, pool, *args)`` once the warm-up's frames have run."""
    from bevy_hanabi_tpu_torch.runtime.effect import CompiledEffect

    cell = TreeBench().cell(f"firework_tree.{mix}")
    warm = inputs.warm_frames(cell.config, cell.traffic)
    original = CompiledEffect._step
    calls = {"n": 0}

    def step(self, pool, *args, **kwargs):
        if self.asset.name != asset_name:
            return original(self, pool, *args, **kwargs)
        calls["n"] += 1
        if calls["n"] <= warm:
            return original(self, pool, *args, **kwargs)
        return broken(original, self, pool, *args, **kwargs)

    monkeypatch.setattr(CompiledEffect, "_step", step)
    return warm


@pytest.mark.parametrize("mix", MIXES)
def test_trail_lane_altered(monkeypatch, mix):
    def altered(original, self, pool, *args, **kwargs):
        pool, events = original(self, pool, *args, **kwargs)
        lane = int(torch.argmax(pool.alive.to(torch.int32)))
        pos = pool.attrs["position"].clone()
        pos[lane] += 1.0
        pool.attrs = dict(pool.attrs, position=pos)
        return pool, events

    _after_warmup(monkeypatch, mix, "firework_trail", altered)
    out = _broken_run(mix)
    assert not out["correct"], out["readings"]


@pytest.mark.parametrize("mix", MIXES)
def test_rockets_left_unstepped(monkeypatch, mix):
    def unstepped(original, self, pool, *args, **kwargs):
        return pool, {ch: self.make_empty_events(pool.capacity)
                      for ch in range(self.num_event_channels)}

    _after_warmup(monkeypatch, mix, "firework", unstepped)
    out = _broken_run(mix)
    assert not out["correct"], out["readings"]


@pytest.mark.parametrize("mix", MIXES)
def test_one_event_dropped(monkeypatch, mix):
    from bevy_hanabi_tpu_torch.runtime import effect

    cell = TreeBench().cell(f"firework_tree.{mix}")
    warm = inputs.warm_frames(cell.config, cell.traffic)
    original = effect.build_event_buffer
    calls = {"n": 0, "dropped": 0}

    def dropped(mask, count, *args, **kwargs):
        calls["n"] += 1
        active = torch.nonzero(mask & (count > 0))
        if calls["n"] > warm and len(active):
            mask = mask.clone()
            mask[active[0, 0]] = False
            calls["dropped"] += 1
        return original(mask, count, *args, **kwargs)

    monkeypatch.setattr(effect, "build_event_buffer", dropped)
    out = _broken_run(mix)
    assert calls["dropped"] > 0
    assert not out["correct"], out["readings"]


@pytest.mark.parametrize("mix", RENDERED)
def test_blend_where_add_is_due(monkeypatch, mix):
    from bevy_hanabi_tpu_torch.render import raster, renderer

    original = raster.rasterize

    def as_blend(*args, **kwargs):
        if kwargs.get("alpha_mode") == "add":
            kwargs["alpha_mode"] = "blend"
        return original(*args, **kwargs)

    monkeypatch.setattr(raster, "rasterize", as_blend)
    monkeypatch.setattr(renderer, "rasterize", as_blend)
    out = _broken_run(mix)
    assert not out["correct"], out["readings"]


@pytest.mark.parametrize("mix", MIXES)
def test_tree_control_fails(mix):
    cell = TreeBench().cell(f"firework_tree.{mix}")
    readings = verify.compare(control.control_record(cell, 7, "cpu"), cell, 7, "cpu")
    assert not verify.judge(readings, cell.limits), readings
    same = verify.compare(control.control_record(cell, 7, "cpu", ft=torch.float32), cell, 7, "cpu")
    assert verify.judge(same, cell.limits), same


def test_traced_tree_run():
    out = run.run(TreeBench(), "firework_tree.chunk", SEED, 0.5, True, "cpu")
    assert out["correct"] and out["frames"] == TreeBench().cell("firework_tree.chunk").traffic[
        "trace_frames"]
    assert out["device"]["window_s"] > 0 and "breakdown" in out


def test_traced_tree_summary():
    """The scene's ``stats()`` by member and channel among the counters,
    and its spans among the program's spans."""
    cell = TreeBench().cell("firework_tree.chunk")
    window = loops.run_window(cell, SEED, 0.0, True, "cpu", time.perf_counter())
    counters, spans = window.summary.counters, window.summary.program_spans
    state = window.record.spans[-1].end
    for member in ("rocket", "trail"):
        assert counters[f"effects.{member}.alive"] == int(state[member]["alive"].sum())
        assert counters[f"fused_step_share.{member}"] == 0.0  # events take the eager step
    assert counters["effects.rocket.events.0.events"] == int(state["rocket"]["events0.num"])
    assert spans["hanabi:step"]["self_host"] > 0 and spans["hanabi:raster"]["self_host"] > 0
