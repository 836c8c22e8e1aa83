"""The comparison sees a broken timed path: a whole run of each cell at a
tiny size on the CPU, the harness's look for a chip skipped, with the
program broken underneath in the window, comes out not correct. The faults
a cell can have: a step that returns its state unchanged; half of the
lanes left out of the step; an answer (a frame's image, or a lane of the
pools where nothing is drawn) altered where it is produced. One chip: no
exchange between chips to leave out."""

from __future__ import annotations

import pytest
import torch

from hanabi_bench import inputs, run, spec
from hanabi_bench.tests._tiny import TinyBench

CELLS = sorted(spec.load().workloads)
RENDERED = [c for c in CELLS if spec.load().cell(c).traffic["render"]]


def _after_warmup(monkeypatch, name, broken):
    """Replace the program's one-frame step by ``broken(original, *args)``
    once the warm-up's frames have run."""
    from bevy_hanabi_tpu_torch.runtime.effect import CompiledEffect

    cell = TinyBench().cell(name)
    warm = inputs.warm_frames(cell.config, cell.traffic)
    original = CompiledEffect._step
    calls = {"n": 0}

    def step(self, pool, *args, **kwargs):
        calls["n"] += 1
        if calls["n"] <= warm:
            return original(self, pool, *args, **kwargs)
        return broken(original, self, pool, *args, **kwargs)

    monkeypatch.setattr(CompiledEffect, "_step", step)


def _run(name):
    return run.run(TinyBench(), name, 4242, 0.3, False, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_state_unchanged(monkeypatch, name):
    _after_warmup(monkeypatch, name, lambda original, self, pool, *a, **k: (pool, {}))
    out = _run(name)
    assert not out["correct"], out["readings"]


@pytest.mark.parametrize("name", CELLS)
def test_half_the_lanes_left_out(monkeypatch, name):
    def half(original, self, pool, *args, **kwargs):
        old = {k: v.clone() for k, v in pool.attrs.items()}
        alive, seed = pool.alive.clone(), pool.seed.clone()
        pool, events = original(self, pool, *args, **kwargs)
        h = alive.shape[-1] // 2
        pool.attrs = {k: torch.cat([v[:h], old[k][h:]]) for k, v in pool.attrs.items()}
        pool.alive = torch.cat([pool.alive[:h], alive[h:]])
        pool.seed = torch.cat([pool.seed[:h], seed[h:]])
        return pool, events

    _after_warmup(monkeypatch, name, half)
    out = _run(name)
    assert not out["correct"], out["readings"]


@pytest.mark.parametrize("name", RENDERED)
def test_image_altered(monkeypatch, name):
    from bevy_hanabi_tpu_torch.render import raster, renderer

    original = raster.rasterize

    def altered(*args, **kwargs):
        img = original(*args, **kwargs).clone()
        img[0, 0, 0] += 1.0
        return img

    monkeypatch.setattr(raster, "rasterize", altered)
    monkeypatch.setattr(renderer, "rasterize", altered)
    out = _run(name)
    assert not out["correct"], out["readings"]


@pytest.mark.parametrize("name", [c for c in CELLS if c not in RENDERED])
def test_lane_altered(monkeypatch, name):
    def altered(original, self, pool, *args, **kwargs):
        pool, events = original(self, pool, *args, **kwargs)
        lane = int(torch.argmax(pool.alive.to(torch.int32)))
        pos = pool.attrs["position"].clone()
        pos[lane] += 1.0
        pool.attrs = dict(pool.attrs, position=pos)
        return pool, events

    _after_warmup(monkeypatch, name, altered)
    out = _run(name)
    assert not out["correct"], out["readings"]
