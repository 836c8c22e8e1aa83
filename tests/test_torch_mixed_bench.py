"""The harness's mixed-blend deployment ``mixed_917k`` at a tiny size on
the CPU (``torch_mixed_tiny.py``): whole runs of its cell through the
harness's ``TreeProgram`` (``update_render_chunk`` under the default
pipeline, the painter pass, and ``update_chunk``) against its plain
reference ``hanabi_bench/reference/mixed_917k.py``, exactly in alive
masks, seeds and event buffers, within the cell's limits on state,
checksums and images; the faults that comparison must catch; and the
port's ``debris_effect``.

Two of the faults show only where two entries of a tile tie in the sort
key: an opaque entry's depth write matters to an entry drawn after it that
lies behind it, which the far-first sort puts after it only on a tie, and
the tie-breaking order matters only to ties. At float positions ties do
not occur by chance, so those cases put pairs of a debris and a gradient
lane at one position (or one float behind it), at rest, into the state a
compared span starts from."""

import time

import numpy as np
import pytest
import torch

import bevy_hanabi_tpu as bj
from bevy_hanabi_tpu_torch import CompiledEffect
from bevy_hanabi_tpu_torch.models import debris_effect
from hanabi_bench import control, inputs, loops, program, run, verify
from torch_mixed_tiny import CELL, FRAMES, SEED, TinyMixed, clone_state, one_thread
from torch_painter_mixed import _debris


@pytest.fixture(autouse=True, scope="module")
def single_thread():
    threads = one_thread()
    yield
    torch.set_num_threads(threads)


def _run(render=True, seconds=0.5):
    return run.run(TinyMixed(render), CELL, SEED, seconds, False, "cpu")


# ---------------------------------------------------------------------------
# the deployment's effect


def test_debris_effect_is_bench_py_debris():
    """``debris_effect`` is bench.py:702-723's debris (the JAX package
    builds it inline), and the generated step takes it."""
    for capacity in (1024, 65536):
        assert debris_effect(capacity).to_json() == _debris(bj, capacity).to_json()
    assert CompiledEffect(debris_effect(1024), device="cpu").fuse_reason is None


# ---------------------------------------------------------------------------
# sound runs


@pytest.mark.parametrize("render", [True, False], ids=["update_render_chunk", "update_chunk"])
def test_mixed_run_is_exact(render):
    out = _run(render)
    assert out["error"] is None and out["frames"] > 0
    assert out["correct"], out["readings"]
    assert set(out["readings"]) == set(out["limits"])
    assert all(v == 0.0 for v in out["readings"].values()), out["readings"]


def test_events_and_overflow_inside_the_compared_spans():
    """The window's spans hold the rockets' events, trails spawned from
    them, every member alive, and tiles past the scene's 64 entries."""
    cell = TinyMixed().cell()
    window = loops.run_window(cell, SEED, 0.0, False, "cpu", time.perf_counter())
    (span,) = window.record.spans
    end = span.end
    assert all(int(end[m]["alive"].sum()) > 0 for m in ("debris", "grad", "trail"))
    young = end["trail"]["alive"] & (end["trail"]["age"] <= FRAMES * inputs.frame_dt(cell.traffic)
                                     + 1e-6)
    assert int(young.sum()) > 0, "no trail lane spawned from an event inside the span"
    assert int(end["rocket"]["events0.num"]) > 0
    from hanabi_bench.reference import _plain

    counts = []
    original = _plain.sort_tiles

    def spy(tile, depth, nt, mode=None):
        order, starts, ends = original(tile, depth, nt, mode)
        counts.append(int((ends - starts).max()))
        return order, starts, ends

    _plain.sort_tiles = spy
    try:
        readings = verify.compare(window.record, cell, SEED, "cpu")
    finally:
        _plain.sort_tiles = original
    assert verify.judge(readings, cell.limits), readings
    assert max(counts) > 2 * cell.config["raster"]["max_entries_per_tile"], counts


def test_mixed_control_fails():
    """The reference in bfloat16 in the program's place fails the cell's
    limits; in float32 it passes them."""
    cell = TinyMixed().cell()
    readings = verify.compare(control.control_record(cell, 7, "cpu"), cell, 7, "cpu")
    assert not verify.judge(readings, cell.limits), readings
    same = verify.compare(control.control_record(cell, 7, "cpu", ft=torch.float32), cell, 7, "cpu")
    assert verify.judge(same, cell.limits), same


# ---------------------------------------------------------------------------
# faults on the harness's path


def _after_warmup(monkeypatch, asset_name, broken):
    """Replace the step of ``asset_name``'s effect by ``broken(original,
    self, pool, *args)`` once the warm-up's frames have run."""
    warm = inputs.warm_frames(TinyMixed().cell().config, TinyMixed().cell().traffic)
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


@pytest.mark.parametrize("render", [True, False], ids=["update_render_chunk", "update_chunk"])
def test_one_event_dropped(monkeypatch, render):
    from bevy_hanabi_tpu_torch.runtime import effect

    warm = inputs.warm_frames(TinyMixed().cell().config, TinyMixed().cell().traffic)
    original = effect.build_event_buffer
    calls = {"n": 0, "dropped": 0}

    def dropped(mask, count, *args, **kwargs):
        calls["n"] += 1
        active = torch.nonzero(mask & (count > 0))
        if calls["n"] > warm and len(active) and not calls["dropped"]:
            mask = mask.clone()
            mask[active[0, 0]] = False
            calls["dropped"] += 1
        return original(mask, count, *args, **kwargs)

    monkeypatch.setattr(effect, "build_event_buffer", dropped)
    out = _run(render, 0.0)
    assert calls["dropped"] == 1
    assert not out["correct"], out["readings"]
    assert out["readings"]["alive_mismatch"] > 0


def test_debris_lane_altered(monkeypatch):
    def altered(original, self, pool, *args, **kwargs):
        pool, events = original(self, pool, *args, **kwargs)
        lane = int(torch.argmax(pool.alive.to(torch.int32)))
        pos = pool.attrs["position"].clone()
        pos[lane] += 1.0
        pool.attrs = dict(pool.attrs, position=pos)
        return pool, events

    _after_warmup(monkeypatch, "debris", altered)
    out = _run(True, 0.0)
    assert not out["correct"], out["readings"]


def test_scene_wide_m_read_per_member(monkeypatch):
    """Each member its own 64 entries a tile, in place of 64 for the whole
    scene: the window keeps each member's nearest 64 of the tile's run."""
    from bevy_hanabi_tpu_torch.render import raster

    caps = TinyMixed().cell().config["members"]
    bounds = torch.tensor(np.cumsum([m["capacity"] for m in caps])[:-1])

    def per_member(rows, pidx_sorted, starts, ends, M, from_start=False):
        nt, width = starts.shape[0], rows.shape[1]
        member = torch.searchsorted(bounds, pidx_sorted.to(torch.int64) % rows.shape[0],
                                    right=True)
        window = rows.new_zeros((nt, M * (len(bounds) + 1), width))
        has = torch.zeros(window.shape[:2], dtype=torch.bool)
        for t in range(nt):
            run_ = torch.arange(int(starts[t]), int(ends[t]))
            keep = torch.cat([run_[member[run_] == k][-M:] for k in range(len(bounds) + 1)])
            keep = torch.sort(keep).values
            window[t, : len(keep)] = rows[pidx_sorted[keep].to(torch.int64) % rows.shape[0]]
            has[t, : len(keep)] = True
        return window, has

    monkeypatch.setattr(raster, "gather_window", per_member)
    out = _run(True, 0.0)
    assert not out["correct"], out["readings"]
    assert out["readings"]["image_err"] > 0.01


# ---------------------------------------------------------------------------
# ties: pairs of lanes at one position


def _make_ties(scene, camera_eye, pairs=8, steps=FRAMES, dt=1 / 60):
    """Put ``pairs`` gradient lanes at the positions of the debris lanes
    nearest the camera (on screen, at least 1 unit away) and ``pairs`` more
    one float behind the next nearest, every paired lane at rest and alive
    for ``steps`` frames, the gradient's lanes young (opaque red to yellow);
    one more gradient lane at rest 150 units behind the launch point, so
    that the sort key's depth step is some 80 floats wide at the pairs."""
    eye = torch.tensor(camera_eye)
    deb, grad = scene["debris"].pool, scene["grad"].pool
    dp, da = deb.attrs["position"], deb.alive & (deb.attrs["age"] + steps * dt
                                                 < deb.attrs["lifetime"])
    depth = eye[2] - dp[:, 2]
    rel = (dp - eye).abs()
    on_screen = (rel[:, 0] < 0.5 * depth) & (rel[:, 1] < 0.5 * depth) & (depth > 1.0) & da
    lanes = torch.nonzero(on_screen)[:, 0]
    lanes = lanes[torch.argsort(depth[lanes])][: 2 * pairs]
    ga = grad.alive & (grad.attrs["age"] < 0.3 * grad.attrs["lifetime"])
    glanes = torch.nonzero(ga)[:, 0][: 2 * pairs + 1]
    assert len(lanes) == 2 * pairs and len(glanes) == 2 * pairs + 1
    gp, gv, dv = grad.attrs["position"], grad.attrs["velocity"], deb.attrs["velocity"]
    for i, (d, g) in enumerate(zip(lanes.tolist(), glanes.tolist())):
        gp[g] = dp[d]
        if i >= pairs:  # one float farther from the camera, on +Z
            gp[g, 2] = torch.nextafter(dp[d, 2], torch.tensor(-np.inf))
        gv[g] = 0.0
        dv[d] = 0.0
    far = glanes[-1]
    gp[far] = torch.tensor([0.0, 3.0, -150.0])
    gv[far] = 0.0


def _tie_readings(monkeypatch=None, fault=None):
    """A tiny cell's warm-up, then one call from a state holding the
    pairs, compared with the reference from the same state; ``fault`` is
    applied to the program for that call only."""
    cell = TinyMixed().cell()
    prog = program.build(cell.config, cell.traffic, SEED, "cpu")
    warm = inputs.warm_frames(cell.config, cell.traffic)
    for f in range(0, warm, FRAMES):
        prog.call(prog.inputs(f, FRAMES))
    start = clone_state(prog.state())
    _make_ties(prog.scene, cell.config["camera"]["eye"])
    tied = clone_state(prog.state())
    if fault is not None:
        fault(monkeypatch)
    sums, img = prog.call(prog.inputs(warm, FRAMES))
    span = verify.Span(warm, FRAMES, tied, sums.double(), img, prog.state(), None)
    record = verify.Record(warm, start, [span])
    return verify.compare(record, cell, SEED, "cpu"), cell.limits


def test_tied_pairs_are_exact():
    readings, limits = _tie_readings()
    assert verify.judge(readings, limits), readings
    assert all(v == 0.0 for v in readings.values()), readings


def _reversed_ties(monkeypatch):
    """The painter's members concatenated front to back: a tie of the
    sort key breaks the other way."""
    from bevy_hanabi_tpu_torch.runtime.scene import HanabiScene

    original = HanabiScene._render_painter

    def reverse(self, insts, pools, inputs_, *args, **kwargs):
        return original(self, insts[::-1], pools[::-1], inputs_[::-1], *args, **kwargs)

    monkeypatch.setattr(HanabiScene, "_render_painter", reverse)


def _opaque_as_blend(monkeypatch):
    from bevy_hanabi_tpu_torch.render import extract

    original = extract.concat_painter_draws

    def as_blend(draws, kinds, *args, **kwargs):
        return original(draws, ["blend" if k == "opaque" else k for k in kinds], *args, **kwargs)

    monkeypatch.setattr(extract, "concat_painter_draws", as_blend)


@pytest.mark.parametrize("fault", [_reversed_ties, _opaque_as_blend],
                         ids=["ties_broken_the_other_way", "opaque_drawn_as_blend"])
def test_tie_faults(monkeypatch, fault):
    readings, limits = _tie_readings(monkeypatch, fault)
    assert not verify.judge(readings, limits), readings
    assert readings["image_err"] > limits["image_err"], readings
