"""The port's event and painter spans and counters on the tiny mixed-blend
scene (``torch_mixed_tiny.py``): ``hanabi:events`` opens inside each
emitting or consuming member's ``hanabi:step`` and ``hanabi:painter`` once
a painter frame, neither on a single effect's chunk; ``HanabiScene.stats()``
counts the events emitted, the trails spawned and dropped and the painter's
frames and rows as the plain reference produces them; counting reads
nothing back inside a frame (on the CPU: no tensor is read on the host; on
the card, ``-m cuda``: no synchronizing call); and no member of the cell is
culled at its camera."""

import math
import warnings
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bevy_hanabi_tpu_torch import CompiledEffect, EffectSpawner, HanabiScene, SimParams, StepInputs
from bevy_hanabi_tpu_torch.models import gradient_effect
from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective
from bevy_hanabi_tpu_torch.render.raster import RasterConfig
from bevy_hanabi_tpu_torch.runtime.events import EventBuffer, EventTally
from hanabi_bench import inputs, program, verify
from hanabi_bench.reference import _events
from torch_mixed_tiny import CAPACITIES, FRAMES, SEED, TinyMixed, one_thread

DT = 1.0 / 60.0


@pytest.fixture(autouse=True, scope="module")
def single_thread():
    threads = one_thread()
    yield
    torch.set_num_threads(threads)


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


def _warm_program(device="cpu", render=True):
    cell = TinyMixed(render).cell()
    prog = program.build(cell.config, cell.traffic, SEED, device)
    warm = inputs.warm_frames(cell.config, cell.traffic)
    for f in range(0, warm, FRAMES):
        prog.call(prog.inputs(f, FRAMES))
    return cell, prog


@pytest.mark.parametrize("render", [True, False], ids=["update_render_chunk", "update_chunk"])
def test_events_and_painter_spans_on_mixed_frames(render):
    _, prog = _warm_program(render=render)
    frames = 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prog.call(frames)
    got = _spans(prof)
    # the rockets' emission and the trails' consumption, inside their steps
    assert got[("hanabi:events", "hanabi:step")] == 2 * frames
    assert not any(name == "hanabi:events" and parent != "hanabi:step" for name, parent in got)
    assert sum(v for (name, _), v in got.items() if name == "hanabi:step") == 4 * frames
    painter = {k: v for k, v in got.items() if k[0] == "hanabi:painter"}
    assert painter == ({("hanabi:painter", None): frames} if render else {})


def test_no_events_or_painter_span_on_a_single_effect():
    cam = CameraParams(look_at((0, 0, 26), (0, 0, 0)), perspective(math.radians(60), 1, 0.1, 200),
                       (64, 64))
    fx = CompiledEffect(gradient_effect(2048), device="cpu")
    sp = EffectSpawner(fx.asset.spawner, rng=np.random.default_rng(0))
    stacked = fx.stack_frames([StepInputs.make(sp.tick(DT), j) for j in range(2)],
                              [SimParams(time=j * DT, delta_time=DT) for j in range(2)])
    scene = HanabiScene(seed=1, device="cpu")
    scene.add(gradient_effect(2048), "grad")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fx.step_render_chunk(fx.create_pool(), *stacked, cam, RasterConfig(64, 64))
        scene.update_render_chunk(2, DT, cam, RasterConfig(64, 64, tile_slots=1))
        scene.update_chunk(2, DT)
    names = {name for name, _ in _spans(prof)}
    assert "hanabi:step" in names and "hanabi:raster" in names
    assert not names & {"hanabi:events", "hanabi:painter"}
    stats = scene.stats()
    assert stats["event_totals"] == {} and stats["painter"] == {"frames": 0, "rows": 0}


def test_counters_match_the_reference(monkeypatch):
    """The scene's counters over a warm-up and a rendered call, against
    what the plain reference emits, consumes and draws over the same
    frames from the same seed."""
    cell, prog = _warm_program()
    prog.call(FRAMES)
    frames = inputs.warm_frames(cell.config, cell.traffic) + FRAMES
    stats = prog.scene.stats()

    consumed = {"requested": 0, "spawned": 0}
    original = _events.consume

    def spy(events, free_rank, num_free):
        total, event = original(events, free_rank, num_free)
        consumed["requested"] += int(events["count"].sum())
        consumed["spawned"] += int(total)
        return total, event

    monkeypatch.setattr(_events, "consume", spy)
    ref = verify.reference(cell, SEED, "cpu")
    emitted = 0
    for _ in range(frames):
        ref.advance(1)
        emitted += int(ref.events["rocket"][0]["num"])
    assert emitted > 0 and consumed["spawned"] > 0
    assert stats["event_totals"] == {
        "rocket": {"emitted": {0: emitted}},
        "trail": {"emitted": {}, "requested": consumed["requested"],
                  "spawned": consumed["spawned"],
                  "dropped": consumed["requested"] - consumed["spawned"]},
    }
    assert stats["painter"] == {"frames": frames, "rows": frames * sum(CAPACITIES.values())}


def test_dropped_spawns_counted_at_a_full_pool():
    """A trail pool too small for one burst's events: the requests past
    its free lanes count as dropped."""
    from bevy_hanabi_tpu_torch.models import firework_effect, firework_trail_effect

    scene = HanabiScene(seed=4, device="cpu")
    scene.add(firework_effect(512), "rocket")
    scene.add(firework_trail_effect(64), "trail", parent="rocket")
    scene.update_chunk(90, 1 / 60)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        totals = scene.stats()["event_totals"]
    trail = totals["trail"]
    assert trail["dropped"] > 0 and trail["spawned"] > 0
    assert trail["requested"] == 4 * totals["rocket"]["emitted"][0]
    assert trail["requested"] == trail["spawned"] + trail["dropped"]


def _host_reads(run) -> Counter:
    """The tensors ``run()`` reads on the host, by method."""
    names = ("item", "tolist", "__int__", "__float__", "__bool__", "__index__", "numpy", "cpu")
    reads = Counter()
    originals = {n: getattr(torch.Tensor, n) for n in names}

    def counting(name):
        def read(self, *args, **kwargs):
            reads[name] += 1
            return originals[name](self, *args, **kwargs)

        return read

    try:
        for n in names:
            setattr(torch.Tensor, n, counting(n))
        run()
    finally:
        for n, f in originals.items():
            setattr(torch.Tensor, n, f)
    return reads


def _without_counters(prog):
    """The program's scene with no event counting from now on."""
    for n in prog.names:
        prog.scene[n].tally = None


def test_tally_adds_each_frame_to_one_vector():
    """A member's frames, a consumption alone, emissions alone, then both,
    add up by channel; the vector grows as channels appear."""

    def emitted(n):
        return EventBuffer(torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int64),
                           torch.tensor(n, dtype=torch.int32))

    tally = EventTally()
    assert tally.read() == {"emitted": {}}
    tally.add(None, {})
    assert tally.totals is None
    tally.add((torch.tensor(5), torch.tensor(3)), {})
    tally.add(None, {0: emitted(2), 1: emitted(4)})
    tally.add((torch.tensor(1), torch.tensor(1)), {0: emitted(1), 1: emitted(0)})
    assert tally.totals.dtype == torch.int64 and tally.totals.shape == (4,)
    assert tally.read() == {"emitted": {0: 3, 1: 4}, "requested": 6, "spawned": 4, "dropped": 2}


def test_counting_reads_nothing_inside_a_frame():
    """A call with the counters reads on the host just what the same call
    without them reads."""
    _, prog = _warm_program()
    with_counters = _host_reads(lambda: prog.call(2))
    _without_counters(prog)
    without = _host_reads(lambda: prog.call(2))
    assert with_counters == without


def test_no_member_culled_at_the_cells_camera():
    """The cell's camera (26 units out) sees every member over a burst's
    cycle of frames: the reference models no culling."""
    cell = TinyMixed().cell()
    cell.config["camera"].update(eye=[0.0, 0.0, 26.0], target=[0.0, 0.0, 0.0])
    prog = program.build(cell.config, cell.traffic, SEED, "cpu")
    for f in range(0, 150, FRAMES):
        assert prog.scene._culled_names([prog.camera], for_render=True) == set(), f
        prog.call(FRAMES)


@pytest.mark.cuda
def test_counting_adds_no_sync_on_the_card():
    """On the card, under ``torch.cuda.set_sync_debug_mode("warn")``: a
    call with the counters makes the synchronizing calls the same call
    without them makes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the census counts the card's syncs")
    _, prog = _warm_program(torch.device("cuda"))

    def syncs():
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                prog.call(2)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return sum("synchronizing CUDA operation" in str(w.message) for w in caught)

    with_counters = syncs()
    _without_counters(prog)
    assert syncs() == with_counters
