"""The program-span attribution (``spans.py``) on a small recorded trace
(two frames: a chunk's step, extract, raster and sort spans, their
launches, syncs and device operations, one operation with no launch in the
window), against a reference that walks the window microsecond by
microsecond; and on a whole traced run of each cell at a tiny size on the
CPU."""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

import pytest

from hanabi_bench import spans, trace
from hanabi_bench.tests._tiny import TinyBench

REC = json.loads((Path(__file__).parent / "data" / "summary_spans.json").read_text())
ATT = spans.attribute(REC)
US = 1000
MS = 1_000_000


def _brute(rec):
    """Host self and idle ns by innermost span, and the idle ns inside the
    benchmark's calls under no span, one microsecond at a time."""
    w0, w1 = rec["window"]
    host, idle, call_none = defaultdict(int), defaultdict(int), 0
    for t in range(w0, w1, US):
        open_ = [s for s in rec["spans"] if s[1] <= t < s[2]]
        name = max(open_, key=lambda s: s[1])[0] if open_ else "none"
        host[name] += US
        if not any(a <= t < b for _, a, b, _ in rec["device"]):
            idle[name] += US
            if name == "none" and any(a <= t < b for _, a, b in rec["calls"]):
                call_none += US
    return host, idle, call_none


def test_sums_are_the_window_totals():
    by = ATT["by_span"]
    for field in spans.FIELDS:
        assert sum(row[field] for row in by.values()) == ATT["totals"][field], field
    w0, w1 = REC["window"]
    busy = trace.busy_ns([(a, b) for _, a, b, _ in REC["device"]])
    assert ATT["totals"]["idle"] == w1 - w0 - busy
    assert ATT["totals"]["self_host"] == w1 - w0


def test_host_and_idle_against_the_walk():
    host, idle, call_none = _brute(REC)
    by = ATT["by_span"]
    assert {k: v["self_host"] for k, v in by.items()} == dict(host)
    assert {k: v["idle"] for k, v in by.items() if v["idle"]} == dict(idle)
    # a frame: [0.05, 0.1) ms and [4.9, 4.92), before the unlaunched tile_blend
    assert ATT["call_idle_none_ns"] == call_none == 2 * 70 * US
    assert ATT["call_idle_ns"] > call_none


def test_device_syncs_and_launches_by_launching_span():
    by = ATT["by_span"]
    # each frame: step 0.55 ms, extract 0.6, raster project_bin 0.2 and two
    # copies 0.07, sort 0.5; the tile_blend with no launch in the window 0.07
    want = {"hanabi:step": 0.55, "hanabi:extract": 0.6, "hanabi:raster": 0.27,
            "hanabi:sort": 0.5, "none": 0.07}
    for name, ms in want.items():
        assert by[name]["device"] == pytest.approx(2 * ms * MS), name
    assert by["hanabi:chunk"]["device"] == 0
    assert ATT["unlinked"] == 2
    assert {k: v["syncs"] for k, v in by.items() if v["syncs"]} == {
        "hanabi:step": 2, "hanabi:raster": 2, "none": 2}
    assert {k: v["launches"] for k, v in by.items() if v["launches"]} == {
        "hanabi:step": 2, "hanabi:extract": 2, "hanabi:raster": 2, "hanabi:sort": 2}
    per = spans.per_frame(ATT)
    assert per["hanabi:step"]["syncs"] == 1.0
    assert per["hanabi:sort"]["device"] == pytest.approx(0.5)


def test_segments_nest_and_cover_the_window():
    got = spans.segments([["a", 0, 10], ["b", 2, 4], ["c", 4, 6], ["d", 12, 20]], -5, 15)
    assert got == [(-5, 0, "none"), (0, 2, "a"), (2, 4, "b"), (4, 6, "c"), (6, 10, "a"),
                   (10, 12, "none"), (12, 15, "d")]


@pytest.mark.parametrize("name,want", [
    ("gradient_4m.chunk120", {"hanabi:chunk", "hanabi:step", "hanabi:extract",
                              "hanabi:raster", "hanabi:sort"}),
    ("instancing_1024x4096.sim120", {"hanabi:chunk", "hanabi:step"}),
    ("gradient_4m.scene_frame", {"hanabi:update", "hanabi:render", "hanabi:cull",
                                 "hanabi:plan", "hanabi:spawn", "hanabi:step",
                                 "hanabi:extract", "hanabi:raster", "hanabi:sort"}),
])
def test_traced_run_on_the_cpu(name, want):
    bench = TinyBench()
    out, rec = spans.traced_run(bench, name, 4242, "cpu")
    assert out["correct"], out["readings"]
    frames = bench.cell(name).traffic["trace_frames"]
    assert rec["frames"] == frames and not rec["device"]
    att = spans.attribute(rec)
    assert set(att["by_span"]) == want | {"none"}
    assert att["totals"]["idle"] == att["totals"]["self_host"]  # no device operation here
    steps = sum(1 for s in rec["spans"] if s[0] == "hanabi:step")
    assert steps == frames
