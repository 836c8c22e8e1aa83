"""The per-layer metric readers on a small recorded trace summary (two
frames of known device operations, host calls and spans), recorded before
the summary kept the program's spans and counters; and a summary recorded
anew, which holds them."""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch

from hanabi_bench import loops, spec, trace
from hanabi_bench.tests._tiny import TinyBench

BENCH = spec.load()
SUMMARY = trace.Summary.load(Path(__file__).parent / "data" / "summary.json")
WINDOW_MS = 2 * (2.01 + 1.0)  # two frames of 2.01 ms of device work and 1 ms idle


def read(metric, cell="gradient_4m.chunk120"):
    return spec.load_module("metrics", metric).read(SUMMARY, BENCH.cell(cell))


def test_window_and_busy():
    assert SUMMARY.window_s == pytest.approx(WINDOW_MS * 1e-3)
    assert SUMMARY.busy_s() == pytest.approx(2 * 2.01e-3)
    assert trace.busy_ns([(0, 10), (5, 12), (20, 30), (30, 31)]) == 23


@pytest.mark.parametrize("metric,value", [
    ("launches_per_frame", 186.0),
    ("syncs_per_frame", 21.0),
    ("syncs_per_frame.scene_frame", 21.0),
    ("aten_ms_per_frame", 1.2),
    ("raster_ms_per_frame", 0.3),
    ("sort_ms_per_frame", 0.5),
    ("device_idle_pct", 100.0 * 2.0 / (2 * 3.01)),
    ("device_idle_pct.scene_frame", 100.0 * 2.0 / (2 * 3.01)),
    ("host_ms_per_frame.scene_frame", 10.0),
])
def test_reader(metric, value):
    assert read(metric) == pytest.approx(value)


def test_project_bin_roofline():
    # the gradient cell's 4M lanes, one entry a lane: its bound over 0.1 ms a call
    n = 1 << 22
    bound_ms = (101 * n + 8) / 3.35e12 * 1e3
    assert read("project_bin_roofline_pct") == pytest.approx(100.0 * bound_ms / 0.1)
    # the instanced cell bins four entries a lane
    inst = read("project_bin_roofline_pct", "instancing_1024x4096.chunk120")
    assert inst == pytest.approx(100.0 * (125 * n + 8) / 3.35e12 * 1e3 / 0.1)


def test_nothing_to_read():
    empty = trace.Summary(2, (0, 10), [], {}, {}, [])
    for m in BENCH.per_layer:
        assert spec.load_module("metrics", m.name).read(empty, BENCH.cell(m.workloads[0])) is None


def test_breakdown_names():
    b = trace.breakdown(SUMMARY)
    names = [n for n, _ in b["device_ops"]]
    assert names[0].startswith("at::native::vectorized_elementwise_kernel")
    assert "project_bin_kernel<false>" in names
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_old_summary_reads_alike():
    """A summary without ``program_spans`` and ``counters`` loads with both
    empty, and every metric reads from it what it reads with them filled."""
    assert SUMMARY.program_spans == {} and SUMMARY.counters == {}
    filled = dataclasses.replace(
        SUMMARY, program_spans={"hanabi:step": dict.fromkeys(("self_host", "idle", "device",
                                                              "syncs", "launches"), 7)},
        counters={"fused_frames": 3.0})
    for m in BENCH.per_layer:
        for cell in m.workloads:
            reader = spec.load_module("metrics", m.name)
            assert reader.read(filled, BENCH.cell(cell)) == reader.read(SUMMARY, BENCH.cell(cell))


def test_recorded_summary_holds_program_spans_and_counters(monkeypatch, tmp_path):
    """A traced run's summary: the program's ``hanabi:step`` span with what
    is put down to it, and the program's counters, read once the profiler
    has stopped; both survive a round trip through JSON."""
    from hanabi_bench import program

    read_while_profiling = []
    counters = program.ChunkProgram.counters

    def counted(self):
        read_while_profiling.append(torch.autograd.profiler._is_profiler_enabled)
        return counters(self)

    monkeypatch.setattr(program.ChunkProgram, "counters", counted)
    cell = TinyBench().cell("instancing_1024x4096.sim120")
    window = loops.run_window(cell, 99, 0.0, True, "cpu", time.perf_counter())
    summary = window.summary
    assert read_while_profiling == [False]
    step = summary.program_spans["hanabi:step"]
    assert set(step) == {"self_host", "idle", "device", "syncs", "launches"}
    assert step["self_host"] > 0
    assert summary.counters["eager_frames"] >= window.frames > 0  # the CPU steps eagerly
    path = tmp_path / "summary.json"
    path.write_text(json.dumps(dataclasses.asdict(summary)))
    again = trace.Summary.load(path)
    assert again.program_spans == summary.program_spans and again.counters == summary.counters
