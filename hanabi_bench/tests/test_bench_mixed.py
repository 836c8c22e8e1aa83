"""The cell ``mixed_917k.scene_auto``, loaded through ``spec.load()`` from
``BENCHMARK.json``, and run at a tiny size on the CPU (``_mixed.py``): a run agrees with the
configuration's painter reference (``reference/mixed_917k.py``) exactly,
a traced run reads the cell's four per-layer metrics and the scene's
counters, and the metric readers find nothing to read in a summary
without the program's events and painter spans and counters, as a
program before them gives."""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import pytest
import torch

from hanabi_bench import loops, run, spec, trace
from hanabi_bench.reference import mixed_917k
from hanabi_bench.tests._mixed import CELL, TinyMixed

SEED = 2**32 + 987654321
NEW = ("step_host_ms_per_frame.scene_auto", "events_host_ms_per_frame.scene_auto",
       "painter_host_ms_per_frame.scene_auto", "painter_rows_per_frame.scene_auto")


def test_cell_is_in_the_benchmark():
    """The cell resolves from ``BENCHMARK.json`` as the benchmark's other
    cells do: its configuration, traffic and limits by name, its reference's
    members, and the metrics listed on it."""
    cell = spec.load().cell(CELL)
    assert cell.chips == 1 and cell.config_name == "mixed_917k"
    assert [m["effect"] for m in cell.config["members"]] == [
        "debris_effect", "gradient_effect", "firework_effect", "firework_trail_effect"]
    assert sum(m["capacity"] for m in cell.config["members"]) == 917_504
    assert [m.name for m in mixed_917k.members(cell.config)] == [
        m["name"] for m in cell.config["members"]]
    assert cell.traffic["frames_per_call"] == 100 and cell.traffic["frame_seeds"] == "scene"
    assert {m.name for m in cell.end_to_end} == {"frames_per_s", "device_mem_gib", "setup_s"}
    assert {m.name for m in cell.per_layer} == set(NEW)
    for m in cell.per_layer:
        assert callable(spec.load_module("metrics", m.name).read)
        assert m.moves == "frames_per_s" and m.workloads == (CELL,)


@pytest.mark.parametrize("render", [True, False])
def test_tiny_run_is_exact(render):
    out = run.run(TinyMixed(render), CELL, SEED, 0.3, False, "cpu")
    assert out["error"] is None and out["frames"] > 0
    assert out["correct"], out["readings"]
    assert all(v == 0.0 for v in out["readings"].values()), out["readings"]
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}  # no device memory on the CPU


def test_traced_run_reads_the_cells_metrics():
    bench = TinyMixed()
    out = run.run(bench, CELL, SEED, 0.0, True, "cpu")
    assert out["correct"], out["readings"]
    assert set(NEW) <= set(out["metrics"])
    assert all(out["metrics"][m]["value"] > 0 for m in NEW)
    assert out["metrics"]["painter_rows_per_frame.scene_auto"]["value"] == 7680.0
    window = loops.run_window(bench.cell(), SEED, 0.0, True, "cpu", time.perf_counter())
    counters = window.summary.counters
    assert counters["event_totals.rocket.emitted.0"] > 0
    assert counters["event_totals.trail.spawned"] > 0
    assert counters["painter.frames"] > 0
    for member in ("debris", "grad", "rocket", "trail"):
        assert counters[f"fused_step_share.{member}"] == 0.0  # the generated step runs on a card


def test_readers_find_nothing_without_the_programs_spans():
    """A summary recorded before the program kept spans and counters reads
    nothing, and neither does one of a program with steps but no events and
    painter spans and counters (as before them): without ``hanabi:events``
    the step's self time holds the events' time too."""
    summary = trace.Summary.load(Path(__file__).parent / "data" / "summary.json")
    cell = spec.load().cell(CELL)

    def read(s):
        return {m: spec.load_module("metrics", m).read(s, cell) for m in NEW}

    assert all(v is None for v in read(summary).values())
    steps = dataclasses.replace(summary, program_spans={"hanabi:step": {"self_host": 4_000_000}},
                                counters={"fused_frames": 2.0})
    assert all(v is None for v in read(steps).values())
    events = dataclasses.replace(steps, program_spans={**steps.program_spans,
                                                       "hanabi:events": {"self_host": 1_000_000}})
    got = read(events)
    assert got.pop("step_host_ms_per_frame.scene_auto") == pytest.approx(4.0 / summary.frames)
    assert got.pop("events_host_ms_per_frame.scene_auto") == pytest.approx(1.0 / summary.frames)
    assert all(v is None for v in got.values())


def test_painter_reference_bins_centre_tiles_only():
    cell = TinyMixed().cell()
    cfg = dict(cell.config, raster=dict(cell.config["raster"], tile_slots=0))
    ref = mixed_917k.make(cfg, cell.traffic, SEED, "cpu", torch.float32)
    ref.advance(2)
    with pytest.raises(ValueError, match="tile_slots 1"):
        ref.draw()
