"""A whole run of every cell at a tiny size on the CPU: the harness drives
the program, and the configuration's plain reference agrees with what the
timed path produced, number for number; a traced run reads its per-layer
metrics from the profiler. The bf16 control, in the program's place,
fails the same comparison."""

from __future__ import annotations

import pytest
import torch

from hanabi_bench import control, run, spec, verify
from hanabi_bench.tests._tiny import TinyBench

CELLS = sorted(spec.load().workloads)
SEED = 2**31 + 12345


@pytest.mark.parametrize("name", CELLS)
def test_run_is_correct(name):
    out = run.run(TinyBench(), name, SEED, 0.5, False, "cpu")
    assert out["error"] is None and out["frames"] > 0
    assert out["correct"], out["readings"]
    assert set(out["readings"]) >= set(out["limits"])
    assert all(v == 0.0 for v in out["readings"].values()), out["readings"]
    assert "setup_s" in out["metrics"]
    line = run.result_line(out)
    assert line.index('"checks"') > line.index('"device"')


@pytest.mark.parametrize("name", ["gradient_4m.scene_frame", "instancing_1024x4096.chunk120"])
def test_traced_run(name):
    out = run.run(TinyBench(), name, SEED, 0.5, True, "cpu")
    assert out["correct"] and out["frames"] == TinyBench().cell(name).traffic["trace_frames"]
    assert out["metrics"], "the traced run reads its per-layer metrics"
    assert out["device"]["window_s"] > 0 and "breakdown" in out


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    cell = TinyBench().cell(name)
    readings = verify.compare(control.control_record(cell, 7, "cpu"), cell, 7, "cpu")
    assert not verify.judge(readings, cell.limits), readings
    same = verify.compare(control.control_record(cell, 7, "cpu", ft=torch.float32), cell, 7, "cpu")
    assert verify.judge(same, cell.limits), same
