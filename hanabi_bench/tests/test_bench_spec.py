"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, limit, metric reader and reference is found by its name, and
the file keeps to the benchmark contract's shapes."""

from __future__ import annotations

import json
import re

import pytest

from hanabi_bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load()
CELLS = sorted(BENCH.workloads)


def test_top_level_keys():
    assert set(BENCH.data) == {"command", "paths", "run_seconds", "configs", "workloads",
                               "end_to_end", "per_layer"}
    assert BENCH.data["paths"] == ["hanabi_bench"]
    assert 1 <= BENCH.data["run_seconds"] <= 51
    assert len(json.dumps(BENCH.data)) <= 64 * 1024
    assert BENCH.data["command"][:3] == ["python3", "-m", "hanabi_bench.run"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = BENCH.cell(name)
    assert cell.chips == 1
    assert cell.config["name"] == cell.config_name
    assert cell.traffic["loop"] in ("chunk", "scene")
    assert cell.limits, "every cell compares something"
    assert {"setup_s"} < {m.name for m in cell.end_to_end}
    assert cell.per_layer
    reported = {m.name for m in cell.end_to_end}
    for m in cell.per_layer:
        assert m.moves in reported, f"{m.name} moves {m.moves}, which {name} does not report"


@pytest.mark.parametrize("name", sorted(BENCH.configs))
def test_config_and_reference(name):
    entry = BENCH.configs[name]
    assert entry["file"].startswith("hanabi_bench/configs/")
    cfg = json.loads((spec.ROOT / entry["file"]).read_text())
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    ref = spec.load_module("reference", name)
    assert callable(ref.effect) and callable(ref.spawner)


@pytest.mark.parametrize("metric", [m.name for m in BENCH.per_layer])
def test_metric_reader(metric):
    assert callable(spec.load_module("metrics", metric).read)


def test_names_units_and_limits():
    names = [c["name"] for c in BENCH.data["configs"]] + CELLS + [
        m.name for m in BENCH.end_to_end + BENCH.per_layer]
    for n in names:
        assert NAME.match(n), n
    metric_names = [m.name for m in BENCH.end_to_end + BENCH.per_layer]
    assert len(set(metric_names)) == len(metric_names)
    for m in BENCH.end_to_end + BENCH.per_layer:
        assert UNIT.match(m.unit) and m.better in ("lower", "higher")
    for m in BENCH.end_to_end:
        assert m.source in ("host_clock", "device_trace")
        assert 0.01 <= m.bound <= 0.25
    for w in BENCH.data["workloads"] + BENCH.data["configs"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    layers = {m.layer for m in BENCH.per_layer}
    assert all(1 <= len(layer) <= 200 for layer in layers)
