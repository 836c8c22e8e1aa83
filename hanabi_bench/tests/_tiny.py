"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds, and
cells of the test tree ``data/tree/firework_tree.json`` (a configuration of
two event-linked effects that is not in ``BENCHMARK.json``)."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from hanabi_bench import spec

TREE = Path(__file__).resolve().parent / "data" / "tree"
# the test tree's mixes: the benchmark's, its frames seeded by the scene
TREE_MIXES = {"chunk": "chunk120", "sim": "sim120", "scene": "scene_frame"}


def tiny(cell: spec.Cell, lanes: int = 512, instances: int = 16, frames: int = 6,
         width: int = 64) -> spec.Cell:
    """``cell`` with ``lanes`` lanes an instance (an instanced cell keeps
    ``instances`` emitters on a square grid), a ``width``-pixel square
    raster and ``frames`` frames a call and a span."""
    cfg = json.loads(json.dumps(cell.config))
    cfg["lanes_per_instance"] = lanes
    if cfg["instances"] > 1:
        side = int(instances ** 0.5)
        cfg["instances"] = side * side
        cfg["emitters"].update(nx=side, ny=side)
    cfg["raster"].update(width=width, height=width)
    tr = dict(cell.traffic)
    if "frames_per_call" in tr:
        tr["frames_per_call"] = frames
    if "span_frames" in tr:
        tr["span_frames"] = frames
    tr["trace_frames"] = 2 * frames
    return dataclasses.replace(cell, config=cfg, traffic=tr)


class TinyBench:
    """A :class:`spec.Bench` whose cells are :func:`tiny`."""

    def __init__(self, **kw) -> None:
        self.bench = spec.load()
        self.kw = kw
        self.end_to_end, self.per_layer = self.bench.end_to_end, self.bench.per_layer

    def cell(self, name: str) -> spec.Cell:
        return tiny(self.bench.cell(name), **self.kw)


class TreeBench:
    """A :class:`spec.Bench` of the test tree's cells ``firework_tree.<mix>``
    (a mix of :data:`TREE_MIXES`), ``frames`` frames a call and a span, its
    members' capacities times ``scale``, its raster ``width`` pixels square."""

    def __init__(self, frames: int = 6, scale: int = 1, width: int = 64) -> None:
        bench = spec.load()
        self.end_to_end, self.per_layer = bench.end_to_end, bench.per_layer
        self.frames, self.scale, self.width = frames, scale, width

    def config(self) -> dict:
        cfg = json.loads((TREE / "firework_tree.json").read_text())
        for m in cfg["members"]:
            m["capacity"] *= self.scale
        cfg["raster"].update(width=self.width, height=self.width)
        return cfg

    def cell(self, name: str) -> spec.Cell:
        config_name, mix = name.split(".", 1)
        traffic = json.loads((spec.HERE / "traffic" / f"{TREE_MIXES[mix]}.json").read_text())
        traffic["frame_seeds"] = "scene"
        for key in ("frames_per_call", "span_frames"):
            if key in traffic:
                traffic[key] = self.frames
        traffic["trace_frames"] = 2 * self.frames
        e2e = ("frame_ms_p95" if traffic["loop"] == "scene" else "frames_per_s", "device_mem_gib",
               "setup_s")
        limits = json.loads((TREE / "limits.json").read_text())
        if not traffic["render"]:
            limits = {k: v for k, v in limits.items() if k not in ("checksum_err", "image_err")}
        return spec.Cell(name, config_name, mix, 1, self.config(), traffic, limits,
                         tuple(m for m in self.end_to_end if m.name in e2e), (), TREE)
