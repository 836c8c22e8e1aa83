"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds."""

from __future__ import annotations

import dataclasses
import json

from hanabi_bench import spec


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
