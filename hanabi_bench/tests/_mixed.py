"""The cell ``mixed_917k.scene_auto`` cut to a size the CPU runs in
seconds: debris 1024, grad 4096, rocket 512 and trail 2048 lanes, drawn at
64 x 64 from 4 units in front of the rockets' launch point (the test tree's
camera, ``data/tree/``: 26 units out, every quad falls between pixel
centres at 64 pixels), 6 frames a call, 0.7 s of warm-up so that the window
opens while the first burst's rockets die and their trails spawn. At this
size most tiles hold more than the scene's 64 entries. Its traffic
``render`` False drives ``update_chunk`` in place of
``update_render_chunk``."""

from __future__ import annotations

import dataclasses
import json

from hanabi_bench import spec

CELL = "mixed_917k.scene_auto"
CAPACITIES = {"debris": 1024, "grad": 4096, "rocket": 512, "trail": 2048}
FRAMES = 6


class TinyMixed:
    """A :class:`spec.Bench` whose ``mixed_917k.scene_auto`` is the tiny
    cell; ``render`` False drops the image limits."""

    def __init__(self, render: bool = True) -> None:
        self.bench = spec.load()
        self.end_to_end, self.per_layer = self.bench.end_to_end, self.bench.per_layer
        self.render = render

    def cell(self, name: str = CELL) -> spec.Cell:
        cell = self.bench.cell(name)
        cfg = json.loads(json.dumps(cell.config))
        for m in cfg["members"]:
            m["capacity"] = CAPACITIES[m["name"]]
        cfg["raster"].update(width=64, height=64)
        cfg["camera"].update(eye=[0.0, 3.0, 4.0], target=[0.0, 3.0, 0.0])
        cfg["lifetime_s"] = 0.7
        traffic = dict(cell.traffic, frames_per_call=FRAMES, trace_frames=2 * FRAMES,
                       render=self.render)
        limits = dict(cell.limits)
        if not self.render:
            limits = {k: v for k, v in limits.items() if k not in ("checksum_err", "image_err")}
        return dataclasses.replace(cell, config=cfg, traffic=traffic, limits=limits)
