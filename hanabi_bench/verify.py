"""The comparison that decides ``correct``.

A run hands over a :class:`Record` of what the timed path produced: the
pools at the window's start, and for each checked span of frames the
per-frame checksums, the span's last image and the pools or the alive
count at its end. The first span follows the window's start; the last one
ends with the window and starts from the program's pools at its start.
The configuration's plain reference works everything out again from the
seed (its own spawn counts, the benchmark's frame seeds or the scene's),
steps from empty pools through the warm-up and the first span, and from
the last span's starting pools through it, rendering a sample of each
span's frames drawn from the seed, and the span's last frame.

Each number compared is the worst over everything compared:

- ``alive_mismatch``: lanes whose alive flag differs, or the difference of
  the alive counts (exact: its limit is 0);
- ``seed_mismatch``: lanes alive on both sides whose PCG state differs (exact);
- ``state_err``: the largest gap of position, velocity, age or lifetime on
  a lane alive on both sides, over that attribute's largest magnitude;
- ``checksum_err``: the largest gap of a frame's image sum, over the sum;
- ``image_err``: the largest gap of a pixel channel of a span's last image.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from hanabi_bench import inputs as bench_inputs
from hanabi_bench import spec
from hanabi_bench.reference import _plain

__all__ = ["Span", "Record", "compare", "judge", "Reference"]

FLOATS = ("position", "velocity", "age", "lifetime")


@dataclass
class Span:
    first: int  # the global index of the span's first frame
    frames: int
    start: Optional[Dict[str, torch.Tensor]] = None  # None: the reference's own pools
    checksums: Optional[torch.Tensor] = None  # [frames] image sums
    image: Optional[torch.Tensor] = None  # the span's last image
    end: Optional[Dict[str, torch.Tensor]] = None  # the pools after the span
    alive: Optional[int] = None  # the alive count after the span


@dataclass
class Record:
    warm_frames: int
    start: Dict[str, torch.Tensor]  # the pools at the window's start
    spans: List[Span] = field(default_factory=list)


def _state_readings(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> dict:
    dev = ref["alive"].device
    p = {k: v.to(dev) for k, v in prog.items()}
    both = p["alive"] & ref["alive"]
    out = {
        "alive_mismatch": float((p["alive"] != ref["alive"]).sum()),
        "seed_mismatch": float((both & (p["seed"] != ref["seed"])).sum()),
        "state_err": 0.0,
    }
    for k in FLOATS:
        r = ref[k].float()
        m = both if r.dim() == 1 else both[:, None]
        scale = float(torch.where(m, r.abs(), 0.0).max()) if bool(both.any()) else 0.0
        gap = float(torch.where(m, (p[k].float() - r).abs(), 0.0).nan_to_num(np.inf).max())
        out["state_err"] = max(out["state_err"], gap / max(scale, 1e-30))
    return out


def _worst(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = max(out.get(k, 0.0), v)
    return out


class Reference:
    """A configuration's plain reference, run frame by frame on ``device``
    in the float type ``ft``."""

    def __init__(self, cell: spec.Cell, seed: int, device, ft=torch.float32) -> None:
        self.seed, self.device, self.ft = seed, torch.device(device), ft
        config, traffic = cell.config, cell.traffic
        mod = spec.load_module("reference", cell.config_name)
        self.effect = mod.effect(config)
        self.spawner = mod.spawner(config)
        self.instances = config["instances"]
        self.lanes = config["instances"] * config["lanes_per_instance"]
        r = config["raster"]
        self.raster = r
        self.camera = _plain.camera(config["camera"], r["width"], r["height"])
        self.transforms = bench_inputs.transforms(config)
        self.dt64 = bench_inputs.frame_dt(traffic)
        self.dt = float(np.float32(self.dt64))
        self.render = bool(traffic["render"])
        self.scene_seeds = (np.random.default_rng(bench_inputs.seed_root(seed) + 1)
                            if traffic["frame_seeds"] == "scene" else None)
        self.frame = 0
        self.pool = _plain.empty_pool(self.lanes, self.device, ft)

    def _seeds(self) -> np.ndarray:
        if self.scene_seeds is not None:
            return np.asarray([self.scene_seeds.integers(0, 2**32)], np.uint32)
        return bench_inputs.frame_seeds(self.seed, self.frame, 1, self.instances)[0]

    def advance(self, frames: int, step: bool = True, render_at=()) -> Dict[int, torch.Tensor]:
        """Tick ``frames`` frames (stepping the pools with ``step``); returns
        the images of the frames (by index in the stretch) in ``render_at``."""
        images = {}
        for j in range(frames):
            counts = self.spawner.tick(self.dt64)
            seeds = self._seeds()
            if step:
                self.pool = _plain.step(self.pool, self.effect, counts, seeds, self.transforms,
                                        self.instances, self.dt, self.ft)
                if j in render_at:
                    images[j] = _plain.render(self.pool, self.effect, self.camera, self.raster,
                                              self.ft).float()
            self.frame += 1
        return images

    def load(self, state: Dict[str, torch.Tensor]) -> None:
        self.pool = {k: v.to(self.device).to(self.ft) if v.is_floating_point()
                     else v.to(self.device) for k, v in state.items()}


def compare(record: Record, cell: spec.Cell, seed: int, device, ft=torch.float32) -> dict:
    """Every number of the module's list that the record lets the
    reference compare, the worst reading of each."""
    ref = Reference(cell, seed, device, ft)
    ref.advance(record.warm_frames)
    readings = _state_readings(record.start, ref.pool)
    sample = max(0, int(cell.traffic.get("checked_frames_per_span", 8)))
    rng = np.random.default_rng([bench_inputs.seed_root(seed), 0xC4EC])
    for span in record.spans:
        if span.start is not None:
            ref.advance(span.first - ref.frame, step=False)
            ref.load(span.start)
        elif span.first != ref.frame:
            raise ValueError(f"a span from the reference's own pools starts at frame "
                             f"{ref.frame}, not {span.first}")
        render_at = set()
        if ref.render and span.checksums is not None:
            picks = rng.choice(span.frames, size=min(sample, span.frames), replace=False)
            render_at = {int(j) for j in picks} | {span.frames - 1}
        images = ref.advance(span.frames, render_at=render_at)
        for j, img in images.items():
            cs_ref = float(img.sum())
            cs = float(span.checksums[j])
            err = abs(cs - cs_ref) / max(abs(cs_ref), 1e-30) if np.isfinite(cs) else np.inf
            readings["checksum_err"] = max(readings.get("checksum_err", 0.0), err)
        if span.image is not None and span.frames - 1 in images:
            gap = (span.image.to(ref.device).float() - images[span.frames - 1]).abs()
            readings["image_err"] = max(readings.get("image_err", 0.0),
                                        float(gap.nan_to_num(np.inf).max()))
        if span.end is not None:
            readings = _worst(readings, _state_readings(span.end, ref.pool))
        if span.alive is not None:
            diff = abs(int(span.alive) - int(ref.pool["alive"].sum()))
            readings["alive_mismatch"] = max(readings["alive_mismatch"], float(diff))
    return readings


def judge(readings: dict, limits: dict) -> bool:
    """Correct where every number compared is within its limit, and every
    number that has a limit was compared."""
    return all(k in readings and readings[k] <= limits[k] for k in limits)
