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
span's frames drawn from the seed, and the span's last frame. A
configuration's reference is ``reference/<config>.py``: its ``make(config,
traffic, seed, device, ft)`` where it has one (an effect tree's), else
:class:`Reference` on its ``effect`` and ``spawner``.

The pools are by member (``{member: {name: tensor}}``); a tree's members
also hand on the event buffers of their last step (``events<c>.*``, as
``program.member_state`` names them). Each number compared is the worst
over everything compared, every member included:

- ``alive_mismatch``: lanes whose alive flag differs, or the difference of
  the alive counts summed over the members, and events that differ in
  number, emitting lane or count (exact: its limit is 0);
- ``seed_mismatch``: lanes alive on both sides whose PCG state differs (exact);
- ``state_err``: the largest gap of position, velocity, age or lifetime on
  a lane alive on both sides, over that attribute's largest magnitude, and
  of an event's payload, over the payload's largest magnitude;
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

__all__ = ["Span", "Record", "compare", "judge", "Reference", "reference", "alive_total"]

FLOATS = ("position", "velocity", "age", "lifetime")
State = Dict[str, Dict[str, torch.Tensor]]  # by member, then by the reference's names


@dataclass
class Span:
    first: int  # the global index of the span's first frame
    frames: int
    start: Optional[State] = None  # None: the reference's own pools
    checksums: Optional[torch.Tensor] = None  # [frames] image sums
    image: Optional[torch.Tensor] = None  # the span's last image
    end: Optional[State] = None  # the pools after the span
    alive: Optional[int] = None  # the alive count after the span, over every member


@dataclass
class Record:
    warm_frames: int
    start: State  # the pools at the window's start
    spans: List[Span] = field(default_factory=list)


def alive_total(state: State) -> int:
    return sum(int(s["alive"].sum()) for s in state.values())


def _state_readings(prog: State, ref: State) -> dict:
    """The readings of the module's docstring, worst over the members."""
    out = None
    for name, r in ref.items():
        if name not in prog:
            raise ValueError(f"the program's state has no member {name!r}: {sorted(prog)}")
        readings = _member_readings(prog[name], r)
        out = readings if out is None else _worst(out, readings)
    return out


def _event_readings(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], out: dict) -> None:
    """Each event buffer of a member: events that differ in number,
    emitting lane or count into ``alive_mismatch``, the payload's largest
    gap on the others into ``state_err``."""
    dev = ref["alive"].device
    for ch in sorted({k.split(".")[0] for k in ref if k.startswith("events")}):
        r_num = int(ref[f"{ch}.num"])
        if f"{ch}.num" not in prog:
            out["alive_mismatch"] += r_num
            continue
        p_num = int(prog[f"{ch}.num"])
        n = min(p_num, r_num)
        same = ((prog[f"{ch}.slot"][:n].to(dev) == ref[f"{ch}.slot"][:n])
                & (prog[f"{ch}.count"][:n].to(dev) == ref[f"{ch}.count"][:n]))
        out["alive_mismatch"] += abs(p_num - r_num) + float((~same).sum())
        for k in ref:
            if not k.startswith(ch + ".") or k.split(".", 1)[1] in ("slot", "count", "num"):
                continue
            r = ref[k][:n].float()
            m = same if r.dim() == 1 else same[:, None]
            scale = float(torch.where(m, r.abs(), 0.0).max()) if bool(same.any()) else 0.0
            gap = torch.where(m, (prog[k][:n].to(dev).float() - r).abs(), 0.0)
            gap = float(gap.nan_to_num(np.inf).max()) if n else 0.0
            out["state_err"] = max(out["state_err"], gap / max(scale, 1e-30))


def _member_readings(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> dict:
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
    if any(k.startswith("events") for k in ref):
        _event_readings(prog, ref, out)
    return out


def _worst(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = max(out.get(k, 0.0), v)
    return out


def reference(cell: spec.Cell, seed: int, device, ft=torch.float32):
    """The configuration's plain reference for a run of ``cell`` from
    ``seed``: its module's ``make``, else :class:`Reference`. Either has
    ``frame`` (the next frame's index), ``pool`` (its state, by member),
    ``render``, ``advance(frames, step, render_at)`` and ``load(state)``."""
    mod = spec.load_module("reference", cell.config_name, cell.references)
    make = getattr(mod, "make", None)
    if make is not None:
        return make(cell.config, cell.traffic, seed, device, ft)
    return Reference(cell, seed, device, ft)


class Reference:
    """A configuration's plain reference of one effect (or one group of
    instances) on its ``effect`` and ``spawner``, run frame by frame on
    ``device`` in the float type ``ft``."""

    def __init__(self, cell: spec.Cell, seed: int, device, ft=torch.float32) -> None:
        self.seed, self.device, self.ft = seed, torch.device(device), ft
        config, traffic = cell.config, cell.traffic
        mod = spec.load_module("reference", cell.config_name, cell.references)
        self.name = config["name"]
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
        self._pool = _plain.empty_pool(self.lanes, self.device, ft)

    @property
    def pool(self) -> State:
        return {self.name: self._pool}

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
                self._pool = _plain.step(self._pool, self.effect, counts, seeds, self.transforms,
                                         self.instances, self.dt, self.ft)
                if j in render_at:
                    images[j] = _plain.render(self._pool, self.effect, self.camera, self.raster,
                                              self.ft).float()
            self.frame += 1
        return images

    def load(self, state: State) -> None:
        self._pool = {k: v.to(self.device).to(self.ft) if v.is_floating_point()
                      else v.to(self.device) for k, v in state[self.name].items()}


def compare(record: Record, cell: spec.Cell, seed: int, device, ft=torch.float32) -> dict:
    """Every number of the module's list that the record lets the
    reference compare, the worst reading of each."""
    ref = reference(cell, seed, device, ft)
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
            diff = abs(int(span.alive) - alive_total(ref.pool))
            readings["alive_mismatch"] = max(readings["alive_mismatch"], float(diff))
    return readings


def judge(readings: dict, limits: dict) -> bool:
    """Correct where every number compared is within its limit, and every
    number that has a limit was compared."""
    return all(k in readings and readings[k] <= limits[k] for k in limits)
