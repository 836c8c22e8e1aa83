"""The system under test, built from a configuration and a traffic mix.

The program is ``bevy_hanabi_tpu_torch`` and is imported only here, inside
the functions that build it. A configuration names its effect (a function
of ``bevy_hanabi_tpu_torch.models``), its lanes, its emitters, its camera
and its raster; the mix's ``loop`` picks the entry the window drives:

- ``"chunk"``: ``frames_per_call`` frames a call, through
  ``step_render_chunk`` (``render``) or ``step_chunk``, of a
  ``CompiledEffect`` (one instance) or an ``InstancedEffect`` (a group);
- ``"scene"``: a ``HanabiScene`` holding the effect, one frame a call,
  ``update(dt, cameras=[camera])`` then ``render(camera, config)``.

A configuration with a ``members`` list is a scene of several effects, an
event-linked tree: each member (``name``, ``effect``, ``capacity``,
``parent``) is added to one ``HanabiScene`` in order, a child with its
``parent``. The ``chunk`` loop drives ``update_render_chunk`` (``render``)
or ``update_chunk``, the ``scene`` loop ``update`` then ``render``; the
frame seeds are the scene's own.

A program's state is its pools by member, each a dict of flat tensors by
the reference's names (:func:`member_state`); a configuration of one effect
is a tree of one member, named after the configuration.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hanabi_bench import inputs as bench_inputs

__all__ = ["build", "flat_state", "member_state", "flatten_counters", "STATE_KEYS"]

STATE_KEYS = ("position", "velocity", "age", "lifetime", "alive", "seed")


def flat_state(pool) -> Dict[str, torch.Tensor]:
    """A pool's lanes as flat ``[lanes, ...]`` tensors (a group's ``[I, N]``
    lanes flattened), by the reference's names."""
    lanes = pool.alive.numel()
    out = {k: v.reshape((lanes,) + tuple(v.shape[pool.alive.dim():]))
           for k, v in pool.attrs.items() if k in STATE_KEYS}
    out["alive"] = pool.alive.reshape(lanes)
    out["seed"] = pool.seed.reshape(lanes)
    return out


def member_state(inst) -> Dict[str, torch.Tensor]:
    """A scene member's pool (:func:`flat_state`) and the event buffers its
    last step emitted, by channel ``c``: ``events<c>.slot`` (the emitting
    lanes, compacted first), ``events<c>.count``, ``events<c>.num`` (the
    events in the buffer, a 0-d tensor) and ``events<c>.<attribute>``, the
    payload captured at emission."""
    out = flat_state(inst.pool)
    for ch, ev in sorted(inst.last_events.items()):
        out[f"events{ch}.slot"] = ev.parent_slot
        out[f"events{ch}.count"] = ev.count
        out[f"events{ch}.num"] = ev.num_events
        for k, v in ev.payload.items():
            out[f"events{ch}.{k}"] = v
    return out


def flatten_counters(tree, prefix: str = "") -> Dict[str, float]:
    """The numbers of a nested dict (``HanabiScene.stats()``) by dotted key."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_counters(v, key + "."))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[key] = v
    return out


def _camera_and_raster(config: dict):
    import bevy_hanabi_tpu_torch as bh

    r, c = config["raster"], config["camera"]
    cam = bh.CameraParams(
        view=bh.look_at(c["eye"], c["target"], c["up"]),
        proj=bh.perspective(math.radians(c["fov_y_deg"]), r["width"] / r["height"], c["near"],
                            c["far"]),
        viewport=(r["width"], r["height"]),
    )
    cfg = bh.RasterConfig(width=r["width"], height=r["height"], tile_size=r["tile_size"],
                          tile_span=r["tile_span"], tile_slots=r["tile_slots"],
                          max_entries_per_tile=r["max_entries_per_tile"])
    return cam, cfg


def _asset(effect: str, capacity: int):
    from bevy_hanabi_tpu_torch import models

    return getattr(models, effect)(capacity=capacity)


class ChunkProgram:
    """``frames_per_call`` frames a call of an effect or a group."""

    def __init__(self, config: dict, traffic: dict, seed: int, device) -> None:
        import bevy_hanabi_tpu_torch as bh
        from bevy_hanabi_tpu_torch.spawn import make_spawner_bank

        self.config, self.seed = config, seed
        self.render = bool(traffic["render"])
        self.dt = bench_inputs.frame_dt(traffic)
        self.instances = config["instances"]
        self.camera, self.raster = _camera_and_raster(config)
        self.transforms = bench_inputs.transforms(config)
        self.name = config["name"]
        asset = _asset(config["effect"], config["lanes_per_instance"])
        spawner = config["spawner"]
        if self.instances == 1:
            self.fx = bh.CompiledEffect(asset, device=device)
            self.pool = self.fx.create_pool()
            sp = bh.EffectSpawner(asset.spawner,
                                  rng=np.random.default_rng(bench_inputs.seed_root(seed)))
            self._tick = sp.tick
        else:
            self.fx = bh.InstancedEffect(asset, self.instances, config["lanes_per_instance"],
                                         device=device)
            self.pool = self.fx.create_pools()
            bank = make_spawner_bank(asset.spawner, self.instances,
                                     seed=bench_inputs.seed_root(seed))
            if type(bank).__name__ != spawner["bank"]:
                raise RuntimeError(f"the configuration runs a {spawner['bank']}, the program "
                                   f"made a {type(bank).__name__}")
            self._tick = bank.tick

    def inputs(self, first: int, frames: int):
        """The stacked inputs of frames ``first ..``: the spawner's ticks and
        the benchmark's frame seeds."""
        from bevy_hanabi_tpu_torch import CompiledEffect, SimParams, StepInputs

        seeds = bench_inputs.frame_seeds(self.seed, first, frames, self.instances)
        ins, sims = [], []
        for j in range(frames):
            counts = self._tick(self.dt)
            if self.instances == 1:
                ins.append(StepInputs.make(counts, seeds[j, 0], self.transforms[0]))
            else:
                ins.append(self.fx.make_inputs(counts, seeds[j], self.transforms))
            sims.append(SimParams(time=(first + j) * self.dt, delta_time=self.dt))
        return CompiledEffect.stack_frames(ins, sims)

    def call(self, stacked) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """One call: ``(checksums [K], last image)`` of a rendered mix, else
        ``(None, None)``; the pool is updated in place."""
        if self.render:
            self.pool, img, sums = self.fx.step_render_chunk(self.pool, *stacked, self.camera,
                                                             self.raster)
            return sums, img
        self.pool = self.fx.step_chunk(self.pool, *stacked)
        return None, None

    def state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {self.name: flat_state(self.pool)}

    def counters(self) -> Dict[str, float]:
        """The frames the generated step kernel and the eager step took."""
        fx = getattr(self.fx, "effect", self.fx)  # a group's one CompiledEffect
        return {"fused_frames": fx.fused_frames, "eager_frames": fx.eager_frames}


class SceneProgram:
    """A ``HanabiScene`` holding the configuration's one effect."""

    def __init__(self, config: dict, traffic: dict, seed: int, device) -> None:
        import bevy_hanabi_tpu_torch as bh

        if config["instances"] != 1:
            raise ValueError("the scene loop holds one effect instance")
        self.dt = bench_inputs.frame_dt(traffic)
        self.camera, self.raster = _camera_and_raster(config)
        root = bench_inputs.seed_root(seed)
        self.scene = bh.HanabiScene(seed=root, device=device)
        self.member = self.scene.add(_asset(config["effect"], config["lanes_per_instance"]),
                                     prng_seed=root)
        self.name = config["name"]

    def frame(self) -> torch.Tensor:
        self.scene.update(self.dt, cameras=[self.camera])
        return self.scene.render(self.camera, self.raster)

    def state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {self.name: flat_state(self.scene[self.member].pool)}

    def counters(self) -> Dict[str, float]:
        return flatten_counters(self.scene.stats())


class TreeProgram(SceneProgram):
    """A ``HanabiScene`` holding the configuration's ``members`` (an
    event-linked tree), through either loop."""

    def __init__(self, config: dict, traffic: dict, seed: int, device) -> None:
        import bevy_hanabi_tpu_torch as bh

        if config["instances"] != 1:
            raise ValueError("a tree configuration holds one instance of each member")
        if traffic.get("frame_seeds", "scene") != "scene":
            raise ValueError(f"the effects of {config['name']!r} take their frame seeds from "
                             f"their HanabiScene: a traffic mix of frame_seeds "
                             f"{traffic['frame_seeds']!r} cannot drive it, only 'scene'")
        self.render = bool(traffic["render"])
        self.dt = bench_inputs.frame_dt(traffic)
        self.camera, self.raster = _camera_and_raster(config)
        self.scene = bh.HanabiScene(seed=bench_inputs.seed_root(seed), device=device)
        self.names = [m["name"] for m in config["members"]]
        for m in config["members"]:
            self.scene.add(_asset(m["effect"], m["capacity"]), m["name"], parent=m.get("parent"))

    def inputs(self, first: int, frames: int) -> int:
        """Nothing to make: the scene ticks its spawners and draws its frame
        seeds inside the call."""
        return frames

    def call(self, frames: int) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """``frames`` frames of the whole scene: ``(checksums [K], last
        image)`` of a rendered mix, else ``(None, None)``."""
        if self.render:
            img, sums = self.scene.update_render_chunk(frames, self.dt, self.camera,
                                                       self.raster)
            return sums, img
        self.scene.update_chunk(frames, self.dt)
        return None, None

    def state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {name: member_state(self.scene[name]) for name in self.names}


def build(config: dict, traffic: dict, seed: int, device):
    if "members" in config:
        return TreeProgram(config, traffic, seed, device)
    loops = {"chunk": ChunkProgram, "scene": SceneProgram}
    return loops[traffic["loop"]](config, traffic, seed, device)
