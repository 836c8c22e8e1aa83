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
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hanabi_bench import inputs as bench_inputs

__all__ = ["build", "flat_state", "STATE_KEYS"]

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


def _asset(config: dict):
    from bevy_hanabi_tpu_torch import models

    return getattr(models, config["effect"])(capacity=config["lanes_per_instance"])


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
        asset = _asset(config)
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

    def state(self) -> Dict[str, torch.Tensor]:
        return flat_state(self.pool)


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
        self.name = self.scene.add(_asset(config), prng_seed=root)

    def frame(self) -> torch.Tensor:
        self.scene.update(self.dt, cameras=[self.camera])
        return self.scene.render(self.camera, self.raster)

    def state(self) -> Dict[str, torch.Tensor]:
        return flat_state(self.scene[self.name].pool)


def build(config: dict, traffic: dict, seed: int, device):
    loops = {"chunk": ChunkProgram, "scene": SceneProgram}
    return loops[traffic["loop"]](config, traffic, seed, device)
