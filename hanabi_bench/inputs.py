"""The inputs the benchmark makes from ``--seed`` and hands to both the
program and the reference: every frame's PCG frame seeds (one an
instance), the emitters' transforms, the frame time, and the frames the
pools are warmed for. The program derives its spawn counts itself, from
its spawner's settings; the reference works them out again."""

from __future__ import annotations

import math

import numpy as np

__all__ = ["seed_root", "frame_seeds", "transforms", "frame_dt", "warm_frames"]


def seed_root(seed: int) -> int:
    """``--seed`` as the non-negative integer the generators take."""
    return int(seed) % (1 << 63)


def frame_seeds(seed: int, first: int, frames: int, instances: int) -> np.ndarray:
    """uint32 [frames, instances] frame seeds of frames ``first ..
    first + frames - 1``, each frame its own generator, so any stretch of
    frames is made alike whoever asks for it."""
    out = np.empty((frames, instances), np.uint32)
    for j in range(frames):
        rng = np.random.default_rng([seed_root(seed), first + j])
        out[j] = rng.integers(0, 1 << 32, size=instances, dtype=np.uint32)
    return out


def transforms(config: dict) -> np.ndarray:
    """f32 [I, 3, 4] emitter transforms: identity rotations at the points of
    the configuration's ``emitters`` grid (``nx`` by ``ny`` over ``x`` and
    ``y`` at depth ``z``), row by row; the origin for one instance."""
    i = config["instances"]
    tf = np.zeros((i, 3, 4), np.float32)
    tf[:, :, :3] = np.eye(3, dtype=np.float32)
    grid = config.get("emitters")
    if grid is not None:
        xs = np.linspace(grid["x"][0], grid["x"][1], grid["nx"], dtype=np.float64)
        ys = np.linspace(grid["y"][0], grid["y"][1], grid["ny"], dtype=np.float64)
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        if gx.size != i:
            raise ValueError(f"an emitter grid of {gx.size} points for {i} instances")
        tf[:, 0, 3] = gx.reshape(-1)
        tf[:, 1, 3] = gy.reshape(-1)
        tf[:, 2, 3] = grid["z"]
    return tf


def frame_dt(traffic: dict) -> float:
    return 1.0 / float(traffic["frames_per_second"])


def warm_frames(config: dict, traffic: dict) -> int:
    """Frames that fill the pools to steady state (a lifetime), rounded up
    to whole calls of the mix."""
    frames = math.ceil(config["lifetime_s"] * traffic["frames_per_second"])
    k = traffic.get("frames_per_call", 1)
    return -(-frames // k) * k
