"""Plain reference of ``instancing_1024x4096``: bevy_hanabi's
``examples/instancing.rs`` effect, one instance an emitter. Spawned in a
ball of radius 0.3, moving radially at 0.5 to 1 unit a second, accelerated
upward at 1 unit a second squared, living 3 seconds; drawn as unit
billboards in the camera's plane, white fading to transparent blue,
alpha-blended. Spawn rate: a third of an instance's lanes a second, each
instance's spawner holding the rate as an f32 (a native bank's settings)."""

from __future__ import annotations

import numpy as np
import torch

from hanabi_bench.reference import _plain

COLOR = [(0.0, (1.0, 1.0, 1.0, 1.0)), (1.0, (0.2, 0.2, 1.0, 0.0))]


def _init(seed, ft):
    dev = seed.device

    def const(v):
        return torch.as_tensor(v, device=dev).to(ft)

    seed, r = _plain.frand(seed, ft)
    r = torch.pow(r, 1.0 / 3.0) * const(0.3)
    seed, theta = _plain.frand(seed, ft)
    theta = theta * _plain.TAU
    seed, z = _plain.frand(seed, ft)
    z = z * 2.0 - 1.0
    sinphi = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    direction = torch.stack([sinphi * torch.cos(theta), sinphi * torch.sin(theta), z], dim=-1)
    center = const((0.0, 0.0, 0.0))
    position = center + r[..., None] * direction
    lo, hi = const(0.5), const(1.0)
    seed, u = _plain.frand(seed, ft)
    speed = lo + u * (hi - lo)
    velocity = _plain.normalize(position - center) * speed[..., None]
    return {"age": const(0.0), "lifetime": const(3.0), "position": position,
            "velocity": velocity}, seed


def _update(pool, dt, ft):
    accel = torch.as_tensor((0.0, 1.0, 0.0), device=pool["velocity"].device).to(ft)
    pool["velocity"] = pool["velocity"] + accel * dt


def _render(pool, rot, ft):
    n = pool["alive"].shape[0]
    ratio = pool["age"] / pool["lifetime"]
    color = _plain.gradient(ratio, COLOR, ft)
    ones = torch.ones((n, 3), dtype=ft, device=rot.device)
    return rot[:, 0].expand(n, 3) * ones[:, 0:1], rot[:, 1].expand(n, 3) * ones[:, 1:2], color


def effect(config) -> _plain.Effect:
    return _plain.Effect(_init, _update, _render)


def spawner(config) -> _plain.RateSpawner:
    rate = np.float32(config["lanes_per_instance"] / 3.0)
    return _plain.RateSpawner(float(rate), config["instances"])
