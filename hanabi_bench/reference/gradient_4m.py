"""Plain reference of ``gradient_4m``: bevy_hanabi's ``examples/gradient.rs``
effect. Spawned on a unit sphere's surface, moving radially at 2 units a
second, living 5 seconds; drawn as billboards in the camera's plane, its
colour red, yellow, then transparent blue over its life, its size 0.1 to
0.02, alpha-blended. Spawn rate: a fifth of the pool a second, ticked by
one spawner that holds the rate as a double."""

from __future__ import annotations

import torch

from hanabi_bench.reference import _plain

COLOR = [(0.0, (1.0, 0.0, 0.0, 1.0)), (0.5, (1.0, 1.0, 0.0, 1.0)), (1.0, (0.0, 0.0, 1.0, 0.0))]
SIZE = [(0.0, (0.1,)), (1.0, (0.02,))]


def _init(seed, ft):
    dev = seed.device

    def const(v):
        return torch.as_tensor(v, device=dev).to(ft)

    seed, theta = _plain.frand(seed, ft)
    theta = theta * _plain.TAU
    seed, z = _plain.frand(seed, ft)
    z = z * 2.0 - 1.0
    sinphi = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    direction = torch.stack([sinphi * torch.cos(theta), sinphi * torch.sin(theta), z], dim=-1)
    center = const((0.0, 0.0, 0.0))
    position = center + const(1.0) * direction
    velocity = _plain.normalize(position - center) * const(2.0)
    return {"age": const(0.0), "lifetime": const(5.0), "position": position,
            "velocity": velocity}, seed


def _render(pool, rot, ft):
    n = pool["alive"].shape[0]
    ratio = pool["age"] / pool["lifetime"]
    color = _plain.gradient(ratio, COLOR, ft)
    size = _plain.gradient(ratio, SIZE, ft).expand(n, 3)
    return rot[:, 0].expand(n, 3) * size[:, 0:1], rot[:, 1].expand(n, 3) * size[:, 1:2], color


def effect(config) -> _plain.Effect:
    return _plain.Effect(_init, None, _render)


def spawner(config) -> _plain.RateSpawner:
    return _plain.RateSpawner(config["lanes_per_instance"] / 5.0, config["instances"])
