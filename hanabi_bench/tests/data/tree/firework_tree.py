"""Plain reference of the test tree ``firework_tree``: bevy_hanabi's
``examples/firework.rs`` as the JAX package's ``bench_firework_events``
builds it, on ``_events.py`` and ``_plain.py``.

Rockets: a burst of 2048 every 2 seconds; spawned in a ball of radius 0.25
around (0, 3, 0), moving away from its centre at 5 to 9 units a second,
aged 0 to 0.2 s at birth and living 0.8 to 1.4 s; accelerated by (0, -6, 0)
and slowed by a linear drag of 4 a second; on death each emits four spawn
events on channel 0. Drawn as billboards in the camera's plane, HDR white
to orange to red to transparent over life, size 0.06 to 0.01, added.

Trails: no spawner of their own; each spawns from a rocket's event, at the
rocket's position (inherited), aged 0, living 0.3 to 0.6 s, drifting at a
random velocity of each component -1 to 1 scaled by 0.2 to 0.6. Drawn as
billboards, (3, 2, 1, 1) fading to transparent black, size 0.02 to 0, added.
"""

from __future__ import annotations

import torch

from hanabi_bench import inputs as bench_inputs
from hanabi_bench.reference import _events, _plain

ROCKET_COLOR = [(0.0, (4.0, 4.0, 4.0, 1.0)), (0.1, (4.0, 2.0, 0.0, 1.0)),
                (0.7, (2.0, 0.2, 0.0, 1.0)), (1.0, (0.5, 0.0, 0.0, 0.0))]
ROCKET_SIZE = [(0.0, (0.06,)), (1.0, (0.01,))]
TRAIL_COLOR = [(0.0, (3.0, 2.0, 1.0, 1.0)), (1.0, (0.0, 0.0, 0.0, 0.0))]
TRAIL_SIZE = [(0.0, (0.02,)), (1.0, (0.0,))]


def _const(v, seed, ft):
    return torch.as_tensor(v, device=seed.device).to(ft)


def _uniform(seed, lo, hi, ft):
    seed, r = _plain.frand(seed, ft)
    a, b = _const(lo, seed, ft), _const(hi, seed, ft)
    return seed, a + r * (b - a)


def _rocket_init(seed, ft, inherited):
    seed, age = _uniform(seed, 0.0, 0.2, ft)
    seed, lifetime = _uniform(seed, 0.8, 1.4, ft)
    center = _const((0.0, 3.0, 0.0), seed, ft)
    seed, u = _plain.frand(seed, ft)
    r = torch.pow(u, 1.0 / 3.0) * _const(0.25, seed, ft)
    seed, theta = _plain.frand(seed, ft)
    theta = theta * _plain.TAU
    seed, z = _plain.frand(seed, ft)
    z = z * 2.0 - 1.0
    sinphi = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    direction = torch.stack([sinphi * torch.cos(theta), sinphi * torch.sin(theta), z], dim=-1)
    position = center + r[..., None] * direction
    seed, speed = _uniform(seed, 5.0, 9.0, ft)
    velocity = _plain.normalize(position - center) * speed[..., None]
    return {"age": age, "lifetime": lifetime, "position": position, "velocity": velocity}, seed


def _rocket_update(pool, dt, ft):
    dev = pool["velocity"].device
    v = pool["velocity"] + torch.as_tensor((0.0, -6.0, 0.0), device=dev).to(ft) * dt
    factor = torch.clamp(1.0 - torch.as_tensor(4.0, device=dev).to(ft) * dt, min=0.0)
    pool["velocity"] = v * factor


def _trail_init(seed, ft, inherited):
    seed, lifetime = _uniform(seed, 0.3, 0.6, ft)
    s1 = _plain.pcg_hash(seed)
    s2 = _plain.pcg_hash(s1)
    s3 = _plain.pcg_hash(s2)
    seed = s3
    rand3 = torch.stack([_plain.to_float01(s, ft) for s in (s1, s2, s3)], dim=-1)
    seed, scale = _uniform(seed, 0.2, 0.6, ft)
    velocity = ((rand3 * _const(2.0, seed, ft) - _const((1.0, 1.0, 1.0), seed, ft))
                * scale[..., None])
    return {"age": _const(0.0, seed, ft), "lifetime": lifetime,
            "position": inherited["position"], "velocity": velocity}, seed


def _billboard(color_keys, size_keys):
    def render(pool, rot, ft):
        n = pool["alive"].shape[0]
        ratio = pool["age"] / pool["lifetime"]
        color = _plain.gradient(ratio, color_keys, ft)
        size = _plain.gradient(ratio, size_keys, ft).expand(n, 3)
        return (rot[:, 0].expand(n, 3) * size[:, 0:1], rot[:, 1].expand(n, 3) * size[:, 1:2],
                color)

    return render


def members(config) -> list:
    """The tree's members at the configuration's capacities."""
    cap = {m["name"]: m["capacity"] for m in config["members"]}
    return [
        _events.Member("rocket", cap["rocket"], _rocket_init, _rocket_update,
                       _billboard(ROCKET_COLOR, ROCKET_SIZE), "add",
                       spawner=_plain.CycleSpawner.burst(2048.0, 2.0),
                       emits=((0, "on_die", 4),)),
        _events.Member("trail", cap["trail"], _trail_init, None,
                       _billboard(TRAIL_COLOR, TRAIL_SIZE), "add", parent="rocket",
                       inherits=("position",)),
    ]


def make(config, traffic, seed, device, ft):
    r = config["raster"]
    return _events.Tree(members(config), seed, device, ft,
                        _plain.camera(config["camera"], r["width"], r["height"]), r,
                        bench_inputs.frame_dt(traffic), bool(traffic["render"]))
