"""Plain reference of ``mixed_917k``: the JAX package's mixed-blend scene
(bench.py:672-774) on ``_events.py`` and ``_plain.py``, drawn by the
painter pass the program's default pipeline takes for it.

Members, in the order they are added (the scene's order, a child right
after its parent), each stepping as one instance at the origin:

- debris: spawned in a ball of radius 3 around the origin (the radius
  ``u^(1/3)`` of a first draw, then the direction's angle and height),
  moving away from its centre at 1 unit a second, living 4 s, HDR (0.9,
  0.6, 0.2, 1), size 0.05 in the camera's plane, OPAQUE; a quarter of the
  pool spawned a second;
- grad: bevy_hanabi's ``examples/gradient.rs`` as ``reference/gradient_4m.py``
  restates it, BLEND; a fifth of the pool a second;
- rocket and trail: ``examples/firework.rs`` as the JAX package's
  ``bench_firework_events`` builds it, both ADD (``hanabi_bench/tests/data/
  tree/firework_tree.py`` restates the same tree).

The painter pass (the port's ``HanabiScene._render_painter``; the JAX
package's scene.py:2658-2769): every member's billboards in one global
(tile, depth) sort, far first, the members concatenated back to front by
their emitter's distance from the camera (all at the origin here, so the
scene's order), which breaks ties of the sort key only, and entry order
after that (the stable sort); each tile's nearest ``M`` entries counted
across the whole scene, drawn far to near onto transparent black, each by
its own member's equation: OPAQUE writes its colour and alpha 1 and the
fragment's depth, BLEND draws over, ADD adds (its alpha clamped to 1), and
every entry is tested against the depth the opaque entries before it
wrote (a fragment at that depth passes).

Departures from the JAX package: its ``lax.sort`` is not stable, so an
exact tie of the sort key may blend in another order there (the port's
and this reference's order is the stable one); the reference bins
``tile_slots`` 1 only, the configuration's.
"""

from __future__ import annotations

import torch

from hanabi_bench import inputs as bench_inputs
from hanabi_bench.reference import _events, _plain, gradient_4m

# the painter's per-entry equation ids (the program's PAINTER_MODE_IDS)
MODES = {"blend": 0.0, "add": 2.0, "opaque": 4.0}
DEBRIS_COLOR = (0.9, 0.6, 0.2, 1.0)
DEBRIS_SIZE = 0.05
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


def _ball(seed, center, radius: float, ft):
    """A point in a ball (SetPositionSphereModifier, VOLUME): the radius
    ``u^(1/3)`` of a first draw, then the direction's angle and height."""
    seed, u = _plain.frand(seed, ft)
    r = torch.pow(u, 1.0 / 3.0) * _const(radius, seed, ft)
    seed, theta = _plain.frand(seed, ft)
    theta = theta * _plain.TAU
    seed, z = _plain.frand(seed, ft)
    z = z * 2.0 - 1.0
    sinphi = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    direction = torch.stack([sinphi * torch.cos(theta), sinphi * torch.sin(theta), z], dim=-1)
    return seed, center + r[..., None] * direction


def _debris_init(seed, ft, inherited):
    center = _const((0.0, 0.0, 0.0), seed, ft)
    seed, position = _ball(seed, center, 3.0, ft)
    velocity = _plain.normalize(position - center) * _const(1.0, seed, ft)
    return {"age": _const(0.0, seed, ft), "lifetime": _const(4.0, seed, ft),
            "position": position, "velocity": velocity}, seed


def _debris_render(pool, rot, ft):
    n = pool["alive"].shape[0]
    size = torch.as_tensor(DEBRIS_SIZE, device=rot.device).to(ft)
    color = torch.as_tensor(DEBRIS_COLOR, device=rot.device).to(ft).expand(n, 4)
    return rot[:, 0].expand(n, 3) * size, rot[:, 1].expand(n, 3) * size, color


def _grad_init(seed, ft, inherited):
    return gradient_4m._init(seed, ft)


def _rocket_init(seed, ft, inherited):
    seed, age = _uniform(seed, 0.0, 0.2, ft)
    seed, lifetime = _uniform(seed, 0.8, 1.4, ft)
    center = _const((0.0, 3.0, 0.0), seed, ft)
    seed, position = _ball(seed, center, 0.25, ft)
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


def spawner(config, name: str):
    """Member ``name``'s spawner: a quarter of the debris pool a second, a
    fifth of the gradient's, the rockets' 2048 every 2 s, and None for the
    trails, which spawn from the rockets' events."""
    cap = {m["name"]: m["capacity"] for m in config["members"]}[name]
    return {"debris": lambda: _plain.RateSpawner(cap / 4.0),
            "grad": lambda: _plain.RateSpawner(cap / 5.0),
            "rocket": lambda: _plain.CycleSpawner.burst(2048.0, 2.0),
            "trail": lambda: None}[name]()


def effect(config, name: str) -> _events.Member:
    """Member ``name`` at its configured capacity: its modifiers, blend
    mode, spawner and event links."""
    cap = {m["name"]: m["capacity"] for m in config["members"]}[name]
    if name == "debris":
        return _events.Member(name, cap, _debris_init, None, _debris_render, "opaque",
                              spawner=spawner(config, name))
    if name == "grad":
        return _events.Member(name, cap, _grad_init, None, gradient_4m._render, "blend",
                              spawner=spawner(config, name))
    if name == "rocket":
        return _events.Member(name, cap, _rocket_init, _rocket_update,
                              _billboard(ROCKET_COLOR, ROCKET_SIZE), "add",
                              spawner=spawner(config, name), emits=((0, "on_die", 4),))
    if name == "trail":
        return _events.Member(name, cap, _trail_init, None, _billboard(TRAIL_COLOR, TRAIL_SIZE),
                              "add", parent="rocket", inherits=("position",))
    raise ValueError(f"mixed_917k has no member {name!r}")


def members(config) -> list:
    """The scene's members at the configuration's capacities, as it adds them."""
    return [effect(config, m["name"]) for m in config["members"]]


def painter_blend(win, has, T: int, ntx: int, ft):
    """Every tile's window (``[nt, M, 12]`` rows: the quad's ten columns,
    its view depth and its equation's id), far to near, onto transparent
    black: each entry's pixels inside its quad and at or before the depth
    the opaque entries wrote, by its own equation."""
    nt, M, _ = win.shape
    dev = win.device
    ar = torch.arange(T, dtype=torch.int32, device=dev)
    tiles = torch.arange(nt, dtype=torch.int32, device=dev)
    py = ((tiles // ntx)[:, None, None] * T + ar[None, :, None]).to(ft) + 0.5
    px = ((tiles % ntx)[:, None, None] * T + ar[None, None, :]).to(ft) + 0.5
    fb = torch.zeros((nt, T, T, 4), dtype=ft, device=dev)
    depth = torch.full((nt, T, T), torch.inf, dtype=ft, device=dev)
    for m in range(M):
        r = win[:, m, :]
        dx = px - r[:, 0, None, None]
        dy = py - r[:, 1, None, None]
        a1x, a1y, a2x, a2y = r[:, 2], r[:, 3], r[:, 4], r[:, 5]
        det = a1x * a2y - a1y * a2x
        det = torch.where(torch.abs(det) < 1e-9, 1e-9, det)[:, None, None]
        u = (a2y[:, None, None] * dx - a2x[:, None, None] * dy) / det
        v = ((-a1y)[:, None, None] * dx + a1x[:, None, None] * dy) / det
        frag = r[:, 10, None, None]
        inside = ((torch.abs(u) <= 1.0) & (torch.abs(v) <= 1.0) & has[:, m, None, None]
                  & (frag <= depth))
        mode = r[:, 11, None, None, None]
        src = r[:, None, None, 6:10]
        a = torch.where(inside[..., None], src[..., 3:4], 0.0)
        rgb_s = torch.where(inside[..., None], src[..., :3], 0.0)
        rgb_d, a_d = fb[..., :3], fb[..., 3:4]
        blend = torch.cat([rgb_s * a + rgb_d * (1.0 - a), a + a_d * (1.0 - a)], dim=-1)
        add = torch.cat([rgb_s * a + rgb_d, torch.clamp(a + a_d, max=1.0)], dim=-1)
        opaque = torch.where(inside[..., None], torch.cat([rgb_s, torch.ones_like(a)], dim=-1),
                             fb)
        fb = torch.where(mode == MODES["opaque"], opaque,
                         torch.where(mode == MODES["add"], add, blend))
        depth = torch.where(inside & (mode[..., 0] == MODES["opaque"]), frag, depth)
    return fb


class Painter(_events.Tree):
    """The tree of :class:`~hanabi_bench.reference._events.Tree`, drawn by
    the painter pass (the module's docstring)."""

    def draw(self) -> torch.Tensor:
        r = self.raster
        if r["tile_slots"] != 1:
            raise ValueError(f"the painter reference bins tile_slots 1, not {r['tile_slots']}")
        T = r["tile_size"]
        ntx, nty = -(-r["width"] // T), -(-r["height"] // T)
        rot = _plain.camera_rotation(self.camera.view).to(self.device).to(self.ft)
        cols = {k: [] for k in ("position", "axis_x", "axis_y", "alive", "color", "mode")}
        # back to front by emitter distance: every emitter is at the origin,
        # so the distances tie and the scene's order stands
        for m in self.members:
            pool = self.pools[m.name]
            axis_x, axis_y, color = m.render(pool, rot, self.ft)
            mode = torch.full((m.capacity,), MODES[m.alpha_mode], dtype=self.ft,
                              device=self.device)
            for k, v in zip(cols, (pool["position"], axis_x, axis_y, pool["alive"], color, mode)):
                cols[k].append(v)
        cols = {k: torch.cat(v) for k, v in cols.items()}
        tile, depth, rows = _plain.project_bin(cols["position"], cols["axis_x"], cols["axis_y"],
                                               cols["alive"], cols["color"].contiguous(),
                                               self.camera, r, self.ft)
        rows = torch.cat([rows, depth[:, None], cols["mode"][:, None]], dim=1)
        order, starts, ends = _plain.sort_tiles(tile, depth, ntx * nty)
        win, has = _plain.window(rows, order, starts, ends, r["max_entries_per_tile"])
        fb = painter_blend(win, has, T, ntx, self.ft)
        img = fb.reshape(nty, ntx, T, T, 4).transpose(1, 2).reshape(nty * T, ntx * T, 4)
        return img[: r["height"], : r["width"]]


def make(config, traffic, seed, device, ft):
    # nothing here multiplies matrices; should anything, it is not in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = config["raster"]
    return Painter(members(config), seed, device, ft,
                   _plain.camera(config["camera"], r["width"], r["height"]), r,
                   bench_inputs.frame_dt(traffic), bool(traffic["render"]))
