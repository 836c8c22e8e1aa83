"""Plain semantics shared by the configurations' references.

Plain PyTorch and NumPy, written from bevy_hanabi's semantics in the op
order the program under test keeps (a frozen copy of that order, so that
the comparison can be tight): the PCG random stream
(vfx_common.wgsl:260-364), a rate spawner's tick (spawn.rs:838-921), a
frame of spawn, init and update over a pool of lanes or a group of
instances, burst and once spawners (spawn.rs's ``SpawnerSettings::burst`` and
``::once``), the camera, and the tile rasterizer's ordered BLEND pass
(project, bin, far-first sort, the nearest ``M`` a tile, back-to-front
blend) and its ADD pass (the order-independent keys of raster.py:336-423:
the first ``M`` a tile in key order, added), and the composite of a pass
onto the frame. Nothing here imports the program; a configuration's
reference supplies its effect's modifiers.

Every float tensor is made in ``ft``, the reference's float type: float32
for the reference, bfloat16 for the control in its place.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

MASK = 0xFFFFFFFF
TAU = 6.283185307179586476925286766559
U32 = torch.int64  # uint32 values in int64 tensors (no uint32 shifts on the CPU)

POOL_FLOATS = ("position", "velocity", "age", "lifetime")


# -- PCG ---------------------------------------------------------------------


def pcg_hash(x):
    """One round of the PCG hash on uint32 values held in int64."""
    state = (x * 747796405 + 2891336453) & MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK
    return (word >> 22) ^ word


def to_float01(u, ft):
    bits = (u & 0x007FFFFF) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).to(ft)


def frand(seed, ft):
    """One float in [0, 1) and the advanced seed."""
    seed = pcg_hash(seed)
    return seed, to_float01(pcg_hash(seed), ft)


# -- spawner -----------------------------------------------------------------


class RateSpawner:
    """``instances`` spawners of ``SpawnerSettings::rate(count)``: a cycle
    of one second, spawning over all of it, forever. ``count`` is the rate
    as the spawner holds it (a bank of f32 settings rounds it first)."""

    def __init__(self, count: float, instances: int = 1) -> None:
        self.count = float(count)
        self.cycle_time = np.zeros(instances, np.float64)
        self.remainder = np.zeros(instances, np.float64)

    def tick(self, dt: float) -> np.ndarray:
        dt = np.full(self.cycle_time.shape, float(dt))
        busy = np.ones(self.cycle_time.shape, bool)
        while busy.any():
            new_time = self.cycle_time + dt
            ratio = np.clip((np.minimum(new_time, 1.0) - self.cycle_time) / 1.0, 0.0, 1.0)
            gain = np.where(busy & (self.cycle_time <= 1.0), self.count * ratio, 0.0)
            self.remainder = self.remainder + gain
            self.cycle_time = np.where(busy, new_time, self.cycle_time)
            rolled = busy & (self.cycle_time >= 1.0)
            dt = np.where(rolled, self.cycle_time - 1.0, 0.0)
            self.cycle_time = np.where(rolled, 0.0, self.cycle_time)
            busy = rolled
        counts = np.floor(self.remainder)
        self.remainder = self.remainder - counts
        return counts.astype(np.int32)


class CycleSpawner:
    """One spawner of constant ``SpawnerSettings``: cycles of ``period``
    seconds, each spawning ``count`` over its first ``spawn_duration``
    seconds (all of it in the cycle's first frame where that is under
    ``max(1e-5, dt / 100)``), ``cycles`` of them (0: forever), the
    fractional remainder carried to the next frame, a frame that spans
    cycle ends catching up on each (spawn.rs:838-921). :meth:`burst` and
    :meth:`once` are spawn.rs's ``SpawnerSettings::burst`` and ``::once``;
    ``tick`` returns int32 ``[1]``, the count of one instance."""

    def __init__(self, count: float, spawn_duration: float, period: float, cycles: int) -> None:
        self.count, self.spawn_duration = float(count), float(spawn_duration)
        self.period, self.cycles = float(period), int(cycles)
        self.cycle_time = 0.0
        self.cycle_period = 0.0  # 0: the next frame starts a cycle
        self.cycle_duration = 0.0
        self.remainder = 0.0
        self.completed = 0

    @classmethod
    def burst(cls, count: float, period: float) -> "CycleSpawner":
        return cls(count, 0.0, period, 0)

    @classmethod
    def once(cls, count: float) -> "CycleSpawner":
        return cls(count, 0.0, 0.0, 1)

    def tick(self, dt: float) -> np.ndarray:
        if self.cycles and self.completed >= self.cycles:
            return np.zeros(1, np.int32)
        while True:
            if self.cycle_period == 0.0:
                if self.cycles == 1:
                    self.cycle_duration = self.spawn_duration
                    self.cycle_period = max(self.spawn_duration, 1e-12)
                else:
                    self.cycle_period = self.period
                    self.cycle_duration = min(max(self.spawn_duration, 0.0), self.period)
            new_time = self.cycle_time + dt
            if self.cycle_time <= self.cycle_duration:
                if self.cycle_duration < max(1e-5, dt / 100.0):
                    self.remainder += self.count
                else:
                    ratio = ((min(new_time, self.cycle_duration) - self.cycle_time)
                             / self.cycle_duration)
                    self.remainder += self.count * min(max(ratio, 0.0), 1.0)
            self.cycle_time = new_time
            if self.cycle_time < self.cycle_period:
                break
            dt = self.cycle_time - self.cycle_period
            self.cycle_time = 0.0
            self.completed += 1
            self.cycle_period = 0.0
            if self.cycles and self.completed >= self.cycles:
                break
        count = np.floor(self.remainder)
        self.remainder -= count
        return np.asarray([count], np.int32)


# -- camera ------------------------------------------------------------------


class Camera(NamedTuple):
    view: np.ndarray  # f32 [4, 4] world -> view
    proj: np.ndarray  # f32 [4, 4] view -> clip
    viewport: tuple


def look_at(eye, target, up) -> np.ndarray:
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    f = target - eye
    f = f / np.linalg.norm(f)
    r = np.cross(f, up)
    r = r / np.linalg.norm(r)
    u = np.cross(r, f)
    rot = np.stack([r, u, -f], axis=0)
    m = np.zeros((4, 4), np.float32)
    m[:3, :3] = rot
    m[:3, 3] = -rot @ eye
    m[3, 3] = 1.0
    return m


def perspective(fov_y: float, aspect: float, near: float, far: float) -> np.ndarray:
    f = 1.0 / np.tan(fov_y / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = far / (near - far)
    m[2, 3] = near * far / (near - far)
    m[3, 2] = -1.0
    return m


def camera(spec: dict, width: int, height: int) -> Camera:
    """A configuration's ``camera`` entry (eye, target, up, fov_y_deg, near, far)."""
    view = look_at(spec["eye"], spec["target"], spec["up"])
    proj = perspective(np.radians(spec["fov_y_deg"]), width / height, spec["near"], spec["far"])
    return Camera(view, proj, (width, height))


def camera_rotation(view: np.ndarray) -> torch.Tensor:
    """The world-from-view 3x3 (columns right, up, back) of an affine view,
    by the closed-form adjugate inverse in f32."""
    m = torch.from_numpy(np.asarray(view, np.float32))
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    ca, cb, cc = e * i - f * h, c * h - b * i, b * f - c * e
    cd, ce, cf = f * g - d * i, a * i - c * g, c * d - a * f
    cg, ch, ci = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * ca + b * cd + c * cg
    return torch.stack([torch.stack([ca, cb, cc]), torch.stack([cd, ce, cf]),
                        torch.stack([cg, ch, ci])]) / det


def mat4_mul(a, b):
    return (a[:, 0:1] * b[0:1, :] + a[:, 1:2] * b[1:2, :] + a[:, 2:3] * b[2:3, :]
            + a[:, 3:4] * b[3:4, :])


# -- gradients ---------------------------------------------------------------


def gradient(x, keys, ft):
    """A colour or size gradient ``[(ratio, value), ...]`` (distinct ratios)
    sampled at ``x``: the value before the first key, the lerp of the
    segment ``x`` falls in, the last value past the last key."""
    ratios = [np.float32(r) for r, _ in keys]
    values = [np.asarray(v, np.float32) for _, v in keys]

    def const(a):
        return torch.as_tensor(a, device=x.device).to(ft)

    out = const(values[0]).expand(x.shape + values[0].shape)
    for i in range(len(keys) - 1):
        span = float(ratios[i + 1] - ratios[i])
        t = torch.clamp((x - float(ratios[i])) / span, 0.0, 1.0)
        seg = const(values[i]) + const(values[i + 1] - values[i]) * t[..., None]
        out = torch.where((x >= float(ratios[i]))[..., None], seg, out)
    return out


# -- pool and step -----------------------------------------------------------


def empty_pool(lanes: int, device, ft) -> Dict[str, torch.Tensor]:
    """Every lane dead, the attributes at their defaults (lifetime 1)."""
    return {
        "position": torch.zeros((lanes, 3), dtype=ft, device=device),
        "velocity": torch.zeros((lanes, 3), dtype=ft, device=device),
        "age": torch.zeros((lanes,), dtype=ft, device=device),
        "lifetime": torch.ones((lanes,), dtype=ft, device=device),
        "alive": torch.zeros((lanes,), dtype=torch.bool, device=device),
        "seed": torch.zeros((lanes,), dtype=U32, device=device),
    }


def normalize(v):
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    return v * torch.rsqrt(torch.clamp(sq, min=1e-24))


def rotate3(v, rot):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([x * rot[..., 0, 0] + y * rot[..., 0, 1] + z * rot[..., 0, 2],
                        x * rot[..., 1, 0] + y * rot[..., 1, 1] + z * rot[..., 1, 2],
                        x * rot[..., 2, 0] + y * rot[..., 2, 1] + z * rot[..., 2, 2]], dim=-1)


class Effect(NamedTuple):
    """A configuration's modifiers: ``init(seed, ft) -> (attrs, seed)``
    (emitter space: position, velocity, age, lifetime, drawing from the
    per-lane PCG state), ``update(attrs, dt, ft)`` (before integration) and
    ``render(attrs, rot, ft) -> (axis_x, axis_y, color)``."""

    init: Callable
    update: Optional[Callable]
    render: Callable


def step(pool, effect: Effect, spawn_counts, frame_seeds, transforms, instances: int, dt: float,
         ft):
    """One frame of every lane: spawn ranking among each instance's dead
    lanes, init of the spawned lanes from ``pcg_hash(rank ^
    pcg_hash(frame_seed))``, the emitter transform, age, the lifetime kill,
    the update modifiers, then post-update integration. ``spawn_counts``
    and ``frame_seeds`` are host arrays of one value an instance,
    ``transforms`` [I, 3, 4]. Returns the new pool."""
    dev = pool["alive"].device
    n = pool["alive"].shape[0]
    per = n // instances
    dead = ~pool["alive"]
    x = dead.view(instances, per).to(torch.int32)
    free_rank = (torch.cumsum(x, dim=-1, dtype=torch.int32) - x).view(n)
    num_free = torch.sum(x, dim=-1, dtype=torch.int32)
    requested = torch.as_tensor(np.asarray(spawn_counts, np.int32).reshape(instances), device=dev)
    total = torch.minimum(requested, num_free).repeat_interleave(per)
    spawn = dead & (free_rank < total)
    hashes = pcg_hash(np.asarray(frame_seeds, np.uint32).reshape(instances).astype(np.int64))
    frame_hash = torch.as_tensor(hashes, device=dev).repeat_interleave(per)
    seed = pcg_hash(free_rank.to(U32) ^ frame_hash)

    init, seed = effect.init(seed, ft)
    tf = torch.as_tensor(np.asarray(transforms, np.float32), device=dev).to(ft)
    rot, tr = tf[:, None, :, :3], tf[:, None, :, 3]
    for name in ("position", "velocity"):
        v = init[name].expand(n, 3).reshape(instances, per, 3)
        v = rotate3(v, rot) + tr if name == "position" else rotate3(v, rot)
        init[name] = v.reshape(n, 3)

    out = {}
    for name in POOL_FLOATS:
        old = pool[name]
        m = spawn if old.dim() == 1 else spawn[:, None]
        out[name] = torch.where(m, init[name].expand(old.shape), old)
    out["seed"] = torch.where(spawn, seed, pool["seed"])
    alive = pool["alive"] | spawn

    out["age"] = out["age"] + dt
    out["alive"] = alive & (out["age"] < out["lifetime"])
    if effect.update is not None:
        effect.update(out, dt, ft)
    out["position"] = out["position"] + out["velocity"] * dt
    return out


# -- raster ------------------------------------------------------------------


def _floor(x, lo: int, hi: int):
    return torch.clamp(torch.floor(x), lo, hi).nan_to_num(0.0).to(torch.int32)


def project_bin(position, axis_x, axis_y, alive, color, cam: Camera, raster: dict, ft):
    """Project every quad, test it against the screen, bin it (``tile_slots``
    1: the centre tile; 0: the ``tile_span`` square it touches) and pack its
    row ``[cx, cy, h1x, h1y, h2x, h2y, r, g, b, a]``. Returns ``(tile,
    depth, rows)``, the entries slot-major (entry ``s * N + p``)."""
    dev = position.device
    view_t = torch.as_tensor(cam.view)
    mvp = mat4_mul(torch.as_tensor(cam.proj), view_t).to(dev).to(ft)
    view_t = view_t.to(dev).to(ft)
    vp_w, vp_h = (float(np.float32(v)) for v in cam.viewport)
    width, height = float(raster["width"]), float(raster["height"])
    T = raster["tile_size"]
    ntx, nty = -(-raster["width"] // T), -(-raster["height"] // T)
    nt = ntx * nty

    def project(p):
        px, py, pz = p[:, 0], p[:, 1], p[:, 2]

        def row(m, i):
            return m[i, 0] * px + m[i, 1] * py + m[i, 2] * pz + m[i, 3]

        view_z = row(view_t, 2)
        cx, cy, w = row(mvp, 0), row(mvp, 1), row(mvp, 3)
        safe_w = torch.where(torch.abs(w) < 1e-6, 1e-6, w)
        x = (cx / safe_w * 0.5 + 0.5) * vp_w
        y = (1.0 - (cy / safe_w * 0.5 + 0.5)) * vp_h
        return x, y, -view_z

    cx, cy, dist = project(position)
    x1, y1, _ = project(position + 0.5 * axis_x)
    x2, y2, _ = project(position + 0.5 * axis_y)
    h1x, h1y, h2x, h2y = x1 - cx, y1 - cy, x2 - cx, y2 - cy
    valid = alive & (dist > 1e-4)
    rx = torch.abs(h1x) + torch.abs(h2x)
    ry = torch.abs(h1y) + torch.abs(h2y)
    valid &= (cx + rx > 0) & (cx - rx < width)
    valid &= (cy + ry > 0) & (cy - ry < height)
    valid &= (rx > 1e-6) & (ry > 1e-6)

    Tf = float(T)
    if raster["tile_slots"] == 1:
        tcx = _floor(cx / Tf, 0, ntx - 1)
        tcy = _floor(cy / Tf, 0, nty - 1)
        tiles, oks = [torch.where(valid, tcy * ntx + tcx, nt)], [valid]
    elif raster["tile_slots"] == 0:
        span = raster["tile_span"]
        tx0 = _floor((cx - rx) / Tf, -span, ntx)
        ty0 = _floor((cy - ry) / Tf, -span, nty)
        tx1 = _floor((cx + rx) / Tf, -1, ntx)
        ty1 = _floor((cy + ry) / Tf, -1, nty)
        tiles, oks = [], []
        for dy in range(span):
            for dx in range(span):
                tx, ty = tx0 + dx, ty0 + dy
                ok = valid & (tx <= tx1) & (ty <= ty1)
                ok &= (tx >= 0) & (tx < ntx) & (ty >= 0) & (ty < nty)
                tiles.append(torch.where(ok, ty * ntx + tx, nt))
                oks.append(ok)
    else:
        raise ValueError(f"the reference bins tile_slots 0 and 1, not {raster['tile_slots']}")
    tile = torch.cat([t.to(torch.int32) for t in tiles])
    depth = torch.cat([torch.where(ok, dist, -torch.inf) for ok in oks])
    rows = torch.cat([torch.stack([cx, cy, h1x, h1y, h2x, h2y], dim=1), color], dim=1)
    return tile, depth, rows


def _bits(x: int) -> int:
    """``ceil(log2(x))``, at least 1."""
    return max(1, (int(x) - 1).bit_length())


def fast_mode(raster: dict, alpha_mode: str, entries: int) -> Optional[str]:
    """The key of an ADD pass over ``entries`` entries, as the JAX
    package's rasterizer picks it by default (raster.py:336-358: order
    independent, the nearest kept): ``"depth"`` (tile, at most 8 bits of
    near-first depth, entry index) where at least 4 bits are left for the
    depth, else ``"payload"`` (tile, at most 22 bits of near-first depth,
    stably sorted); None (the ordered path, far first) for BLEND."""
    if alpha_mode != "add":
        return None
    nt = -(-raster["width"] // raster["tile_size"]) * -(-raster["height"] // raster["tile_size"])
    return "depth" if 32 - _bits(nt + 2) - _bits(max(entries, 2)) >= 4 else "payload"


def sort_tiles(tile, depth, nt: int, mode: Optional[str] = None):
    """Entries by tile, each tile far first: the 32-bit key ``tile << s |
    (2**s - 1 - q)``, ``q`` the depth quantised over the binned range to
    ``s = min(22, 32 - tile bits)`` bits, stably sorted. ``mode`` (a
    :func:`fast_mode`) orders each tile near first (``q`` itself), and for
    ``"depth"`` the key ends in the entry index (unique keys), below ``q``
    of at most 8 bits. Returns the sorted entry indices and each tile's
    ``[start, end)``."""
    tile_bits = max(1, int(np.ceil(np.log2(nt + 2))))
    idx_bits = _bits(max(tile.shape[0], 2)) if mode == "depth" else 0
    q_bits = min(32 - tile_bits - idx_bits, 8) if mode == "depth" else min(22, 32 - tile_bits)
    shift = q_bits + idx_bits
    binned = depth > -torch.inf
    lo = torch.where(binned, depth, torch.inf).min()
    hi = torch.where(binned, depth, -torch.inf).max()
    any_binned = binned.any()
    dmin = torch.where(any_binned, lo, torch.inf)
    dmax = torch.where(any_binned, hi, -torch.inf)
    span = torch.fmax(dmax - dmin, depth.new_tensor(1e-9))
    x = torch.clamp(torch.fmax((depth - dmin) / span, depth.new_zeros(())), max=1.0)
    q = (x.float() * float((1 << q_bits) - 1)).to(torch.int64)
    if mode is None:
        q = ((1 << q_bits) - 1) - q
    key = (tile.to(torch.int64) << shift) | (q << idx_bits)
    if idx_bits:
        key = key | torch.arange(tile.shape[0], dtype=torch.int64, device=tile.device)
    key = (key - (1 << 31)).to(torch.int32)
    key_sorted, order = torch.sort(key, stable=True)
    bounds = (np.arange(nt + 1, dtype=np.int64) << shift) - (1 << 31)
    r = torch.searchsorted(key_sorted, torch.from_numpy(bounds.astype(np.int32)).to(tile.device))
    return order, r[:-1], r[1:]


def window(rows, order, starts, ends, M: int, from_start: bool = False):
    """Each tile's nearest ``M`` entries, back to front (the last ``M`` of
    its run), or with ``from_start`` the first ``M`` of its run: ``(rows
    [nt, M, F], has [nt, M])``; entry ``e`` reads row ``e mod N``."""
    n, nt = order.shape[0], starts.shape[0]
    base = starts if from_start else torch.maximum(ends - M, starts)
    raw = base[:, None] + torch.arange(M, dtype=base.dtype, device=base.device)[None, :]
    has = raw < ends[:, None]
    pidx = torch.remainder(order[torch.clamp(raw, max=n - 1)], rows.shape[0])
    win = rows.index_select(0, pidx.reshape(-1)).reshape(nt, M, rows.shape[1])
    return torch.where(has[..., None], win, 0.0), has


def blend(win, has, T: int, ntx: int, ft, alpha_mode: str = "blend"):
    """BLEND (or ADD) of every tile's window over a transparent black
    target, entry by entry, each pixel's quad test in its ``(u, v)`` frame."""
    nt, M, _ = win.shape
    dev = win.device
    ar = torch.arange(T, dtype=torch.int32, device=dev)
    tiles = torch.arange(nt, dtype=torch.int32, device=dev)
    py = ((tiles // ntx)[:, None, None] * T + ar[None, :, None]).to(ft) + 0.5
    px = ((tiles % ntx)[:, None, None] * T + ar[None, None, :]).to(ft) + 0.5
    fb = torch.zeros((nt, T, T, 4), dtype=ft, device=dev)
    for m in range(M):
        r = win[:, m, :]
        dx = px - r[:, 0, None, None]
        dy = py - r[:, 1, None, None]
        a1x, a1y, a2x, a2y = r[:, 2], r[:, 3], r[:, 4], r[:, 5]
        det = a1x * a2y - a1y * a2x
        det = torch.where(torch.abs(det) < 1e-9, 1e-9, det)[:, None, None]
        u = (a2y[:, None, None] * dx - a2x[:, None, None] * dy) / det
        v = ((-a1y)[:, None, None] * dx + a1x[:, None, None] * dy) / det
        inside = (torch.abs(u) <= 1.0) & (torch.abs(v) <= 1.0) & has[:, m, None, None]
        coverage = inside.to(ft)
        covered = coverage[..., None] > 0.0
        src = r[:, None, None, 6:10]
        a = torch.where(covered, (src[..., 3] * coverage)[..., None], 0.0)
        rgb_s = torch.where(covered, src[..., :3], 0.0)
        if alpha_mode == "add":
            rgb = rgb_s * a + fb[..., :3]
            alpha = torch.clamp(a + fb[..., 3:4], max=1.0)
        else:
            rgb = rgb_s * a + fb[..., :3] * (1.0 - a)
            alpha = a + fb[..., 3:4] * (1.0 - a)
        fb = torch.cat([rgb, alpha], dim=-1)
    return fb


def rasterize(position, axis_x, axis_y, alive, color, cam: Camera, raster: dict, ft,
              alpha_mode: str = "blend"):
    """The BLEND (or ADD) frame as a ``[height, width, 4]`` image."""
    if alpha_mode not in ("blend", "add"):
        raise ValueError(f"the reference draws BLEND and ADD, not {alpha_mode!r}")
    T = raster["tile_size"]
    ntx, nty = -(-raster["width"] // T), -(-raster["height"] // T)
    tile, depth, rows = project_bin(position, axis_x, axis_y, alive, color, cam, raster, ft)
    mode = fast_mode(raster, alpha_mode, tile.shape[0])
    order, starts, ends = sort_tiles(tile, depth, ntx * nty, mode)
    win, has = window(rows, order, starts, ends, raster["max_entries_per_tile"],
                      from_start=mode is not None)
    fb = blend(win, has, T, ntx, ft, alpha_mode)
    img = fb.reshape(nty, ntx, T, T, 4).transpose(1, 2).reshape(nty * T, ntx * T, 4)
    return img[: raster["height"], : raster["width"]]


def composite(layer, frame, alpha_mode: str = "blend"):
    """A pass's layer (drawn over transparent black) onto the frame by the
    pass's equation (asset.rs:212-240): ADD adds, its alpha clamped to 1;
    BLEND draws over."""
    if alpha_mode == "add":
        rgb = frame[..., :3] + layer[..., :3]
        alpha = torch.clamp(frame[..., 3:4] + layer[..., 3:4], max=1.0)
    else:
        a = layer[..., 3:4]
        rgb = layer[..., :3] + frame[..., :3] * (1.0 - a)
        alpha = a + frame[..., 3:4] * (1.0 - a)
    return torch.cat([rgb, alpha], dim=-1)


def render(pool, effect: Effect, cam: Camera, raster: dict, ft, alpha_mode: str = "blend"):
    rot = camera_rotation(cam.view).to(pool["alive"].device).to(ft)
    axis_x, axis_y, color = effect.render(pool, rot, ft)
    return rasterize(pool["position"], axis_x, axis_y, pool["alive"], color.contiguous(), cam,
                     raster, ft, alpha_mode)
