"""Plain semantics of event-linked effect trees, shared by the references
of tree configurations (a configuration with ``members``).

Plain PyTorch and NumPy on ``_plain.py``, written from bevy_hanabi's
semantics in the op order the program under test keeps:

- emission (``EmitSpawnEventModifier``, modifier/mod.rs:664-692): each lane
  emits ``count`` events on its channel, ON_DIE where it was alive when the
  update pass began (after spawning) and is not at its end, ALWAYS where it
  is alive at the end; the events are compacted in lane order, each with
  its emitting lane, its count and the lane's attributes at the end of the
  update pass (the payload), the lanes that emit nothing after them in lane
  order (:func:`compact`, what ``event_compact`` produces);
- consumption (vfx_init.wgsl:123-171): a child reads the events its parent
  emitted in the frame before (one frame of latency, vfx_init.wgsl:123-129),
  spawns ``min(events' total count, free lanes)`` lanes, and its ``k``-th
  spawned lane belongs to the event whose running count first exceeds
  ``k`` (:func:`consume`);
- ``InheritAttributeModifier`` (attr.rs:148): a spawned lane takes the
  attribute from its event's payload;
- the scene's random draws: a generator on the run's seed draws each
  member's seed (``0 .. 2**63``) as the member is added, in order; the
  member's frame seeds (one a frame, ``0 .. 2**32``) come from a generator
  on that seed plus one, its spawner's from one on that seed (constant
  settings draw nothing);
- the scene's order: a root after the members before it, a child right
  after its parent (so a later sibling before an earlier one); the members
  draw in that order, and one blend mode's members draw as one pass over
  their lanes concatenated in that order, onto a transparent black layer
  composited onto the frame (``_plain.composite``).

Each member steps as one instance at the origin. :class:`Tree` is the
comparison's reference protocol over such members: ``frame``, ``pool``
(each member's lanes and the event buffers of its last step, as
``program.member_state`` names them), ``render``, ``advance`` and ``load``.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from hanabi_bench import inputs as bench_inputs
from hanabi_bench.reference import _plain

__all__ = ["Member", "Tree", "emit", "compact", "consume", "inherit", "scene_order",
           "step_member"]

EVENT_FIELDS = ("slot", "count", "num")


class Member(NamedTuple):
    """One effect of a tree. ``init(seed, ft, inherited) -> (attrs, seed)``
    is ``_plain.Effect``'s init with the lanes' :func:`inherit`-ed
    attributes (None for a root); ``update`` and ``render`` are
    ``_plain.Effect``'s. ``emits`` holds ``(channel, condition, count)``
    for each ``EmitSpawnEventModifier``; ``inherits`` the attributes a child
    takes from its parent's payload on ``channel``."""

    name: str
    capacity: int
    init: Callable
    update: Optional[Callable]
    render: Callable
    alpha_mode: str = "blend"
    parent: Optional[str] = None
    channel: int = 0
    spawner: object = None  # a root's, with ``tick(dt) -> int32 [1]``
    emits: tuple = ()
    inherits: tuple = ()


def emit(was_alive, alive, condition: str):
    """The lanes that emit under ``condition`` (``"on_die"`` or ``"always"``)."""
    if condition == "on_die":
        return was_alive & ~alive
    if condition == "always":
        return alive
    raise ValueError(f"unknown emit condition {condition!r}")


def compact(mask, count, attrs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One channel's event buffer: the lanes with ``mask`` and ``count >
    0`` first and the others after them, each part in lane order; ``slot``
    (int64 lanes), ``count`` (int64, 0 past the events), ``num`` (a 0-d
    int64) and each attribute of ``attrs`` gathered in that order."""
    count = count.to(torch.int64).expand(mask.shape)
    active = mask & (count > 0)
    order = torch.cat([torch.nonzero(active)[:, 0], torch.nonzero(~active)[:, 0]])
    num = active.sum()
    pos = torch.arange(order.shape[0], device=order.device)
    out = {"slot": order, "count": torch.where(pos < num, count[order], 0), "num": num}
    for k, v in attrs.items():
        out[k] = v[order]
    return out


def empty_events(capacity: int, attrs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A buffer with no event, shaped as :func:`compact`'s over ``capacity`` lanes."""
    mask = torch.zeros(capacity, dtype=torch.bool, device=next(iter(attrs.values())).device)
    return compact(mask, torch.zeros((), dtype=torch.int64, device=mask.device),
                   {k: v[:capacity] for k, v in attrs.items()})


def consume(events: Dict[str, torch.Tensor], free_rank, num_free):
    """A child's spawn from its parent's buffer: ``(spawn_total, event)``,
    the lanes it spawns and, for each lane, the event its free rank falls
    in (clamped to the buffer)."""
    requested = events["count"].sum()
    total = torch.minimum(requested, num_free.to(torch.int64))
    cum = torch.cumsum(events["count"], dim=0)
    event = torch.searchsorted(cum, free_rank.to(torch.int64), right=True)
    return total, torch.clamp(event, max=cum.shape[0] - 1)


def inherit(events: Dict[str, torch.Tensor], event, attrs) -> Dict[str, torch.Tensor]:
    """``InheritAttributeModifier``: each lane's ``attrs`` from its event's payload."""
    return {a: events[a][event] for a in attrs}


def scene_order(members) -> list:
    """The members in the scene's order (the module's docstring)."""
    order = []
    for m in members:
        if m.parent is None:
            order.append(m)
        else:
            at = next(i for i, o in enumerate(order) if o.name == m.parent)
            order.insert(at + 1, m)
    return order


def step_member(pool, m: Member, requested, events, frame_seed, dt: float, ft, payload_attrs):
    """One frame of member ``m``: spawn (``requested`` lanes of a root, or
    from the parent's ``events``), init, the identity emitter transform,
    age, the lifetime kill, the update modifiers, post-update integration,
    then each channel's emission. Returns ``(pool, {channel: buffer})``."""
    dev = pool["alive"].device
    n = pool["alive"].shape[0]
    dead = ~pool["alive"]
    x = dead.to(torch.int32)
    free_rank = torch.cumsum(x, dim=-1, dtype=torch.int32) - x
    num_free = torch.sum(x, dtype=torch.int32)
    inherited = None
    if events is not None:
        total, event = consume(events, free_rank, num_free)
        inherited = inherit(events, event, m.inherits)
    else:
        total = torch.clamp(num_free, max=int(requested))
    spawn = dead & (free_rank < total)
    frame_hash = int(_plain.pcg_hash(np.int64(np.uint32(frame_seed))))
    seed = _plain.pcg_hash(free_rank.to(_plain.U32) ^ frame_hash)

    init, seed = m.init(seed, ft, inherited)
    eye = torch.eye(3, dtype=ft, device=dev)
    for name in ("position", "velocity"):
        v = _plain.rotate3(init[name].expand(n, 3), eye)
        init[name] = v + torch.zeros(3, dtype=ft, device=dev) if name == "position" else v

    out = {}
    for name in _plain.POOL_FLOATS:
        old = pool[name]
        mask = spawn if old.dim() == 1 else spawn[:, None]
        out[name] = torch.where(mask, init[name].expand(old.shape), old)
    out["seed"] = torch.where(spawn, seed, pool["seed"])
    was_alive = pool["alive"] | spawn
    out["age"] = out["age"] + dt
    out["alive"] = was_alive & (out["age"] < out["lifetime"])
    if m.update is not None:
        m.update(out, dt, ft)
    out["position"] = out["position"] + out["velocity"] * dt

    emitted = {}
    for channel, condition, count in m.emits:
        mask = emit(was_alive, out["alive"], condition)
        emitted[channel] = compact(mask, torch.as_tensor(count, device=dev),
                                   {a: out[a] for a in payload_attrs})
    return out, emitted


class Tree:
    """The reference of a tree configuration: its members stepped frame by
    frame on ``device`` in the float type ``ft`` from the run's ``seed``,
    drawn with ``camera`` and ``raster`` (a configuration's ``raster``),
    the frames ``dt64`` seconds apart. ``render``: whether the traffic
    draws."""

    def __init__(self, members, seed: int, device, ft, camera: _plain.Camera, raster: dict,
                 dt64: float, render: bool) -> None:
        self.device, self.ft = torch.device(device), ft
        self.members = scene_order(members)
        self.camera, self.raster, self.render = camera, raster, render
        self.dt64 = dt64
        self.dt = float(np.float32(dt64))
        scene = np.random.default_rng(bench_inputs.seed_root(seed))
        self.rngs = {}
        for m in members:  # drawn in the order they are added
            self.rngs[m.name] = np.random.default_rng(int(scene.integers(0, 2**63)) + 1)
        self.payload = {m.name: tuple(sorted({a for c in members if c.parent == m.name
                                              for a in c.inherits})) for m in members}
        self.frame = 0
        self.pools = {m.name: _plain.empty_pool(m.capacity, self.device, ft) for m in members}
        self.events = {m.name: {} for m in members}

    @property
    def pool(self) -> Dict[str, Dict[str, torch.Tensor]]:
        out = {}
        for m in self.members:
            state = dict(self.pools[m.name])
            for ch, buf in sorted(self.events[m.name].items()):
                state.update({f"events{ch}.{k}": v for k, v in buf.items()})
            out[m.name] = state
        return out

    def load(self, state) -> None:
        for m in self.members:
            s = state[m.name]
            self.pools[m.name] = {k: v.to(self.device).to(self.ft) if v.is_floating_point()
                                  else v.to(self.device) for k, v in s.items()
                                  if not k.startswith("events")}
            events = {}
            for k, v in s.items():
                if k.startswith("events"):
                    ch, field = k[len("events"):].split(".", 1)
                    v = v.to(self.device)
                    if v.is_floating_point():
                        v = v.to(self.ft)
                    elif field in EVENT_FIELDS:
                        v = v.to(torch.int64)
                    events.setdefault(int(ch), {})[field] = v
            self.events[m.name] = events

    def _parent_events(self, m: Member, pending):
        buf = pending[m.parent].get(m.channel)
        if buf is None:
            parent = next(p for p in self.members if p.name == m.parent)
            buf = empty_events(parent.capacity, {a: self.pools[m.parent][a]
                                                 for a in self.payload[m.parent]})
        return buf

    def advance(self, frames: int, step: bool = True, render_at=()) -> Dict[int, torch.Tensor]:
        """Tick ``frames`` frames (stepping the members with ``step``); returns
        the images of the frames (by index in the stretch) in ``render_at``."""
        images = {}
        for j in range(frames):
            pending = self.events
            new = {}
            for m in self.members:
                requested = m.spawner.tick(self.dt64)[0] if m.spawner is not None else 0
                frame_seed = np.uint32(self.rngs[m.name].integers(0, 2**32))
                if not step:
                    continue
                events = None if m.parent is None else self._parent_events(m, pending)
                self.pools[m.name], new[m.name] = step_member(
                    self.pools[m.name], m, requested, events, frame_seed, self.dt, self.ft,
                    self.payload[m.name])
            if step:
                self.events = new
                if j in render_at:
                    images[j] = self.draw().float()
            self.frame += 1
        return images

    def draw(self) -> torch.Tensor:
        """The frame of the members' pools: one pass of one blend mode."""
        modes = {m.alpha_mode for m in self.members}
        if len(modes) != 1:
            raise NotImplementedError(f"the reference draws a tree of one blend mode, not {modes}")
        rot = _plain.camera_rotation(self.camera.view).to(self.device).to(self.ft)
        cols = {k: [] for k in ("position", "axis_x", "axis_y", "alive", "color")}
        for m in self.members:
            pool = self.pools[m.name]
            axis_x, axis_y, color = m.render(pool, rot, self.ft)
            for k, v in zip(cols, (pool["position"], axis_x, axis_y, pool["alive"], color)):
                cols[k].append(v)
        cols = {k: torch.cat(v) for k, v in cols.items()}
        mode = modes.pop()
        layer = _plain.rasterize(cols["position"], cols["axis_x"], cols["axis_y"], cols["alive"],
                                 cols["color"].contiguous(), self.camera, self.raster, self.ft,
                                 mode)
        return _plain.composite(layer, torch.zeros_like(layer), mode)
