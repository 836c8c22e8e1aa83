"""Multi-device rendering of sharded particle pools
(port of ``bevy_hanabi_tpu/parallel/render.py``).

A :class:`~.mesh.ShardedEffect`'s pools lie on the devices of its mesh
(instances over ``dp``, the particle axis over ``sp``); rasterization is the
one step that needs data of other shards. One process drives every shard,
and what the JAX package's collectives move is an explicit copy or sum here.
Three strategies:

* **psum**, exact for additive blending (``AlphaMode.ADD``): every shard
  extracts and rasterizes only its own particles onto a transparent
  framebuffer on its device; the partial images are summed on the output
  device, then the background is added and alpha clamped. Particle data
  never leaves its shard.
* **slice**, exact for every blend mode with memory per device in
  proportion to its shard: the framebuffer is cut into D horizontal slices,
  one per device. Each shard extracts its particles, routes each draw entry
  to the slice(s) its screen bbox touches (:func:`route_keys` and
  :func:`route_window` on the source, then :func:`deliver`'s one copy per
  (source, destination) pair: the ``all_to_all``), and each destination
  rasterizes its slice
  (``rasterize(y_offset=)``) with full depth ordering; the slices are
  stacked on the output device. Ribbons route by ribbon id first, so each
  device sorts and connects whole trails, and their segments then route by
  slice; triangle meshes expand locally before the slice route.
* **gather**: the draw data of every shard, reassembled in the natural
  ``[I, N]`` order on the output device, rasterized once there.

``mode="auto"`` takes psum for additive quad effects and slice otherwise.
Extraction always runs on each shard's device and sees the shard's own
lanes (its ``PARTICLE_INDEX`` is the lane's index in its shard, as under the
JAX package's ``shard_map``).

Slice routing capacity: a destination accepts at most ``_route_cap``
entries of each source (``slice_capacity_factor x 2 x local entries / D``
rounded up to 256); entries past it are dropped, and an entry spanning more
than two slices loses its middle ones. A tile overflowing
``max_entries_per_tile`` keeps a different subset under psum (per shard) and
slice (per slice) than on one device; all three modes equal the single-device
render when no tile overflows.

The route's window is the rasterizer's window gather
(:func:`~..ops.gather.gather_window`, the port of the TPU row gather) with
destinations in place of tiles; the sort is ``torch.sort`` of the JAX
package's 32-bit key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..compiler import SimParams
from ..ops.gather import gather_window
from ..render.extract import ParticleDrawData, extract_draw_data, flatten_instance_axis
from ..render.mesh import expand_mesh_draw
from ..render.raster import RasterConfig, rasterize, texture_tensor
from ..render.ribbon import build_ribbon_segments
from ..runtime.pool import to_device
from .mesh import ShardedEffect

__all__ = ["ShardedRenderer", "route_keys", "route_window", "deliver", "slice_destinations"]

# Draw fields routable between devices, packed as f32 rows; the 32-bit
# integer fields travel bit-cast so every bit survives the trip.
_INT_FIELDS = {"sprite_index", "ribbon_id", "counter"}

_RIBBON_FIELDS = ("position", "axis_x", "axis_y", "color", "alive", "roundness",
                  "sprite_index", "alpha_cutoff", "ribbon_id", "age", "counter")
_SLICE_FIELDS = ("position", "axis_x", "axis_y", "color", "alive", "roundness",
                 "sprite_index", "alpha_cutoff", "tri", "uv_abc", "nrm_abc", "vcol_abc")


def _pack_draw(draw: ParticleDrawData, fields):
    """The present ``fields`` of ``draw`` as ``([N, F] f32, schema)``
    (render.py:98-120): bools as 0/1, the integer fields bit-cast."""
    cols, schema = [], []
    for name in fields:
        arr = getattr(draw, name)
        if arr is None:
            continue
        a2 = arr[:, None] if arr.dim() == 1 else arr
        if name == "alive":
            a2, kind = a2.to(torch.float32), "bool"
        elif name in _INT_FIELDS:
            kind = "i32" if arr.dtype == torch.int32 else "u32"
            if kind == "u32":  # an int64 carrier of uint32 values: its low word
                a2 = torch.where(a2 >= 2**31, a2 - 2**32, a2).to(torch.int32)
            a2 = a2.contiguous().view(torch.float32)
        else:
            a2, kind = a2.to(torch.float32), "f32"
        schema.append((name, arr.dim(), a2.shape[1], kind))
        cols.append(a2)
    return torch.cat(cols, dim=1).contiguous(), schema


def _unpack_draw(rows, schema, meta) -> ParticleDrawData:
    """Inverse of :func:`_pack_draw`; ``meta`` carries the static fields."""
    out: Dict[str, Any] = dict(meta)
    off = 0
    for name, nd, w, kind in schema:
        sl = rows[:, off:off + w]
        off += w
        if kind == "bool":
            val = sl > 0.5
        elif kind == "f32":
            val = sl
        else:
            val = sl.contiguous().view(torch.int32)
            if kind == "u32":
                val = val.to(torch.int64) & 0xFFFFFFFF
        out[name] = (val[:, 0] if nd == 1 else val).contiguous()
    return ParticleDrawData(**out)


def route_keys(dest0: torch.Tensor, dest1: torch.Tensor, n_dev: int):
    """Sort a source's entries into per-destination runs (render.py:163-186).

    ``dest0`` / ``dest1`` int [N] in ``[0, D]`` (``D`` drops the entry);
    entry ``e`` of the ``2N`` is row ``e mod N``'s ``e // N``-th destination.
    Returns ``(entries int64 [2N] sorted by destination, then entry;
    starts, ends int64 [D])``. The key is JAX's ``(dest << idx_bits) | e``,
    sorted as int32 with the sign bit flipped (the unsigned order); where
    it does not fit 32 bits, a stable sort of the destinations carries the
    entry ids (JAX's two-key fallback)."""
    dev = dest0.device
    n2 = 2 * dest0.shape[0]
    dests = torch.cat([dest0, dest1]).to(torch.int64)
    idx_bits = max(1, int(np.ceil(np.log2(max(n2, 2)))))
    dev_bits = max(1, int(np.ceil(np.log2(n_dev + 2))))
    if idx_bits + dev_bits <= 32:
        key = (dests << idx_bits) | torch.arange(n2, dtype=torch.int64, device=dev)
        key32 = torch.sort((key - 2**31).to(torch.int32)).values
        bound = (torch.arange(n_dev + 1, dtype=torch.int64, device=dev) << idx_bits) - 2**31
        r = torch.searchsorted(key32, bound.to(torch.int32))
        entries = (key32.to(torch.int64) + 2**31) & ((1 << idx_bits) - 1)
    else:
        key_sorted, entries = torch.sort(dests, stable=True)
        r = torch.searchsorted(key_sorted, torch.arange(n_dev + 1, dtype=torch.int64, device=dev))
    return entries, r[:-1].contiguous(), r[1:].contiguous()


def route_window(rows, entries, starts, ends, cap: int) -> torch.Tensor:
    """Each destination's first ``cap`` entries as rows, with a validity
    column appended: ``[D, cap, F + 1]`` (render.py:173-194), through the
    rasterizer's window gather (entry ``e`` reads row ``e mod N``)."""
    window, has = gather_window(rows, entries, starts, ends, cap, from_start=True)
    return torch.cat([window, has[..., None].to(torch.float32)], dim=-1)


def deliver(sends, devices):
    """The ``all_to_all``: destination ``t`` gets every source's ``sends[src][t]``
    in source order, on ``devices[t]``; returns ``(rows [D * cap, F],
    valid [D * cap])`` for each destination."""
    out = []
    for t, dev in enumerate(devices):
        recv = torch.cat([send[t].to(dev) for send in sends])
        out.append((recv[:, :-1], recv[:, -1] > 0.5))
    return out


def _screen(camera, p: torch.Tensor):
    """World [N, 3] -> (x, y) viewport pixels and the view distance, in the
    f32 op order of raster.py:148-176."""
    from ..ops.linalg import mat4_mul

    view = torch.as_tensor(np.asarray(camera.view, np.float32)).to(p.device)
    mvp = mat4_mul(torch.as_tensor(np.asarray(camera.proj, np.float32)).to(p.device), view)
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]

    def row(m, i):
        return m[i, 0] * px + m[i, 1] * py + m[i, 2] * pz + m[i, 3]

    view_z = row(view, 2)
    cx, cy, w = row(mvp, 0), row(mvp, 1), row(mvp, 3)
    safe_w = torch.where(torch.abs(w) < 1e-6, 1e-6, w)
    width, height = camera.viewport
    x = (cx / safe_w * 0.5 + 0.5) * width
    y = (1.0 - (cy / safe_w * 0.5 + 0.5)) * height
    return x, y, -view_z


def _slice_of(y: torch.Tensor, slice_h: int, n_dev: int) -> torch.Tensor:
    """``clip(floor(y / slice_h), 0, D - 1)`` as int64 (NaN to 0)."""
    return torch.clamp(torch.floor(y / slice_h), 0, n_dev - 1).nan_to_num(0.0).to(torch.int64)


def slice_destinations(draw: ParticleDrawData, camera, config: RasterConfig, n_dev: int):
    """The slice(s) each entry's screen bbox touches (render.py:345-375):
    ``(dest0, dest1)`` int64 [N], ``D`` where none. An entry spanning more
    than two slices goes to its first two (a taller splat loses its middle
    slices, as ``RasterConfig.tile_span`` crops)."""
    H, W = config.height, config.width
    slice_h = H // n_dev
    cx, cy, dist = _screen(camera, draw.position)
    x1, y1, _ = _screen(camera, draw.position + 0.5 * draw.axis_x)
    x2, y2, _ = _screen(camera, draw.position + 0.5 * draw.axis_y)
    rx = torch.abs(x1 - cx) + torch.abs(x2 - cx)
    ry = torch.abs(y1 - cy) + torch.abs(y2 - cy)
    if draw.tri is not None:
        half = torch.where(draw.tri > 0.5, 0.5, 1.0)
        rx = rx * half
        ry = ry * half
    ok = draw.alive & (dist > 1e-4)
    ok &= (cx + rx > 0) & (cx - rx < W) & (cy + ry > 0) & (cy - ry < H)
    s0 = _slice_of(cy - ry, slice_h, n_dev)
    s1 = _slice_of(cy + ry, slice_h, n_dev)
    dest0 = torch.where(ok, s0, n_dev)
    dest1 = torch.where(ok & (s1 > s0), torch.clamp(s0 + 1, max=n_dev - 1), n_dev)
    return dest0, dest1


class ShardedRenderer:
    """Renders a :class:`~.mesh.ShardedEffect`'s pools from its mesh.

    GLOBAL simulation-space effects. Quads work in every mode; ribbons and
    triangle meshes need ``mode="slice"`` ("auto" takes it for them).
    Images come out on the effect's device."""

    def __init__(
        self,
        effect: ShardedEffect,
        config: RasterConfig,
        textures: Sequence[Any] = (),
        mode: str = "auto",
        slice_capacity_factor: float = 4.0,
    ) -> None:
        if mode not in ("auto", "psum", "gather", "slice"):
            raise ValueError(f"unknown mode {mode!r}")
        asset = effect.effect.asset
        alpha = asset.alpha_mode.kind
        has_ribbons = asset.particle_layout().contains("ribbon_id")
        if mode == "auto":
            mode = "psum" if alpha == "add" and not has_ribbons else "slice"
        if mode == "psum" and alpha != "add":
            raise ValueError(
                f"psum compositing is only exact for additive blending, "
                f"asset uses {alpha!r}; use mode='slice'"
            )
        if mode in ("psum", "gather") and (has_ribbons or asset.mesh is not None):
            raise ValueError(
                "psum/gather sharded rendering supports quad effects only; "
                "use mode='slice' (or 'auto') for ribbons and meshes"
            )
        self.slice_capacity_factor = float(slice_capacity_factor)
        if mode == "slice" and config.height % effect.mesh.size:
            raise ValueError(
                f"slice mode needs a height ({config.height}) divisible "
                f"by the device count ({effect.mesh.size})"
            )
        self.effect = effect
        self.asset = asset
        self.mesh = effect.mesh
        self.config = config
        self.mode = mode
        self.textures = tuple(textures)
        self._device_textures: Dict[torch.device, tuple] = {}
        self._alpha_mode = alpha
        self._ribbons = has_ribbons

    def _textures_on(self, device) -> tuple:
        texs = self._device_textures.get(device)
        if texs is None:
            texs = tuple(texture_tensor(t, device) for t in self.textures)
            self._device_textures[device] = texs
        return texs

    def _route_cap(self, n: int, n_dev: int) -> int:
        """Per-destination routing capacity for n local entries (render.py:260-263)."""
        cap = int(np.ceil(2 * n * self.slice_capacity_factor / n_dev))
        return max(256, min(2 * n, -(-cap // 256) * 256))

    def _extract(self, pool, camera, sim, properties) -> ParticleDrawData:
        """One shard's ``[I/dp, N/sp]`` pools extracted on its device, every
        lane with the shared ``properties``."""
        dev = pool.device
        flat = pool.flatten()
        n = flat.capacity
        per_lane = {}
        for k, v in properties.items():
            t = v.to(dev) if isinstance(v, torch.Tensor) else to_device(np.asarray(v), dev)
            per_lane[k] = t.expand((n,) + tuple(t.shape))
        return extract_draw_data(self.asset, flat, camera, sim=sim, properties=per_lane,
                                 textures=list(self._textures_on(dev)),
                                 instances=pool.alive.shape[0])

    # -- the three modes ----------------------------------------------------

    def _psum(self, pools, camera, sim, properties, scene_depth, config):
        """render.py:425-439."""
        out_dev = self.effect.device
        cfg = dataclasses.replace(config, background=(0.0, 0.0, 0.0, 0.0))
        total = None
        for p in pools.flat:
            dev = p.device
            img = rasterize(
                self._extract(p, camera, sim, properties), camera, cfg, alpha_mode="add",
                textures=list(self._textures_on(dev)),
                scene_depth=None if scene_depth is None else scene_depth.to(dev),
            ).to(out_dev)
            total = img if total is None else total + img
        bg = torch.tensor(config.background, dtype=torch.float32, device=out_dev)
        rgb = total[..., :3] + bg[:3]
        alpha = torch.clamp(total[..., 3:4] + bg[3], max=1.0)
        return torch.cat([rgb, alpha], dim=-1)

    def _gather(self, pools, camera, sim, properties, scene_depth, config, return_depth):
        """render.py:440-455: the shards' draw data in natural ``[I, N]``
        order (the ``sp`` shards side by side on the particle axis, the
        ``dp`` rows on the instance axis), then one rasterization."""
        out_dev = self.effect.device
        grid = [[self._extract(p, camera, sim, properties) for p in row] for row in pools.shards]
        first = grid[0][0]
        fields = {}
        for f in dataclasses.fields(ParticleDrawData):
            if not isinstance(getattr(first, f.name), torch.Tensor):
                continue
            fields[f.name] = torch.cat([
                torch.cat([
                    getattr(d, f.name).to(out_dev).reshape(
                        (p.alive.shape[0], p.alive.shape[1]) + tuple(getattr(d, f.name).shape[1:]))
                    for d, p in zip(drow, prow)
                ], dim=1)
                for drow, prow in zip(grid, pools.shards)
            ])
        flat = flatten_instance_axis(dataclasses.replace(first, **fields))
        return rasterize(flat, camera, config, alpha_mode=self._alpha_mode,
                         textures=list(self._textures_on(out_dev)),
                         scene_depth=None if scene_depth is None else scene_depth.to(out_dev),
                         return_depth=return_depth)

    def _routed(self, draws, fields, dests, meta):
        """Route each source's packed ``fields`` to the destinations
        ``dests[src]`` = (dest0, dest1) names and unpack what each
        destination receives, dead where the slot was empty."""
        devices = self.mesh.flat_devices()
        n_dev = len(devices)
        sends = []
        schema = None
        for draw, (d0, d1) in zip(draws, dests):
            rows, schema = _pack_draw(draw, fields)
            entries, starts, ends = route_keys(d0, d1, n_dev)
            sends.append(route_window(rows, entries, starts, ends,
                                      self._route_cap(rows.shape[0], n_dev)))
        out = []
        for rows, valid in deliver(sends, devices):
            d = _unpack_draw(rows, schema, meta)
            out.append(dataclasses.replace(d, alive=d.alive & valid))
        return out

    def slice_draws(self, pools, camera, sim, properties, config) -> list:
        """render.py:265-397 up to the slices' rasterization: each shard's
        extracted draw (ribbons routed by composite id and connected into
        segments on their device, meshes expanded) routed to the slices its
        entries touch. Returns each destination's received draw, on its
        device, dead where a slot was empty."""
        devices = self.mesh.flat_devices()
        n_dev = len(devices)
        il = self.effect.num_instances // self.mesh.shape["dp"]
        draws = [self._extract(p, camera, sim, properties) for p in pools.flat]
        meta = dict(sprite_grid_size=draws[0].sprite_grid_size,
                    texture_layers=draws[0].texture_layers,
                    needs_uv=draws[0].needs_uv, lighting=draws[0].lighting)
        if self._ribbons:
            # Distributed ribbon pass: every particle of composite ribbon r
            # (rid * I + the lane's global instance, so trails of different
            # instances stay apart) goes to device r mod D, which then holds
            # whole trails and connects them; the segments route by slice.
            dests = []
            sp = self.mesh.shape["sp"]
            for j, draw in enumerate(draws):
                dev = draw.position.device
                n_loc = draw.position.shape[0]
                n_per = max(n_loc // max(il, 1), 1)
                g_inst = (j // sp) * il + torch.arange(n_loc, dtype=torch.int64, device=dev) // n_per
                comp = (draw.ribbon_id * self.effect.num_instances + g_inst) & 0xFFFFFFFF
                draws[j] = dataclasses.replace(draw, ribbon_id=comp)
                dest = torch.where(draw.alive, comp % n_dev, n_dev)
                dests.append((dest, torch.full_like(dest, n_dev)))
            received = self._routed(draws, _RIBBON_FIELDS, dests, meta)
            draws = [build_ribbon_segments(r, camera) for r in received]
        elif self.asset.mesh is not None:
            draws = [expand_mesh_draw(d, self.asset.mesh) for d in draws]
            meta["lighting"] = draws[0].lighting
        dests = [slice_destinations(d, camera, config, n_dev) for d in draws]
        return self._routed(draws, _SLICE_FIELDS, dests, meta)

    def _slice(self, pools, camera, sim, properties, scene_depth, config, return_depth):
        """render.py:265-409: image-space decomposition, one horizontal
        slice of the framebuffer a device (``rasterize(y_offset=)``), the
        slices stacked on the output device."""
        devices = self.mesh.flat_devices()
        slice_h = config.height // len(devices)
        received = self.slice_draws(pools, camera, sim, properties, config)
        out_dev = self.effect.device
        cfg = dataclasses.replace(config, height=slice_h)
        imgs, deps = [], []
        for t, (sdraw, dev) in enumerate(zip(received, devices)):
            sd = None
            if scene_depth is not None:
                sd = scene_depth[t * slice_h:(t + 1) * slice_h].to(dev)
            out = rasterize(sdraw, camera, cfg, alpha_mode=self._alpha_mode,
                            textures=list(self._textures_on(dev)), scene_depth=sd,
                            return_depth=return_depth, y_offset=float(t * slice_h))
            img, dep = out if return_depth else (out, None)
            imgs.append(img.to(out_dev))
            if return_depth:
                deps.append(dep.to(out_dev))
        img = torch.cat(imgs)
        return (img, torch.cat(deps)) if return_depth else img

    def render(
        self,
        pools,
        camera,
        sim: SimParams = None,
        properties: Optional[Dict[str, Any]] = None,
        scene_depth=None,
        return_depth: bool = False,
    ):
        """Rasterize the sharded pools into one [H, W, 4] image on the
        effect's device (render.py:457-520).

        ``scene_depth`` ([H, W]) occludes fragments behind external scene
        geometry on every shard (the depth test is per fragment, so the
        psum's partial images stay exact under it). ``return_depth=True``
        (opaque and mask assets, slice or gather mode) also returns the
        depth plane."""
        if return_depth and self.mode == "psum":
            raise ValueError(
                "return_depth requires slice or gather mode (additive psum "
                "effects never write depth)"
            )
        sim = sim if sim is not None else SimParams()
        properties = properties or {}
        vw, vh = camera.viewport
        config = self.config
        if (config.width, config.height) != (vw, vh):
            if self.mode == "slice" and vh % self.mesh.size:
                raise ValueError(
                    f"slice mode needs a viewport height ({vh}) "
                    f"divisible by the device count ({self.mesh.size})"
                )
            # the raster grid follows the camera viewport, as EffectRenderer's
            config = dataclasses.replace(config, width=vw, height=vh)
        if scene_depth is not None:
            scene_depth = torch.as_tensor(scene_depth, dtype=torch.float32)
        if self.mode == "psum":
            return self._psum(pools, camera, sim, properties, scene_depth, config)
        if self.mode == "gather":
            return self._gather(pools, camera, sim, properties, scene_depth, config, return_depth)
        return self._slice(pools, camera, sim, properties, scene_depth, config, return_depth)
