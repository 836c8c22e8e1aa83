"""Scene checkpoint/resume (port of ``bevy_hanabi_tpu/utils/checkpoint.py``).

The reference cannot checkpoint simulation state at all: particles live
only in GPU buffers. A scene checkpoint here is a single npz in the JAX
package's layout and meta: every effect's particle pool, spawner state and
in-flight spawn events, the numpy RNG streams, and the simulation clock.
Arrays are written in the JAX package's dtypes (the port's int64 carriers
of uint32 values as uint32), so a checkpoint either package wrote loads in
the other; tensors go to numpy on save and back to the scene's device on
load. A sharded effect's pool is saved assembled and split over its mesh
again on load.
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING

import numpy as np

from ..ops import rng as _rng
from ..runtime.events import EventBuffer
from ..runtime.pool import ParticlePool, to_device

if TYPE_CHECKING:
    from ..runtime.scene import HanabiScene

__all__ = ["save_scene_state", "load_scene_state"]


def _host(t) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.astype(np.uint32) if t.dtype == _rng.U32 else a


def save_scene_state(scene: "HanabiScene", path: str) -> None:
    arrays = {}
    # the RNG streams belong to the checkpoint, or a resumed run diverges
    # from an uninterrupted one (CpuValue resampling, per-frame seeds)
    meta = {"effects": [], "rng": {"scene": scene._rng.bit_generator.state}, "clock": {
        "time": scene.clock._time,
        "virtual_time": scene.clock._virtual_time,
        "real_time": scene.clock._real_time,
        "speed": scene.clock._speed,
        "paused": scene.clock._paused,
    }}
    for inst in scene.effects():
        key = inst.name
        meta["effects"].append(key)
        if inst.rng is not None:
            meta["rng"][f"{key}/frame"] = inst.rng.bit_generator.state
        if inst.spawner is not None:
            meta["rng"][f"{key}/spawner"] = inst.spawner.rng.bit_generator.state
        attrs, alive, seed, counter = inst.pool.to_numpy()
        for aname, arr in attrs.items():
            arrays[f"{key}/attr:{aname}"] = arr
        arrays[f"{key}/alive"] = alive
        arrays[f"{key}/seed"] = seed
        arrays[f"{key}/counter"] = counter
        if inst.spawner is not None:
            sp = inst.spawner
            arrays[f"{key}/spawner"] = np.asarray(
                [
                    sp.cycle_time,
                    sp.sampled_period,
                    sp.sampled_spawn_duration,
                    sp.sampled_count,
                    sp.spawn_remainder,
                    float(sp.completed_cycle_count),
                    1.0 if sp.active else 0.0,
                ]
            )
        # in-flight spawn events (emitted last frame, consumed next frame):
        # dropping them would silently lose the children they request
        for chan, ev in (inst.last_events or {}).items():
            base = f"{key}/event:{chan}"
            arrays[f"{base}/parent_slot"] = _host(ev.parent_slot)
            arrays[f"{base}/count"] = _host(ev.count)
            arrays[f"{base}/num_events"] = _host(ev.num_events)
            for pname, parr in ev.payload.items():
                arrays[f"{base}/payload:{pname}"] = _host(parr)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_scene_state(scene: "HanabiScene", path: str) -> None:
    """Restore pools, spawners, events, RNG streams and the clock into an
    already-built scene (same assets), on the scene's device."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    meta = json.loads(bytes(data["__meta__"]).decode())
    dev = scene.device

    def tensor(k):
        return to_device(data[k], dev)

    for key in meta["effects"]:
        inst = scene[key]
        # the whole pool, then split over the effect's mesh where it has one
        inst.pool = inst.fx.place_pool(ParticlePool(
            {a.name: tensor(f"{key}/attr:{a.name}") for a in inst.fx.layout.storage_attributes()},
            tensor(f"{key}/alive"), tensor(f"{key}/seed"), tensor(f"{key}/counter"),
        ))
        events: dict = {}
        prefix = f"{key}/event:"
        for k in data.files:
            if not k.startswith(prefix) or not k.endswith("/parent_slot"):
                continue
            chan = int(k[len(prefix):].split("/")[0])
            base = f"{prefix}{chan}"
            payload = {
                pk[len(base) + len("/payload:"):]: tensor(pk)
                for pk in data.files
                if pk.startswith(f"{base}/payload:")
            }
            events[chan] = EventBuffer(
                tensor(f"{base}/parent_slot"),
                tensor(f"{base}/count"),
                tensor(f"{base}/num_events"),
                payload,
            )
        inst.last_events = events
        if inst.spawner is not None and f"{key}/spawner" in data:
            s = data[f"{key}/spawner"]
            sp = inst.spawner
            sp.cycle_time = float(s[0])
            sp.sampled_period = float(s[1])
            sp.sampled_spawn_duration = float(s[2])
            sp.sampled_count = float(s[3])
            sp.spawn_remainder = float(s[4])
            sp.completed_cycle_count = int(s[5])
            sp.active = bool(s[6])
        rng_meta = meta.get("rng", {})
        if inst.rng is not None and f"{key}/frame" in rng_meta:
            inst.rng.bit_generator.state = rng_meta[f"{key}/frame"]
        if inst.spawner is not None and f"{key}/spawner" in rng_meta:
            inst.spawner.rng.bit_generator.state = rng_meta[f"{key}/spawner"]
    if "scene" in meta.get("rng", {}):
        scene._rng.bit_generator.state = meta["rng"]["scene"]
    clk = meta["clock"]
    scene.clock._time = clk["time"]
    scene.clock._virtual_time = clk["virtual_time"]
    scene.clock._real_time = clk["real_time"]
    scene.clock._speed = clk["speed"]
    scene.clock._paused = clk["paused"]
