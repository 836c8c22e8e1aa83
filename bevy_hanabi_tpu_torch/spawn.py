"""Spawner state machine (reference: src/spawn.rs).

Per-frame integer spawn counts are produced by a small host-side state
machine, exactly mirroring the reference's cycle algorithm
(``EffectSpawner::tick``, spawn.rs:838-921): cycles of
``{count, spawn_duration, period}`` resampled per cycle, fractional spawn
remainders accumulated across frames, multi-cycle catch-up when ``dt`` spans
cycle boundaries.

The host→device traffic this produces is one int per effect per frame (the
reference re-uploads a GpuSpawnerParams row per frame, render/mod.rs:2998).
For fleets of thousands of instances the vectorized :class:`SpawnerBank`
ticks every spawner in one numpy pass.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

from .cpu_value import CpuValue

__all__ = ["SpawnerSettings", "EffectSpawner", "SpawnerBank", "make_spawner_bank"]


def make_spawner_bank(settings: "SpawnerSettings", num_instances: int, seed: int = 0):
    """Best available bank for N same-settings spawners, chosen as the JAX
    package chooses it (spawn.py:28-40): the native (C++) bank of
    :mod:`.native` where ``g++`` is on ``PATH``, else the numpy one. Both
    tick the same counts for constant settings; for ``CpuValue.uniform``
    ones each draws its own random stream, and the native bank's streams
    are the JAX package's bit for bit."""
    from .native import NativeSpawnerBank, native_available

    if native_available():
        # a g++ that fails to build raises: a broken native bank is a bug
        # to surface, not a reason to run another bank's streams
        return NativeSpawnerBank(settings, num_instances, seed=seed)
    return SpawnerBank(settings, num_instances, seed=seed)


@dataclass(frozen=True)
class SpawnerSettings:
    """Declarative spawner configuration (spawn.rs:219-617)."""

    count: CpuValue = CpuValue.single(1.0)
    spawn_duration: CpuValue = CpuValue.single(0.0)
    period: CpuValue = CpuValue.single(0.0)
    cycle_count: int = 1  # 0 = forever
    starts_active: bool = True
    emit_on_start: bool = True

    def __post_init__(self):
        object.__setattr__(self, "count", _as_cpu(self.count))
        object.__setattr__(self, "spawn_duration", _as_cpu(self.spawn_duration))
        object.__setattr__(self, "period", _as_cpu(self.period))
        if self.cycle_count != 1:
            lo, hi = self.period.range()
            if lo < 0.0 or hi <= 0.0:
                raise ValueError(
                    f"period must be positive for multi-cycle spawners, got [{lo}, {hi}]"
                )

    # -- constructors (spawn.rs:408-472) ---------------------------------

    @staticmethod
    def once(count) -> "SpawnerSettings":
        """Spawn ``count`` particles immediately, once."""
        return SpawnerSettings(_as_cpu(count), CpuValue.single(0.0), CpuValue.single(0.0), 1)

    @staticmethod
    def rate(rate) -> "SpawnerSettings":
        """Spawn continuously at ``rate`` particles/second."""
        return SpawnerSettings(_as_cpu(rate), CpuValue.single(1.0), CpuValue.single(1.0), 0)

    @staticmethod
    def burst(count, period) -> "SpawnerSettings":
        """Spawn ``count`` particles every ``period`` seconds."""
        return SpawnerSettings(_as_cpu(count), CpuValue.single(0.0), _as_cpu(period), 0)

    def is_once(self) -> bool:
        return self.cycle_count == 1

    def is_forever(self) -> bool:
        return self.cycle_count == 0

    def with_starts_active(self, active: bool) -> "SpawnerSettings":
        return replace(self, starts_active=active)

    def with_emit_on_start(self, emit: bool) -> "SpawnerSettings":
        return replace(self, emit_on_start=emit)

    # -- serde -------------------------------------------------------------

    def to_json(self):
        return {
            "count": self.count.to_json(),
            "spawn_duration": self.spawn_duration.to_json(),
            "period": self.period.to_json(),
            "cycle_count": self.cycle_count,
            "starts_active": self.starts_active,
            "emit_on_start": self.emit_on_start,
        }

    @staticmethod
    def from_json(data) -> "SpawnerSettings":
        return SpawnerSettings(
            CpuValue.from_json(data["count"]),
            CpuValue.from_json(data["spawn_duration"]),
            CpuValue.from_json(data["period"]),
            data.get("cycle_count", 1),
            data.get("starts_active", True),
            data.get("emit_on_start", True),
        )


def _as_cpu(v) -> CpuValue:
    return v if isinstance(v, CpuValue) else CpuValue.single(float(v))


class EffectSpawner:
    """Runtime spawner state for one effect instance (spawn.rs:646).

    ``tick(dt, rng)`` returns the integral number of particles to spawn this
    frame; the fractional remainder carries over (spawn.rs:916-921).
    """

    def __init__(self, settings: SpawnerSettings, rng: Optional[np.random.Generator] = None):
        self.settings = settings
        self.rng = rng if rng is not None else np.random.default_rng()
        self.cycle_time = 0.0
        self.sampled_period = 0.0
        self.sampled_spawn_duration = 0.0
        self.sampled_count = 0.0
        self.spawn_remainder = 0.0
        self.spawn_count = 0
        # emit_on_start=False starts a finite-cycle spawner at its last
        # cycle, so it emits nothing until reset(); forever spawners ignore
        # the flag (spawn.rs:703-710).
        self.completed_cycle_count = (
            0
            if settings.emit_on_start or settings.is_forever()
            else settings.cycle_count
        )
        self.active = settings.starts_active

    # -- control (spawn.rs:762-835) ---------------------------------------

    def set_active(self, active: bool) -> None:
        self.active = active

    def is_active(self) -> bool:
        return self.active

    def reset(self) -> None:
        """Restart the spawner from the beginning (spawn.rs:814)."""
        self.cycle_time = 0.0
        self.sampled_period = 0.0
        self.sampled_spawn_duration = 0.0
        self.sampled_count = 0.0
        self.spawn_remainder = 0.0
        self.spawn_count = 0
        self.completed_cycle_count = 0

    def retarget(self, settings: SpawnerSettings) -> None:
        """Swap in new settings from a hot-reloaded asset without losing
        runtime state: the fractional remainder, completed-cycle count,
        RNG stream, and active flag carry over; the current cycle's
        sampled values are discarded so the new settings take effect at
        the next tick instead of after the old cycle drains. (The
        reference keeps EffectSpawner state across compile_effects too —
        the component outlives asset edits.)

        Exception: a FOREVER spawner's completed-cycle tally (one per
        elapsed period) is meaningless under a finite schedule — carrying
        it over would leave e.g. a rate→once edit permanently spent — so
        crossing forever→finite restarts the cycle count per the new
        settings' emit_on_start, exactly as construction would."""
        if self.settings.is_forever() and not settings.is_forever():
            self.completed_cycle_count = (
                0 if settings.emit_on_start else settings.cycle_count
            )
        self.settings = settings
        self.cycle_time = 0.0
        self.sampled_period = 0.0
        self.sampled_spawn_duration = 0.0
        self.sampled_count = 0.0
        self.spawn_count = 0

    # -- tick (spawn.rs:838-921, mirrored control flow) --------------------

    def tick(self, dt: float) -> int:
        s = self.settings
        if not self.active or (
            not s.is_forever() and self.completed_cycle_count >= s.cycle_count
        ):
            self.spawn_count = 0
            return 0

        while True:
            # New cycle: resample the CpuValues.
            if self.sampled_period == 0.0:
                if s.is_once():
                    self.sampled_spawn_duration = float(s.spawn_duration.sample(self.rng))
                    self.sampled_period = max(self.sampled_spawn_duration, 1e-12)
                else:
                    self.sampled_period = float(s.period.sample(self.rng))
                    assert self.sampled_period > 0.0
                    self.sampled_spawn_duration = float(
                        np.clip(s.spawn_duration.sample(self.rng), 0.0, self.sampled_period)
                    )
                # (the reference resamples spawn_duration twice; keep one)
                self.sampled_count = max(float(s.count.sample(self.rng)), 0.0)

            new_time = self.cycle_time + dt

            if self.cycle_time <= self.sampled_spawn_duration:
                if self.sampled_spawn_duration < max(1e-5, dt / 100.0):
                    # Near-zero duration: burst everything this frame.
                    self.spawn_remainder += self.sampled_count
                else:
                    ratio = (
                        min(new_time, self.sampled_spawn_duration) - self.cycle_time
                    ) / self.sampled_spawn_duration
                    self.spawn_remainder += self.sampled_count * float(
                        np.clip(ratio, 0.0, 1.0)
                    )

            self.cycle_time = new_time

            if self.cycle_time >= self.sampled_period:
                dt = self.cycle_time - self.sampled_period
                self.cycle_time = 0.0
                self.completed_cycle_count += 1
                self.sampled_period = 0.0  # needs resampling
                if not s.is_forever() and self.completed_cycle_count >= s.cycle_count:
                    break
            else:
                break

        count = float(np.floor(self.spawn_remainder))
        self.spawn_remainder -= count
        self.spawn_count = int(count)
        return self.spawn_count


class SpawnerBank:
    """Vectorized spawners for many instances of the same settings.

    Equivalent of the reference's ``tick_spawners`` system (spawn.rs:946)
    looping over ECS entities, but as one numpy pass over ``[I]`` state
    arrays — the natural layout when instances are a batched axis on TPU.
    Only constant-valued settings are vectorized; CpuValue::Uniform settings
    fall back to per-instance :class:`EffectSpawner`.
    """

    def __init__(self, settings: SpawnerSettings, num_instances: int, seed: int = 0):
        self.settings = settings
        self.n = num_instances
        s = settings
        if any(v.is_uniform for v in (s.count, s.spawn_duration, s.period)):
            root = np.random.default_rng(seed)
            self._spawners = [
                EffectSpawner(s, rng=np.random.default_rng(root.integers(0, 2**63)))
                for _ in range(num_instances)
            ]
            self._vector = False
            return
        self._vector = True
        self.count = float(s.count.value)
        if s.is_once():
            self.spawn_duration = float(s.spawn_duration.value)
            self.period = max(self.spawn_duration, 1e-12)
        else:
            self.period = float(s.period.value)
            self.spawn_duration = float(np.clip(s.spawn_duration.value, 0.0, self.period))
        self.cycle_time = np.zeros(num_instances, np.float64)
        self.remainder = np.zeros(num_instances, np.float64)
        # Same emit_on_start rule as EffectSpawner (spawn.rs:703-710).
        start_cycles = (
            0 if s.emit_on_start or s.is_forever() else s.cycle_count
        )
        self.completed_cycles = np.full(num_instances, start_cycles, np.int64)
        self.active = np.full(num_instances, s.starts_active)

    def reset(self, idx=None) -> None:
        if not self._vector:
            for sp in self._spawners if idx is None else [self._spawners[idx]]:
                sp.reset()
            return
        sl = slice(None) if idx is None else idx
        self.cycle_time[sl] = 0.0
        self.remainder[sl] = 0.0
        self.completed_cycles[sl] = 0

    def set_active(self, active: bool, index: int = -1) -> None:
        """Activate or pause every spawner (``index`` < 0) or one, as the
        native bank does (native/src/hanabi_native.cpp:
        hanabi_spawner_bank_set_active)."""
        if not self._vector:
            for sp in self._spawners if index < 0 else [self._spawners[index]]:
                sp.set_active(active)
            return
        self.active[slice(None) if index < 0 else index] = active

    def tick(self, dt: float) -> np.ndarray:
        """Tick all spawners; returns int32[I] spawn counts."""
        if not self._vector:
            return np.asarray([sp.tick(dt) for sp in self._spawners], np.int32)

        s = self.settings
        done = (
            np.zeros(self.n, bool)
            if s.is_forever()
            else self.completed_cycles >= s.cycle_count
        )
        live = self.active & ~done
        dt_left = np.where(live, dt, 0.0)

        # A frame can span multiple cycles; loop until all dt consumed.
        # Bounded iterations guard against pathological dt >> period.
        # ``proc`` marks the lanes still processing a cycle this frame:
        # every live lane processes its FIRST iteration even at dt == 0
        # (the scalar path and spawn.rs:838-921 emit a near-zero-duration
        # burst on a zero-dt tick), then only rolled-over lanes continue.
        proc = live.copy()
        for _ in range(64):
            if not proc.any():
                break
            in_window = self.cycle_time <= self.spawn_duration
            new_time = self.cycle_time + dt_left
            # The burst threshold uses the PER-CYCLE leftover dt, like the
            # scalar path which rebinds dt each cycle (spawn.rs:878).
            burst = self.spawn_duration < np.maximum(1e-5, dt_left / 100.0)
            ratio = np.clip(
                (np.minimum(new_time, self.spawn_duration) - self.cycle_time)
                / max(self.spawn_duration, 1e-300),
                0.0,
                1.0,
            )
            gain = np.where(
                proc & in_window,
                np.where(burst, self.count, self.count * ratio),
                0.0,
            )
            self.remainder += gain
            self.cycle_time = np.where(proc, new_time, self.cycle_time)
            rolled = proc & (self.cycle_time >= self.period)
            dt_left = np.where(rolled, self.cycle_time - self.period, 0.0)
            self.cycle_time = np.where(rolled, 0.0, self.cycle_time)
            self.completed_cycles += rolled
            proc = rolled
            if not s.is_forever():
                newly_done = self.completed_cycles >= s.cycle_count
                dt_left = np.where(newly_done, 0.0, dt_left)
                proc &= ~newly_done

        counts = np.floor(self.remainder)
        self.remainder -= counts
        return counts.astype(np.int32)
