"""Effect simulation clock (reference: src/time.rs).

``Time<EffectSimulation>``: a pausable clock with a relative speed factor,
derived from the virtual clock. Produces the per-frame
:class:`~bevy_hanabi_tpu_torch.compiler.SimParams` consumed by the step —
pure host state (copy of ``bevy_hanabi_tpu/time.py``).
"""

from __future__ import annotations

from .compiler import SimParams

__all__ = ["EffectSimulationClock"]


class EffectSimulationClock:
    """Pausable, speed-scaled simulation clock (time.rs:31-164)."""

    def __init__(self) -> None:
        self._time = 0.0
        self._delta = 0.0
        self._virtual_time = 0.0
        self._virtual_delta = 0.0
        self._real_time = 0.0
        self._real_delta = 0.0
        self._speed = 1.0
        self._paused = False

    # -- control ---------------------------------------------------------

    def pause(self) -> None:
        self._paused = True

    def unpause(self) -> None:
        self._paused = False

    def is_paused(self) -> bool:
        return self._paused

    def set_relative_speed(self, speed: float) -> None:
        if speed < 0.0:
            raise ValueError("relative speed must be >= 0")
        self._speed = float(speed)

    def relative_speed(self) -> float:
        return self._speed

    # -- advancing ---------------------------------------------------------

    def advance(self, real_dt: float) -> SimParams:
        """Advance by one frame of wall-clock ``real_dt`` seconds."""
        self._real_delta = float(real_dt)
        self._real_time += self._real_delta
        self._virtual_delta = 0.0 if self._paused else self._real_delta
        self._virtual_time += self._virtual_delta
        self._delta = self._virtual_delta * self._speed
        self._time += self._delta
        return self.sim_params()

    @property
    def time(self) -> float:
        return self._time

    @property
    def delta(self) -> float:
        return self._delta

    def sim_params(self) -> SimParams:
        return SimParams(
            time=self._time,
            delta_time=self._delta,
            virtual_time=self._virtual_time,
            virtual_delta_time=self._virtual_delta,
            real_time=self._real_time,
            real_delta_time=self._real_delta,
        )
