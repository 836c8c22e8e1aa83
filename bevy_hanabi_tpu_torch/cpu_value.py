"""CPU-sampled values: fixed or uniformly random per sample.

Re-design of the reference's ``CpuValue<T>`` (spawn.rs:82-163): a value that
is either a single constant or re-sampled uniformly from ``[a, b)`` on the
host each time it's needed (e.g. per spawner cycle, or per effect instance
for SetColor/SetSizeModifier).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np

__all__ = ["CpuValue"]


@dataclass(frozen=True)
class CpuValue:
    """Single constant or uniform-random range, sampled on the host."""

    value: Any
    upper: Any = None  # None => Single, else Uniform [value, upper)

    @staticmethod
    def single(v) -> "CpuValue":
        return CpuValue(v)

    @staticmethod
    def uniform(a, b) -> "CpuValue":
        return CpuValue(a, b)

    @property
    def is_uniform(self) -> bool:
        return self.upper is not None

    def sample(self, rng: np.random.Generator):
        """Sample on the host (reference: CpuValue::sample, spawn.rs:128)."""
        if self.upper is None:
            return self.value
        a = np.asarray(self.value, np.float32)
        b = np.asarray(self.upper, np.float32)
        return a + (b - a) * rng.random(a.shape if a.shape else None, np.float32)

    def range(self) -> Tuple[Any, Any]:
        if self.upper is None:
            return (self.value, self.value)
        return (self.value, self.upper)

    # -- serde ----------------------------------------------------------

    def to_json(self):
        def conv(x):
            if isinstance(x, (tuple, list, np.ndarray)):
                return list(np.asarray(x).tolist())
            return x

        if self.upper is None:
            return {"single": conv(self.value)}
        return {"uniform": [conv(self.value), conv(self.upper)]}

    @staticmethod
    def from_json(data) -> "CpuValue":
        if isinstance(data, dict) and "uniform" in data:
            a, b = data["uniform"]
            return CpuValue(_tup(a), _tup(b))
        if isinstance(data, dict) and "single" in data:
            return CpuValue(_tup(data["single"]))
        return CpuValue(_tup(data))


def _tup(x):
    return tuple(x) if isinstance(x, list) else x
