"""Piecewise-linear keyframe gradients.

TPU-native re-design of bevy_hanabi ``src/gradient.rs``. The reference
samples gradients on CPU or code-generates a WGSL if/else chain
(lib.rs:1567-1688); here sampling is a vectorized ``where`` chain over the keys
(port of ``bevy_hanabi_tpu/gradient.py``).
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Gradient", "GradientKey"]


class GradientKey(NamedTuple):
    """One keyframe: ``(ratio, value)`` (reference GradientKey,
    gradient.rs:59-68). A plain tuple subclass, so destructuring
    ``for ratio, value in gradient.keys()`` keeps working."""

    ratio: float
    value: Any


class Gradient:
    """Keyframe curve over ratio in [0,1] with values of any fixed width.

    Duplicate ratios create a step discontinuity, matching the reference's
    behavior: keys with equal ratio are kept in insertion order, sampling AT
    the exact shared ratio returns the FIRST duplicate "for determinism"
    (gradient.rs:394-407), and ratios just past it take the later key.
    """

    def __init__(self, keys: Sequence[Tuple[float, Any]] = ()):
        self._ratios: List[float] = []
        self._values: List[np.ndarray] = []
        for r, v in keys:
            self.add_key(r, v)

    # ---- construction (reference: Gradient::constant/linear/from_keys) ----

    @staticmethod
    def constant(value) -> "Gradient":
        g = Gradient()
        g.add_key(0.0, value)
        return g

    @staticmethod
    def linear(start, end) -> "Gradient":
        g = Gradient()
        g.add_key(0.0, start)
        g.add_key(1.0, end)
        return g

    def add_key(self, ratio: float, value) -> "Gradient":
        if not (0.0 <= ratio <= 1.0):
            raise ValueError(f"gradient key ratio must be in [0,1], got {ratio}")
        v = np.atleast_1d(np.asarray(value, np.float32))
        if self._values and v.shape != self._values[0].shape:
            raise ValueError(
                f"gradient value shape {v.shape} != existing {self._values[0].shape}"
            )
        # insert sorted by ratio; equal ratios keep insertion order (stable)
        idx = len(self._ratios)
        for i, r in enumerate(self._ratios):
            if ratio < r:
                idx = i
                break
        self._ratios.insert(idx, float(ratio))
        self._values.insert(idx, v)
        return self

    def with_key(self, ratio: float, value) -> "Gradient":
        self.add_key(ratio, value)
        return self

    # ---- inspection ----------------------------------------------------

    @property
    def num_keys(self) -> int:
        return len(self._ratios)

    def keys(self) -> List[GradientKey]:
        return [GradientKey(r, v) for r, v in zip(self._ratios, self._values)]

    def value_width(self) -> int:
        return 0 if not self._values else int(self._values[0].shape[0])

    def is_empty(self) -> bool:
        return not self._ratios

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Gradient)
            and self._ratios == other._ratios
            and all(np.array_equal(a, b) for a, b in zip(self._values, other._values))
        )

    def __hash__(self) -> int:
        return hash(
            tuple(self._ratios) + tuple(tuple(v.tolist()) for v in self._values)
        )

    # ---- sampling --------------------------------------------------------

    def sample(self, x: float) -> np.ndarray:
        """CPU reference sampling (mirrors gradient.rs:394-423)."""
        if not self._ratios:
            raise ValueError("cannot sample empty gradient")
        r = self._ratios
        if x < r[0]:
            return self._values[0]
        if x > r[-1]:
            return self._values[-1]
        for i, ri in enumerate(r):
            if x == ri:
                # exact hit: the FIRST duplicate (gradient.rs:400-405)
                return self._values[i]
        for i in range(len(r) - 1):
            if r[i] < x < r[i + 1]:
                t = (x - r[i]) / (r[i + 1] - r[i])
                return self._values[i] * (1 - t) + self._values[i + 1] * t
        return self._values[-1]

    def sample_torch(self, x: torch.Tensor) -> torch.Tensor:
        """Vectorized device sampling; ``x`` any shape, returns ``x.shape + (D,)``.

        The same fused ``where`` chain over the (static, few) segments as the
        JAX package's ``sample_jax``, with the same op order, so the two
        agree to the last bit on the CPU. Gradients of more than 16 keys
        take the JAX package's searchsorted form, not ported yet.
        """
        k = len(self._ratios)
        if k > 16:
            raise NotImplementedError(
                "Gradient.sample_torch: the searchsorted form for more than "
                f"16 keys is not ported (gradient has {k})"
            )
        if k == 1:
            v0 = torch.as_tensor(self._values[0], device=x.device)
            return v0.expand(x.shape + v0.shape)
        x = x.to(torch.float32)
        # host-constant keys fold into the program; out-of-range clamps
        # fall out of the chain (below r0 -> v0; above r_last -> t=1)
        r = np.asarray(self._ratios, np.float32)
        v = [np.asarray(vi, np.float32) for vi in self._values]

        def const(a):
            return torch.as_tensor(a, device=x.device)

        out = const(v[0]).expand(x.shape + v[0].shape)
        for i in range(k - 1):
            span = float(r[i + 1] - r[i])
            if span > 0.0:
                t = torch.clamp((x - float(r[i])) / span, 0.0, 1.0)
                seg = const(v[i]) + const(v[i + 1] - v[i]) * t[..., None]
            else:  # step discontinuity: value jumps JUST AFTER r[i]
                seg = const(v[i + 1])
            # Strict inequality when the segment starts at a duplicated
            # ratio: an exact hit must return the FIRST duplicate
            # (gradient.rs:400-405), so later duplicates only take over
            # past the shared ratio.
            strict = span == 0.0 or (i > 0 and r[i] == r[i - 1])
            pred = x > float(r[i]) if strict else x >= float(r[i])
            out = torch.where(pred[..., None], seg, out)
        return out

    # ---- serde ------------------------------------------------------------

    def to_json(self) -> List[List]:
        return [[r, v.tolist()] for r, v in zip(self._ratios, self._values)]

    @staticmethod
    def from_json(data) -> "Gradient":
        g = Gradient()
        for r, v in data:
            g.add_key(r, v)
        return g
