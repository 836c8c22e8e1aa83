"""Stream-compaction primitives (port of ``bevy_hanabi_tpu/ops/compaction.py``).

Only the flat form: the JAX package's blocked ``[B, 4096]`` two-level scan
exists for the TPU's scan lowering, and one ``cumsum`` is already a single
device scan here.
"""

from __future__ import annotations

import torch

__all__ = ["exclusive_rank"]


def exclusive_rank(mask: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix count of True lanes; int32, same shape as mask."""
    x = mask.to(torch.int32)
    return torch.cumsum(x, dim=-1, dtype=torch.int32) - x
