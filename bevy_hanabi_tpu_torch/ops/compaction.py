"""Stream-compaction primitives (port of ``bevy_hanabi_tpu/ops/compaction.py``).

Only the flat form: the JAX package's blocked ``[B, 4096]`` two-level scan
exists for the TPU's scan lowering, and one ``cumsum`` is already a single
device scan here. Integer sums are exact, so the flat and blocked forms
agree bit for bit.
"""

from __future__ import annotations

import torch

__all__ = ["exclusive_rank", "inclusive_sum", "compact_indices"]


def inclusive_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of an integer array, in its own dtype."""
    return torch.cumsum(x, dim=-1, dtype=x.dtype)


def exclusive_rank(mask: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix count of True lanes; int32, same shape as mask."""
    x = mask.to(torch.int32)
    return torch.cumsum(x, dim=-1, dtype=torch.int32) - x


def compact_indices(mask: torch.Tensor, out_size: int = None):
    """Dense indices of True lanes, padded with ``n`` (one-past-end).

    Returns ``(indices int32 [out_size], count int32 [])``; lanes whose rank
    is ``>= out_size`` are dropped, as the JAX package's ``mode="drop"``."""
    n = mask.shape[-1]
    out_size = out_size or n
    rank = exclusive_rank(mask)
    # dropped lanes all land in one extra slot past the end, cut off below
    dst = torch.where(mask & (rank < out_size), rank, out_size).long()
    idx = torch.full((out_size + 1,), n, dtype=torch.int32, device=mask.device)
    idx.scatter_(0, dst, torch.arange(n, dtype=torch.int32, device=mask.device))
    return idx[:out_size], torch.sum(mask, dtype=torch.int32)
