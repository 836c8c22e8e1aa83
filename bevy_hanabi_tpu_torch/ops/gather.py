"""Row gather ``table[idx]`` (port of the TPU kernel ``pallas_gather``).

:func:`gather_rows` launches ``csrc/gather_rows.cu`` on CUDA tensors and
adds one to ``gather_rows.launches``; on CPU tensors it takes its plain
version, :func:`gather_rows_plain`. Two stages use it: the rasterizer's
per-tile window gather and the event payload gather of a child's step.
"""

from __future__ import annotations

import torch

from .. import cuda_build
from ..cuda_build import Kernel
from ..cuda_build import check_tensor as _check
from ..cuda_build import current_stream as _stream

__all__ = ["gather_rows", "gather_rows_plain", "KERNELS"]


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` row gather (plain version of :func:`gather_rows`)."""
    return table.index_select(0, idx)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[j] = table[idx[j]]`` for an f32 ``[N, F]`` table and int32 ``[M]``
    indices in ``[0, N)``. Port of the TPU kernel ``pallas_gather``."""
    if table.dim() != 2:
        raise ValueError(f"table must be [N, F], got shape {tuple(table.shape)}")
    _check(table, "table", torch.float32, table.shape, table.device)
    if idx.dim() != 1:
        raise ValueError(f"idx must be [M], got shape {tuple(idx.shape)}")
    _check(idx, "idx", torch.int32, idx.shape, table.device)
    if not table.is_cuda:
        return gather_rows_plain(table, idx)
    n, f = table.shape
    out = torch.empty((idx.shape[0], f), dtype=torch.float32, device=table.device)
    code = cuda_build.library().hanabi_gather_rows(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0], n, f, _stream()
    )
    cuda_build.check(code, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0

KERNELS = {
    "gather_rows": Kernel(
        gather_rows,
        gather_rows_plain,
        "bevy_hanabi_tpu_torch/csrc/gather_rows.cu",
        "experiments/pallas_gather_bench.py:64",
    ),
}
