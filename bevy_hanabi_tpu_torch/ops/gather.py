"""Row gathers from an f32 row table (ports of the TPU kernel ``pallas_gather``).

:func:`gather_rows` (``table[idx]``, the event payload gather of a child's
step) and :func:`gather_window` (the rasterizer's per-tile window: its slot
indices, ``has`` flags and rows in one launch) launch
``csrc/gather_rows.cu`` on CUDA tensors and add one to their ``launches``;
on CPU tensors they take their plain versions, :func:`gather_rows_plain`
and :func:`gather_window_plain`. :func:`window_index` is the window's slot
indices in plain torch, which the plain window is built from.
"""

from __future__ import annotations

import torch

from .. import cuda_build
from ..cuda_build import Kernel
from ..cuda_build import check_tensor as _check
from ..cuda_build import current_stream as _stream

__all__ = [
    "gather_rows",
    "gather_rows_plain",
    "gather_window",
    "gather_window_plain",
    "window_index",
    "KERNELS",
]

def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` row gather (plain version of :func:`gather_rows`)."""
    return table.index_select(0, idx)


@cuda_build.on_tensor_device
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


def window_index(pidx_sorted, starts, ends, M: int, from_start: bool = False, n_rows=None):
    """``M`` entries of every tile in blend order (raster.py:488-506):
    ``(pidx int32 [nt, M], has bool [nt, M])``. The ordered path takes the
    END of each far-first run (the nearest M, back to front); the fast
    paths take the START (``from_start``). With ``n_rows`` each slot holds
    its entry's row, ``entry mod n_rows`` (raster.py:497-500)."""
    n = pidx_sorted.shape[0]
    base = starts if from_start else torch.maximum(ends - M, starts)
    raw = base[:, None] + torch.arange(M, dtype=base.dtype, device=base.device)[None, :]
    has = raw < ends[:, None]
    idx = torch.clamp(raw, max=n - 1)
    pidx = pidx_sorted[idx]
    if n_rows is not None:
        pidx = torch.remainder(pidx, n_rows)
    return pidx.to(torch.int32), has


def gather_window_plain(rows, pidx_sorted, starts, ends, M: int, from_start: bool = False):
    """Plain version of :func:`gather_window`: :func:`window_index` (each
    entry's row ``entry mod N``), then ``index_select`` of its slots, empty
    slots zeroed."""
    nt, width = starts.shape[0], rows.shape[1]
    if pidx_sorted.shape[0] == 0:
        return (rows.new_zeros((nt, M, width)),
                torch.zeros((nt, M), dtype=torch.bool, device=rows.device))
    pidx, has = window_index(pidx_sorted, starts, ends, M, from_start, rows.shape[0])
    window = rows.index_select(0, pidx.reshape(-1)).reshape(nt, M, width)
    return torch.where(has[..., None], window, 0.0), has


@cuda_build.on_tensor_device
def gather_window(rows, pidx_sorted, starts, ends, M: int, from_start: bool = False):
    """Each tile's window of ``M`` rows in blend order, in one launch.

    ``rows`` f32 [N, F] (``project_bin``'s, one a particle),
    ``pidx_sorted`` int32 or int64 [E] (the sorted entries' indices, of
    ``S`` slot-major entries a particle: entry ``e`` reads row ``e mod N``,
    JAX's ``t_p`` of raster.py:497-500, so no id reads outside ``rows``),
    ``starts``/``ends`` int64 [nt] (each tile's run in the sorted order,
    from :func:`~..render.raster.sort_tiles`). Tile t's slot m holds entry
    ``base + m`` of the run, ``base`` its start (``from_start``, the fast
    paths) or ``max(ends - M, starts)`` (the ordered path's nearest M, back
    to front). Returns ``(window f32 [nt, M, F], has bool [nt, M])``; an
    empty slot is 0.0 and reads no row. Folds :func:`window_index` and the
    row gather of raster.py:488-506, 586 into one kernel."""
    if rows.dim() != 2:
        raise ValueError(f"rows must be [N, F], got shape {tuple(rows.shape)}")
    dev = rows.device
    _check(rows, "rows", torch.float32, rows.shape, dev)
    if pidx_sorted.dim() != 1 or pidx_sorted.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"pidx_sorted must be int32 or int64 [n], got {pidx_sorted.dtype} "
                        f"of shape {tuple(pidx_sorted.shape)}")
    _check(pidx_sorted, "pidx_sorted", pidx_sorted.dtype, pidx_sorted.shape, dev)
    if starts.dim() != 1:
        raise ValueError(f"starts must be [nt], got shape {tuple(starts.shape)}")
    nt = starts.shape[0]
    _check(starts, "starts", torch.int64, (nt,), dev)
    _check(ends, "ends", torch.int64, (nt,), dev)
    if M < 1:
        raise ValueError(f"gather_window: M must be positive, got {M}")
    if pidx_sorted.shape[0] and not 0 < rows.shape[0] < 2**31:
        raise ValueError(f"gather_window: entries need 1 to 2**31 - 1 rows, got {rows.shape[0]}")
    if not rows.is_cuda:
        return gather_window_plain(rows, pidx_sorted, starts, ends, M, from_start)
    width = rows.shape[1]
    window = torch.empty((nt, M, width), dtype=torch.float32, device=dev)
    has = torch.empty((nt, M), dtype=torch.bool, device=dev)
    code = cuda_build.library().hanabi_gather_window(
        rows.data_ptr(), pidx_sorted.data_ptr(), starts.data_ptr(), ends.data_ptr(),
        window.data_ptr(), has.data_ptr(), nt, pidx_sorted.shape[0], rows.shape[0], M, width,
        int(from_start), int(pidx_sorted.dtype == torch.int64), _stream(),
    )
    cuda_build.check(code, "gather_window")
    gather_window.launches += 1
    return window, has


gather_window.launches = 0

KERNELS = {
    "gather_rows": Kernel(
        gather_rows,
        gather_rows_plain,
        "bevy_hanabi_tpu_torch/csrc/gather_rows.cu",
        "experiments/pallas_gather_bench.py:65",
    ),
    "gather_window": Kernel(
        gather_window,
        gather_window_plain,
        "bevy_hanabi_tpu_torch/csrc/gather_rows.cu",
        "experiments/pallas_gather_bench.py:65",
    ),
}
