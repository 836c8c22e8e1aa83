"""The port's window gather against the JAX package, on the CPU.

On the CPU ``gather_window`` takes its plain version, ``window_index`` then
``index_select`` with empty slots zeroed; these tests hold it against a
numpy transcription of the JAX rasterizer's window (raster.py:488-506) and
row gather (raster.py:586), and its filled rows against the TPU kernel
``pallas_gather`` in Pallas interpret mode. The CUDA kernel against its
plain version is in ``test_torch_cuda.py``. Every value is a moved f32 bit
pattern or an integer, so every comparison is bit for bit.
"""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bevy_hanabi_tpu_torch.ops import gather
from bevy_hanabi_tpu_torch.render import raster

EXPERIMENTS = Path(__file__).resolve().parent.parent / "experiments"


def _reference_window(table, pidx_sorted, starts, ends, M, fast):
    """raster.py:488-506 and :586 in numpy, laid out [nt, M] as the port's
    window, with empty slots zeroed."""
    n = pidx_sorted.shape[0]
    base = starts if fast else np.maximum(ends - M, starts)
    raw = base[None, :] + np.arange(M, dtype=starts.dtype)[:, None]  # [M, nt]
    idx = np.minimum(raw, n - 1)
    t_has = raw < ends[None, :]
    t_p = pidx_sorted[idx]
    both = table[t_p]  # [M, nt, F]
    both = np.where(t_has[..., None], both, np.float32(0.0))
    return np.ascontiguousarray(both.transpose(1, 0, 2)), np.ascontiguousarray(t_has.T)


def _sorted_entries(layout, M, seed, F=13):
    """A sorted entry list: (row table [n, F] with NaN and inf values,
    pidx_sorted [n], starts [nt], ends [nt]). Each tile's run length is
    drawn so that some tiles are empty and some hold more than M entries."""
    r = np.random.default_rng(seed)
    if layout == "ragged":
        lengths = r.choice([0, 1, M - 1, M, M + 1, 3 * M], size=24)
        lengths[0], lengths[-1] = 0, 2 * M + 5  # an empty first tile, an overflowing last
    elif layout == "n < M":
        lengths = np.array([0, 2, 0, 3, 0])
    else:  # every tile empty but the entry list is not
        lengths = np.zeros(9, np.int64)
    ends = np.cumsum(lengths).astype(np.int64)
    starts = ends - lengths
    n = max(int(ends[-1]), 7)  # entries past the last tile: the sentinel tile's
    table = r.standard_normal((n + 5, F)).astype(np.float32)
    table[r.random(table.shape) < 0.02] = np.nan
    table[1, 2] = np.inf
    pidx_sorted = r.permutation(n + 5)[:n]
    return table, pidx_sorted, starts, ends


@pytest.mark.parametrize("layout", ["ragged", "n < M", "all empty"])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("from_start", [False, True])
def test_gather_window_matches_the_jax_window(layout, index_dtype, from_start):
    M = 8
    table, pidx_sorted, starts, ends = _sorted_entries(layout, M, seed=len(layout))
    want_w, want_has = _reference_window(table, pidx_sorted, starts, ends, M, from_start)
    window, has = gather.gather_window(
        torch.from_numpy(table), torch.from_numpy(pidx_sorted).to(index_dtype),
        torch.from_numpy(starts), torch.from_numpy(ends), M, from_start=from_start,
    )
    assert window.dtype == torch.float32 and window.shape == (starts.shape[0], M, table.shape[1])
    np.testing.assert_array_equal(has.numpy(), want_has)
    np.testing.assert_array_equal(window.numpy().view(np.uint32), want_w.view(np.uint32))
    if layout == "ragged":
        assert want_has.any() and not want_has.all()
    # empty slots are +0.0 in every column
    assert not window.numpy().view(np.uint32)[~want_has].any()


def test_gather_window_of_no_entries_is_empty():
    starts = ends = torch.zeros(4, dtype=torch.int64)
    window, has = gather.gather_window(torch.ones((3, 10)), torch.zeros(0, dtype=torch.int32),
                                       starts, ends, 6)
    assert window.shape == (4, 6, 10) and not window.any() and not has.any()


def _load_experiment(name):
    spec = importlib.util.spec_from_file_location(f"_exp_{name}", EXPERIMENTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("F", [10, 17, 26])  # quads, the mesh's rows, lit
@pytest.mark.parametrize("from_start", [False, True])
def test_gather_window_rows_match_pallas_gather(monkeypatch, from_start, F):
    # The TPU kernel runs in Pallas interpret mode; the experiment is not edited.
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    mod = _load_experiment("pallas_gather_bench")
    M = 8
    table, pidx_sorted, starts, ends = _sorted_entries("ragged", M, seed=3, F=F)
    window, has = gather.gather_window(
        torch.from_numpy(table), torch.from_numpy(pidx_sorted), torch.from_numpy(starts),
        torch.from_numpy(ends), M, from_start=from_start,
    )
    # the filled slots' row ids, padded to whole blocks of the TPU kernel
    pidx, _ = raster.window_index(torch.from_numpy(pidx_sorted), torch.from_numpy(starts),
                                  torch.from_numpy(ends), M, from_start)
    idx = pidx[has].numpy()
    block = 64
    padded = np.zeros(-(-idx.shape[0] // block) * block, np.int32)
    padded[: idx.shape[0]] = idx
    want = np.asarray(mod.pallas_gather(jnp.asarray(table), jnp.asarray(padded), block=block, depth=4))
    np.testing.assert_array_equal(window[has].numpy().view(np.uint32),
                                  want[: idx.shape[0]].view(np.uint32))


@pytest.mark.parametrize("mode", [None, "first", "depth", "payload"])
def test_gather_window_equals_window_index_then_gather_on_sorted_tiles(mode):
    # the rasterizer's own sort: the window the route before gather_window
    # built (window_index, then the row gather), with empty slots zeroed
    r = np.random.default_rng(7)
    n, nt, M = 1500, 64, 16
    # dense low tiles (overflowing), sparse high ones (empty or part filled)
    binned = (nt * r.random(n) ** 2).astype(np.int64)
    tile = torch.from_numpy(np.where(r.random(n) < 0.9, binned, nt).astype(np.int32))
    depth = torch.from_numpy(np.where(tile.numpy() < nt, r.uniform(1, 50, n), -np.inf).astype(np.float32))
    rows = torch.from_numpy(r.standard_normal((n, raster.ROW)).astype(np.float32))
    pidx_sorted, starts, ends = raster.sort_tiles(tile, depth, nt, mode)
    assert pidx_sorted.dtype == (torch.int32 if mode in ("first", "depth") else torch.int64)
    window, has = gather.gather_window(rows, pidx_sorted, starts, ends, M, from_start=mode is not None)
    pidx, has_old = raster.window_index(pidx_sorted, starts, ends, M, from_start=mode is not None)
    old = gather.gather_rows(rows, pidx.reshape(-1)).reshape(nt, M, raster.ROW)
    assert torch.equal(has, has_old) and bool(has.any()) and not bool(has.all())
    assert torch.equal(window[has], old[has])
    assert not window[~has].any()


def test_gather_window_rejects_what_the_kernel_does_not_take():
    rows = torch.zeros((8, 10))
    pidx = torch.zeros(8, dtype=torch.int32)
    se = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        gather.gather_window(rows.double(), pidx, se, se, 4)
    with pytest.raises(TypeError):
        gather.gather_window(rows, pidx.to(torch.int16), se, se, 4)
    with pytest.raises(TypeError):
        gather.gather_window(rows, pidx, se.to(torch.int32), se, 4)
    with pytest.raises(ValueError, match="shape"):
        gather.gather_window(rows, pidx, se, torch.zeros(3, dtype=torch.int64), 4)
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_window(torch.zeros((10, 8)).t(), pidx, se, se, 4)
    with pytest.raises(ValueError, match="positive"):
        gather.gather_window(rows, pidx, se, se, 0)
