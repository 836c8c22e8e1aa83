"""The port's rasterizer and its three kernels against the JAX package.

On the CPU every kernel wrapper takes its plain PyTorch version; these
tests hold those plain versions against the JAX package (the Pallas row
gather in interpret mode, the rasterizer's internals and its image). The
CUDA kernels against their plain versions are in ``test_torch_cuda.py``.
"""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bevy_hanabi_tpu.render.camera import CameraParams as CamJ
from bevy_hanabi_tpu.render.extract import ParticleDrawData as DrawJ
from bevy_hanabi_tpu.render.raster import RasterConfig as CfgJ
from bevy_hanabi_tpu.render.raster import _project
from bevy_hanabi_tpu.render.raster import rasterize as rasterize_j
from bevy_hanabi_tpu_torch.render import raster
from bevy_hanabi_tpu_torch.render.camera import CameraParams as CamT
from bevy_hanabi_tpu_torch.render.camera import look_at, perspective
from bevy_hanabi_tpu_torch.render.extract import ParticleDrawData as DrawT

EXPERIMENTS = Path(__file__).resolve().parent.parent / "experiments"
N = 8192
SIZE = 128


def _load_experiment(name):
    spec = importlib.util.spec_from_file_location(f"_exp_{name}", EXPERIMENTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- (c) gather_rows against the TPU kernel ----------------------------------


@pytest.mark.parametrize(
    "experiment,F",
    [("pallas_gather_bench", 10), ("pallas_gather_bench", 9), ("pallas_gather2", 128)],
)
def test_gather_rows_matches_pallas_gather(monkeypatch, experiment, F):
    # The TPU kernel runs in Pallas interpret mode; the experiment is not edited.
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    mod = _load_experiment(experiment)
    r = np.random.default_rng(F)
    table = r.standard_normal((4096, F)).astype(np.float32)
    idx = r.integers(0, 4096, 1024).astype(np.int32)
    want = np.asarray(mod.pallas_gather(jnp.asarray(table), jnp.asarray(idx), block=256, depth=4))
    got = raster.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)  # bit for bit


# ---- (d) project_bin / tile_blend against the JAX rasterizer -----------------


def _scene(seed=0):
    """A hand-built 8192-entry draw: camera-facing quads of random size,
    some dead, some behind the camera or off screen, some with NaN colour."""
    r = np.random.default_rng(seed)
    view = look_at((0.5, 1.0, 6.0), (0.0, 0.0, 0.0))
    proj = perspective(0.9, 1.0, 0.1, 100.0)
    rot = CamT(view, proj, (SIZE, SIZE)).rotation.numpy()
    pos = r.uniform(-2.5, 2.5, (N, 3)).astype(np.float32)
    pos[:64, 2] = 8.0  # behind the camera
    pos[64:128, 0] = 40.0  # off screen
    size = r.uniform(0.02, 0.4, (N, 2)).astype(np.float32)
    draw = {
        "position": pos,
        "axis_x": (rot[:, 0][None, :] * size[:, :1]).astype(np.float32),
        "axis_y": (rot[:, 1][None, :] * size[:, 1:]).astype(np.float32),
        "color": r.uniform(0.0, 1.0, (N, 4)).astype(np.float32),
        "alive": r.random(N) < 0.9,
    }
    draw["color"][128:136] = np.nan
    draw["alive"][128:136] = False  # NaN rows that must never reach a pixel
    return view, proj, draw


def _jax_tiles(view, proj, d, cfg):
    """Tile ids of the JAX rasterizer's tile_slots=1 binning (raster.py:241-292)."""
    cam = CamJ(view, proj, (SIZE, SIZE))
    T = cfg.tile_size
    p, ax, ay = (jnp.asarray(d[k]) for k in ("position", "axis_x", "axis_y"))
    center, w, _ = _project(cam, p)
    h1 = _project(cam, p + 0.5 * ax)[0] - center
    h2 = _project(cam, p + 0.5 * ay)[0] - center
    valid = jnp.logical_and(jnp.asarray(d["alive"]), w > 1e-4)
    rx = jnp.abs(h1[:, 0]) + jnp.abs(h2[:, 0])
    ry = jnp.abs(h1[:, 1]) + jnp.abs(h2[:, 1])
    valid &= (center[:, 0] + rx > 0) & (center[:, 0] - rx < cfg.width)
    valid &= (center[:, 1] + ry > 0) & (center[:, 1] - ry < cfg.height)
    valid &= (rx > 1e-6) & (ry > 1e-6)
    tcx = jnp.clip(jnp.floor(center[:, 0] / T).astype(jnp.int32), 0, cfg.tiles_x - 1)
    tcy = jnp.clip(jnp.floor(center[:, 1] / T).astype(jnp.int32), 0, cfg.tiles_y - 1)
    tile = jnp.where(valid, tcy * cfg.tiles_x + tcx, cfg.num_tiles)
    rows = jnp.concatenate([center, h1, h2, jnp.asarray(d["color"])], axis=1)
    return np.asarray(tile), np.asarray(jnp.where(valid, w, -jnp.inf)), np.asarray(rows)


def _torch_draw(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}


def test_project_bin_matches_jax_binning():
    view, proj, d = _scene()
    cfg = raster.RasterConfig(SIZE, SIZE, tile_slots=1)
    t = _torch_draw(d)
    tile, depth, rows = raster.project_bin(
        t["position"], t["axis_x"], t["axis_y"], t["alive"], t["color"],
        view, proj, (SIZE, SIZE), cfg.tile_size, cfg.tiles_x, cfg.tiles_y,
    )
    tile_j, depth_j, rows_j = _jax_tiles(view, proj, d, cfg)
    assert tile.dtype == torch.int32 and rows.shape == (N, raster.ROW)
    np.testing.assert_array_equal(tile.numpy(), tile_j)  # integer bins: exact
    assert 0 < int((tile < cfg.num_tiles).sum()) < N  # some binned, some culled
    # f32 projections in the same op order; 1e-4 px covers ULPs of XLA's
    # fused CPU loops
    np.testing.assert_allclose(depth.numpy(), depth_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rows.numpy(), rows_j, rtol=1e-6, atol=1e-4)


def _images(seed, background=(0.0, 0.0, 0.0, 0.0), M=64):
    view, proj, d = _scene(seed)
    cfg_t = raster.RasterConfig(SIZE, SIZE, tile_slots=1, background=background, max_entries_per_tile=M)
    cfg_j = CfgJ(SIZE, SIZE, tile_slots=1, background=background, max_entries_per_tile=M)
    t = _torch_draw(d)
    img_t = raster.rasterize(
        DrawT(t["position"], t["axis_x"], t["axis_y"], t["color"], t["alive"]),
        CamT(view, proj, (SIZE, SIZE)), cfg_t,
    )
    draw_j = DrawJ(
        position=jnp.asarray(d["position"]), axis_x=jnp.asarray(d["axis_x"]),
        axis_y=jnp.asarray(d["axis_y"]), color=jnp.asarray(d["color"]),
        alive=jnp.asarray(d["alive"]), roundness=None,
        sprite_index=jnp.zeros((N,), jnp.int32), sprite_grid_size=(1, 1),
        texture_layers=(), needs_uv=False,
    )
    img_j = np.asarray(rasterize_j(draw_j, CamJ(view, proj, (SIZE, SIZE)), cfg_j))
    return img_t.numpy(), img_j


@pytest.mark.parametrize(
    "seed,background,M",
    [(0, (0.0, 0.0, 0.0, 0.0), 64), (1, (0.1, 0.2, 0.3, 1.0), 64), (2, (0.0, 0.0, 0.0, 0.0), 8)],
)
def test_rasterize_matches_jax_image(seed, background, M):
    img_t, img_j = _images(seed, background, M)
    assert img_t.shape == (SIZE, SIZE, 4) and np.isfinite(img_t).all()
    # Keys are integers and equal (tile|depth) ties are rare at 21 depth
    # bits, so the images agree to f32 blend rounding; 0.5% on the checksum
    # is the repo's device-gate tolerance (bench.py:155-161).
    np.testing.assert_allclose(img_t, img_j, atol=1e-5)
    assert abs(img_t.sum() - img_j.sum()) <= 0.005 * abs(img_j.sum())


def test_sort_and_window_keep_the_nearest_m_back_to_front():
    tile = torch.tensor([0, 1, 0, 0, 2, 0, 1], dtype=torch.int32)
    depth = torch.tensor([5.0, 1.0, 3.0, 9.0, -torch.inf, 1.0, 2.0])
    tile[4] = 3  # sentinel: nt = 3
    pidx_sorted, starts, ends = raster.sort_tiles(tile, depth, 3)
    pidx, has = raster.window_index(pidx_sorted, starts, ends, 3)
    # tile 0 holds depths 5, 3, 9, 1: the nearest three, far first
    assert pidx[0].tolist() == [0, 2, 5] and has[0].tolist() == [True] * 3
    assert pidx[1].tolist()[:2] == [6, 1] and has[1].tolist() == [True, True, False]
    assert has[2].tolist() == [False] * 3


# ---- wrapper contract --------------------------------------------------------


def test_wrappers_reject_what_the_kernels_do_not_take():
    table = torch.zeros((8, 10))
    with pytest.raises(TypeError):
        raster.gather_rows(table, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(TypeError):
        raster.gather_rows(table.double(), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        raster.gather_rows(torch.zeros((10, 8)).t(), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        raster.tile_blend(torch.zeros((3, 4, 10)), torch.zeros((4, 4), dtype=torch.bool), 16, 2, 2, (0, 0, 0, 0))
    p = torch.zeros((5, 3))
    with pytest.raises(ValueError, match="shape"):
        raster.project_bin(p, p, p, torch.ones(5, dtype=torch.bool), torch.zeros((5, 3)),
                           np.eye(4), np.eye(4), (16, 16), 16, 1, 1)


@pytest.mark.parametrize(
    "kwargs,config",
    [
        ({}, dict(tile_slots=0)),
        ({}, dict(tile_slots=2)),
        ({"alpha_mode": "add"}, dict(tile_slots=1)),
        ({}, dict(tile_slots=1, antialias=True)),
        ({"return_depth": True}, dict(tile_slots=1)),
        ({"y_offset": 4.0}, dict(tile_slots=1)),
    ],
)
def test_unported_raster_branches_raise(kwargs, config):
    view, proj, d = _scene()
    t = _torch_draw(d)
    draw = DrawT(t["position"], t["axis_x"], t["axis_y"], t["color"], t["alive"])
    with pytest.raises(NotImplementedError, match="not ported"):
        raster.rasterize(draw, CamT(view, proj, (SIZE, SIZE)),
                         raster.RasterConfig(SIZE, SIZE, **config), **kwargs)
