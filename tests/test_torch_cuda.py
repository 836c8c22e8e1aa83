"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device: a CUDA
kernel has no CPU or interpret mode. The file imports no JAX, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` because ``tests/conftest.py`` configures JAX.)
Tolerances: the gather must be bit-exact; ``project_bin`` must give equal
tiles and depths (both versions round op for op, the library is built with
``-fmad=false``); ``tile_blend`` within 1e-5 absolute.
"""

import numpy as np
import pytest
import torch

from bevy_hanabi_tpu_torch import CompiledEffect, RasterConfig, SimParams, StepInputs
from bevy_hanabi_tpu_torch.models import gradient_effect
from bevy_hanabi_tpu_torch.render import raster
from bevy_hanabi_tpu_torch.render.camera import CameraParams, look_at, perspective

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _draw(n, device, seed=0):
    r = np.random.default_rng(seed)
    view = look_at((0.5, 1.0, 6.0), (0.0, 0.0, 0.0))
    proj = perspective(0.9, 1.0, 0.1, 100.0)
    rot = CameraParams(view, proj, (128, 128)).rotation.numpy()
    size = r.uniform(0.02, 0.4, (n, 2)).astype(np.float32)
    d = {
        "position": r.uniform(-2.5, 2.5, (n, 3)).astype(np.float32),
        "axis_x": rot[:, 0][None, :] * size[:, :1],
        "axis_y": rot[:, 1][None, :] * size[:, 1:],
        "color": r.uniform(0.0, 1.0, (n, 4)).astype(np.float32),
        "alive": r.random(n) < 0.9,
    }
    return view, proj, {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in d.items()}


def test_gather_rows_is_bit_exact(cuda):
    r = np.random.default_rng(0)
    table = torch.from_numpy(r.standard_normal((1 << 20, 10)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(r.integers(0, 1 << 20, 65536).astype(np.int32)).to(cuda)
    before = raster.gather_rows.launches
    out = raster.gather_rows(table, idx)
    assert raster.gather_rows.launches == before + 1
    assert torch.equal(out, raster.gather_rows_plain(table, idx))


def test_project_bin_and_tile_blend_match_plain(cuda):
    view, proj, t = _draw(8192, cuda)
    cfg = raster.RasterConfig(128, 128, tile_slots=1)
    args = (t["position"], t["axis_x"], t["axis_y"], t["alive"], t["color"],
            view, proj, (128, 128), cfg.tile_size, cfg.tiles_x, cfg.tiles_y)
    got = raster.project_bin(*args)
    want = raster.project_bin_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float((got[2] - want[2]).abs().max()) <= 1e-3
    pidx_sorted, starts, ends = raster.sort_tiles(want[0], want[1], cfg.num_tiles)
    pidx, has = raster.window_index(pidx_sorted, starts, ends, cfg.max_entries_per_tile)
    window = raster.gather_rows_plain(want[2], pidx.reshape(-1)).reshape(cfg.num_tiles, -1, raster.ROW)
    bg = (0.1, 0.0, 0.0, 1.0)
    fb = raster.tile_blend(window, has, cfg.tile_size, cfg.tiles_x, cfg.tiles_y, bg)
    fb_p = raster.tile_blend_plain(window, has, cfg.tile_size, cfg.tiles_x, cfg.tiles_y, bg)
    assert float((fb - fb_p).abs().max()) <= 1e-5


def test_wrappers_refuse_mixed_devices(cuda):
    with pytest.raises(ValueError, match="cuda"):
        raster.gather_rows(torch.zeros((4, 10), device=cuda), torch.zeros(2, dtype=torch.int32))


def test_small_frame_on_the_card_matches_the_cpu(cuda):
    """8192 particles at 128x128 through the kernels vs the CPU's plain path;
    checksums within 0.5% (the repo's device-gate tolerance)."""

    def run(device):
        fx = CompiledEffect(gradient_effect(8192), device=device)
        ins = [StepInputs.make(s, 7 + 31 * i) for i, s in enumerate([4096, 1024, 2048])]
        sims = [SimParams(time=2.0 * i, delta_time=2.0) for i in range(3)]
        cam = CameraParams(look_at((0, 0, 6), (0, 0, 0)), perspective(0.9, 1.0, 0.1, 100.0), (128, 128))
        return fx.step_render_chunk(
            fx.create_pool(), *fx.stack_frames(ins, sims), cam, RasterConfig(128, 128, tile_slots=1)
        )

    pool_g, img_g, sums_g = run(cuda)
    pool_c, img_c, sums_c = run("cpu")
    assert torch.isfinite(img_g).all()
    np.testing.assert_array_equal(pool_g.to_numpy()[1], pool_c.to_numpy()[1])
    np.testing.assert_array_equal(pool_g.to_numpy()[2], pool_c.to_numpy()[2])
    for a, b in zip(sums_g.cpu().tolist(), sums_c.tolist()):
        assert abs(a - b) <= 0.005 * abs(b)
