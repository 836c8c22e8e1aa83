"""The port's ``update_render_chunk`` on the small mixed scene
(tests/torch_painter_mixed.py) against its own per-frame ``update`` and
``render``, under both pipelines, on the CPU (tests/test_scene.py:1307):
the pools bit for bit, the last image and its checksum exactly. A file of
its own, so that pytest-xdist's ``--dist loadfile`` runs it beside the
painter tests' other long cases.
"""

import numpy as np
import pytest
import torch

from bevy_hanabi_tpu_torch import RasterConfig
from bevy_hanabi_tpu_torch.render import camera as camera_t
from torch_jax_cache import jax_cache_of_the_module  # noqa: F401
from torch_painter_mixed import one_torch_thread  # noqa: F401
from torch_painter_mixed import MIXED_K, _mixed_pair, _persp


@pytest.mark.parametrize("pipeline", ["auto", "split"])
def test_mixed_chunk_equals_per_frame_update_and_render(pipeline):
    # test_scene.py:1307: the chunk is the per-frame path, frame for frame
    _, sa = _mixed_pair()
    _, sb = _mixed_pair()
    cam, cfg = _persp(camera_t), RasterConfig(128, 128, tile_slots=1)
    img_a, sums_a = sa.update_render_chunk(2 * MIXED_K, 0.1, cam, cfg, pipeline=pipeline)
    for _ in range(2 * MIXED_K):
        sb.update(0.1)
        img_b = sb.render(cam, cfg, pipeline=pipeline)
    assert int(sb["trail"].pool.counter) > 0  # events flowed
    for name in ("debris", "grad", "rocket", "trail"):
        for a, b in zip(sa[name].pool.to_numpy()[1:], sb[name].pool.to_numpy()[1:]):
            np.testing.assert_array_equal(a, b)
    assert torch.equal(img_a, img_b)
    assert float(sums_a[-1]) == float(img_b.sum())
