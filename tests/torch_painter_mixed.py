"""The small mixed scene of the port's painter tests, shared by
``test_torch_painter.py`` and the files that hold its long cases
(``test_torch_painter_chunk_auto.py``, ``test_torch_painter_chunk_split.py``,
``test_torch_painter_per_frame.py``), one file each so that pytest-xdist's
``--dist loadfile`` spreads them over workers.

The mixed scene (bench.py:672-774 cut down: debris 1024 opaque, gradient
4096, rocket 512 -> trail 2048) runs in both packages from the same JAX
assets, crossed to the port as JSON. Tolerances: alive masks, PCG seeds
and event counts bit for bit (the same integer ops); checksums within 0.5%
(bench.py:155-161, the repo's device-gate tolerance).
"""

import math

import numpy as np
import pytest
import torch

import bevy_hanabi_tpu as bj
from bevy_hanabi_tpu.models import firework_effect as firework_j
from bevy_hanabi_tpu.models import firework_trail_effect as trail_j
from bevy_hanabi_tpu.models import gradient_effect as gradient_j
from bevy_hanabi_tpu.render import camera as camera_j
from bevy_hanabi_tpu.render.raster import RasterConfig as CfgJ
from bevy_hanabi_tpu.runtime import HanabiScene as SceneJ
from bevy_hanabi_tpu_torch import EffectAsset, HanabiScene, RasterConfig
from bevy_hanabi_tpu_torch.render import camera as camera_t

REL = 0.005  # checksum tolerance (bench.py:155-161)
MIXED_K = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain raster path calls small vectorised ops thousands of times,
    each of which wakes OpenMP: run PyTorch single-threaded in the painter
    files (beside the other xdist workers, their OpenMP threads made one
    case 100x slower than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close_sum(a, b):
    a, b = float(np.asarray(a).sum()), float(np.asarray(b).sum())
    assert abs(a - b) <= REL * max(abs(b), 1.0), (a, b)


def _persp(cam_mod, size=128, eye=(0.0, 0.0, 26.0)):
    return cam_mod.CameraParams(
        view=cam_mod.look_at(eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
        proj=cam_mod.perspective(math.radians(60.0), 1.0, 0.1, 200.0),
        viewport=(size, size),
    )


def _debris(pkg, capacity=65536):
    """The mixed scene's opaque debris (bench.py:702-723) in ``pkg``."""
    A = pkg.attributes
    w = pkg.ExprWriter()
    return (
        pkg.EffectAsset("debris", capacity, pkg.SpawnerSettings.rate(capacity / 4.0), w.finish())
        .init(pkg.SetPositionSphereModifier(w.module.lit((0.0, 0.0, 0.0)), w.module.lit(3.0),
                                            pkg.ShapeDimension.VOLUME))
        .init(pkg.SetVelocitySphereModifier(w.module.lit((0.0, 0.0, 0.0)), w.module.lit(1.0)))
        .init(pkg.SetAttributeModifier(A.LIFETIME, w.lit(4.0).expr()))
        .init(pkg.SetAttributeModifier(A.AGE, w.lit(0.0).expr()))
        .init(pkg.SetAttributeModifier(A.HDR_COLOR, w.lit((0.9, 0.6, 0.2, 1.0)).expr()))
        .render(pkg.SetSizeModifier((0.05,) * 3))
        .with_alpha_mode(pkg.AlphaMode.OPAQUE)
    )


def _scene_pair(build, seed=0):
    sj = SceneJ(seed=seed)
    st = HanabiScene(seed=seed, device="cpu")
    for args in build:
        asset, name, kw = args
        sj.add(asset, name, **kw)
        st.add(EffectAsset.from_json(asset.to_json()), name, **kw)
    return sj, st


def _mixed_build():
    """bench.py:672-774 cut down: debris 1024 (opaque), gradient 4096,
    rocket 512 -> trail 2048."""
    return [
        (_debris(bj, 1024), "debris", {}),
        (gradient_j(4096), "grad", {}),
        (firework_j(512), "rocket", {}),
        (trail_j(2048), "trail", {"parent": "rocket"}),
    ]


def _mixed_pair():
    # the trail's parent must be added before it in both scenes
    return _scene_pair(_mixed_build(), seed=3)


def mixed_chunks_of(pipeline):
    """Both scenes after three render chunks of 8 frames at a dt of 1/10 s:
    the first burst's rockets die in the second chunk, so events flow, and
    the second burst (at 2 s) is alive at the end."""
    sj, st = _mixed_pair()
    out = []
    for _ in range(3):
        img_j, sums_j = sj.update_render_chunk(MIXED_K, 0.1, _persp(camera_j), CfgJ(128, 128, tile_slots=1),
                                               pipeline=pipeline)
        img_t, sums_t = st.update_render_chunk(MIXED_K, 0.1, _persp(camera_t), RasterConfig(128, 128, tile_slots=1),
                                               pipeline=pipeline)
        out.append((np.asarray(sums_j), sums_t.numpy()))
    return pipeline, sj, st, out, np.asarray(img_j), img_t.numpy()


def check_chunk_state(mixed_chunks):
    """Every effect's alive count, mask, seeds and spawn counter, and the
    rockets' last events, bit for bit."""
    _, sj, st, _, _, _ = mixed_chunks
    for name in ("debris", "grad", "rocket", "trail"):
        assert st[name].alive_count() == sj[name].alive_count()
        _, alive, seed, counter = st[name].pool.to_numpy()
        np.testing.assert_array_equal(alive, np.asarray(sj[name].pool.alive))
        np.testing.assert_array_equal(seed, np.asarray(sj[name].pool.seed))
        # the spawn counter: every effect spawned, the trail from events
        assert int(counter) == int(sj[name].pool.counter) > 0
    assert st["rocket"].alive_count() > 0  # the second burst
    ev_j, ev_t = sj["rocket"].last_events[0], st["rocket"].last_events[0]
    assert int(ev_t.num_events) == int(ev_j.num_events)
    np.testing.assert_array_equal(ev_t.count.numpy().astype(np.uint32), np.asarray(ev_j.count))


def check_chunk_checksums(mixed_chunks):
    """Every frame's checksum and the last image within 0.5%."""
    _, _, _, out, img_j, img_t = mixed_chunks
    for sums_j, sums_t in out:
        assert sums_t.shape == (MIXED_K,)
        for a, b in zip(sums_t.tolist(), sums_j.tolist()):
            assert abs(a - b) <= REL * max(abs(b), 1.0), (a, b)
    assert np.isfinite(img_t).all()
    _close_sum(img_t, img_j)
