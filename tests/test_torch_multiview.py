"""The port's multi-view rendering and 2D cameras against the JAX package, on
the CPU: ``render_views``, ``update_render_chunk`` over a camera list,
per-view culling of effects and groups, ``camera_2d`` and z-layer ordering,
perspective against orthographic depth (tests/test_multicam_2d.py:38-183),
the render plan frozen under ``cameras[0]``, and the gallery's
``example_multicam`` and bloomed firework (examples/run_all.py:251-295).

Each case builds the same scene in both packages (assets from each
package's own authoring layer, the same seeds and frames). Framebuffers
agree within 0.5% on their checksums (bench.py:155-161) and pixel for pixel
within 1e-5; the JAX test's own assertions hold on the port's images.
"""

import types

import numpy as np
import pytest
import torch

import bevy_hanabi_tpu as bj
import bevy_hanabi_tpu_torch as bt
from bevy_hanabi_tpu import modifiers as mods_j
from bevy_hanabi_tpu.graph import ExprWriter as WriterJ
from bevy_hanabi_tpu.render import camera as camera_j
from bevy_hanabi_tpu.render.raster import RasterConfig as CfgJ
from bevy_hanabi_tpu.runtime import HanabiScene as SceneJ
from bevy_hanabi_tpu.spawn import SpawnerSettings as SpawnJ
from bevy_hanabi_tpu_torch import modifiers as mods_t
from bevy_hanabi_tpu_torch.graph import ExprWriter as WriterT
from bevy_hanabi_tpu_torch.render import camera as camera_t
from bevy_hanabi_tpu_torch.render.raster import RasterConfig as CfgT
from bevy_hanabi_tpu_torch.spawn import SpawnerSettings as SpawnT
from torch_jax_cache import jax_cache_of_the_module  # noqa: F401

DT = 1.0 / 60.0
REL = 0.005

JAX = types.SimpleNamespace(
    pkg=bj, m=mods_j, W=WriterJ, S=SpawnJ, cam=camera_j,
    cfg=CfgJ(width=64, height=64, tile_size=16, max_entries_per_tile=16),
    scene=lambda seed: SceneJ(seed=seed), host=np.asarray,
)
PORT = types.SimpleNamespace(
    pkg=bt, m=mods_t, W=WriterT, S=SpawnT, cam=camera_t,
    cfg=CfgT(width=64, height=64, tile_size=16, max_entries_per_tile=16),
    scene=lambda seed: bt.HanabiScene(seed=seed, device="cpu"),
    host=lambda t: t.numpy(),
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def point_asset(P, name, pos, color, z_layer=0.0, size=0.3):
    A, m = P.pkg.attributes, P.m
    w = P.W()
    a = (
        P.pkg.EffectAsset(name, 8, P.S.once(1.0), w.finish())
        .init(m.SetAttributeModifier(A.POSITION, w.lit(tuple(pos)).expr()))
        .init(m.SetAttributeModifier(A.LIFETIME, w.lit(100.0).expr()))
        .render(m.SetColorModifier(color))
        .render(m.SetSizeModifier((size,) * 3))
    )
    a.z_layer_2d = z_layer
    return a


def ortho(P, eye, half=2.0, far=10.0):
    return P.cam.CameraParams(P.cam.look_at(eye, (0, 0, 0)),
                              P.cam.orthographic(-half, half, -half, half, 0.1, far), (64, 64))


def _same_image(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert abs(float(got.sum()) - float(want.sum())) <= REL * max(abs(float(want.sum())), 1.0)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _both(build):
    return build(PORT), build(JAX)


def two_views(P):
    s = P.scene(1)
    s.add(point_asset(P, "p", (1.0, 0.0, 0.0), (1.0, 0.0, 0.0, 1.0)), "p")
    s.update(DT)
    front, side = ortho(P, (0, 0, 5.0)), ortho(P, (5.0, 0, 0))
    return (P.host(s.render(front, P.cfg)), P.host(s.render(side, P.cfg)),
            P.host(s.render_views([front, side], P.cfg)))


def test_multicam_two_views_one_scene():
    (front, side, views), want = _both(two_views)
    for g, w in zip((front, side, views), want):
        _same_image(g, w)
    assert front[32, 48, 0] > 0.5 and front[32, 16, 0] < 0.1
    assert side[32, 32, 0] > 0.5
    # render_views is render() per view where the pass order agrees
    np.testing.assert_array_equal(views[0], front)
    np.testing.assert_array_equal(views[1], side)


def z_layers(P):
    s = P.scene(2)
    s.add(point_asset(P, "below", (0, 0, 0), (1.0, 0.0, 0.0, 1.0), z_layer=0.0), "below")
    s.add(point_asset(P, "above", (0, 0, 0), (0.0, 0.0, 1.0, 1.0), z_layer=1.0), "above")
    s.update(DT)
    cam = P.cam.camera_2d((64, 64), scale=1.0)
    return P.host(s.render(cam, P.cfg, pipeline="split")), P.host(s.render(cam, P.cfg))


def test_2d_z_layer_orders_effects():
    got, want = _both(z_layers)
    for g, w in zip(got, want):
        _same_image(g, w)
    # the higher z_layer paints later: blue on top
    np.testing.assert_allclose(got[0][32, 32, :3], [0, 0, 1], atol=1e-5)


def test_camera_2d_matches_jax():
    for vp, scale, z in (((64, 64), 1.0, 5.0), ((96, 48), 2.5, 8.0)):
        got, want = camera_t.camera_2d(vp, scale, z), camera_j.camera_2d(vp, scale, z)
        np.testing.assert_array_equal(np.asarray(got.view), np.asarray(want.view))
        np.testing.assert_array_equal(np.asarray(got.proj), np.asarray(want.proj))
        assert got.viewport == want.viewport


def persp_depth(P):
    s = P.scene(3)
    s.add(point_asset(P, "near", (-0.8, 0.0, 2.0), (1, 1, 1, 1.0), size=0.4), "near")
    s.add(point_asset(P, "far", (0.8, 0.0, -4.0), (1, 1, 1, 1.0), size=0.4), "far")
    s.update(DT)
    cam = P.cam.CameraParams(P.cam.look_at((0, 0, 6.0), (0, 0, 0)),
                             P.cam.perspective(0.9, 1.0, 0.1, 50.0), (64, 64))
    return P.host(s.render(cam, P.cfg))


def test_perspective_vs_ortho_depth():
    img, want = _both(persp_depth)
    _same_image(img, want)
    cov = img[..., 0] > 0.3
    assert cov[:, :32].sum() > cov[:, 32:].sum() > 0


def _cams(P):
    return ortho(P, (0, 0, 5.0), far=6.0), ortho(P, (0, 0, -5.0), far=6.0)


TF = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 4.5]], np.float32)


def culled_effect(P):
    s = P.scene(5)
    # the particle at z=+4.5 is inside A's frustum and outside B's
    s.add(point_asset(P, "p", (0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 1.0)), "p", transform=TF,
          cull_pad=0.5)
    s.add(point_asset(P, "q", (1.0, 0.0, 0.0), (0.0, 1.0, 0.0, 1.0)), "q")
    s.update(DT)
    a, b = _cams(P)
    return P.host(s.render_views([a, b], P.cfg)), P.host(s.render_views([a, b], P.cfg,
                                                                         pipeline="split"))


def test_render_views_per_view_culling():
    got, want = _both(culled_effect)
    for imgs, w in zip(got, want):
        _same_image(imgs, w)
        assert imgs.shape[0] == 2
        assert imgs[0][..., 0].max() > 0.5 and imgs[1][..., 0].max() == 0.0
        assert imgs[0][..., 1].max() > 0.5 and imgs[1][..., 1].max() > 0.5


def culled_group(P):
    s = P.scene(6)
    s.add_group(point_asset(P, "g", (0.0, 0.0, 0.0), (1.0, 0.0, 1.0, 1.0)), 2, "grp",
                transforms=np.broadcast_to(TF, (2, 3, 4)), cull_pad=0.5)
    s.update(DT)
    return P.host(s.render_views(list(_cams(P)), P.cfg))


def test_render_views_per_view_culling_group():
    imgs, want = _both(culled_group)
    _same_image(imgs, want)
    assert imgs[0][..., 0].max() > 0.5 and imgs[1][..., 0].max() == 0.0


def multiview_chunk(P):
    s = P.scene(7)
    s.add(point_asset(P, "p", (0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 1.0)), "p", transform=TF,
          cull_pad=0.5)
    s.add(point_asset(P, "q", (1.0, 0.0, 0.0), (0.0, 1.0, 0.0, 1.0)), "q")
    s.update(DT)  # spawn first so the AABB is meaningful
    imgs, sums = s.update_render_chunk(3, DT, list(_cams(P)), P.cfg)
    return P.host(imgs), P.host(sums)


def test_update_render_chunk_over_a_camera_list():
    (imgs, sums), (want, want_sums) = _both(multiview_chunk)
    _same_image(imgs, want)
    assert imgs.shape == (2, 64, 64, 4) and sums.shape == (3,)
    np.testing.assert_allclose(sums, want_sums, rtol=REL)
    assert imgs[0][..., 0].max() > 0.5 and imgs[1][..., 0].max() == 0.0


def order_freeze(P):
    """Two overlapping blend effects in passes of their own (a raster
    override never batches nor joins the painter), one at z=+1 and one at
    z=-1, seen from +z and from -z: the two views disagree on which pass is
    farther, and render_views composites both in camera 0's order."""
    s = P.scene(8)
    own = {"tile_span": 2}
    s.add(point_asset(P, "r", (0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.6), size=1.0), "r",
          transform=np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 1.0]], np.float32),
          raster_override=own)
    s.add(point_asset(P, "b", (0.0, 0.0, 0.0), (0.0, 0.0, 1.0, 0.6), size=1.0), "b",
          transform=np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -1.0]], np.float32),
          raster_override=own)
    s.update(DT)
    a, b = ortho(P, (0, 0, 5.0)), ortho(P, (0, 0, -5.0))
    views = P.host(s.render_views([a, b], P.cfg))
    if P is JAX:
        return views
    return views, P.host(s.render(a, P.cfg)), P.host(s.render(b, P.cfg))


def test_render_views_freezes_the_order_under_camera_0():
    (views, ra, rb), want = _both(order_freeze)
    _same_image(views, want)
    np.testing.assert_array_equal(views[0], ra)
    # view 1 composites in camera 0's order: red (nearer camera 0) over
    # blue, where render(camera 1) puts blue over red
    c = views[1][32, 32]
    assert c[0] > c[2] and rb[32, 32, 2] > rb[32, 32, 0]
    assert not np.allclose(views[1], rb)


def test_example_multicam_at_run_all_config_matches_jax():
    """examples/run_all.py:251-287: ``example_multicam`` after 200 frames,
    two cameras through ``render_views`` at the gallery's antialiased config
    (at 64x64)."""
    from bevy_hanabi_tpu.models.examples import examples_registry as registry_j
    from bevy_hanabi_tpu_torch.models import examples_registry as registry_t

    def run(P, registry):
        s = P.scene(1)
        s.add(registry()["multicam"](), "fx")
        for _ in range(200):
            s.update(DT)
        cfg = type(P.cfg)(width=64, height=64, tile_size=16, tile_span=2,
                          max_entries_per_tile=128, antialias=True)
        proj = P.cam.perspective(0.9, 1.0, 0.1, 200.0)
        cams = [P.cam.CameraParams(P.cam.look_at(eye, (0.0, 0.0, 0.0)), proj, (64, 64))
                for eye in ((0.0, 0.0, 10.0), (4.0, 3.0, 8.0))]
        return s["fx"].alive_count(), P.host(s.render_views(cams, cfg))

    (alive, views), (alive_j, views_j) = run(PORT, registry_t), run(JAX, registry_j)
    assert alive == alive_j > 0
    _same_image(views, views_j)
    assert views.shape == (2, 64, 64, 4) and views[:, :, :, :3].sum() > 0


def test_firework_frame_with_bloom_matches_jax():
    """The gallery's firework look (examples/run_all.py:289-295): a firework
    tree's HDR frame through ``bloom(threshold=1.0, sigma=3.0,
    intensity=0.8)``."""
    from bevy_hanabi_tpu.models import firework_effect as firework_j
    from bevy_hanabi_tpu.models import firework_trail_effect as trail_j
    from bevy_hanabi_tpu.render import bloom as bloom_j
    from bevy_hanabi_tpu_torch.models import firework_effect, firework_trail_effect
    from bevy_hanabi_tpu_torch.render import bloom

    def run(P, firework, trail, post):
        s = P.scene(4)
        s.add(firework(256), "rocket")
        s.add(trail(1024), "trail", parent="rocket")
        for _ in range(25):
            s.update(1.0 / 20.0)
        cam = P.cam.CameraParams(P.cam.look_at((0.0, 2.0, 8.0), (0.0, 2.0, 0.0)),
                                 P.cam.perspective(0.9, 1.0, 0.1, 100.0), (64, 64))
        return s["trail"].alive_count(), P.host(post(s.render(cam, P.cfg), threshold=1.0,
                                                     sigma=3.0, intensity=0.8))

    (alive, img), (alive_j, img_j) = (run(PORT, firework_effect, firework_trail_effect, bloom),
                                      run(JAX, firework_j, trail_j, bloom_j))
    assert alive == alive_j > 0
    assert abs(float(img.sum()) - float(img_j.sum())) <= REL * abs(float(img_j.sum()))
    assert img[..., :3].max() > 0
