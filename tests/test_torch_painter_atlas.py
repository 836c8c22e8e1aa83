"""The port's painter merge of textured, flipbook, mesh and lit-mesh effects
against the JAX package, on the CPU: ``concat_painter_draws`` field for field
(the stacked atlas, ``tex_entry``, the NaN pattern of ``uv_abc``, the
padded normals, ``light_entry``, ``vcol_abc``) and ``HanabiScene`` images
under the painter and ``"auto"`` pipelines, on the eight compositions of
the JAX package's own tests (tests/test_scene.py:1859-2315): multilayer
textures, meshes with quads, a UV-less textured mesh, a lit mesh with
quads, two conflicting Lambert setups, textured effects, a textured
flipbook, and ``update_render_chunk`` with a two-layer painter.

The scenes are the same in both packages: assets built by one function
against either package's API, seeded scenes, numpy textures. Tolerances:
the merged draws exactly (the same copies and constants); images within
1e-6 absolute on these orthographic check compositions (XLA's CPU backend
contracts a multiply and an add of the blend into one fused op where
PyTorch rounds twice: one f32 ulp, as test_torch_painter.py measures), and
the JAX package's own painter-against-split tolerance where its test
states a wider one (1e-5: the UV-less mesh and the fused chunk).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_hanabi_tpu as bj
import bevy_hanabi_tpu_torch as bt
from bevy_hanabi_tpu.models.examples import LambertianLightingModifier as LambertJ
from bevy_hanabi_tpu.render import camera as camera_j
from bevy_hanabi_tpu.render.extract import concat_painter_draws as concat_j
from bevy_hanabi_tpu.render.extract import extract_draw_data as extract_j
from bevy_hanabi_tpu.render.mesh import ParticleMesh as MeshJ
from bevy_hanabi_tpu.render.mesh import expand_mesh_draw as expand_j
from bevy_hanabi_tpu.render.raster import RasterConfig as CfgJ
from bevy_hanabi_tpu.runtime import HanabiScene as SceneJ
from bevy_hanabi_tpu_torch.models.examples import LambertianLightingModifier as LambertT
from bevy_hanabi_tpu_torch.render import camera as camera_t
from bevy_hanabi_tpu_torch.render.extract import concat_painter_draws as concat_t
from bevy_hanabi_tpu_torch.render.extract import extract_draw_data as extract_t
from bevy_hanabi_tpu_torch.render.mesh import ParticleMesh as MeshT
from bevy_hanabi_tpu_torch.render.mesh import expand_mesh_draw as expand_t
from torch_jax_cache import jax_cache_of_the_module  # noqa: F401

DT = 1.0 / 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain raster path calls small vectorised ops thousands of times,
    each of which wakes OpenMP: run PyTorch single-threaded here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Pkg:
    """One package's API for the composition functions below."""

    def __init__(self, pkg, mesh, lambert, scene):
        self.pkg, self.Mesh, self.Lambert, self.scene = pkg, mesh, lambert, scene


JAX = _Pkg(bj, MeshJ, LambertJ, lambda seed: SceneJ(seed=seed))
TORCH = _Pkg(bt, MeshT, LambertT, lambda seed: bt.HanabiScene(seed=seed, device="cpu"))


def _camera(mod):
    return mod.CameraParams(view=mod.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0)),
                            proj=mod.orthographic(-1, 1, -1, 1, 0.1, 10.0), viewport=(64, 64))


def _phase(p, name, pos, mode, color):
    """A 4-particle effect at one point (test_scene.py:1135-1154)."""
    pkg = p.pkg
    A = pkg.attributes
    w = pkg.ExprWriter()
    a = (
        pkg.EffectAsset(name, 4, pkg.SpawnerSettings.once(1.0), w.finish())
        .init(pkg.SetAttributeModifier(A.POSITION, w.lit(pos).expr()))
        .init(pkg.SetAttributeModifier(A.LIFETIME, w.lit(100.0).expr()))
        .init(pkg.SetAttributeModifier(A.HDR_COLOR, w.lit(color).expr()))
        .render(pkg.SetSizeModifier((0.5, 0.5, 0.5)))
    )
    return a.with_alpha_mode(getattr(pkg.AlphaMode, mode.upper()))


def _checker():
    ch = np.indices((8, 8)).sum(0) % 2
    return np.stack([ch, 1 - ch, np.zeros_like(ch), np.ones_like(ch)], -1).astype(np.float32)


def _fade():
    yy, xx = np.mgrid[0:6, 0:6]
    r = np.clip(1.0 - np.hypot(xx - 2.5, yy - 2.5) / 3.0, 0.0, 1.0)
    return np.stack([r, r, r, np.ones_like(r)], -1).astype(np.float32)


def multilayer(p, tex):
    """test_scene.py:1859: two-layer, one-layer and plain effects."""
    M = p.pkg.ImageSampleMapping
    two = _phase(p, "two", (-0.4, 0.0, -0.5), "blend", (1, 1, 1, 0.9))
    two.render(p.pkg.ParticleTextureModifier(0, M.MODULATE))
    two.render(p.pkg.ParticleTextureModifier(1, M.MODULATE_OPACITY_FROM_R))
    one = _phase(p, "one", (0.4, 0.0, 0.5), "blend", (1, 1, 1, 0.6))
    one.render(p.pkg.ParticleTextureModifier(0, M.MODULATE_RGB))
    return [(two, "two", [tex["checker"], tex["fade"]]), (one, "one", [tex["checker"]]),
            (_phase(p, "plain", (0.0, 0.5, 0.0), "add", (0.3, 0.3, 0.1, 1.0)), "plain", [])]


def meshes_and_quads(p, tex):
    """test_scene.py:1975: an opaque triangle mesh with vertex colours
    beside a blend quad."""
    tri = p.Mesh(vertices=[[-0.5, -0.4, 0.0], [0.5, -0.4, 0.0], [0.0, 0.6, 0.0]],
                 indices=[[0, 1, 2]], colors=[[1, 1, 1, 1]] * 3)
    return [(_phase(p, "tri", (0.0, 0.0, -0.5), "opaque", (0.2, 0.3, 0.9, 1.0)).with_mesh(tri),
             "tri", []),
            (_phase(p, "bl", (0.6, 0.6, 0.5), "blend", (0.9, 0.1, 0.1, 0.5)), "bl", [])]


def uvless_mesh(p, tex):
    """test_scene.py:2014: a textured mesh without vertex UVs beside one
    with them, sharing one texture object."""
    verts = [[-0.5, -0.4, 0.0], [0.5, -0.4, 0.0], [0.0, 0.6, 0.0]]
    no_uv = p.Mesh(vertices=verts, indices=[[0, 1, 2]])
    with_uv = p.Mesh(vertices=verts, indices=[[0, 1, 2]], uvs=[[0.0, 1.0], [1.0, 1.0], [0.5, 0.0]])
    nu = _phase(p, "nu", (-0.4, 0.0, -0.5), "blend", (1.0, 1.0, 1.0, 0.8)).with_mesh(no_uv)
    wu = _phase(p, "wu", (0.4, 0.0, 0.5), "blend", (1.0, 1.0, 1.0, 0.8)).with_mesh(with_uv)
    return [(nu.render(p.pkg.ParticleTextureModifier(0)), "nu", [tex["ramp"]]),
            (wu.render(p.pkg.ParticleTextureModifier(0)), "wu", [tex["ramp"]])]


def lit_mesh(p, tex):
    """test_scene.py:2071: one lit icosphere beside an unlit quad."""
    lit = _phase(p, "ico", (0.0, 0.0, -0.5), "opaque", (0.8, 0.8, 0.8, 1.0)).with_mesh(
        p.Mesh.icosphere(0.5, subdivisions=1))
    lit.render(p.Lambert((1.0, 0.0, 0.0), 0.2))
    return [(lit, "ico", []),
            (_phase(p, "bl", (0.6, 0.6, 0.5), "blend", (0.9, 0.1, 0.1, 0.5)), "bl", [])]


def two_lamberts(p, tex):
    """test_scene.py:2113: two lit meshes with different setups and an
    unlit quad."""
    out = []
    for name, pos, ldir in (("a", (-0.4, 0.0, -0.5), (1.0, 0.0, 0.0)),
                            ("b", (0.4, 0.0, -0.5), (0.0, 1.0, 0.0))):
        a = _phase(p, name, pos, "opaque", (0.8, 0.8, 0.8, 1.0)).with_mesh(
            p.Mesh.icosphere(0.4, subdivisions=0))
        a.render(p.Lambert(ldir, 0.2))
        out.append((a, name, []))
    return out + [(_phase(p, "bl", (0.0, 0.5, 0.5), "blend", (0.9, 0.1, 0.1, 0.5)), "bl", [])]


def textured(p, tex):
    """test_scene.py:2163: textures of two sizes and mappings, a plain quad."""
    M = p.pkg.ImageSampleMapping
    a1 = _phase(p, "t1", (-0.4, 0.0, -0.5), "blend", (1, 1, 1, 0.8))
    a1.render(p.pkg.ParticleTextureModifier(0, M.MODULATE))
    a2 = _phase(p, "t2", (0.4, 0.0, 0.5), "blend", (1, 1, 1, 0.6))
    a2.render(p.pkg.ParticleTextureModifier(0, M.MODULATE_RGB))
    return [(a1, "t1", [tex["checker"]]), (a2, "t2", [tex["tint"]]),
            (_phase(p, "plain", (0.0, 0.5, 0.0), "add", (0.3, 0.3, 0.1, 1.0)), "plain", [])]


def flipbook(p, tex):
    """test_scene.py:2213: a 2x2 flipbook at frame 2 beside a blend quad."""
    pkg = p.pkg
    A = pkg.attributes
    w = pkg.ExprWriter()
    flip = (
        pkg.EffectAsset("flip", 4, pkg.SpawnerSettings.once(1.0), w.finish())
        .init(pkg.SetAttributeModifier(A.POSITION, w.lit((-0.4, 0.0, -0.5)).expr()))
        .init(pkg.SetAttributeModifier(A.LIFETIME, w.lit(100.0).expr()))
        .init(pkg.SetAttributeModifier(A.SPRITE_INDEX, w.lit(2, None).expr()))
        .render(pkg.SetSizeModifier((0.5, 0.5, 0.5)))
        .render(pkg.FlipbookModifier((2, 2)))
        .render(pkg.ParticleTextureModifier(0, pkg.ImageSampleMapping.MODULATE))
        .with_alpha_mode(pkg.AlphaMode.BLEND)
    )
    return [(flip, "flip", [tex["sheet"]]),
            (_phase(p, "bl", (0.5, 0.5, 0.5), "blend", (0.9, 0.1, 0.1, 0.5)), "bl", [])]


def chunk_two_layer(p, tex):
    """test_scene.py:2263: a two-layer effect and a plain one, for the
    fused chunk."""
    M = p.pkg.ImageSampleMapping
    two = _phase(p, "two", (-0.3, 0.0, -0.5), "blend", (1, 1, 1, 0.9))
    two.render(p.pkg.ParticleTextureModifier(0, M.MODULATE))
    two.render(p.pkg.ParticleTextureModifier(1, M.MODULATE_OPACITY_FROM_R))
    return [(two, "two", [tex["checker"], tex["flat"]]),
            (_phase(p, "plain", (0.3, 0.0, 0.5), "add", (0.3, 0.3, 0.1, 1.0)), "plain", [])]


def _textures():
    ramp = np.zeros((8, 8, 4), np.float32)
    u = np.linspace(0.1, 1.0, 8, dtype=np.float32)
    ramp[..., 0], ramp[..., 1], ramp[..., 3] = u[None, :], u[:, None], 1.0
    ramp[0, 0] = 0.0
    tint = np.ones((4, 4, 4), np.float32)
    tint[..., 0], tint[..., 2] = 0.2, 0.9
    sheet = np.zeros((8, 8, 4), np.float32)
    sheet[:4, :4], sheet[:4, 4:] = (1, 0, 0, 1), (0, 1, 0, 1)
    sheet[4:, :4], sheet[4:, 4:] = (0, 0, 1, 1), (1, 1, 0, 1)
    return {"checker": _checker(), "fade": _fade(), "ramp": ramp, "tint": tint, "sheet": sheet,
            "flat": np.full((4, 4, 4), 0.6, np.float32)}


# composition -> the tolerance of the JAX package's own painter-vs-split test
COMPOSITIONS = {
    "multilayer": (multilayer, 1e-6),
    "meshes_and_quads": (meshes_and_quads, 1e-6),
    "uvless_mesh": (uvless_mesh, 1e-5),
    "lit_mesh": (lit_mesh, 1e-6),
    "two_lamberts": (two_lamberts, 1e-6),
    "textured": (textured, 1e-6),
    "flipbook": (flipbook, 1e-6),
    "chunk_two_layer": (chunk_two_layer, 1e-5),
}


def _scene(p, build, seed=0):
    tex = _textures()
    s = p.scene(seed)
    for asset, name, texs in build(p, tex):
        s.add(asset, name, textures=texs)
    s.update(DT)
    return s


def _draws(p, s, cam, extract, expand):
    """Each effect's draw as the painter builds it, and its textures as the
    painter passes them: one object a source texture (the JAX package's
    _convert_textures_shared, the port's texture_sources)."""
    draws, texs = [], []
    conv = {}
    for inst in s.effects():
        if p is JAX:
            ts = [conv.setdefault(id(t), jnp.asarray(t, jnp.float32)) for t in inst.textures]
        else:
            ts = [conv.setdefault(id(src), t) for src, t in zip(inst.texture_sources, inst.textures)]
        d = extract(inst.asset, inst.pool, cam, textures=ts)
        if inst.asset.mesh is not None:
            d = expand(d, inst.asset.mesh)
        draws.append(d)
        texs.append(ts)
    return draws, texs


@pytest.mark.parametrize("name", list(COMPOSITIONS))
def test_concat_painter_draws_fields_match_jax(name):
    build, _ = COMPOSITIONS[name]
    sj, st = _scene(JAX, build), _scene(TORCH, build)
    dj, tj = _draws(JAX, sj, _camera(camera_j), extract_j, expand_j)
    dt, tt = _draws(TORCH, st, _camera(camera_t), extract_t, expand_t)
    kinds = [i.asset.alpha_mode.kind for i in st.effects()]
    want = concat_j(dj, kinds, textures_per_draw=tj)
    got = concat_t(dt, kinds, textures_per_draw=tt)
    for f in ("position", "axis_x", "axis_y", "color", "alive", "mode_id", "alpha_cutoff", "tri",
              "nrm_abc", "vcol_abc", "light_entry", "atlas", "tex_entry", "uv_abc"):
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
    assert got.lighting == want.lighting
    # every entry's flipbook frame as JAX's (None: no draw has one, JAX's zeros)
    sprite = got.sprite_index
    if sprite is None:
        sprite = torch.zeros(got.alive.shape, dtype=torch.int32)
    np.testing.assert_array_equal(sprite.numpy(), np.asarray(want.sprite_index))


@pytest.mark.parametrize("pipeline", ["painter", "auto"])
@pytest.mark.parametrize("name", [n for n in COMPOSITIONS if n != "chunk_two_layer"])
def test_painter_scene_matches_jax(name, pipeline):
    build, atol = COMPOSITIONS[name]
    sj, st = _scene(JAX, build), _scene(TORCH, build)
    img_j = np.asarray(sj.render(_camera(camera_j), background=(0, 0, 0, 0), pipeline=pipeline))
    insts = st.effects()
    _, transp = st._scene_render_plan(insts, _camera(camera_t), pipeline)
    assert transp[0][0] == "painter"
    img_t = st.render(_camera(camera_t), background=(0, 0, 0, 0), pipeline=pipeline).numpy()
    assert img_j[..., 3].max() > 0.1
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=atol)


def test_update_render_chunk_two_layer_painter_matches_jax():
    """test_scene.py:2263: the fused chunk of a two-layer painter scene
    against JAX's chunk, and against the port's own per-frame render."""
    build, atol = COMPOSITIONS["chunk_two_layer"]
    cfg_j, cfg_t = CfgJ(width=64, height=64, tile_size=16), bt.RasterConfig(64, 64, tile_size=16)
    sj, st = _scene(JAX, build, seed=11), _scene(TORCH, build, seed=11)
    img_j, sums_j = sj.update_render_chunk(4, DT, _camera(camera_j), cfg_j)
    img_t, sums_t = st.update_render_chunk(4, DT, _camera(camera_t), cfg_t)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=0, atol=atol)
    np.testing.assert_allclose(sums_t.numpy(), np.asarray(sums_j), rtol=1e-5)
    frame = _scene(TORCH, build, seed=11)
    for _ in range(4):
        frame.update(DT)
    np.testing.assert_allclose(img_t.numpy(), frame.render(_camera(camera_t), cfg_t).numpy(),
                               rtol=0, atol=atol)
    assert img_t[..., :3].max() > 0.05


def test_shared_texture_is_one_atlas_layer(monkeypatch):
    """Two effects given the same texture object share one atlas layer (the
    JAX package's _convert_textures_shared, scene.py:62-75), so each entry's
    layer id is JAX's; an equal copy is a layer of its own."""
    import bevy_hanabi_tpu_torch.render.extract as extract

    merged = []
    real = extract.concat_painter_draws

    def spy(*args, **kwargs):
        merged.append(real(*args, **kwargs))
        return merged[-1]

    monkeypatch.setattr(extract, "concat_painter_draws", spy)
    tex = _textures()
    for second, layers in ((tex, 1), (dict(tex, ramp=tex["ramp"].copy()), 2)):
        s = TORCH.scene(0)
        for asset, name, texs in uvless_mesh(TORCH, tex)[:1] + uvless_mesh(TORCH, second)[1:]:
            s.add(asset, name, textures=texs)
        s.update(DT)
        assert float(s.render(_camera(camera_t), pipeline="painter").sum()) > 0
        assert merged[-1].atlas.shape[0] == layers
        assert sorted(merged[-1].tex_entry[:, 2].unique().tolist()) == list(range(layers))
