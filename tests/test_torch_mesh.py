"""The port's mesh particles against the JAX package, on the CPU:
``ParticleMesh`` (stock meshes and JSON), ``expand_mesh_draw`` (the plain
version of the ``mesh_expand`` kernel), triangle entries through the
rasterizer (the halved binning radii, the barycentric test, UVs, Lambert
normals and vertex colours), the textured-mesh gate of bench.py:295-327,
``example_puffs``, and mesh and textured effects in ``HanabiScene``.

Inputs are the same in both packages: numpy-seeded draws, or assets built
in the JAX package that cross to the port as JSON. Tolerances:
* meshes, their JSON and ``expand_mesh_draw``: exact (JAX called eagerly,
  as its own tests call it; XLA fuses its ``jnp.cross`` into one fused
  multiply-add a component, which the plain version reproduces);
* images: within 1e-5 absolute (XLA's CPU backend contracts a multiply and
  an add of the blend into one fused op where PyTorch rounds twice;
  measured 4.5e-7 unlit and 2.1e-6 lit on the union mesh, 7.2e-7 on the
  gate);
* stepped effects: alive masks and PCG seeds bit for bit, checksums within
  0.5% (bench.py:155-161).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_hanabi_tpu as bj
import bevy_hanabi_tpu_torch as bt
from bevy_hanabi_tpu.models import examples as examples_j
from bevy_hanabi_tpu.models import textured_mesh_check_effect as check_j
from bevy_hanabi_tpu.models.texutils import make_circle_texture
from bevy_hanabi_tpu.render import camera as camera_j
from bevy_hanabi_tpu.render.extract import ParticleDrawData as DrawJ
from bevy_hanabi_tpu.render.extract import concat_painter_draws as concat_painter_draws_j
from bevy_hanabi_tpu.render.mesh import ParticleMesh as MeshJ
from bevy_hanabi_tpu.render.mesh import expand_mesh_draw as expand_j
from bevy_hanabi_tpu.render.raster import RasterConfig as CfgJ
from bevy_hanabi_tpu.render.raster import rasterize as rasterize_j
from bevy_hanabi_tpu.runtime import HanabiScene as SceneJ
from bevy_hanabi_tpu.runtime.effect import CompiledEffect as EffectJ
from bevy_hanabi_tpu.runtime.effect import StepInputs as InputsJ
from bevy_hanabi_tpu_torch.models import examples as examples_t
from bevy_hanabi_tpu_torch.models import textured_mesh_check_effect
from bevy_hanabi_tpu_torch.render import camera as camera_t
from bevy_hanabi_tpu_torch.render import mesh as mesh_t
from bevy_hanabi_tpu_torch.render import raster
from bevy_hanabi_tpu_torch.render.extract import ParticleDrawData as DrawT
from bevy_hanabi_tpu_torch.render.extract import concat_painter_draws
from torch_jax_cache import jax_cache_of_the_module  # noqa: F401

ATOL = 1e-5  # XLA's fused multiply-adds (module docstring)
REL = 0.005  # checksum tolerance (bench.py:155-161)
DT = 1.0 / 60.0
SIZE = 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch's vectorised unary ops (floor, sqrt) hand even small tensors
    to OpenMP, whose wake-up costs milliseconds a call on a shared host, and
    the plain raster path calls them thousands of times: these tests run
    PyTorch single-threaded, and restore its thread count after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _camera(mod, size=SIZE, eye=(0.5, 1.0, 6.0)):
    return mod.CameraParams(mod.look_at(eye, (0.0, 0.0, 0.0)), mod.perspective(0.9, 1.0, 0.1, 100.0),
                            (size, size))


def _union(M):
    """Two quads and three triangles with vertex UVs (some outside [0, 1]),
    normals and colours."""
    r = np.random.default_rng(4)
    normals = r.normal(size=(5, 3))
    return M([[0.0, 0.0, 0.2], [0.1, 0.0, 0.0]], [[1, 0, 0], [0, 0, 1]], [[0, 1, 0], [0, 1, 0]],
             vertices=r.normal(size=(5, 3)) * 0.4, indices=[[0, 1, 2], [2, 3, 4], [4, 0, 1]],
             uvs=r.uniform(-1.5, 2.5, (5, 2)), normals=normals / np.linalg.norm(normals, axis=1)[:, None],
             colors=r.uniform(0, 1, (5, 4)))


MESHES = {
    "quad": lambda M: M.quad(),
    "cross": lambda M: M.cross(),
    "cube": lambda M: M.cube(0.7),
    "tetrahedron": lambda M: M.tetrahedron(1.3),
    "icosphere0": lambda M: M.icosphere(0.4, 0),
    "icosphere1": lambda M: M.icosphere(0.5, 1),
    "union": _union,
}


# ---- ParticleMesh ------------------------------------------------------------


@pytest.mark.parametrize("name", list(MESHES))
def test_stock_meshes_and_json_equal_the_jax_package(name):
    mj, mt = MESHES[name](MeshJ), MESHES[name](mesh_t.ParticleMesh)
    for f in ("offsets", "axes_x", "axes_y", "vertices", "indices", "uvs", "normals", "colors"):
        a, b = getattr(mj, f), getattr(mt, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=f)
    assert mt.to_json() == mj.to_json()
    back = mesh_t.ParticleMesh.from_json(mj.to_json())
    assert back.to_json() == mj.to_json() and back.num_triangles == mj.num_triangles


@pytest.mark.parametrize("kwargs,match", [
    (dict(vertices=np.zeros((3, 3)), indices=[[0, 1, 3]]), "index"),
    (dict(vertices=np.zeros((3, 3)), indices=[[0, 1, -2]]), "index"),
    (dict(vertices=np.zeros((3, 3)), indices=[[0, 1, 2]], uvs=np.zeros((2, 2))), "vertex count"),
    (dict(), "at least one"),
    (dict(offsets=[[0, 0, 0]], axes_x=[[1, 0, 0]], axes_y=np.zeros((0, 3))), "equal quad counts"),
])
def test_mesh_validation_matches_jax(kwargs, match):
    for M in (MeshJ, mesh_t.ParticleMesh):
        with pytest.raises(ValueError, match=match):
            M(**kwargs)


def test_assets_cross_with_their_mesh():
    asset_j = check_j(64).with_mesh(MeshJ.icosphere(0.4, 1))
    asset_t = bt.EffectAsset.from_json(asset_j.to_json())
    assert isinstance(asset_t.mesh, mesh_t.ParticleMesh)
    assert asset_t.to_json() == asset_j.to_json()
    assert textured_mesh_check_effect(64).to_json() == check_j(64).to_json()


# ---- expand_mesh_draw ---------------------------------------------------------


def _particles(n, seed):
    r = np.random.default_rng(seed)
    cols = {
        "position": r.normal(size=(n, 3)).astype(np.float32),
        "axis_x": r.normal(size=(n, 3)).astype(np.float32),
        "axis_y": r.normal(size=(n, 3)).astype(np.float32),
        "color": r.uniform(0, 1, (n, 4)).astype(np.float32),
        "alive": r.random(n) < 0.8,
        "roundness": r.uniform(0, 1, n).astype(np.float32),
        "sprite_index": r.integers(0, 9, n).astype(np.int32),
        "alpha_cutoff": r.uniform(0, 1, n).astype(np.float32),
    }
    cols["axis_x"][:3] = 0.0  # degenerate frames: the 1e-9 clamps
    cols["axis_y"][3] = cols["axis_x"][4]
    return cols


def _draws(cols, lit):
    lighting = ((0.577, 0.577, 0.577), 0.7) if lit else None
    dj = DrawJ(**{k: jnp.asarray(v) for k, v in cols.items()}, sprite_grid_size=(1, 1),
               texture_layers=(), needs_uv=False, lighting=lighting)
    dt = DrawT(**{k: torch.from_numpy(v) for k, v in cols.items()}, lighting=lighting)
    return dj, dt


@pytest.mark.parametrize("lit", [False, True])
@pytest.mark.parametrize("name", list(MESHES))
def test_expand_mesh_draw_is_exact(name, lit):
    """Every column of the expanded draw equal to JAX's, element-major, the
    per-particle columns repeated per element; the default quad returns the
    draw itself."""
    mj, mt = MESHES[name](MeshJ), MESHES[name](mesh_t.ParticleMesh)
    dj, dt = _draws(_particles(53, 7), lit)
    out_j, out_t = expand_j(dj, mj), mesh_t.expand_mesh_draw(dt, mt)
    if name == "quad":
        assert out_t is dt
        return
    for f in ("position", "axis_x", "axis_y", "color", "alive", "roundness", "sprite_index",
              "alpha_cutoff", "tri", "uv_abc", "nrm_abc", "vcol_abc"):
        a, b = getattr(out_j, f), getattr(out_t, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
    assert out_t.lighting == out_j.lighting


def test_mesh_tables_upload_once_per_device():
    m = mesh_t.ParticleMesh.icosphere(0.4, 1)
    assert mesh_t.mesh_tables(m, "cpu") is mesh_t.mesh_tables(m, torch.device("cpu"))
    t = mesh_t.mesh_tables(m, "cpu")
    assert t.geom.shape == (80, 10) and t.uv.shape == (80, 6) and t.nrm.shape == (80, 9)
    assert t.vcol is None


# ---- triangles through the rasterizer ----------------------------------------


def _mesh_draws(lit, textured, seed=2, n=24):
    """A union-mesh draw in both packages: camera-facing particles of a few
    tenths of a unit, expanded by each package's own expand_mesh_draw."""
    r = np.random.default_rng(seed)
    rot = _camera(camera_t).rotation.numpy()
    s = r.uniform(0.4, 1.2, (n, 1)).astype(np.float32)
    cols = {
        "position": r.uniform(-1.5, 1.5, (n, 3)).astype(np.float32),
        "axis_x": (rot[:, 0][None, :] * s).astype(np.float32),
        "axis_y": (rot[:, 1][None, :] * s).astype(np.float32),
        "color": r.uniform(0.2, 1, (n, 4)).astype(np.float32),
        "alive": r.random(n) < 0.9,
    }
    layers = ((0, bj.ImageSampleMapping.MODULATE),) if textured else ()
    lighting = ((0.577, 0.577, 0.577), 0.3) if lit else None
    dj = DrawJ(**{k: jnp.asarray(v) for k, v in cols.items()}, roundness=None,
               sprite_index=jnp.zeros(n, jnp.int32), sprite_grid_size=(1, 1), texture_layers=layers,
               needs_uv=textured, lighting=lighting)
    dt = DrawT(**{k: torch.from_numpy(v) for k, v in cols.items()}, texture_layers=layers,
               needs_uv=textured, lighting=lighting)
    return expand_j(dj, _union(MeshJ)), mesh_t.expand_mesh_draw(dt, _union(mesh_t.ParticleMesh))


@pytest.mark.parametrize("lit,textured,slots", [(False, True, 0), (True, True, 2)])
def test_triangle_entries_rasterize_like_jax(lit, textured, slots):
    """Quad and triangle entries of one union mesh, with vertex colours,
    UVs outside [0, 1] on a texture, and Lambert normals."""
    dj, dt = _mesh_draws(lit, textured)
    tex = make_circle_texture(16)
    cfg = dict(width=SIZE, height=SIZE, tile_slots=slots)
    img_j = np.asarray(rasterize_j(dj, _camera(camera_j), CfgJ(**cfg), textures=[jnp.asarray(tex)]))
    img_t = raster.rasterize(dt, _camera(camera_t), raster.RasterConfig(**cfg),
                             textures=[torch.from_numpy(tex)]).numpy()
    assert img_j.sum() > 0
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=ATOL)


def test_triangles_bin_at_half_their_quad_radii():
    """A triangle entry near the screen's edge bins by half its radii, as
    JAX's (raster.py:259-263): the tiles equal JAX's binning."""
    _, dt = _mesh_draws(False, False, seed=5, n=200)
    args = (dt.position, dt.axis_x, dt.axis_y, dt.alive, dt.color, _camera(camera_t).view,
            _camera(camera_t).proj, (SIZE, SIZE), 16, 4, 4)
    tile, _, _, _ = raster.project_bin(*args, tile_slots=0, appearance=(None, dt.tri) + (None,) * 6)
    quad, _, _, _ = raster.project_bin(*args, tile_slots=0)
    tri = dt.tri.repeat(4).bool()
    assert bool((tile[tri] != quad[tri]).any())  # halving changes triangles' tiles
    assert torch.equal(tile[~tri], quad[~tri])  # and no quad's


# ---- the gate, example_puffs, the scene --------------------------------------


def _gate_pair():
    asset_j = check_j(2048).render(bj.ParticleTextureModifier(0)).with_mesh(MeshJ.icosphere(0.4, 1))
    return asset_j, bt.EffectAsset.from_json(asset_j.to_json())


def test_textured_mesh_gate_matches_jax():
    """bench.py:295-327: HanabiScene(seed=5), 3 updates, a 128x128 render
    at RasterConfig(128, 128) with the circle texture."""
    asset_j, asset_t = _gate_pair()
    tex = make_circle_texture(32)
    sj = SceneJ(seed=5)
    sj.add(asset_j, "mesh", textures=[tex])
    st = bt.HanabiScene(seed=5, device="cpu")
    st.add(asset_t, "mesh", textures=[tex])
    for _ in range(3):
        sj.update(DT)
        st.update(DT)
    np.testing.assert_array_equal(st["mesh"].pool.alive.numpy(), np.asarray(sj["mesh"].pool.alive))
    img_j = np.asarray(sj.render(_camera(camera_j, 128, (0, 0, 6)), CfgJ(128, 128)))
    img_t = st.render(_camera(camera_t, 128, (0, 0, 6)), bt.RasterConfig(128, 128)).numpy()
    assert img_j.sum() > 0
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=ATOL)


def test_example_puffs_matches_jax():
    """Lambert on the icosphere's normals: a few frames through
    step_render_chunk, masks and seeds bit for bit, checksums within 0.5%."""
    asset_j, asset_t = examples_j.example_puffs(), examples_t.example_puffs()
    assert asset_t.to_json() == asset_j.to_json()
    frames = 4
    fx_j, fx_t = EffectJ(asset_j), bt.CompiledEffect(asset_t, device="cpu")
    ins_j = [InputsJ.make(24, 7 * i + 1) for i in range(frames)]
    ins_t = [bt.StepInputs.make(24, 7 * i + 1) for i in range(frames)]
    sims_j = [bj.SimParams(time=i * DT, delta_time=DT) for i in range(frames)]
    sims_t = [bt.SimParams(time=i * DT, delta_time=DT) for i in range(frames)]
    pool_j, _, sums_j = fx_j.step_render_chunk(fx_j.create_pool(), *fx_j.stack_frames(ins_j, sims_j),
                                               _camera(camera_j, eye=(0, 0, 4)), CfgJ(SIZE, SIZE))
    pool_t, _, sums_t = fx_t.step_render_chunk(fx_t.create_pool(), *fx_t.stack_frames(ins_t, sims_t),
                                               _camera(camera_t, eye=(0, 0, 4)),
                                               raster.RasterConfig(SIZE, SIZE))
    np.testing.assert_array_equal(pool_t.alive.numpy(), np.asarray(pool_j.alive))
    np.testing.assert_array_equal(pool_t.to_numpy()[2], np.asarray(pool_j.seed))
    sums_j = np.asarray(sums_j)
    assert sums_j[-1] > 0
    np.testing.assert_allclose(sums_t.numpy(), sums_j, rtol=REL)


def _scene(textured_mesh=True, other=True):
    from bevy_hanabi_tpu_torch.models import gradient_effect

    s = bt.HanabiScene(seed=5, device="cpu")
    asset = textured_mesh_check_effect(512).render(bt.ParticleTextureModifier(0))
    s.add(asset.with_mesh(mesh_t.ParticleMesh.icosphere(0.4, 0)) if textured_mesh else asset, "mesh",
          textures=[make_circle_texture(16)])
    if other:
        s.add(gradient_effect(256), "grad")
    for _ in range(6):
        s.update(4 * DT)
    return s


def _scene_j(textured_mesh=True, other=True):
    """:func:`_scene` in the JAX package."""
    from bevy_hanabi_tpu.models import gradient_effect

    s = SceneJ(seed=5)
    asset = check_j(512).render(bj.ParticleTextureModifier(0))
    s.add(asset.with_mesh(MeshJ.icosphere(0.4, 0)) if textured_mesh else asset, "mesh",
          textures=[make_circle_texture(16)])
    if other:
        s.add(gradient_effect(256), "grad")
    for _ in range(6):
        s.update(4 * DT)
    return s


@pytest.mark.parametrize("mesh,other,pipeline", [(True, True, "auto"), (True, False, "painter"),
                                                 (False, True, "auto"), (False, False, "painter")])
def test_painter_plans_with_textures_or_meshes_raise(mesh, other, pipeline):
    """Textured and mesh effects in a painter plan (the atlas and the
    mesh merge) render as the JAX package's: the frame, then a two-frame
    update_render_chunk, images within 1e-5 and checksums within 0.5%."""
    s, sj = _scene(mesh, other), _scene_j(mesh, other)
    cam, cam_j = _camera(camera_t, eye=(0, 0, 6)), _camera(camera_j, eye=(0, 0, 6))
    assert s._scene_render_plan(s.effects(), cam, pipeline)[1][0][0] == "painter"
    img = s.render(cam, pipeline=pipeline).numpy()
    img_j = np.asarray(sj.render(cam_j, pipeline=pipeline))
    assert img_j[..., :3].sum() > 0
    np.testing.assert_allclose(img, img_j, rtol=0, atol=ATOL)
    img, sums = s.update_render_chunk(2, DT, cam, pipeline=pipeline)
    img_j, sums_j = sj.update_render_chunk(2, DT, cam_j, pipeline=pipeline)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(sums.numpy(), np.asarray(sums_j), rtol=REL)


def test_concat_painter_draws_refuses_meshes():
    """A mesh draw's painter merge (its triangle, UV-less and vertex-colour
    columns) equals the JAX package's, field for field."""
    dj, dt = _mesh_draws(False, False)
    want = concat_painter_draws_j([dj], ["blend"])
    got = concat_painter_draws([dt], ["blend"])
    for f in ("position", "axis_x", "axis_y", "color", "alive", "tri", "vcol_abc", "mode_id"):
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
    assert got.nrm_abc is None and want.nrm_abc is None and got.atlas is None


def test_mesh_scene_chunk_matches_its_frames():
    """update_render_chunk (the split plan, one pass) renders the frames
    that update then render give, and set_textures reaches the renderer."""
    a, b = _scene(other=False), _scene(other=False)
    cam = _camera(camera_t, eye=(0, 0, 6))
    img, sums = a.update_render_chunk(3, DT, cam)
    for _ in range(3):
        b.update(DT)
    frame = b.render(cam)
    np.testing.assert_array_equal(img.numpy(), frame.numpy())
    assert float(sums[-1]) == float(frame.sum()) > 0
    b.set_textures("mesh", [np.zeros((4, 4, 4), np.float32)])
    assert float(b.render(cam, background=(0, 0, 0, 0)).sum()) == 0.0
