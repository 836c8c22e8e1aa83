"""Per-particle meshes (port of ``bevy_hanabi_tpu/render/mesh.py``).

:class:`ParticleMesh` is the JAX package's numpy class, unchanged: a union
of oriented quads and indexed triangles in mesh space, each of which becomes
one raster entry per particle (triangles take the rasterizer's barycentric
inside test). :func:`expand_mesh_draw` expands a draw into those entries
through :func:`mesh_expand`, a CUDA kernel (``csrc/mesh.cu``) on CUDA
tensors and its plain version, :func:`mesh_expand_plain`, on CPU tensors.
The mesh's constants (each element's offset and edges, and its vertex UVs,
normals and colours) are uploaded once per mesh and device
(:func:`mesh_tables`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import cuda_build
from ..cuda_build import Kernel
from ..cuda_build import check_tensor as _check
from ..cuda_build import current_stream as _stream
from ..ops.linalg import sqrt_f32
from .extract import ParticleDrawData

__all__ = [
    "ParticleMesh",
    "MeshTables",
    "mesh_tables",
    "mesh_expand",
    "mesh_expand_plain",
    "expand_mesh_draw",
    "KERNELS",
]


class ParticleMesh:
    """A union of oriented quads and indexed triangles instanced per particle."""

    def __init__(self, offsets=None, axes_x=None, axes_y=None,
                 vertices=None, indices=None, uvs=None, normals=None,
                 colors=None):
        self.offsets = np.asarray(
            offsets if offsets is not None else np.zeros((0, 3)), np.float32
        ).reshape(-1, 3)
        self.axes_x = np.asarray(
            axes_x if axes_x is not None else np.zeros((0, 3)), np.float32
        ).reshape(-1, 3)
        self.axes_y = np.asarray(
            axes_y if axes_y is not None else np.zeros((0, 3)), np.float32
        ).reshape(-1, 3)
        if not (len(self.offsets) == len(self.axes_x) == len(self.axes_y)):
            raise ValueError("mesh arrays must have equal quad counts")
        self.vertices = np.asarray(
            vertices if vertices is not None else np.zeros((0, 3)), np.float32
        ).reshape(-1, 3)
        self.indices = np.asarray(
            indices if indices is not None else np.zeros((0, 3)), np.int32
        ).reshape(-1, 3)
        if self.indices.size and (
            self.indices.max() >= len(self.vertices) or self.indices.min() < 0
        ):
            raise ValueError("triangle index out of range")
        if self.num_quads + self.num_triangles == 0:
            raise ValueError("mesh needs at least one quad or triangle")
        # Optional per-vertex attributes (the reference's ATTRIBUTE_UV_0 /
        # _NORMAL / _COLOR vertex buffers), indexed by the same `indices` and
        # interpolated barycentrically per fragment by the rasterizer.
        self.uvs = (
            None if uvs is None else np.asarray(uvs, np.float32).reshape(-1, 2)
        )
        self.normals = (
            None
            if normals is None
            else np.asarray(normals, np.float32).reshape(-1, 3)
        )
        self.colors = (
            None
            if colors is None
            else np.asarray(colors, np.float32).reshape(-1, 4)
        )
        for name in ("uvs", "normals", "colors"):
            arr = getattr(self, name)
            if arr is not None and len(arr) != len(self.vertices):
                raise ValueError(
                    f"per-vertex {name} must match vertex count "
                    f"({len(arr)} vs {len(self.vertices)})"
                )
        # the device copies of this mesh's tables, by device (mesh_tables)
        self._tables = {}

    @property
    def num_quads(self) -> int:
        return len(self.offsets)

    @property
    def num_triangles(self) -> int:
        return len(self.indices)

    # -- stock meshes ------------------------------------------------------

    @staticmethod
    def quad() -> "ParticleMesh":
        """The default single camera-oriented quad (the reference default)."""
        return ParticleMesh([[0, 0, 0]], [[1, 0, 0]], [[0, 1, 0]])

    @staticmethod
    def cross() -> "ParticleMesh":
        """Two perpendicular quads (cheap volumetric impostor)."""
        return ParticleMesh(
            [[0, 0, 0], [0, 0, 0]],
            [[1, 0, 0], [0, 0, 1]],
            [[0, 1, 0], [0, 1, 0]],
        )

    @staticmethod
    def cube(size: float = 1.0) -> "ParticleMesh":
        """Axis-aligned box from 6 face quads."""
        s = size / 2.0
        offsets, ax, ay = [], [], []
        for axis in range(3):
            for sign in (-1.0, 1.0):
                normal = np.zeros(3)
                normal[axis] = sign * s
                u = np.zeros(3)
                u[(axis + 1) % 3] = size
                v = np.zeros(3)
                v[(axis + 2) % 3] = size
                offsets.append(normal)
                ax.append(u)
                ay.append(v)
        return ParticleMesh(offsets, ax, ay)

    @staticmethod
    def from_triangles(vertices, indices, uvs=None, normals=None,
                       colors=None) -> "ParticleMesh":
        """An arbitrary indexed triangle mesh (the general EffectMesh case),
        optionally with per-vertex UVs, normals, and colors."""
        return ParticleMesh(
            vertices=vertices, indices=indices, uvs=uvs, normals=normals,
            colors=colors,
        )

    @staticmethod
    def icosphere(radius: float = 0.5, subdivisions: int = 1) -> "ParticleMesh":
        """Subdivided icosahedron (the reference's puffs.rs mesh,
        SphereMeshBuilder SphereKind::Ico). 20*4^subdivisions triangles —
        every triangle becomes one raster entry per particle, so keep
        subdivisions small for large pools."""
        phi = (1.0 + np.sqrt(5.0)) / 2.0
        verts = np.array(
            [
                [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
                [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
                [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
            ],
            np.float64,
        )
        faces = [
            (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
            (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
            (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
            (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
        ]
        verts = [v / np.linalg.norm(v) for v in verts]
        cache = {}

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = verts[i] + verts[j]
                verts.append(m / np.linalg.norm(m))
                cache[key] = len(verts) - 1
            return cache[key]

        for _ in range(subdivisions):
            nxt = []
            for a, b, c in faces:
                ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
                nxt += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
            faces = nxt
        unit = np.asarray(verts, np.float32)
        # exact per-vertex attributes for a sphere: normal = unit position,
        # UV = equirectangular mapping (seam triangles wrap)
        uvs = np.stack(
            [
                0.5 + np.arctan2(unit[:, 2], unit[:, 0]) / (2.0 * np.pi),
                0.5 - np.arcsin(np.clip(unit[:, 1], -1.0, 1.0)) / np.pi,
            ],
            axis=1,
        )
        return ParticleMesh.from_triangles(
            unit * radius, faces, uvs=uvs, normals=unit
        )

    @staticmethod
    def tetrahedron(size: float = 1.0) -> "ParticleMesh":
        """A regular tetrahedron — the smallest closed triangle mesh."""
        s = size / 2.0
        verts = np.array(
            [[s, s, s], [s, -s, -s], [-s, s, -s], [-s, -s, s]], np.float32
        )
        idx = [[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2]]
        return ParticleMesh.from_triangles(verts, idx)

    # -- serde --------------------------------------------------------------

    def to_json(self):
        data = {
            "offsets": self.offsets.tolist(),
            "axes_x": self.axes_x.tolist(),
            "axes_y": self.axes_y.tolist(),
        }
        if self.num_triangles:
            data["vertices"] = self.vertices.tolist()
            data["indices"] = self.indices.tolist()
            for name in ("uvs", "normals", "colors"):
                arr = getattr(self, name)
                if arr is not None:
                    data[name] = arr.tolist()
        return data

    @staticmethod
    def from_json(data) -> "ParticleMesh":
        return ParticleMesh(
            data.get("offsets"),
            data.get("axes_x"),
            data.get("axes_y"),
            vertices=data.get("vertices"),
            indices=data.get("indices"),
            uvs=data.get("uvs"),
            normals=data.get("normals"),
            colors=data.get("colors"),
        )


# ---------------------------------------------------------------------------
# the expansion: tables, kernel wrapper, plain version
# ---------------------------------------------------------------------------

# floats of an element's geometry row: anchor (3), edge x (3), edge y (3),
# edge scale (1)
GEOM = 10


class MeshTables(NamedTuple):
    """A mesh's constants on one device, one row per element ``k`` (the
    ``Q`` quads, then the ``T`` triangles), as the JAX package computes
    them in numpy float32 (mesh.py:261-331).

    ``geom`` f32 [K, 10]: the anchor (a quad's offset; a triangle's
    ``0.5 * (B + C)``), the two edges (a quad's axes; a triangle's ``B - A``
    and ``C - A``) and the scale of the mapped edges (1 for a quad, 2 for a
    triangle). ``uv`` [K, 6] (a quad's ``(0,0, 1,0, 0,1)``, a triangle's
    vertex UVs), ``nrm`` [K, 9] (a triangle's mesh-space vertex normals; a
    quad's row is unused: its normals are the particle's axis z) and
    ``vcol`` [K, 12] (a quad's white, a triangle's vertex colours), each
    None where the mesh has no such attribute or no triangle."""

    num_quads: int
    num_triangles: int
    geom: torch.Tensor
    uv: Optional[torch.Tensor]
    nrm: Optional[torch.Tensor]
    vcol: Optional[torch.Tensor]


def _tables_numpy(mesh: ParticleMesh):
    q, t = mesh.num_quads, mesh.num_triangles
    geom = np.zeros((q + t, GEOM), np.float32)
    geom[:q, 0:3] = mesh.offsets
    geom[:q, 3:6] = mesh.axes_x
    geom[:q, 6:9] = mesh.axes_y
    geom[:q, 9] = 1.0
    tri = mesh.vertices[mesh.indices]  # [T, 3 vertices, 3]
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    geom[q:, 0:3] = np.float32(0.5) * (b + c)
    geom[q:, 3:6] = b - a
    geom[q:, 6:9] = c - a
    geom[q:, 9] = 2.0
    uv = nrm = vcol = None
    if mesh.uvs is not None and t:
        uv = np.zeros((q + t, 6), np.float32)
        uv[:q] = (0.0, 0.0, 1.0, 0.0, 0.0, 1.0)
        uv[q:] = mesh.uvs[mesh.indices].reshape(t, 6)
    if mesh.normals is not None and t:
        nrm = np.zeros((q + t, 9), np.float32)
        nrm[q:] = mesh.normals[mesh.indices].reshape(t, 9)
    if mesh.colors is not None and t:
        vcol = np.ones((q + t, 12), np.float32)
        vcol[q:] = mesh.colors[mesh.indices].reshape(t, 12)
    return geom, uv, nrm, vcol


def mesh_tables(mesh: ParticleMesh, device) -> MeshTables:
    """The mesh's :class:`MeshTables` on ``device``, uploaded once per
    mesh and device."""
    device = torch.device(device)
    tables = mesh._tables.get(device)
    if tables is None:
        arrays = [None if a is None else torch.from_numpy(a).to(device)
                  for a in _tables_numpy(mesh)]
        tables = MeshTables(mesh.num_quads, mesh.num_triangles, *arrays)
        mesh._tables[device] = tables
    return tables


def is_default_quad(mesh: ParticleMesh) -> bool:
    """The reference's default single quad, which expands to the draw
    itself (mesh.py:237-244)."""
    return (
        mesh.num_triangles == 0
        and mesh.num_quads == 1
        and np.allclose(mesh.offsets, 0)
        and np.allclose(mesh.axes_x, [[1, 0, 0]])
        and np.allclose(mesh.axes_y, [[0, 1, 0]])
    )


def _fms(a, b, p):
    """``a * b - p`` with one rounding, as XLA contracts ``jnp.cross``'s
    ``a1 * b2 - a2 * b1`` into a fused multiply-add of the first product
    (the kernel's ``fmaf``): the f32 product is exact in f64, and the f64
    difference rounds to f32 as the fused op does, unless that difference
    itself rounded onto an f32 tie (|p| above 32 |a * b|, and then about
    one term in 2^29)."""
    return (a.double() * b.double() - p.double()).to(torch.float32)


def _sum3(v):
    """``jnp.sum(v, axis=-1)`` over 3 components, in its order."""
    return (v[..., 0] + v[..., 1]) + v[..., 2]


def _at_least(x, lo: float):
    """``jnp.maximum(x, lo)``: NaN stays NaN."""
    return torch.where(x < lo, lo, x)


def mesh_expand_plain(position, axis_x, axis_y, color, alive, tables: MeshTables,
                      want_uv: bool = False, want_nrm: bool = False, want_vcol: bool = False):
    """Plain version of :func:`mesh_expand` (mesh.py:246-336), broadcast
    over the ``[K, N]`` entries with the JAX package's op order."""
    ax, ay = axis_x, axis_y
    az = torch.stack([
        _fms(ax[:, 1], ay[:, 2], ax[:, 2] * ay[:, 1]),
        _fms(ax[:, 2], ay[:, 0], ax[:, 0] * ay[:, 2]),
        _fms(ax[:, 0], ay[:, 1], ax[:, 1] * ay[:, 0]),
    ], dim=1)
    azn = az / _at_least(sqrt_f32(_sum3(az * az)), 1e-9)[:, None]
    sz = sqrt_f32(_sum3(ax * ax))[:, None]
    az = azn * sz

    def map3(m, x, y, z):  # m [K, 3] -> [K, N, 3]
        return (m[:, None, 0:1] * x[None] + m[:, None, 1:2] * y[None]) + m[:, None, 2:3] * z[None]

    g = tables.geom
    n, k = position.shape[0], g.shape[0]
    scale = g[:, None, 9:10]
    out = {
        "position": (position[None] + map3(g[:, 0:3], ax, ay, az)).reshape(k * n, 3),
        "axis_x": (scale * map3(g[:, 3:6], ax, ay, az)).reshape(k * n, 3),
        "axis_y": (scale * map3(g[:, 6:9], ax, ay, az)).reshape(k * n, 3),
        "color": color.repeat(k, 1),
        "alive": alive.repeat(k),
        "tri": None,
        "uv_abc": None,
        "nrm_abc": None,
        "vcol_abc": None,
    }
    if tables.num_triangles:
        out["tri"] = (g[:, 9] > 1.0).to(torch.float32).repeat_interleave(n)
    if want_uv:
        out["uv_abc"] = tables.uv.repeat_interleave(n, dim=0)
    if want_vcol:
        out["vcol_abc"] = tables.vcol.repeat_interleave(n, dim=0)
    if want_nrm:
        axn = ax / _at_least(sqrt_f32(_sum3(ax * ax)), 1e-9)[:, None]
        ayn = ay / _at_least(sqrt_f32(_sum3(ay * ay)), 1e-9)[:, None]
        q, t = tables.num_quads, tables.num_triangles
        tri_n = tables.nrm[q:].reshape(3 * t, 3)  # [T * 3 vertices, 3]
        v = map3(tri_n, axn, ayn, azn)
        v = v / _at_least(sqrt_f32(_sum3(v * v)), 1e-9)[..., None]
        tri_n = v.reshape(t, 3, n, 3).transpose(1, 2).reshape(t, n, 9)
        quad_n = azn.repeat(1, 3)[None].expand(q, n, 9)
        out["nrm_abc"] = torch.cat([quad_n, tri_n]).reshape(k * n, 9)
    return out


@cuda_build.on_tensor_device
def mesh_expand(position, axis_x, axis_y, color, alive, tables: MeshTables,
                want_uv: bool = False, want_nrm: bool = False, want_vcol: bool = False):
    """Expand ``N`` particles into the mesh's ``K`` elements, entry
    ``k * N + p`` (element-major, the order of the JAX package's
    concatenation): ``position`` / ``axis_x`` / ``axis_y`` f32 [K·N, 3]
    (each element mapped through the particle's frame), ``color`` f32
    [K·N, 4] and ``alive`` bool [K·N] (the particle's), ``tri`` f32 [K·N]
    (1.0 on triangle entries; None for a mesh without triangles) and, where
    asked, ``uv_abc`` [K·N, 6], ``nrm_abc`` [K·N, 9] (the vertex normals
    through the normalised particle axes) and ``vcol_abc`` [K·N, 12].
    Inputs: the particles' ``position``, ``axis_x``, ``axis_y`` f32 [N, 3],
    ``color`` f32 [N, 4], ``alive`` bool [N], and the mesh's tables on
    the same device (:func:`mesh_tables`). Returns a dict of those names."""
    dev = position.device
    n = position.shape[0]
    _check(position, "position", torch.float32, (n, 3), dev)
    _check(axis_x, "axis_x", torch.float32, (n, 3), dev)
    _check(axis_y, "axis_y", torch.float32, (n, 3), dev)
    _check(color, "color", torch.float32, (n, 4), dev)
    _check(alive, "alive", torch.bool, (n,), dev)
    k = tables.geom.shape[0]
    _check(tables.geom, "geom", torch.float32, (k, GEOM), dev)
    for name, want, width in (("uv", want_uv, 6), ("nrm", want_nrm, 9), ("vcol", want_vcol, 12)):
        if want:
            table = getattr(tables, name)
            if table is None:
                raise ValueError(f"mesh_expand: the mesh has no {name} table")
            _check(table, name, torch.float32, (k, width), dev)
    if not position.is_cuda:
        return mesh_expand_plain(position, axis_x, axis_y, color, alive, tables,
                                 want_uv, want_nrm, want_vcol)
    if not 0 < k <= 65535:
        raise ValueError(f"mesh_expand runs one grid row an element: 1 to 65535 elements, got {k}")
    e = k * n
    if color.data_ptr() % 16:  # the kernel moves a colour as one 16-byte vector
        color = color.clone()

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = {
        "position": empty(e, 3),
        "axis_x": empty(e, 3),
        "axis_y": empty(e, 3),
        "color": empty(e, 4),
        "alive": empty(e, dtype=torch.bool),
        "tri": empty(e) if tables.num_triangles else None,
        "uv_abc": empty(e, 6) if want_uv else None,
        "nrm_abc": empty(e, 9) if want_nrm else None,
        "vcol_abc": empty(e, 12) if want_vcol else None,
    }

    def ptr(t):
        return None if t is None else t.data_ptr()

    code = cuda_build.library().hanabi_mesh_expand(
        position.data_ptr(), axis_x.data_ptr(), axis_y.data_ptr(), color.data_ptr(),
        alive.data_ptr(), tables.geom.data_ptr(), ptr(tables.uv if want_uv else None),
        ptr(tables.nrm if want_nrm else None), ptr(tables.vcol if want_vcol else None),
        out["position"].data_ptr(), out["axis_x"].data_ptr(), out["axis_y"].data_ptr(),
        out["color"].data_ptr(), out["alive"].data_ptr(), ptr(out["tri"]), ptr(out["uv_abc"]),
        ptr(out["nrm_abc"]), ptr(out["vcol_abc"]), n, tables.num_quads, tables.num_triangles,
        _stream(),
    )
    cuda_build.check(code, "mesh_expand")
    mesh_expand.launches += 1
    return out


mesh_expand.launches = 0

KERNELS = {
    "mesh_expand": Kernel(
        mesh_expand,
        mesh_expand_plain,
        "bevy_hanabi_tpu_torch/csrc/mesh.cu",
        "bevy_hanabi_tpu/render/mesh.py:228",
    ),
}


def expand_mesh_draw(draw: ParticleDrawData, mesh: ParticleMesh) -> ParticleDrawData:
    """Expand per-particle draw data into per-quad/per-triangle entries
    (mesh.py:228-363).

    The particle frame is (axis_x, axis_y, axis_z), already scaled by size
    in extraction, so a mesh-space point m maps to ``position + m.x*axis_x
    + m.y*axis_y + m.z*axis_z`` (axis_z: the unit normal of axis_x and
    axis_y times ``|axis_x|``). A triangle entry is anchored at the midpoint
    of B and C with ``axis = 2 * world(edge)``, so the rasterizer's
    half-extent convention recovers the exact edges. Vertex UVs and colours
    are the mesh's constants; normals follow the particle's normalised axes,
    only where the draw is lit. The default quad returns the draw itself.
    The ribbon columns are not carried (a ribbon effect renders segments,
    never a mesh); every other per-particle column repeats per element."""
    if is_default_quad(mesh):
        return draw
    q, t = mesh.num_quads, mesh.num_triangles
    k = q + t
    want_nrm = mesh.normals is not None and t > 0 and draw.lighting is not None
    out = mesh_expand(
        draw.position.contiguous(), draw.axis_x.contiguous(), draw.axis_y.contiguous(),
        draw.color.contiguous(), draw.alive, mesh_tables(mesh, draw.position.device),
        want_uv=mesh.uvs is not None and t > 0, want_nrm=want_nrm,
        want_vcol=mesh.colors is not None and t > 0,
    )

    def rep(x):
        return None if x is None else x.repeat(k)

    return dataclasses.replace(
        draw,
        **out,
        roundness=rep(draw.roundness),
        sprite_index=rep(draw.sprite_index),
        alpha_cutoff=rep(draw.alpha_cutoff),
        ribbon_id=None,
        age=None,
        counter=None,
        lighting=draw.lighting if want_nrm else None,
    )
