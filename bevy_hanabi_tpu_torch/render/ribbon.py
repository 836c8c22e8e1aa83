"""Ribbon rendering: sorted segment quads
(port of ``bevy_hanabi_tpu/render/ribbon.py``).

Alive particles are ordered by ``(RIBBON_ID, -AGE, PARTICLE_COUNTER)`` (a
ribbon runs from its oldest particle to its newest; dead lanes sort last)
and each particle becomes the quad of the segment from its predecessor:
centre the midpoint, ``axis_x`` the segment, ``axis_y`` the camera-facing
side scaled by the particle's width. The segments are ordinary quads, so the
tile rasterizer needs no ribbon path.

The JAX package sorts once with ``lax.sort(num_keys=3)``. ``torch.sort``
takes one key, so the order comes from two stable sorts, least significant
first, whose keys :func:`ribbon_keys` (CUDA kernel) builds:

1. an int32 key of the counter (``0xFFFFFFFF`` where dead), giving
   ``perm1``;
2. an int64 key of ``(ribbon id, ordered(-age))``, read through ``perm1``,
   giving ``perm2``; the order is ``perm1[perm2]``.

``ordered`` reproduces ``lax.sort``'s float order, which is not IEEE's
total order: ``-0.0``, ``+0.0`` and the subnormals compare equal (to zero),
every NaN equals every other and sorts after ``+inf``.

:func:`ribbon_segments` (CUDA kernel) then builds every segment from the
sorted rows, and gathers the appearance columns (colour, the mask cutoff,
a textured ribbon's flipbook sprite index) into segment order. The JAX package leaves them in source order behind a
``remap`` that its rasterizer composes at window size, because a full
permutation gather cost milliseconds on the TPU; on the card it costs a
fraction of one of the sorts, so the segment draw carries every column in
segment order and the rasterizer is unchanged.

Both wrappers launch their kernel on CUDA tensors and add one to their
``launches``; on CPU tensors they take their plain versions.
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
from .camera import CameraParams
from .extract import ParticleDrawData

__all__ = [
    "build_ribbon_segments",
    "ribbon_sort",
    "RibbonSort",
    "ribbon_keys",
    "ribbon_keys_plain",
    "ribbon_segments",
    "ribbon_segments_plain",
    "KERNELS",
]

_U32 = 0xFFFFFFFF  # the dead lanes' ribbon id and counter (ribbon.py:47)
_SIGN = 0x80000000
# ordered(+inf): the dead lanes' age key (ribbon.py:49)
_ORDERED_INF = 0xFF800000
# the ribbon-id half (key >> 32) of a dead lane's sort key
_DEAD_HIGH = _U32 - _SIGN


def _ptr(t):
    return None if t is None else t.data_ptr()


def _ordered_neg_age(age: torch.Tensor) -> torch.Tensor:
    """``-age`` as uint32 bits (in int64) that order as ``lax.sort`` orders
    f32 on the CPU: zeros and subnormals map to +0.0, every NaN to one
    quiet NaN, then the sign flip makes the unsigned order the float
    order."""
    bits = (age.contiguous().view(torch.int32).to(torch.int64) & _U32) ^ _SIGN
    bits = torch.where((bits & 0x7FFFFFFF) > 0x7F800000, 0x7FC00000, bits)
    bits = torch.where((bits & 0x7F800000) == 0, 0, bits)
    return torch.where(bits >= _SIGN, bits ^ _U32, bits | _SIGN)


def ribbon_keys_plain(alive, counter=None, ribbon_id=None, age=None, perm=None):
    """Plain version of :func:`ribbon_keys`."""
    if counter is not None:
        c = torch.where(alive, counter & _U32, _U32)
        return (c - _SIGN).to(torch.int32)
    if perm is not None:
        alive, ribbon_id, age = alive[perm], ribbon_id[perm], age[perm]
    rid = torch.where(alive, ribbon_id & _U32, _U32)
    q = torch.where(alive, _ordered_neg_age(age), _ORDERED_INF)
    # the unsigned (rid << 32 | q) with its top bit flipped, as int64
    return (rid - _SIGN) * (1 << 32) + q


@cuda_build.on_tensor_device
def ribbon_keys(alive, counter=None, ribbon_id=None, age=None, perm=None):
    """The sort keys of the two stable sorts of :func:`ribbon_sort`.

    With ``counter`` (int64 [N], uint32 values): stage 1, the int32 key
    ``where(alive, counter, 0xFFFFFFFF) ^ 0x80000000``. Otherwise, with
    ``ribbon_id`` (int64 [N], uint32 values) and ``age`` (f32 [N]): stage
    2, the int64 key of ``(where(alive, ribbon_id, 0xFFFFFFFF),
    ordered(where(alive, -age, inf)))`` for row ``perm[i]`` (int64 [N],
    the stage-1 order; the identity when ``None``). Each key orders under
    a signed sort as its unsigned form. ``alive`` is bool [N]."""
    n = alive.shape[0]
    dev = alive.device
    _check(alive, "alive", torch.bool, (n,), dev)
    if counter is not None:
        _check(counter, "counter", torch.int64, (n,), dev)
        ribbon_id = age = perm = None
    else:
        if ribbon_id is None or age is None:
            raise ValueError("ribbon_keys: pass counter, or ribbon_id and age")
        _check(ribbon_id, "ribbon_id", torch.int64, (n,), dev)
        _check(age, "age", torch.float32, (n,), dev)
        if perm is not None:
            _check(perm, "perm", torch.int64, (n,), dev)
    if not alive.is_cuda:
        return ribbon_keys_plain(alive, counter, ribbon_id, age, perm)
    key = torch.empty((n,), dtype=torch.int32 if counter is not None else torch.int64, device=dev)
    code = cuda_build.library().hanabi_ribbon_keys(
        alive.data_ptr(), _ptr(counter), _ptr(ribbon_id), _ptr(age), _ptr(perm), key.data_ptr(),
        n, _stream(),
    )
    cuda_build.check(code, "ribbon_keys")
    ribbon_keys.launches += 1
    return key


ribbon_keys.launches = 0


class RibbonSort(NamedTuple):
    """The two stable sorts of :func:`ribbon_sort`: ``perm1`` (the counter
    order, None without a counter), ``perm2`` (the ``(ribbon, age)`` order
    of the ``perm1`` rows) and ``key`` (the sorted stage-2 keys)."""

    perm1: Optional[torch.Tensor]
    perm2: torch.Tensor
    key: torch.Tensor

    @property
    def order(self) -> torch.Tensor:
        """The source row of every sorted row: the JAX package's ``remap``."""
        return self.perm2 if self.perm1 is None else self.perm1[self.perm2]


def ribbon_sort(draw: ParticleDrawData) -> RibbonSort:
    """Sort the draw's particles by ``(ribbon id, -age, counter)``
    (ribbon.py:40-77) with two stable ``torch.sort`` calls, least
    significant key first. Without a counter the second sort alone orders
    by ``(ribbon id, -age)``, and particles equal on both keep their source
    order, where ``lax.sort`` (not stable) may order them otherwise."""
    perm1 = None
    if draw.counter is not None:
        perm1 = torch.sort(ribbon_keys(draw.alive, counter=draw.counter), stable=True).indices
    key = ribbon_keys(draw.alive, ribbon_id=draw.ribbon_id, age=draw.age.contiguous(), perm=perm1)
    key_sorted, perm2 = torch.sort(key, stable=True)
    return RibbonSort(perm1, perm2, key_sorted)


def _camera_params(camera_position) -> np.ndarray:
    """The camera position as a contiguous host f32 [3] (a camera's
    ``position`` is a column of its 4x4 matrix: strided)."""
    cam = torch.as_tensor(camera_position, dtype=torch.float32).cpu()
    return np.ascontiguousarray(cam.numpy(), np.float32)


def ribbon_segments_plain(position, axis_y, color, alpha_cutoff, perm1, perm2, key,
                          camera_position, sprite=None):
    """Plain version of :func:`ribbon_segments` (ribbon.py:61-121)."""
    dev = position.device
    order = perm2 if perm1 is None else perm1[perm2]
    prev = torch.roll(order, 1)
    p, q = position[order], position[prev]
    ay = axis_y[order]
    width = torch.sqrt(ay[:, 0] * ay[:, 0] + ay[:, 1] * ay[:, 1] + ay[:, 2] * ay[:, 2])
    rid = key >> 32
    alive = rid != _DEAD_HIGH
    valid = alive & torch.roll(alive, 1) & (rid == torch.roll(rid, 1))
    valid[:1] = False  # row 0 starts no segment (ribbon.py:87-90)
    d = p - q
    center = 0.5 * (p + q)
    v = center - torch.from_numpy(_camera_params(camera_position)).to(dev)
    side = torch.stack(
        [
            v[:, 1] * d[:, 2] - v[:, 2] * d[:, 1],
            v[:, 2] * d[:, 0] - v[:, 0] * d[:, 2],
            v[:, 0] * d[:, 1] - v[:, 1] * d[:, 0],
        ],
        dim=1,
    )
    norm = torch.sqrt(side[:, 0] * side[:, 0] + side[:, 1] * side[:, 1] + side[:, 2] * side[:, 2])
    side = side / torch.where(norm > 1e-8, norm, 1.0)[:, None]
    cutoff = None if alpha_cutoff is None else alpha_cutoff[order]
    sprite = None if sprite is None else sprite[order]
    return center, d, side * width[:, None], valid, color[order], cutoff, sprite


@cuda_build.on_tensor_device
def ribbon_segments(position, axis_y, color, alpha_cutoff, perm1, perm2, key, camera_position,
                    sprite=None):
    """Every segment quad from the sorted rows, in one launch.

    ``position``/``axis_y`` f32 [N, 3] and ``color`` f32 [N, 4] (and
    ``alpha_cutoff`` f32 [N] or None, ``sprite`` int32 [N] or None, a
    textured ribbon's flipbook frame) in source order; ``perm1`` (int64
    [N] or None), ``perm2`` (int64 [N]) and ``key`` (int64 [N], the sorted
    stage-2 keys) from :func:`ribbon_sort`; ``camera_position`` the world
    position (3 floats). Row i's source is ``perm1[perm2[i]]`` and its
    predecessor row i - 1's (row N - 1's for row 0, the roll of
    ribbon.py:82). Returns ``(center, axis_x, axis_y, valid, color,
    alpha_cutoff, sprite)`` in segment order: ``valid`` bool [N] where rows i - 1
    and i are alive rows of one ribbon and i > 0, ``axis_x`` the segment
    ``p - p_prev``, ``axis_y`` ``normalize(cross(center - camera, axis_x))``
    times row i's width ``|axis_y|``, colour, cutoff and sprite gathered
    by the order (cutoff and sprite None where not given). On the card ``color``, ``perm2`` and ``key`` must be 16-byte
    aligned, as every tensor that does not start inside another's row is:
    the kernel reads them in 16-byte vectors."""
    n = position.shape[0]
    dev = position.device
    _check(position, "position", torch.float32, (n, 3), dev)
    _check(axis_y, "axis_y", torch.float32, (n, 3), dev)
    _check(color, "color", torch.float32, (n, 4), dev)
    if alpha_cutoff is not None:
        _check(alpha_cutoff, "alpha_cutoff", torch.float32, (n,), dev)
    if sprite is not None:
        _check(sprite, "sprite", torch.int32, (n,), dev)
    if perm1 is not None:
        _check(perm1, "perm1", torch.int64, (n,), dev)
    _check(perm2, "perm2", torch.int64, (n,), dev)
    _check(key, "key", torch.int64, (n,), dev)
    if not position.is_cuda:
        return ribbon_segments_plain(position, axis_y, color, alpha_cutoff, perm1, perm2, key,
                                     camera_position, sprite)
    for name, t in (("color", color), ("perm2", perm2), ("key", key)):
        if t.data_ptr() % 16:
            raise ValueError(f"ribbon_segments: {name} must be 16-byte aligned on the card")
    center = torch.empty((n, 3), dtype=torch.float32, device=dev)
    axis_x = torch.empty((n, 3), dtype=torch.float32, device=dev)
    side = torch.empty((n, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    color_out = torch.empty((n, 4), dtype=torch.float32, device=dev)
    cutoff = None if alpha_cutoff is None else torch.empty((n,), dtype=torch.float32, device=dev)
    sprite_out = None if sprite is None else torch.empty((n,), dtype=torch.int32, device=dev)
    cam = _camera_params(camera_position)
    code = cuda_build.library().hanabi_ribbon_segments_sprite(
        position.data_ptr(), axis_y.data_ptr(), color.data_ptr(), _ptr(alpha_cutoff), _ptr(sprite),
        _ptr(perm1), perm2.data_ptr(), key.data_ptr(), cam.ctypes.data, center.data_ptr(),
        axis_x.data_ptr(), side.data_ptr(), valid.data_ptr(), color_out.data_ptr(), _ptr(cutoff),
        _ptr(sprite_out), n, _stream(),
    )
    cuda_build.check(code, "ribbon_segments")
    ribbon_segments.launches += 1
    return center, axis_x, side, valid, color_out, cutoff, sprite_out


ribbon_segments.launches = 0

KERNELS = {
    "ribbon_keys": Kernel(
        ribbon_keys,
        ribbon_keys_plain,
        "bevy_hanabi_tpu_torch/csrc/ribbon.cu",
        "bevy_hanabi_tpu/render/ribbon.py:47",
    ),
    "ribbon_segments": Kernel(
        ribbon_segments,
        ribbon_segments_plain,
        "bevy_hanabi_tpu_torch/csrc/ribbon.cu",
        "bevy_hanabi_tpu/render/ribbon.py:79",
    ),
}


def build_ribbon_segments(draw: ParticleDrawData, camera: CameraParams) -> ParticleDrawData:
    """Convert per-particle draw data into per-segment quad draw data
    (ribbon.py:27-122).

    Requires ``draw.ribbon_id`` and ``draw.age``. The output has the same
    length, every column in segment order; invalid segments (ribbon heads,
    cross-ribbon pairs, dead lanes) have ``alive=False``. The valid set,
    its order and its geometry are the JAX package's; its ``remap`` is
    resolved here (see the module docstring). As in the JAX package
    (ribbon.py:104-121), a segment quad drops roundness and keeps the
    texture layers, the flipbook grid and ``needs_uv``; its sprite index
    rides the kernel into segment order beside colour and cutoff.
    ``ribbon_id``, ``age`` and ``counter`` are None on the segment draw:
    nothing reads them after the segment build (the sharded renderer,
    ``parallel/render.py``, routes a draw's particles by them before it)."""
    if draw.ribbon_id is None or draw.age is None:
        raise ValueError("ribbon rendering requires RIBBON_ID and AGE attributes")
    order = ribbon_sort(draw)
    center, axis_x, axis_y, valid, color, cutoff, sprite = ribbon_segments(
        draw.position.contiguous(), draw.axis_y.contiguous(), draw.color.contiguous(),
        None if draw.alpha_cutoff is None else draw.alpha_cutoff.contiguous(),
        order.perm1, order.perm2, order.key, camera.position,
        None if draw.sprite_index is None else draw.sprite_index.contiguous(),
    )
    return dataclasses.replace(
        draw, position=center, axis_x=axis_x, axis_y=axis_y, color=color, alive=valid,
        roundness=None, alpha_cutoff=cutoff, sprite_index=sprite, ribbon_id=None, age=None,
        counter=None,
    )
