"""Exact small-matrix transforms as broadcast f32 math — never ``@``.

Port of ``bevy_hanabi_tpu/ops/linalg.py``. On the TPU a tiny ``@`` ran on
the MXU at bf16 precision; on Hopper the same trap is TF32. Every helper is
plain mul/add with a fixed association order, so the results are exact f32
and identical on the CPU and the card.
"""

from __future__ import annotations

import torch

__all__ = ["rotate3", "affine3", "mat4_mul", "mvp_w", "affine4_inv", "sqrt_f32"]


def rotate3(v, rot):
    """``v @ rot.T`` for ``v: [..., 3]``, ``rot: [..., 3, 3]`` broadcast
    against ``v``'s leading axes (one ``[3, 3]`` for all, or ``[I, 1, 3, 3]``
    for ``[I, N, 3]`` instanced lanes) — exact f32."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [
            x * rot[..., 0, 0] + y * rot[..., 0, 1] + z * rot[..., 0, 2],
            x * rot[..., 1, 0] + y * rot[..., 1, 1] + z * rot[..., 1, 2],
            x * rot[..., 2, 0] + y * rot[..., 2, 1] + z * rot[..., 2, 2],
        ],
        dim=-1,
    )


def affine3(v, rot, tr):
    """``v @ rot.T + tr`` for ``v: [..., 3]``, ``rot: [..., 3, 3]``, ``tr:
    [..., 3]``, broadcast as :func:`rotate3`."""
    return rotate3(v, rot) + tr


def mat4_mul(a, b):
    """``a @ b`` for two 4x4 matrices, unrolled over the contraction so the
    f32 adds have a fixed left-to-right order on every backend."""
    return (
        a[:, 0:1] * b[0:1, :]
        + a[:, 1:2] * b[1:2, :]
        + a[:, 2:3] * b[2:3, :]
        + a[:, 3:4] * b[3:4, :]
    )


def affine4_inv(m):
    """Closed-form inverse of an AFFINE 4x4 (last row ``0 0 0 1``) via the
    3x3 adjugate, in the same f32 op order as the JAX package."""
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    ca, cb, cc = e * i - f * h, c * h - b * i, b * f - c * e
    cd, ce, cf = f * g - d * i, a * i - c * g, c * d - a * f
    cg, ch, ci = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * ca + b * cd + c * cg
    inv3 = (
        torch.stack(
            [
                torch.stack([ca, cb, cc]),
                torch.stack([cd, ce, cf]),
                torch.stack([cg, ch, ci]),
            ]
        )
        / det
    )
    tx, ty, tz = m[0, 3], m[1, 3], m[2, 3]
    ti = torch.stack(
        [
            -(inv3[0, 0] * tx + inv3[0, 1] * ty + inv3[0, 2] * tz),
            -(inv3[1, 0] * tx + inv3[1, 1] * ty + inv3[1, 2] * tz),
            -(inv3[2, 0] * tx + inv3[2, 1] * ty + inv3[2, 2] * tz),
        ]
    )
    top = torch.cat([inv3, ti[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=m.dtype, device=m.device)
    return torch.cat([top, bottom], dim=0)


def mvp_w(mvp, p):
    """Clip-space ``w`` of points ``p: [N, 3]`` under ``mvp: [4, 4]``."""
    return p[:, 0] * mvp[3, 0] + p[:, 1] * mvp[3, 1] + p[:, 2] * mvp[3, 2] + mvp[3, 3]


def sqrt_f32(x):
    """The correctly rounded f32 square root of an f32 tensor, as XLA's and
    the card's ``sqrtf``: through f64, since PyTorch's vectorised CPU
    square root may miss by an ulp (an f64 result within an ulp rounds to
    the right f32: an f32's square root is never that close to an f32 tie)."""
    return torch.sqrt(x.double()).to(torch.float32)
