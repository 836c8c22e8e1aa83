"""The yardstick of a kernel's roofline share: the card's peaks and the
bytes and operations a kernel's work needs, counted from its shapes.

The peaks are NVIDIA's H100 SXM data sheet's at its 700 W limit: device
memory at 3.35 TB/s and FP32 outside the tensor cores at 67 TFLOP/s. A
bound counts each input byte read once and each output byte written once,
and the FP32 operations every correct kernel must do; a share is the bound
over the measured time.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "FP32_OPS_PER_S", "PROJECT_OPS", "bound", "project_bin_bytes",
           "project_bin_bound_ms"]

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# project_bin's FP32 operations a particle: three projections of four dot
# products, the divide and viewport map, the half axes, the screen and size
# tests, the tile floor
PROJECT_OPS = 150


def bound(moved_bytes: float, ops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the FP32 rate, in ms."""
    by_bytes = 1e3 * moved_bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * ops / FP32_OPS_PER_S
    if by_bytes >= by_ops:
        return {"bound_ms": by_bytes, "bound_by": "bytes"}
    return {"bound_ms": by_ops, "bound_by": "operations"}


def project_bin_bytes(n: int, slots: int, row: int) -> int:
    """``project_bin`` over ``n`` particles: position, both axes (f32 x3),
    alive (bool) and colour (f32 x4) read; ``slots`` entries a particle of
    a tile (int32) and a depth (f32), one ``row``-float row a particle and
    the depth range (f32 x2) written."""
    return n * (3 * 3 * 4 + 1 + 4 * 4) + slots * n * (4 + 4) + n * row * 4 + 2 * 4


def project_bin_bound_ms(n: int, slots: int, row: int) -> float:
    return bound(project_bin_bytes(n, slots, row), PROJECT_OPS * n)["bound_ms"]
