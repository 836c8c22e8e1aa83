"""Raster kernels: device ms a frame in the port's ``project_bin``,
``bin_keys``, ``gather_window`` and ``tile_blend`` kernels."""

from hanabi_bench.metrics import _common

PATTERNS = (r"\bproject_bin_kernel", r"\bbin_keys_kernel", r"\bgather_window_kernel",
            r"\btile_blend(_appear|_painter)?_kernel")


def read(summary, cell):
    return _common.device_ms_per_frame(summary, PATTERNS)
