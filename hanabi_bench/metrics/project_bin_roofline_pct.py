"""Kernels: ``project_bin``'s share of its roofline, the bound of the
cell's lanes, entry slots and 10-float BLEND rows over its device time a
call."""

from hanabi_bench import roofline

PATTERNS = (r"\bproject_bin_kernel",)
ROW = 10  # cx, cy, two half axes, rgba: a BLEND pass's row


def read(summary, cell):
    seconds, calls = summary.device_s(PATTERNS)
    if not calls or seconds <= 0:
        return None
    config = cell.config
    r = config["raster"]
    slots = r["tile_span"] ** 2 if r["tile_slots"] == 0 else r["tile_slots"]
    lanes = config["instances"] * config["lanes_per_instance"]
    return 100.0 * roofline.project_bin_bound_ms(lanes, slots, ROW) / (1e3 * seconds / calls)
