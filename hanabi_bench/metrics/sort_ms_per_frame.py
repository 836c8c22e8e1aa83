"""Sort: device ms a frame in the library sort's kernels (CUB's radix sort)."""

from hanabi_bench.metrics import _common

PATTERNS = (r"RadixSort",)


def read(summary, cell):
    return _common.device_ms_per_frame(summary, PATTERNS)
