"""Step and extract: device ms a frame in the port's generated step kernel
(``bevy_hanabi_tpu_torch/runtime/fused.py``): the step, and before it, for
an instance of more than 4096 lanes, its count and scan passes. None where
the program has no such kernel."""

from hanabi_bench.metrics import _common

PATTERNS = (r"\bhanabi_step_(count_|scan_)?kernel\b",)


def read(summary, cell):
    return _common.device_ms_per_frame(summary, PATTERNS)
