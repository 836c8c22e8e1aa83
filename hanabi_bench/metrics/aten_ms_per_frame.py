"""Step and extract: device ms a frame in PyTorch's own kernels (ATen's,
and the CUB scans and reductions it calls), the sort's excepted."""

from hanabi_bench.metrics import _common

PATTERNS = (r"^(?!.*RadixSort).*(\bat::|at_cuda_detail|\bcub::)",)


def read(summary, cell):
    return _common.device_ms_per_frame(summary, PATTERNS)
