"""Host dispatch: kernel launches a frame (the runtime's launch calls)."""

from hanabi_bench.metrics import _common


def read(summary, cell):
    return _common.per_frame(summary, _common.LAUNCHES)
