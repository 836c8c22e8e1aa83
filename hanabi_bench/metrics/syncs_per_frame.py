"""Host dispatch: calls a frame that block the host on the device."""

from hanabi_bench.metrics import _common


def read(summary, cell):
    return _common.per_frame(summary, _common.SYNCS)
