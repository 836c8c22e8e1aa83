"""Device: the share of the traced stretch that no device operation covers."""

from hanabi_bench.metrics import _common


def read(summary, cell):
    return _common.idle_pct(summary)
