"""The frozen roofline yardstick gives the kernel table's bound."""

from __future__ import annotations

import pytest

from hanabi_bench import roofline


def test_project_bin_headline_bound():
    # 1M lanes, the centre tile (one entry a lane), 10-float BLEND rows:
    # 0.0316 ms by bytes in the port's kernel table
    n = 1 << 20
    assert roofline.project_bin_bytes(n, 1, 10) == 101 * n + 8
    b = roofline.bound(roofline.project_bin_bytes(n, 1, 10), roofline.PROJECT_OPS * n)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(0.0316, abs=5e-5)


def test_exact_binning_bound():
    # exact binning writes four entries a lane: 0.0391 ms at 1M (the table's exact row)
    assert roofline.project_bin_bound_ms(1 << 20, 4, 10) == pytest.approx(0.0391, abs=5e-5)
