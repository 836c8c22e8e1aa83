"""The same whole runs on the card, at the tiny size: the program's CUDA
kernels and the reference agree, and the control fails; and so for the
test tree of ``test_bench_tree.py``. Skips without a card (decided inside
each test)."""

from __future__ import annotations

import pytest
import torch

from hanabi_bench import control, run, spec, verify
from hanabi_bench.tests._tiny import TREE_MIXES, TinyBench, TreeBench

CELLS = sorted(spec.load().workloads)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the program's CUDA kernels have no CPU mode")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_run_on_card(name):
    out = run.run(TinyBench(lanes=2048), name, 99, 0.5, False, _card())
    assert out["correct"], out["readings"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_card(name):
    dev = _card()
    cell = TinyBench(lanes=2048).cell(name)
    readings = verify.compare(control.control_record(cell, 5, dev), cell, 5, dev)
    assert not verify.judge(readings, cell.limits), readings


@pytest.mark.cuda
@pytest.mark.parametrize("mix", sorted(TREE_MIXES))
def test_tree_on_card(mix):
    dev = _card()
    out = run.run(TreeBench(), f"firework_tree.{mix}", 99, 0.5, False, dev)
    assert out["correct"], out["readings"]
    cell = TreeBench().cell(f"firework_tree.{mix}")
    readings = verify.compare(control.control_record(cell, 5, dev), cell, 5, dev)
    assert not verify.judge(readings, cell.limits), readings
