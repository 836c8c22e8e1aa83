"""The harness's ``mixed_917k.scene_auto`` cell at a tiny size on the CPU
(``hanabi_bench/tests/_mixed.py``: debris 1024, grad 4096, rocket 512 and
trail 2048 lanes at 64 x 64 with a near camera), shared by
``test_torch_mixed_bench.py`` and ``test_torch_mixed_tracing.py``."""

from __future__ import annotations

import torch

from hanabi_bench.tests._mixed import CAPACITIES, CELL, FRAMES, TinyMixed  # noqa: F401

SEED = 2**31 + 1234567


def clone_state(state):
    return {m: {k: v.clone() for k, v in s.items()} for m, s in state.items()}


def one_thread():
    """Run PyTorch single-threaded (a module fixture's body): the plain
    raster's small ops each wake OpenMP, beside the other xdist workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    return threads
