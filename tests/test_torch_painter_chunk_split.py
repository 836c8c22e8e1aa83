"""The small mixed scene through ``update_render_chunk`` under the
``"split"`` pipeline, in the port and the JAX package, on the CPU: three
chunks of 8 frames (tests/torch_painter_mixed.py). A file of its own, so
that pytest-xdist's ``--dist loadfile`` runs it beside the other
pipeline's. Tolerances: alive masks, PCG seeds, spawn counters and event
counts bit for bit; checksums within 0.5%.
"""

import pytest

from torch_jax_cache import jax_cache_of_the_module  # noqa: F401
from torch_painter_mixed import one_torch_thread  # noqa: F401
from torch_painter_mixed import check_chunk_checksums, check_chunk_state, mixed_chunks_of


@pytest.fixture(scope="module", params=["split"])
def mixed_chunks(request):
    return mixed_chunks_of(request.param)


def test_mixed_chunk_state_matches_jax_bit_for_bit(mixed_chunks):
    check_chunk_state(mixed_chunks)


def test_mixed_chunk_checksums_match_jax(mixed_chunks):
    check_chunk_checksums(mixed_chunks)
