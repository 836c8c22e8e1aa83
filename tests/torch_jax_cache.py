"""A fixture for the port's test files that build effects of the JAX
package, imported by each of them.

The JAX package caches its compiled effects process-wide
(``CompiledEffect._CACHE``, keyed by the asset's signature when it was
compiled), and a cached effect keeps the asset object it compiled. A JAX
test that edits an asset after adding it (tests/test_scene.py:1053 sets a
cached firework's capacity to 512) leaves an entry whose asset no longer has
the signature it is cached under, and a JAX scene built later in the same
process on a fresh asset of that signature gets it back, with the edited
capacity: under pytest-xdist that depends on which files share a worker.
:func:`jax_cache_of_the_module` gives a module an empty cache of its own and
puts the old one back after the module.
"""

import pytest

from bevy_hanabi_tpu.runtime.effect import CompiledEffect


@pytest.fixture(autouse=True, scope="module")
def jax_cache_of_the_module():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CompiledEffect, "_CACHE", {})
        yield
