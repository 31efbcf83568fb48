"""The test suite runs without JAX's persistent compilation cache.

``tests/conftest.py`` points JAX at an on-disk cache under ``~/.cache``
that outlives a run. An XLA:CPU executable with cross-device collectives
that a process loads from that cache, instead of compiling it, can stall
at an all-gather until XLA's rendezvous times out and aborts the process:
``tests/test_sharding.py::test_sharded_volexact_step_matches_single_device
[adaptive]`` takes its pytest-xdist worker down so whenever the cache
already holds its executables from an earlier run, and passes from a cold
cache. Every worker imports this module while it collects, before any
test compiles, so turning the cache off here makes every run compile
afresh, as a first run does.
"""

import jax
import jax.extend.backend
import jax.numpy as jnp
from jax._src import compilation_cache

jax.config.update("jax_enable_compilation_cache", False)
compilation_cache.reset_cache()   # forget a check made before the update


def test_persistent_compile_cache_is_off():
    assert not jax.config.jax_enable_compilation_cache
    assert int(jax.jit(lambda x: x + 1)(jnp.int32(1))) == 2
    assert not compilation_cache.is_cache_used(jax.extend.backend.get_backend())
