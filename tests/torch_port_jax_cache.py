"""JAX's persistent compilation cache for the port's parity test files.

The parity test files run the reference's models through the same XLA
computations again and again: each jitted forward, and the ~900 small ops
of each eager ``quantize_model`` pass (``torch_port_quant_common``), which
XLA compiles one by one in every process.  Each port test file imports the
module fixture ``jax_compile_cache``, which points JAX at a cache shared by
the worker processes under the checkout's git-ignored ``.jax_cache/``,
keeping every compile (no minimum compile time), while that file's tests
run, and turns it off after them: a file takes from the cache what an
earlier one compiled, and the JAX package's own tests run as before.
Measured on a CPU: ``test_torch_port_quant.py`` alone 123.8 s with an
empty cache, 67.8 s after ``test_torch_port_quant_entry.py`` had filled
it.  A cached executable is the one XLA compiled, so nothing a test
compares changes.  The cache is not bounded: a bound makes JAX lock it and
scan it at every entry, which costs more than it saves here (~60 MB after
every port test file).
"""

from pathlib import Path

import jax
import pytest
from jax._src import compilation_cache

CACHE_DIR = Path(__file__).resolve().parents[1] / ".jax_cache" / "port_tests"


@pytest.fixture(scope="module", autouse=True)
def jax_compile_cache():
    """The shared cache on for the module's tests, off after them."""
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_compilation_cache_dir", old[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old[1])
    compilation_cache.reset_cache()
