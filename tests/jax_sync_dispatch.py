"""Opt-in pytest plugin: run the JAX CPU client without async dispatch.

TPU interpret mode's callbacks dispatch jnp ops to the CPU device that runs
the kernel, and async dispatch lets the host queue the next batch's state
there at the same moment; the two can block each other, and the test hangs.
Inline dispatch removes the race. Load it from the repository root:

    python -m pytest -p tests.jax_sync_dispatch tests/
"""

import jax


def pytest_configure(config):
    # After tests/conftest.py has set up JAX, before any backend exists.
    jax.config.update("jax_cpu_enable_async_dispatch", False)
