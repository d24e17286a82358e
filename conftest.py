"""Settings for every pytest run from the repository root, loaded before
tests/conftest.py. They keep tier-1 (`pytest tests/ -n 6 --dist loadfile`,
ROADMAP.md) well inside its time limit and free of hangs:

- the JAX CPU client dispatches inline (`pytest_configure`);
- under `--dist loadfile`, the tests of SPLIT_FILE are handed out one test
  function a work unit, before any other file (`pytest_xdist_make_scheduler`).

Neither imports JAX or xdist itself, so runs without them (benchmark/tests on
the card) load this file unchanged. tests/test_tier1_setup.py checks both.
"""

import sys

import pytest

# Its test functions run minutes each and share only a cheap module fixture.
# In one work unit they are longer than the rest of the suite on the other
# workers together. This is the one place that names a file to split: a
# later file that takes minutes belongs here too.
SPLIT_FILE = "tests/test_sharding.py"


def pytest_configure(config):
    # TPU interpret mode's callbacks dispatch jnp ops to the CPU device that
    # runs the kernel; async dispatch lets the host queue the next batch's
    # state there at the same moment, and the two can block each other and
    # hang the test. The flag is read when the CPU client is made, which no
    # conftest does. jax is in sys.modules once tests/conftest.py is loaded.
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.config.update("jax_cpu_enable_async_dispatch", False)


def _scope(nodeid):
    """xdist's work unit of a test: its file, or in SPLIT_FILE its function
    (all parameter cases of it together)."""
    path, _, test = nodeid.partition("::")
    if path == SPLIT_FILE:
        return path + "::" + test.split("[", 1)[0]
    return path


def _split_first(workqueue):
    """Move SPLIT_FILE's work units, in their order, to the front of the
    queue, so each starts at once on a worker of its own."""
    split = [scope for scope in workqueue if scope.startswith(SPLIT_FILE + "::")]
    for scope in reversed(split):
        workqueue.move_to_end(scope, last=False)


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class SplitFileScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            return _scope(nodeid)

        def _assign_work_unit(self, node):
            _split_first(self.workqueue)
            super()._assign_work_unit(node)

    return SplitFileScheduling(config, log)
