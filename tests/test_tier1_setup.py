"""The test session's set-up that the repository's root conftest.py makes."""

from collections import OrderedDict

import jax
import jax.numpy as jnp


def _root_conftest(config):
    return config.pluginmanager.get_plugin(str(config.rootpath / "conftest.py"))


def test_cpu_client_dispatches_inline():
    """Async CPU dispatch deadlocks the TPU-interpret-mode tests (root
    conftest.py), so the session's CPU client runs each computation before
    dispatch returns: the result is ready at once."""
    assert jax.config.values["jax_cpu_enable_async_dispatch"] is False
    f = jax.jit(lambda a: (a @ a) @ a)
    x = jnp.ones((1024, 1024), jnp.float32)
    f(x).block_until_ready()
    assert all(f(x).is_ready() for _ in range(8))


def test_split_file_handed_out_first(request):
    """Under `--dist loadfile` the split file's test functions are work units
    of their own (parameter cases together), queued before every file."""
    root = _root_conftest(request.config)
    assert (request.config.rootpath / root.SPLIT_FILE).is_file()
    hook = request.config.pluginmanager.hook.pytest_xdist_make_scheduler
    assert root in [impl.plugin for impl in hook.get_hookimpls()]

    split = root.SPLIT_FILE
    nodeids = [
        "tests/test_a.py::test_one",
        f"{split}::test_f[(8, 1)]",
        "tests/test_a.py::test_two",
        f"{split}::test_f[(1, 1)]",
        f"{split}::test_g",
        "tests/test_z.py::test_three",
    ]
    queue = OrderedDict()
    for nodeid in nodeids:
        queue.setdefault(root._scope(nodeid), {})[nodeid] = False
    root._split_first(queue)
    assert list(queue) == [
        f"{split}::test_f", f"{split}::test_g", "tests/test_a.py", "tests/test_z.py"
    ]
    assert list(queue[f"{split}::test_f"]) == [nodeids[1], nodeids[3]]
