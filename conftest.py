"""Root hooks of the test suites.  The benchmark's CPU tests
(``benchmark/tests``) cut every configuration of ``BENCHMARK.json`` to a
tiny shape (``TINY`` in ``benchmark/tests/conftest.py``, widened by
``benchmark/conftest.py``'s ``SAME_LANE``); this gives the configurations
that came after those tables the shape of the configuration whose lane
they run.  Both copies of the table (the plugin pytest loads and the module
the tests import again as ``benchmark.tests.conftest``) are given it."""

import sys

# configuration -> the configuration whose lane, and so tiny shape, it has
SAME_LANE = {"chr20_30x_slice_pair": "chr20_30x_slice",
             "chr20_30x_slice_capped": "chr20_30x_slice"}


def _extend(mod) -> None:
    tiny = getattr(mod, "TINY", None)
    if getattr(mod, "tiny_root", None) is None or not isinstance(tiny, dict):
        return
    for name, like in SAME_LANE.items():
        if like in tiny:
            tiny.setdefault(name, tiny[like])


def pytest_plugin_registered(plugin):
    _extend(plugin)
    _extend(sys.modules.get("benchmark.tests.conftest"))
