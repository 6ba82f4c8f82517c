"""The CPU tests' tiny shape (``tests/conftest.py``'s ``TINY``) of each
configuration that came after that table: it takes the shape of the
configuration whose lane it runs.  pytest loads ``tests/conftest.py`` as a
module of its own, and the tests import it again as
``benchmark.tests.conftest``; both copies of the table are given it."""

import benchmark.tests.conftest as _tests

# configuration -> the configuration whose lane, and so tiny shape, it has
SAME_LANE = {"chr20_30x_slice_sharded": "chr20_30x_slice"}


def _extend(tiny: dict) -> None:
    for name, like in SAME_LANE.items():
        tiny.setdefault(name, tiny[like])


def pytest_plugin_registered(plugin):
    if getattr(plugin, "tiny_root", None) is not None and isinstance(
            getattr(plugin, "TINY", None), dict):
        _extend(plugin.TINY)


_extend(_tests.TINY)
