"""cooccur_s: stream seconds per pass in friend clustering's shift join and
co-occurrence reductions (the program's span ``cluster.cooccur`` in
``cluster/sparse.py``, ``Engine.stats["cluster.cooccur.device_s"]``), the
mean over the window's passes."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "cluster.cooccur.device_s")
