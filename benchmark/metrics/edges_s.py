"""edges_s: stream seconds per pass building friend clustering's
(position, friend) edges (the program's span ``cluster.edges`` in
``cluster/sparse.py``, ``Engine.stats["cluster.edges.device_s"]``), the
mean over the window's passes."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "cluster.edges.device_s")
