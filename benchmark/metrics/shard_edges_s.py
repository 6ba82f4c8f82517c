"""shard_edges_s: stream seconds per pass in sharded friend clustering's
edge sweep, its sweep arrays included (the program's span
``cluster.edges`` in ``cluster/sparse_dist.py``,
``Engine.stats["cluster.edges.device_s"]``), the mean over the window's
passes."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "cluster.edges.device_s")
