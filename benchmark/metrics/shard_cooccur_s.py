"""shard_cooccur_s: stream seconds per pass in sharded friend clustering's
co-occurrence sweep, its routing and its tables' flushes included (the
program's span ``cluster.cooccur`` in ``cluster/sparse_dist.py``,
``Engine.stats["cluster.cooccur.device_s"]``), the mean over the window's
passes."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "cluster.cooccur.device_s")
