"""shard_propagation_s: stream seconds per pass in sharded friend
clustering's label propagation rounds, their all_reduce(min) merges
included (the program's span ``cluster.round`` in
``cluster/sparse_dist.py``, summed over the rounds,
``Engine.stats["cluster.round.device_s"]``), the mean over the window's
passes."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "cluster.round.device_s")
