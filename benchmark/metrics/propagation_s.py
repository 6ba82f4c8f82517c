"""propagation_s: stream seconds per pass in friend clustering's label
propagation rounds (the program's span ``cluster.round`` in
``cluster/sparse.py``, summed over the rounds,
``Engine.stats["cluster.round.device_s"]``), the mean over the window's
passes."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "cluster.round.device_s")
