"""pair_propagation_s: stream seconds per pass in pair clustering's label
propagation, every round of every batch (the program's span
``cluster.pair.round`` in ``cluster/cooccur.py``,
``Engine.stats["cluster.pair.round.device_s"]``), the mean over the
window's passes."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "cluster.pair.round.device_s")
