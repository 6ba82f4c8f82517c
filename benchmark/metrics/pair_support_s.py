"""pair_support_s: stream seconds per pass in pair clustering's support
products: each batch's dense ranks, 0/1 indicator D, D @ D^T and adjacency
(the program's span ``cluster.pair.support`` in ``cluster/cooccur.py``,
summed over the batches, ``Engine.stats["cluster.pair.support.device_s"]``),
the mean over the window's passes."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "cluster.pair.support.device_s")
