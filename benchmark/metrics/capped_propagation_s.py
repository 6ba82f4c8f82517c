"""capped_propagation_s: stream seconds per pass in capped-friend
clustering's label propagation: every min-label round of every batch over
its (B, K, F) membership mask, and the canonical ranks (the program's span
``cluster.capped.round`` in ``cluster/cooccur.py``, summed over the
batches, ``Engine.stats["cluster.capped.round.device_s"]``), the mean over
the window's passes."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "cluster.capped.round.device_s")
