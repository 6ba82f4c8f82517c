"""pair_rounds: rounds of pair clustering's label propagation per pass,
summed over the batches, the last round of each (the one that finds
nothing changed) included (the program's counter ``cluster.pair_rounds``
in ``cluster/cooccur.py``, ``Engine.stats``), the mean over the window's
passes.  Each round writes and reads a (B, K, K) temporary and waits for
the host."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "cluster.pair_rounds")
