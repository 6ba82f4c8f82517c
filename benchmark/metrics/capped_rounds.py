"""capped_rounds: rounds of capped-friend clustering's label propagation
per pass, summed over the batches, the last round of each (the one that
finds nothing changed) included (the program's counter
``cluster.capped_rounds`` in ``cluster/cooccur.py``, ``Engine.stats``),
the mean over the window's passes.  Each round makes two passes over the
batch's (B, K, F) mask and waits for the host."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "cluster.capped_rounds")
