"""capped_friends_s: stream seconds per pass in capped-friend clustering's
friend table: the sparse co-occurrence counts, their three sorts and the
(n_codes, F) table of each barcode's first ``max_friends`` friends (the
program's span ``cluster.capped.friends`` in ``cluster/cooccur.py``,
``Engine.stats["cluster.capped.friends.device_s"]``), the mean over the
window's passes."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "cluster.capped.friends.device_s")
