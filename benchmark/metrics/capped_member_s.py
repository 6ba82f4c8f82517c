"""capped_member_s: stream seconds per pass in capped-friend clustering's
membership masks: each batch's gather of its k-mers' barcode lists and the
(B, K, F) test of each friend against each list (the program's span
``cluster.capped.member`` in ``cluster/cooccur.py``, summed over the
batches, ``Engine.stats["cluster.capped.member.device_s"]``), the mean
over the window's passes."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "cluster.capped.member.device_s")
