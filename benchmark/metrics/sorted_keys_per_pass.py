"""sorted_keys_per_pass: elements put through the main path's device sorts
per pass: table flushes, the steps' dedups, the incidence's CSR,
clustering's co-occurrence, friend-key and canonical-rank sorts and the
split's (the program's counter ``sorted_keys``, ``Engine.stats``), the
mean over the window's passes."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "sorted_keys")
