"""flushes_per_pass: the count and pair tables' sort-merges of their append
buffers in a pass's count and incidence (``Engine.stats["flushes"]``), the
mean over the window's passes."""

from benchmark.readers import stat_mean


def read(ctx):
    return stat_mean(ctx, "flushes")
